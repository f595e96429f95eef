// The delay-and-sum heatmap beam as one CUDA kernel.
//
// Replaces beamforming_lk_tpu/ops/pallas_das.py::das_beam_pallas (kernel
// _das_kernel):
//     beam[k, d, t] = sum_c sum_j w[d, c, j] * x[k, c, shift[d, c] + j + t]
// for K windows x [K, C, T+S], the compact delay split shift [D, C] int32
// and tap weights w [D, C, taps] f32 (2 taps linear, 8 FIR).  The plain
// PyTorch twin is ops/cuda_das.py::das_beam_reference (the JAX package's
// dense one-hot stencil contraction).
//
// Why it gathers: the TPU kernel rebuilds a dense one-hot stencil tile
// [tile_c*S, tile_d] and runs it through the MXU, because Mosaic has no
// gathers.  Only `taps` of the S columns of a channel carry weight (2 of 64
// for linear), so here each tap is read straight from the staged window:
// taps/S of the dense work.
//
// What bounds it on an H100: the heatmap (D = 4096, T = 256) does
// D*C*taps*T FMAs (134 M at 64 mics linear, 537 M at 256 mics) on a window
// of C*(T+S) floats (82 KB / 327 KB) and a split of D*C*(taps+1) words
// (3 / 12 MB).  Each FMA reads one window value from shared memory, so the
// shared-memory load rate bounds it, not device memory or arithmetic.
//
// Design: one thread block of kThreads threads per tile of kDirs
// directions, per window of the stack, per 256 time samples.  Channels run
// in tiles of kChan: the tile's window rows (f32; a bf16 product widens its
// rounded inputs) and the tile's shifts and tap weights for the kDirs
// directions are staged in shared memory.  Each thread owns kPerThread
// time samples kThreads apart (neighbouring lanes read neighbouring window
// columns: no bank conflicts) and keeps kDirs x kPerThread f32 sums in
// registers across the channel tiles.  The 256-mic f32 window (327 KB)
// does not fit in 227 KB of shared memory; channel tiles of 32 rows do.
//
// Later work: stage the window once per block cluster with TMA, share the
// tile's window across more directions per block, and run the taps of
// several channels as a banded product on the tensor cores.
//
// Numerics: f32 sums (fmaf), in channel order then tap order per output;
// with the bf16 flag the window values and tap weights are rounded to bf16
// (round to nearest even) before the product, as the JAX package's
// astype(bfloat16) does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 2;                  // time samples per thread
constexpr int kTile = kThreads * kPerThread;   // time samples per block
constexpr int kDirs = 8;                       // directions per block
constexpr int kChan = 32;                      // channels per staged tile
constexpr int kMaxTaps = 16;

struct DasParams {
  const float* win;     // [K, C, T+S], time stride 1
  long long ldk, ldc;   // window and channel strides (elements)
  const int* shift;     // [D, C]
  const float* w;       // [D, C, taps]
  float* out;           // [K, D, T]
  int D, C, T, S, taps, bf16;
};

__device__ __forceinline__ float maybe_bf16(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

__global__ void __launch_bounds__(kThreads) das_beam_kernel(const DasParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lds = kTile + p.S;                  // staged columns per channel
  float* s_win = reinterpret_cast<float*>(smem);                 // [kChan, lds]
  float* s_w = s_win + kChan * lds;                              // [kDirs, kChan, taps]
  int* s_sh = reinterpret_cast<int*>(s_w + kDirs * kChan * p.taps);  // [kDirs, kChan]

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kDirs, k = blockIdx.y, t0 = blockIdx.z * kTile;
  const int n_t = min(kTile, p.T - t0);
  const int width = n_t + p.S - 1;              // columns this tile reads
  const int max_shift = p.S - p.taps;
  const float* win = p.win + (size_t)k * p.ldk + t0;

  float acc[kDirs][kPerThread];
#pragma unroll
  for (int d = 0; d < kDirs; ++d)
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) acc[d][i] = 0.0f;

  for (int c0 = 0; c0 < p.C; c0 += kChan) {
    const int nc = min(kChan, p.C - c0);
    __syncthreads();                            // the previous tile is consumed
    for (int i = tid; i < nc * width; i += kThreads) {
      const int c = i / width, col = i - c * width;
      s_win[c * lds + col] = maybe_bf16(win[(size_t)(c0 + c) * p.ldc + col], p.bf16);
    }
    // Directions past D and channels past C get zero weight.
    for (int i = tid; i < kDirs * kChan; i += kThreads) {
      const int d = i / kChan, c = i - d * kChan;
      const bool in = d0 + d < p.D && c < nc;
      const size_t src = (size_t)(d0 + d) * p.C + c0 + c;
      // Clamped into the window: a split from delay_split_np is in range.
      s_sh[i] = in ? min(max(p.shift[src], 0), max_shift) : 0;
      for (int j = 0; j < p.taps; ++j)
        s_w[i * p.taps + j] = in ? maybe_bf16(p.w[src * p.taps + j], p.bf16) : 0.0f;
    }
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const float* row = s_win + c * lds + tid;
#pragma unroll
      for (int d = 0; d < kDirs; ++d) {
        const int sh = s_sh[d * kChan + c];
        const float* wc = s_w + (d * kChan + c) * p.taps;
        for (int j = 0; j < p.taps; ++j) {
          const float wj = wc[j];
#pragma unroll
          for (int i = 0; i < kPerThread; ++i)
            acc[d][i] = fmaf(wj, row[sh + j + i * kThreads], acc[d][i]);
        }
      }
    }
  }
#pragma unroll
  for (int d = 0; d < kDirs; ++d) {
    if (d0 + d >= p.D) continue;
    float* o = p.out + ((size_t)k * p.D + d0 + d) * p.T + t0;
#pragma unroll
    for (int i = 0; i < kPerThread; ++i)
      if (tid + i * kThreads < n_t) o[tid + i * kThreads] = acc[d][i];
  }
}

}  // namespace

extern "C" const char* das_beam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// beam [K, D, T] f32 of K windows (f32, time stride 1, window stride ldk
// and channel stride ldc in elements), shift [D, C] int32 in [0, S - taps]
// and tap weights [D, C, taps] f32; bf16 != 0 rounds the window values and
// the weights to bf16 before the product.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int das_beam_launch(const float* win, long long ldk, long long ldc,
                               const int* shift, const float* w, float* out,
                               int K, int D, int C, int T, int S, int taps,
                               int bf16, void* stream) {
  if (K < 1 || D < 1 || C < 1 || T < 1 || taps < 1 || taps > kMaxTaps ||
      S < taps)
    return (int)cudaErrorInvalidValue;
  DasParams p;
  p.win = win;
  p.ldk = ldk;
  p.ldc = ldc;
  p.shift = shift;
  p.w = w;
  p.out = out;
  p.D = D;
  p.C = C;
  p.T = T;
  p.S = S;
  p.taps = taps;
  p.bf16 = bf16;
  const size_t smem = (size_t)kChan * (kTile + S) * sizeof(float) +
                      (size_t)kDirs * kChan * taps * sizeof(float) +
                      (size_t)kDirs * kChan * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      das_beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((D + kDirs - 1) / kDirs, K, (T + kTile - 1) / kTile);
  das_beam_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
