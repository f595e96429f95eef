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
// (3 / 12 MB): 4 / 16 us at the f32 peak.  The window values come from
// shared memory, so once each loaded value feeds several FMAs the
// per-(direction, channel) step's shared-memory traffic and instructions
// set the pace: its entry load, the residue switch and its window loads
// (perf_swarm.py ablate times each), not the FMAs.
//
// Design: a thread block of kThreads threads per tile of kDirs directions,
// per window of the stack, per kTile time samples.  Warp w owns direction
// w of the tile; lane l owns its kRun CONSECUTIVE samples 8 l .. 8 l + 7,
// in registers.  For one (direction, channel) a lane reads the pair's
// packed entry once (one broadcast 16-byte load for 2 taps: the weights,
// the shift's padded column and its residue mod 8) and kRun + taps - 1
// window values, which feed kRun x taps FMAs: 9 loads for 16 FMAs with 2
// taps, where one sample per load pair took 1.75 loads an FMA.  A staged
// row keeps window column a at a + a / 8, so the 32 lanes' runs (8 columns
// apart) fall in 32 distinct banks; a run's offsets depend only on the
// shift mod 8, which selects one of 8 unrolled load sequences (the same
// for the whole warp).  A step is a dependent chain (entry load, branch,
// window loads, FMAs); 32 warps of one direction each hide its latency
// from each other, where 8 warps of 4 directions left the SM waiting, and
// the channel loop is unrolled 8 deep.  Channels run in tiles of kChan,
// the window double-buffered: while tile c is summed, tile c + 1's window
// rows stream in with 4-byte cp.async (the ring views' rows have no
// 16-byte alignment) and each thread's entry of tile c + 1 (one a thread:
// kDirs x kChan = kThreads) waits in registers, to be packed once tile c
// is consumed.  With the bf16 flag each thread rounds the values it copied
// once they land, before the barrier that publishes the tile.
//
// Later work: stage the window once per block cluster with TMA, and run
// the taps of several channels as a banded product on the tensor cores.
//
// Numerics: f32 sums (fmaf), in channel order then tap order per output;
// with the bf16 flag the window values and tap weights are rounded to bf16
// (round to nearest even) before the product, as the JAX package's
// astype(bfloat16) does.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <mutex>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 8;                        // consecutive samples per lane
constexpr int kTile = 32 * kRun;               // time samples per block
constexpr int kDirs = kWarps;                 // directions per block, one a warp
constexpr int kChan = 32;                      // channels per staged tile
constexpr int kMaxTaps = 16;
constexpr size_t kMaxSmem = 232448;            // 227 KB a block can use on sm_90

struct DasParams {
  const float* win;     // [K, C, T+S], time stride 1
  long long ldk, ldc;   // window and channel strides (elements)
  const int* shift;     // [D, C]
  const float* w;       // [D, C, taps]
  float* out;           // [K, D, T]
  int D, C, T, S, taps, bf16;
};

// A staged row keeps window column a at padded(a).
__host__ __device__ constexpr int padded(int a) { return a + (a >> 3); }

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Dynamic shared memory: [2 window tiles of kChan rows x ld floats] [the
// tile's kDirs x kChan entries of pstride floats: taps weights, then
// padded(shift) and shift mod 8 as ints].  ops/cuda_das.py::das_beam_plan
// computes the same bytes.
struct DasLayout {
  int ld, pstride;
  size_t win, par, total;
};

__host__ __device__ inline DasLayout das_layout(int S, int taps) {
  DasLayout L;
  L.ld = padded(kTile + S);
  L.pstride = (taps + 5) & ~3;
  L.win = align16((size_t)kChan * L.ld * sizeof(float));
  L.par = (size_t)kDirs * kChan * L.pstride * sizeof(float);
  L.total = 2 * L.win + L.par;
  return L;
}

__device__ __forceinline__ float maybe_bf16(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// Start copying window rows [c0, c0 + nc), columns [0, width) of `win`
// into the staged tile `dst` (row stride ld, padded columns), kRowThreads
// threads a row: one cp.async group.  round_tile then rounds the same
// values, by the same threads.
constexpr int kRowThreads = kThreads / kChan;

__device__ void stage_tile(const DasParams& p, const float* win, int c0,
                           int nc, int width, float* dst, int ld) {
  const int c = threadIdx.x / kRowThreads;
  if (c < nc) {
    const float* src = win + (size_t)(c0 + c) * p.ldc;
    for (int col = threadIdx.x % kRowThreads; col < width; col += kRowThreads)
      __pipeline_memcpy_async(dst + c * ld + padded(col), src + col, 4);
  }
  __pipeline_commit();
}

__device__ void round_tile(int nc, int width, float* dst, int ld) {
  const int c = threadIdx.x / kRowThreads;
  if (c < nc)
    for (int col = threadIdx.x % kRowThreads; col < width; col += kRowThreads) {
      float* v = dst + c * ld + padded(col);
      *v = maybe_bf16(*v, 1);
    }
}

// One entry of a tile: thread i packs entry i (direction i / kChan,
// channel i mod kChan), the tap weights, then the shift as the staged
// row's padded column and its residue mod 8 (what a run's loads need).
// Its raw operands are fetched into registers a tile ahead.  Directions
// past D and channels past C get zero weight; a shift is clamped into the
// window (a split from delay_split_np is in range).  TAPS > 0 fixes the
// tap count at compile time, 0 reads it from p.taps.
static_assert(kDirs * kChan == kThreads, "one entry a thread");

template <int TAPS>
struct RawEntry {
  float w[TAPS > 0 ? TAPS : kMaxTaps];
  int sh;
  bool in;
};

template <int TAPS>
__device__ __forceinline__ RawEntry<TAPS> fetch_entry(const DasParams& p,
                                                      int d0, int c0, int nc) {
  const int d = threadIdx.x / kChan, c = threadIdx.x % kChan;
  const int taps = TAPS > 0 ? TAPS : p.taps;
  RawEntry<TAPS> r;
  r.in = d0 + d < p.D && c < nc;
  const size_t src = (size_t)(d0 + d) * p.C + c0 + c;
  r.sh = r.in ? p.shift[src] : 0;
#pragma unroll
  for (int j = 0; j < taps; ++j) r.w[j] = r.in ? p.w[src * taps + j] : 0.0f;
  return r;
}

template <int TAPS>
__device__ __forceinline__ void store_entry(const DasParams& p,
                                            const RawEntry<TAPS>& r,
                                            float* dst, int pstride) {
  const int taps = TAPS > 0 ? TAPS : p.taps;
  float* e = dst + (size_t)threadIdx.x * pstride;
#pragma unroll
  for (int j = 0; j < taps; ++j) e[j] = maybe_bf16(r.w[j], p.bf16);
  const int sh = r.in ? min(max(r.sh, 0), p.S - taps) : 0;
  e[taps] = __int_as_float(padded(sh));
  e[taps + 1] = __int_as_float(sh & 7);
}

// The NV values of a lane's run whose shift has residue M mod 8: value k
// (column shift + 8 lane + k) sits at base[k + (M + k) / 8], base = row +
// padded(shift) + 9 lane.
template <int NV, int M>
__device__ __forceinline__ void load_run(const float* base, float* v) {
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = base[k + ((M + k) >> 3)];
}

template <int NV>
__device__ __forceinline__ void load_run(const float* base, int m, float* v) {
  switch (m) {
    case 0: load_run<NV, 0>(base, v); break;
    case 1: load_run<NV, 1>(base, v); break;
    case 2: load_run<NV, 2>(base, v); break;
    case 3: load_run<NV, 3>(base, v); break;
    case 4: load_run<NV, 4>(base, v); break;
    case 5: load_run<NV, 5>(base, v); break;
    case 6: load_run<NV, 6>(base, v); break;
    default: load_run<NV, 7>(base, v); break;
  }
}

// This warp's directions over the nc channels of a staged tile, into acc.
// TAPS > 0 fixes the tap count at compile time and reuses each loaded
// value for every tap; 0 reads the count from `taps` and loads each
// product's value.
template <int TAPS>
__device__ __forceinline__ void tile_products(
    const float* s_win, const float* s_par, const DasLayout& L, int nc,
    int taps, int warp, int lane, float (&acc)[kRun]) {
#pragma unroll 8
  for (int c = 0; c < nc; ++c) {
    const float* row = s_win + c * L.ld + 9 * lane;
    const float* e = s_par + (size_t)(warp * kChan + c) * L.pstride;
    if constexpr (TAPS > 0) {
      constexpr int kEntry = (TAPS + 5) & ~3, kValues = kRun + TAPS - 1;
      float ew[kEntry];
#pragma unroll
      for (int f = 0; f < kEntry; f += 4) {
        const float4 e4 = *reinterpret_cast<const float4*>(e + f);
        ew[f] = e4.x;
        ew[f + 1] = e4.y;
        ew[f + 2] = e4.z;
        ew[f + 3] = e4.w;
      }
      float v[kValues];
      load_run<kValues>(row + __float_as_int(ew[TAPS]),
                        __float_as_int(ew[TAPS + 1]), v);
#pragma unroll
      for (int j = 0; j < TAPS; ++j)
#pragma unroll
        for (int i = 0; i < kRun; ++i)
          acc[i] = fmaf(ew[j], v[i + j], acc[i]);
    } else {
      const float* base = row + __float_as_int(e[taps]);
      const int m = __float_as_int(e[taps + 1]);
      for (int j = 0; j < taps; ++j) {
        const float wj = e[j];
#pragma unroll
        for (int i = 0; i < kRun; ++i)
          acc[i] = fmaf(wj, base[i + j + ((m + i + j) >> 3)], acc[i]);
      }
    }
  }
}

template <int TAPS>
__global__ void __launch_bounds__(kThreads, 1)
    das_beam_kernel(const DasParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const DasLayout L = das_layout(p.S, p.taps);
  // Window tile buffer b, and the entries.
  auto s_win = [&](int b) { return reinterpret_cast<float*>(smem + b * L.win); };
  float* s_par = reinterpret_cast<float*>(smem + 2 * L.win);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int d0 = blockIdx.x * kDirs, k = blockIdx.y, t0 = blockIdx.z * kTile;
  const int n_t = min(kTile, p.T - t0);
  const int width = n_t + p.S - 1;              // columns this tile reads
  const float* win = p.win + (size_t)k * p.ldk + t0;
  const int n_tiles = (p.C + kChan - 1) / kChan;

  float acc[kRun];
#pragma unroll
  for (int i = 0; i < kRun; ++i) acc[i] = 0.0f;

  stage_tile(p, win, 0, min(kChan, p.C), width, s_win(0), L.ld);
  RawEntry<TAPS> cur = fetch_entry<TAPS>(p, d0, 0, min(kChan, p.C)), next;
  for (int it = 0; it < n_tiles; ++it) {
    const int c0 = it * kChan, nc = min(kChan, p.C - c0), b = it & 1;
    if (it + 1 < n_tiles) {
      // Tile it + 1's window streams into the other buffer (last read by
      // tile it - 1) and its entries into registers while tile it runs.
      const int nc1 = min(kChan, p.C - c0 - kChan);
      stage_tile(p, win, c0 + kChan, nc1, width, s_win(b ^ 1), L.ld);
      next = fetch_entry<TAPS>(p, d0, c0 + kChan, nc1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    store_entry<TAPS>(p, cur, s_par, L.pstride);  // tile it - 1's are consumed
    if (p.bf16) round_tile(nc, width, s_win(b), L.ld);
    __syncthreads();  // tile it and its entries are staged
    tile_products<TAPS>(s_win(b), s_par, L, nc, p.taps, warp, lane, acc);
    __syncthreads();  // tile it is consumed
    cur = next;
  }

  const int t = kRun * lane, d = d0 + warp;
  if (d < p.D) {
    float* o = p.out + ((size_t)k * p.D + d) * p.T + t0 + t;
    if ((p.T & 3) == 0 && t + kRun <= n_t) {
#pragma unroll
      for (int i = 0; i < kRun; i += 4)
        *reinterpret_cast<float4*>(o + i) =
            make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < kRun; ++i)
        if (t + i < n_t) o[i] = acc[i];
    }
  }
}

using KernelFn = void (*)(const DasParams);

KernelFn kernel_for(int taps) {
  return taps == 2 ? &das_beam_kernel<2>
         : taps == 8 ? &das_beam_kernel<8>
                     : &das_beam_kernel<0>;
}

// Set once per process: every instance may take the whole 227 KB.
std::once_flag g_once;
cudaError_t g_setup_error = cudaSuccess;

void set_up() {
  for (KernelFn kernel : {kernel_for(2), kernel_for(8), kernel_for(0)}) {
    g_setup_error = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (g_setup_error != cudaSuccess) return;
  }
}

}  // namespace

extern "C" const char* das_beam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// beam [K, D, T] f32 of K windows (f32, time stride 1, window stride ldk
// and channel stride ldc in elements), shift [D, C] int32 in [0, S - taps]
// and tap weights [D, C, taps] f32; bf16 != 0 rounds the window values and
// the weights to bf16 before the product.  plan[5] is the launch plan
// {blocks over D, over K, over T, threads, shared bytes}
// (ops/cuda_das.py::das_beam_plan); a plan that is not the kernel's returns
// cudaErrorInvalidValue.  Launches on `stream`; returns cudaGetLastError()
// (0 on success).
extern "C" int das_beam_launch(const float* win, long long ldk, long long ldc,
                               const int* shift, const float* w, float* out,
                               int K, int D, int C, int T, int S, int taps,
                               int bf16, const int* plan, void* stream) {
  if (K < 1 || D < 1 || C < 1 || T < 1 || taps < 1 || taps > kMaxTaps ||
      S < taps)
    return (int)cudaErrorInvalidValue;
  const DasLayout L = das_layout(S, taps);
  const dim3 grid((D + kDirs - 1) / kDirs, K, (T + kTile - 1) / kTile);
  if ((unsigned)plan[0] != grid.x || (unsigned)plan[1] != grid.y ||
      (unsigned)plan[2] != grid.z || plan[3] != kThreads ||
      (size_t)plan[4] != L.total || L.total > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  std::call_once(g_once, set_up);
  if (g_setup_error != cudaSuccess) return (int)g_setup_error;
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
  kernel_for(taps)<<<grid, kThreads, L.total, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
