// The power stage of the separable-FFT heatmap as one CUDA kernel.
//
// Replaces beamforming_lk_tpu/ops/fft_das.py::power_matmul_pallas (kernel
// _pow_kernel):
//     powers[r] = sum_t (sum_f a_re[r,f] * pc[f,t] + a_im[r,f] * ps[f,t])^2
// for the steered beam spectra a_re/a_im [R, F] against the two halves of
// the bandpass-folded restricted inverse DFT pc/ps [F, Tp].  The [R, Tp]
// beam never reaches device memory.  The plain PyTorch twin is
// ops/fft_das.py::power_matmul_reference.
//
// What bounds it on an H100: at the replay shapes (R = 16 384 or 32 768,
// F = 161, Tp = 256) it does 2*2*R*F*Tp flops (2.7 or 5.4 GFLOP) on
// 2*R*F inputs (10.5 or 21 MB in f32), ~250 flops a byte, so it is bound
// by arithmetic; this first version runs that arithmetic as f32 FMAs on the
// CUDA cores, not on the tensor cores.
//
// Design: one thread block of 256 threads per tile of 64 rows and all Tp
// columns (in passes of 256).  The F axis runs in tiles of 16: the A tiles
// (re, im) and the B tiles (cos, sin) are staged in shared memory as f32,
// zero past F and past the last row.  Each thread holds an 8 x 8 register
// tile of the beam (8 rows shared by its warp, 8 columns 32 apart, so the
// B reads of a warp are contiguous), squares it in the epilogue and sums
// its columns; a warp shuffle sums the row over the warp and lane 0 writes
// it.  Rows past R are not written (no padding of R).
//
// Later work: the contraction on tensor cores (mma.sync or wgmma, bf16
// inputs with f32 accumulation; TF32 is refused for the f32 path), B
// staged once per block with TMA, and a persistent grid.
//
// Numerics: bf16 inputs are widened to f32 exactly; products and sums are
// f32 (no TF32), accumulated in F order per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;          // rows per block
constexpr int kCols = 256;         // columns per pass
constexpr int kF = 16;             // F per shared-memory tile
constexpr int kRowsPerThread = 8;  // rows of a thread (shared by its warp)
constexpr int kColsPerThread = 8;  // columns of a thread, 32 apart

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    power_matmul_kernel(const T* __restrict__ a_re, const T* __restrict__ a_im,
                        const T* __restrict__ pc, const T* __restrict__ ps,
                        float* __restrict__ out, int R, int F, int Tp) {
  __shared__ float s_are[kRows][kF + 1];
  __shared__ float s_aim[kRows][kF + 1];
  __shared__ float s_pc[kF][kCols];
  __shared__ float s_ps[kF][kCols];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int my_row0 = warp * kRowsPerThread;   // within the block's tile
  float row_sum[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) row_sum[i] = 0.0f;

  for (int col0 = 0; col0 < Tp; col0 += kCols) {
    float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.0f;

    for (int f0 = 0; f0 < F; f0 += kF) {
      // Stage A [64 rows x 16 f] and B [16 f x 256 cols], zero outside.
      for (int i = tid; i < kRows * kF; i += kThreads) {
        const int r = i / kF, f = i % kF;
        const int gr = row0 + r, gf = f0 + f;
        const bool in = gr < R && gf < F;
        const size_t idx = (size_t)gr * F + gf;
        s_are[r][f] = in ? widen(a_re[idx]) : 0.0f;
        s_aim[r][f] = in ? widen(a_im[idx]) : 0.0f;
      }
      for (int i = tid; i < kF * kCols; i += kThreads) {
        const int f = i / kCols, c = i % kCols;
        const int gf = f0 + f, gc = col0 + c;
        const bool in = gf < F && gc < Tp;
        const size_t idx = (size_t)gf * Tp + gc;
        s_pc[f][c] = in ? widen(pc[idx]) : 0.0f;
        s_ps[f][c] = in ? widen(ps[idx]) : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int f = 0; f < kF; ++f) {
        float ar[kRowsPerThread], ai[kRowsPerThread];
        float bc[kColsPerThread], bs[kColsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          ar[i] = s_are[my_row0 + i][f];   // one address per warp: broadcast
          ai[i] = s_aim[my_row0 + i][f];
        }
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) {
          bc[j] = s_pc[f][lane + 32 * j];
          bs[j] = s_ps[f][lane + 32 * j];
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j)
            acc[i][j] = fmaf(ai[i], bs[j], fmaf(ar[i], bc[j], acc[i][j]));
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        row_sum[i] = fmaf(acc[i][j], acc[i][j], row_sum[i]);
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    float v = row_sum[i];
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    const int gr = row0 + my_row0 + i;
    if (lane == 0 && gr < R) out[gr] = v;
  }
}

}  // namespace

extern "C" const char* power_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// powers [R] f32 of a_re, a_im [R, F] and pc, ps [F, Tp], all of one dtype
// (bf16 when is_bf16, else f32), on `stream`.  Returns cudaGetLastError()
// (0 on success).
extern "C" int power_matmul_launch(const void* a_re, const void* a_im,
                                   const void* pc, const void* ps, float* out,
                                   int R, int F, int Tp, int is_bf16,
                                   void* stream) {
  if (R < 1 || F < 1 || Tp < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((R + kRows - 1) / kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using T = __nv_bfloat16;
    power_matmul_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(a_re), static_cast<const T*>(a_im),
        static_cast<const T*>(pc), static_cast<const T*>(ps), out, R, F, Tp);
  } else {
    power_matmul_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(a_re), static_cast<const float*>(a_im),
        static_cast<const float*>(pc), static_cast<const float*>(ps), out, R,
        F, Tp);
  }
  return (int)cudaGetLastError();
}
