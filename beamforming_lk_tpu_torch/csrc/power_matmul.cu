// The power stage of the separable-FFT heatmap as one CUDA kernel.
//
// Replaces beamforming_lk_tpu/ops/fft_das.py::power_matmul_pallas (kernel
// _pow_kernel):
//     powers[r] = sum_t (sum_f a_re[r,f] * pc[f,t] + a_im[r,f] * ps[f,t])^2
// for the steered beam spectra a_re/a_im [R, F] (f32 or bf16) against the
// two halves of the bandpass-folded restricted inverse DFT pc/ps [F, Tp]
// (f32, rounded to a_re's type here).  The [R, Tp] beam never reaches
// device memory.  The plain PyTorch twin is
// ops/fft_das.py::power_matmul_reference; the launch plan is
// ops/fft_das.py::power_matmul_plan, which the launcher checks.
//
// Both paths read the contraction as one product of K = 2F: [a_re | a_im]
// by [pc ; ps], zero-padded to a multiple of 16, then square and sum each
// row's Tp = 256 columns in registers.
//
// bf16 (what bounds it): at R = 16 384 rows the product is 2.8 GFLOP on
// 10.9 MB of inputs, ~250 flops a byte, under the card's ridge (~295), so
// bytes bind (3.3 us).  Design: the contraction on the tensor cores
// (wgmma m64n128k16, bf16 in, f32 accumulate, both operands in shared
// memory), a thread block cluster of two CTAs, each owning 128 of the 256
// columns and persistent over 64-row tiles:
//   - each CTA keeps its half of B resident in shared memory, rounded from
//     f32 once per launch (__float2bfloat16_rn, as .to(torch.bfloat16));
//   - a tile's rows are not 16-byte aligned one by one (322 B), but 8 rows
//     are one 16-byte aligned span (2576 B).  A loader warp copies each
//     plane's quarter-tile span (16 rows) with one 1-D bulk copy
//     (cp.async.bulk, completion on an mbarrier; the ragged tail with plain
//     loads) into a ring of 5 raw slots, and asks L2 for the tile after
//     next;
//   - 8 producer warps repack the raw rows into the operand layout of
//     wgmma (re at k 0..F-1, im at k plane_k..plane_k+F-1, plane_k = F
//     rounded up to 8, zero elsewhere), into one of two A tiles, while the
//     MMA warpgroup runs the other;
//   - the MMA warpgroup squares and sums its accumulators per row, a fixed
//     shuffle order over the 4 lanes of a row; an exchange warp adds the
//     two CTAs' half-sums in rank order (CTA 0's + CTA 1's) through
//     distributed shared memory and mbarriers, off the MMA warps' path.
//     No atomics: a run is reproducible.
// Each CTA loads its own copy of a tile: the partner's read is an L2 hit,
// so device memory is read once.  What limits it on the H100
// (perf_swarm.py ablate3): the 21 wgmma of a tile take ~2 us, about a
// third of the tensor cores' rate, and the producers' loads and repack
// about as long; launch, cluster barriers and B's staging add ~7 us.

// f32 (what bounds it): 2.7 GFLOP at R = 16 384 on the CUDA cores (no
// TF32 in any form: the f32 path matches the reference's full-precision
// product), 40.5 us at 67 TFLOP/s, so operations bind.  Design: a
// register-tiled product, one CTA of 8 warps per 64 rows x all 256
// columns; k-tiles of 16 double-buffered with cp.async (A transposed to
// [k][row] with 4-byte copies, B as [k][col] with 16-byte copies, zero
// fill past R and K), each thread 8 rows x 8 columns, read as two float4
// broadcasts of A and two float4 of B per k: 4 shared loads for 64 FMAs.
// Products and sums are fmaf in k order (re then im) per output.
//
// Numerics: bf16 products are exact in f32 and the tensor cores add them
// in their own order; f32 sums in k order.  Either way the powers differ
// from the twin's only by summation order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;   // f32 path
constexpr int kRows = 64;         // rows per tile, both paths
constexpr int kTp = 256;          // columns
constexpr int kCluster = 2;       // bf16: CTAs per cluster
constexpr int kCols = kTp / kCluster;  // bf16: columns per CTA
constexpr int kKTile = 16;        // f32: k per staged tile
constexpr int kAPitch = kRows + 4;  // f32: floats per staged A k-row
constexpr size_t kMaxSmem = 232448;

// ---------------------------------------------------------------- helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// ------------------------------------------------------------- bf16 path

constexpr int kQuarter = kRows / 4;   // rows per raw slot (a quarter-tile)
constexpr int kSlots = 5;             // raw slots in the ring
// Warps 0-3: the MMA warpgroup; 4-11: the producers (repack); 12: the
// exchange of half-sums between the cluster's CTAs; 13: the loader.
constexpr int kMmaWarps = 4, kProdWarps = 8;
constexpr int kXWarp = kMmaWarps + kProdWarps, kLoadWarp = kXWarp + 1;
constexpr int kBf16Threads = 32 * (kLoadWarp + 1);
constexpr int kProdThreads = 32 * kProdWarps;
// Named barriers (0 is __syncthreads): per A tile b a "full" (producers
// arrive, the MMA warpgroup waits) and an "empty" (the reverse) barrier;
// per half-sum slot p the same pair between the MMA warpgroup and the
// exchange warp; B staged, among every warp but the loader.
constexpr int kBarFull = 1, kBarEmpty = 3, kBarXFull = 5, kBarXEmpty = 7, kBarStaged = 9;
constexpr int kTileCount = 32 * (kMmaWarps + kProdWarps);
constexpr int kXCount = 32 * (kMmaWarps + 1);

// Shared-memory layout of the bf16 kernel for F (bytes unless named).  B
// and the two A tiles are K-major in wgmma's 32-byte swizzle: a k-step of
// 16 values of all rows is one block, 8-row atoms of 32 bytes a row, and
// in rows 4-7 of an atom the two 16-byte halves trade places.
struct Bf16Layout {
  int plane_k;         // k where the im plane starts: F rounded up to 8
  int k_pad;           // K = 2 plane_k rounded up to 16
  size_t plane_bytes;  // one plane's raw quarter-tile span, 16-byte padded
  size_t b_off, a_off, raw_off, own_off, half_off, bar_off, total;
};

__host__ __device__ inline Bf16Layout bf16_layout(int F) {
  Bf16Layout L;
  L.plane_k = (F + 7) / 8 * 8;
  L.k_pad = (2 * L.plane_k + 15) / 16 * 16;
  L.plane_bytes = ((size_t)kQuarter * F * 2 + 15) / 16 * 16;
  L.b_off = 0;
  L.a_off = L.b_off + (size_t)kCols * L.k_pad * 2;
  L.raw_off = L.a_off + (size_t)2 * kRows * L.k_pad * 2;  // 2 A tiles
  // The repack reads up to 16 bytes past a plane's span: into the next
  // plane or slot, or into the half-sums that follow the ring.
  L.own_off = L.raw_off + (size_t)kSlots * 2 * L.plane_bytes;
  L.half_off = L.own_off + (size_t)2 * kRows * 4;  // this CTA's: [slot][row]
  L.bar_off = L.half_off + (size_t)2 * kRows * 4;  // rank 1's, in rank 0
  L.total = L.bar_off + (4 + 2 * kSlots) * 8;      // mbarriers
  return L;
}

// Element offset of (r, k) in a swizzled operand of `rows` rows.
__device__ __forceinline__ int swz_offset(int r, int k, int rows) {
  return (k >> 4) * rows * 16 + (r >> 3) * 128 + (r & 7) * 16 +
         ((((k >> 3) & 1) ^ ((r >> 2) & 1)) << 3) + (k & 7);
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Make this thread's shared-memory writes visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Arrive on the mbarrier at `bar` in CTA `rank` of the cluster, releasing
// this thread's earlier writes (to any CTA's shared memory) at cluster scope.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(bar)), "r"(rank));
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
      : "memory");
}

// Wait for phase `parity` of a local mbarrier to complete (acquiring at
// cluster scope).  A wait that never ends traps, so a lost arrival fails
// the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == (1u << 22)) __trap();
  }
}

// One 1-D bulk copy of `bytes` (a multiple of 16) from global to shared
// memory, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// wgmma descriptor of a K-major operand in the 32-byte swizzle at p: 256
// bytes between 8-row atoms.
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

// d (64 x 128 f32 over the warpgroup) = a (64 x 16) * b (16 x 128) + (acc ? d : 0).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// Ask L2 to fetch the two planes' spans of rows [row0, row0 + nrows)
// (whole 16-byte units), ahead of their copy into shared memory.
__device__ __forceinline__ void prefetch_tile(const __nv_bfloat16* a_re,
                                              const __nv_bfloat16* a_im,
                                              int row0, int nrows, int F) {
  const uint32_t bytes = (uint32_t)(nrows * F * 2) & ~15u;
  if (bytes == 0) return;
#pragma unroll
  for (int p = 0; p < 2; ++p)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                     (p ? a_im : a_re) + (size_t)row0 * F),
                 "r"(bytes)
                 : "memory");
}

// Raw slot -> rows [r0, r0 + kQuarter) of an A tile: row r's plane p at k
// p * plane_k + f.  A half-warp takes one plane (the planes' spans are 8
// banks apart at F = 161), a lane one row (a half-warp's 16 rows fall on
// distinct banks: 161 elements is 80.5 words), a 16-byte chunk of 8 k a
// step; the 8 values start at any element, so 5 aligned words are read
// and shifted.  Rows past nrows and k past F within a plane are written as
// zero.  `pw` counts the producer warps.
__device__ __forceinline__ void repack_quarter(const unsigned char* slot,
                                               const Bf16Layout& L,
                                               __nv_bfloat16* s_a, int r0,
                                               int nrows, int F, int pw,
                                               int lane) {
  const int chunks = L.plane_k / 8;
  const int r = lane & (kQuarter - 1), plane = lane >> 4;
  const uint32_t* words =
      reinterpret_cast<const uint32_t*>(slot + plane * L.plane_bytes);
#pragma unroll 2
  for (int c = pw; c < chunks; c += kProdWarps) {
    uint32_t x[5] = {0u, 0u, 0u, 0u, 0u};
    if (r < nrows) {
      const int s = r * F + 8 * c;
      const uint32_t* w = words + (s >> 1);
      const uint32_t shift = (s & 1) << 4;
#pragma unroll
      for (int i = 0; i < 5; ++i) x[i] = w[i];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = __funnelshift_r(x[i], x[i + 1], shift);
      const int valid = F - 8 * c;
      if (valid < 8) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          x[i] &= (2 * i < valid ? 0x0000ffffu : 0u) |
                  (2 * i + 1 < valid ? 0xffff0000u : 0u);
      }
    }
    *reinterpret_cast<uint4*>(s_a + swz_offset(r0 + r, plane * L.plane_k + 8 * c, kRows)) =
        make_uint4(x[0], x[1], x[2], x[3]);
  }
}

constexpr int kStagers = kBf16Threads - 32;  // every warp but the loader

// B while L2 fetches the first tiles: element (n, p * plane_k + f) of s_b
// = bf16(plane p of B [f][col0 + n]), zero past F.  A job is one column's
// 8 f: 8 loads (a warp's are 128 contiguous bytes each), one 16-byte
// store.  Past both planes (when 2 plane_k is not a multiple of 16) B and
// the A tiles are zero: the producers never write there.  `tid` counts
// the kStagers threads.
__device__ __forceinline__ void stage_b(const float* pc, const float* ps,
                                        const Bf16Layout& L, __nv_bfloat16* s_b,
                                        __nv_bfloat16* s_a, int col0, int F, int tid) {
  const int chunks = L.plane_k / 8;
#pragma unroll 2
  for (int j = tid; j < 2 * chunks * kCols; j += kStagers) {
    const int n = j & (kCols - 1), pcn = j / kCols;
    const int plane = pcn >= chunks ? 1 : 0, c = pcn - plane * chunks;
    const float* src = (plane ? ps : pc) + col0 + n;
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int f = 8 * c + e;
      v[e] = f < F ? __ldg(src + (size_t)f * kTp) : 0.0f;
    }
    *reinterpret_cast<uint4*>(s_b + swz_offset(n, plane * L.plane_k + 8 * c, kCols)) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
  const int pad_chunks = L.k_pad / 8 - 2 * chunks;
  const size_t tile_elems = (size_t)kRows * L.k_pad;
  for (int j = tid; j < kCols * pad_chunks; j += kStagers)
    *reinterpret_cast<uint4*>(
        s_b + swz_offset(j & (kCols - 1), 8 * (2 * chunks + j / kCols), kCols)) =
        make_uint4(0u, 0u, 0u, 0u);
  for (int j = tid; j < 2 * kRows * pad_chunks; j += kStagers)
    *reinterpret_cast<uint4*>(s_a + (j & kRows) / kRows * tile_elems +
                              swz_offset(j & (kRows - 1),
                                         8 * (2 * chunks + j / (2 * kRows)), kRows)) =
        make_uint4(0u, 0u, 0u, 0u);
}

// The MMA warpgroup runs the products and the square-sums of a tile; the
// loader keeps the raw slots filled; the producers repack quarter-tiles
// into the other A tile meanwhile; the exchange warp adds the two CTAs'
// halves.
__global__ void __launch_bounds__(kBf16Threads, 1)
    power_bf16_kernel(const __nv_bfloat16* __restrict__ a_re,
                      const __nv_bfloat16* __restrict__ a_im,
                      const float* __restrict__ pc, const float* __restrict__ ps,
                      float* __restrict__ out, int R, int F) {
  extern __shared__ __align__(1024) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Bf16Layout L = bf16_layout(F);
  __nv_bfloat16* s_b = reinterpret_cast<__nv_bfloat16*>(smem + L.b_off);
  __nv_bfloat16* s_a = reinterpret_cast<__nv_bfloat16*>(smem + L.a_off);  // [2] tiles
  unsigned char* raw = smem + L.raw_off;                        // [kSlots][2 planes]
  float* s_own = reinterpret_cast<float*>(smem + L.own_off);    // [2][kRows]
  float* s_half = reinterpret_cast<float*>(smem + L.half_off);  // [2][kRows], rank 0
  uint64_t* full_h = reinterpret_cast<uint64_t*>(smem + L.bar_off);  // [2], rank 0 waits
  uint64_t* empty_h = full_h + 2;                                     // [2], rank 1 waits
  uint64_t* landed = empty_h + 2;        // [kSlots]: a slot's copies are in
  uint64_t* freed = landed + kSlots;     // [kSlots]: a slot is repacked
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = (int)cluster.block_rank();
  const int n_clusters = gridDim.x / kCluster;
  const int n_tiles = (R + kRows - 1) / kRows;
  const int col0 = rank * kCols;
  const int tile0 = blockIdx.x / kCluster;
  const int my_tiles = tile0 < n_tiles ? (n_tiles - 1 - tile0) / n_clusters + 1 : 0;
  const size_t tile_elems = (size_t)kRows * L.k_pad;
  const size_t slot_bytes = 2 * L.plane_bytes;

  if (tid == 0) {
    for (int t = tile0; t < min(n_tiles, tile0 + 2 * n_clusters); t += n_clusters)
      prefetch_tile(a_re, a_im, t * kRows, min(kRows, R - t * kRows), F);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      mbar_init(full_h + p, 32);
      mbar_init(empty_h + p, 32);
    }
    for (int s = 0; s < kSlots; ++s) {
      mbar_init(landed + s, 1);
      mbar_init(freed + s, kProdThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the mbarriers are set
  // Every CTA of the cluster is running and its mbarriers are set once this
  // barrier completes; only the exchange warp waits for it before its
  // loop, the others at the end.
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  if (warp != kLoadWarp) {  // the loader starts at once; the others stage B
    stage_b(pc, ps, L, s_b, s_a, col0, F, tid);
    fence_async_shared();
    bar_sync(kBarStaged, kStagers);
  }

  int i = 0;
  if (warp == kLoadWarp) {
    // Quarter u of this CTA's tiles into slot u mod kSlots, once the
    // producers have freed it: one bulk copy a plane (whole 16-byte
    // units), the tail of a ragged last quarter with plain loads.
    if (lane == 0) {
      int s = 0, round = 0;
#pragma unroll 1
      for (int u = 0; u < 4 * my_tiles; ++u) {
        const int tile = tile0 + (u >> 2) * n_clusters;
        const int row0 = tile * kRows + (u & 3) * kQuarter;
        const int nrows = max(0, min(kQuarter, R - row0));
        if ((u & 3) == 0 && tile + 2 * n_clusters < n_tiles) {
          const int after = tile + 2 * n_clusters;
          prefetch_tile(a_re, a_im, after * kRows, min(kRows, R - after * kRows), F);
        }
        if (round > 0) mbar_wait(freed + s, (round - 1) & 1);
        const uint32_t nb = nrows * F * 2, bulk = nb & ~15u;
        unsigned char* dst = raw + s * slot_bytes;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const unsigned short* src = reinterpret_cast<const unsigned short*>(
              (p ? a_im : a_re) + (size_t)row0 * F);
          for (uint32_t e = bulk / 2; e < nb / 2; ++e)
            reinterpret_cast<unsigned short*>(dst + p * L.plane_bytes)[e] = src[e];
        }
        mbar_expect(landed + s, 2 * bulk);
        if (bulk)
#pragma unroll
          for (int p = 0; p < 2; ++p)
            bulk_copy(dst + p * L.plane_bytes, (p ? a_im : a_re) + (size_t)row0 * F,
                      bulk, landed + s);
        if (++s == kSlots) {
          s = 0;
          ++round;
        }
      }
    }
    __syncwarp();
  } else if (warp >= kMmaWarps && warp < kXWarp) {
    const int pw = warp - kMmaWarps;
    int s = 0, round = 0, b = 0;
#pragma unroll 1
    for (int tile = tile0; tile < n_tiles; ++i, tile += n_clusters) {
      if (i >= 2) bar_sync(kBarEmpty + b, kTileCount);  // tile i-2 consumed
#pragma unroll 1
      for (int q = 0; q < 4; ++q) {
        const int r0 = tile * kRows + q * kQuarter;
        mbar_wait(landed + s, round & 1);
        repack_quarter(raw + s * slot_bytes, L, s_a + b * tile_elems, q * kQuarter,
                       max(0, min(kQuarter, R - r0)), F, pw, lane);
        mbar_arrive(freed + s);
        if (++s == kSlots) {
          s = 0;
          ++round;
        }
      }
      fence_async_shared();
      bar_arrive(kBarFull + b, kTileCount);  // A tile b holds tile i
      b ^= 1;
    }
  } else if (warp < kMmaWarps) {
    const int g = lane >> 2, t = lane & 3;  // accumulator row, column pair
    const uint64_t b_desc = wgmma_desc(s_b);
    const int row = warp * 16 + g;          // rows row and row + 8 of the tile
    int b = 0;
#pragma unroll 1
    for (int tile = tile0; tile < n_tiles; ++i, tile += n_clusters) {
      const uint64_t a_desc = wgmma_desc(s_a + b * tile_elems);
      bar_sync(kBarFull + b, kTileCount);
      float acc[64];
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      // A k-step is one swizzled block: kRows * 32 bytes of A, kCols * 32 of B.
      const int steps = L.k_pad / 16;
#pragma unroll 1
      for (int ks = 0; ks < steps; ++ks)
        wgmma_m64n128k16(acc, a_desc + ks * (kRows * 32 >> 4),
                         b_desc + ks * (kCols * 32 >> 4), 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      bar_arrive(kBarEmpty + b, kTileCount);  // A tile b may be refilled
      b ^= 1;

      // Square-sum: a thread's rows g and g + 8 of the warp's 16 over its
      // columns, then over the 4 lanes of a row; the exchange warp adds the
      // two CTAs' halves (rank 0's + rank 1's).
      float lo = 0.0f, hi = 0.0f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        lo = fmaf(acc[4 * j], acc[4 * j], lo);
        lo = fmaf(acc[4 * j + 1], acc[4 * j + 1], lo);
        hi = fmaf(acc[4 * j + 2], acc[4 * j + 2], hi);
        hi = fmaf(acc[4 * j + 3], acc[4 * j + 3], hi);
      }
      lo += __shfl_xor_sync(0xffffffffu, lo, 1);
      hi += __shfl_xor_sync(0xffffffffu, hi, 1);
      lo += __shfl_xor_sync(0xffffffffu, lo, 2);
      hi += __shfl_xor_sync(0xffffffffu, hi, 2);
      const int par = i & 1;
      if (i >= 2) bar_sync(kBarXEmpty + par, kXCount);  // tile i-2's halves read
      if (t == 0) {
        s_own[par * kRows + row] = lo;
        s_own[par * kRows + row + 8] = hi;
      }
      bar_arrive(kBarXFull + par, kXCount);
    }
  } else {
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
    float* half0 = cluster.map_shared_rank(s_half, 0);
#pragma unroll 1
    for (int tile = tile0; tile < n_tiles; ++i, tile += n_clusters) {
      const int par = i & 1;
      bar_sync(kBarXFull + par, kXCount);
      const float h0 = s_own[par * kRows + lane], h1 = s_own[par * kRows + lane + 32];
      bar_arrive(kBarXEmpty + par, kXCount);
      if (rank == 0) {
        mbar_wait(full_h + par, (i >> 1) & 1);  // rank 1's half of tile i is in
        const float v0 = h0 + s_half[par * kRows + lane];
        const float v1 = h1 + s_half[par * kRows + lane + 32];
        mbar_arrive_remote(empty_h + par, 1);   // slot par read
        const int r = tile * kRows + lane;
        if (r < R) out[r] = v0;
        if (r + 32 < R) out[r + 32] = v1;
      } else {
        if (i >= 2) mbar_wait(empty_h + par, ((i >> 1) + 1) & 1);  // tile i-2's read
        half0[par * kRows + lane] = h0;
        half0[par * kRows + lane + 32] = h1;
        mbar_arrive_remote(full_h + par, 0);
      }
    }
  }
  if (warp != kXWarp) asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
  cluster.sync();  // no CTA exits while the other may still reach its memory
}

// -------------------------------------------------------------- f32 path

constexpr size_t kF32Smem =
    (size_t)(2 * kKTile * kAPitch + 2 * kKTile * kTp + 4 * kRows) * 4;

// Stage k-tile kt: A [k][row] (4-byte copies, lanes along k of one row),
// B [k][col] (16-byte copies); zero past R and past K = 2F.
__device__ __forceinline__ void stage_f32(const float* a_re, const float* a_im,
                                          const float* pc, const float* ps,
                                          float* s_a, float* s_b, int kt,
                                          int row0, int R, int F, int tid) {
  const int K = 2 * F;
  const int kk = tid & (kKTile - 1), k = kt * kKTile + kk;
  const bool k_in = k < K;
  const float* col = k < F ? a_re + k : a_im + (k - F);
#pragma unroll
  for (int i = 0; i < kRows / (kThreads / kKTile); ++i) {
    const int r = (tid >> 4) + i * (kThreads / kKTile);
    const bool in = k_in && row0 + r < R;
    cp_async4(s_a + kk * kAPitch + r, in ? col + (size_t)(row0 + r) * F : a_re, in);
  }
#pragma unroll
  for (int i = 0; i < kKTile * kTp / 4 / kThreads; ++i) {
    const int kb = (tid >> 6) + i * (kThreads / 64), c4 = tid & 63;
    const int kr = kt * kKTile + kb;
    const bool in = kr < K;
    const float* src = (kr < F ? pc + (size_t)kr * kTp : ps + (size_t)(kr - F) * kTp);
    cp_async16(s_b + kb * kTp + 4 * c4, in ? src + 4 * c4 : pc, in);
  }
}

// acc[i][j] += A[k][row i] * B[k][col j] for the first kn k of a tile.
template <bool kFull>
__device__ __forceinline__ void product_f32(const float* s_a, const float* s_b,
                                            int ar, int bc, int kn,
                                            float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < (kFull ? kKTile : kn); ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(s_a + k * kAPitch + ar);
    const float4 a1 = *reinterpret_cast<const float4*>(s_a + k * kAPitch + ar + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(s_b + k * kTp + bc);
    const float4 b1 = *reinterpret_cast<const float4*>(s_b + k * kTp + bc + 32);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    power_f32_kernel(const float* __restrict__ a_re,
                     const float* __restrict__ a_im, const float* __restrict__ pc,
                     const float* __restrict__ ps, float* __restrict__ out,
                     int R, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_a = reinterpret_cast<float*>(smem);     // [2][kKTile][kAPitch]
  float* s_b = s_a + 2 * kKTile * kAPitch;         // [2][kKTile][kTp]
  float* s_part = s_b + 2 * kKTile * kTp;          // [4][kRows]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kRows;
  const int K = 2 * F, n_kt = (K + kKTile - 1) / kKTile;
  // 2 x 4 warps of 32 rows x 64 columns; a lane 8 rows x 8 columns (two
  // quads 32 apart), lanes 4 x 8 over a warp's tile.
  const int wm = warp & 1, wn = warp >> 1, lr = lane >> 3, lc = lane & 7;
  const int ar = wm * 32 + lr * 8, bc = wn * 64 + lc * 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  stage_f32(a_re, a_im, pc, ps, s_a, s_b, 0, row0, R, F, tid);
  cp_async_commit();
#pragma unroll 1
  for (int kt = 0; kt < n_kt; ++kt) {
    const int nb = (kt + 1) & 1;
    if (kt + 1 < n_kt)
      stage_f32(a_re, a_im, pc, ps, s_a + nb * kKTile * kAPitch,
                s_b + nb * kKTile * kTp, kt + 1, row0, R, F, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* a = s_a + (kt & 1) * kKTile * kAPitch;
    const float* b = s_b + (kt & 1) * kKTile * kTp;
    const int kn = min(kKTile, K - kt * kKTile);
    if (kn == kKTile)
      product_f32<true>(a, b, ar, bc, kn, acc);
    else
      product_f32<false>(a, b, ar, bc, kn, acc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s = fmaf(acc[i][j], acc[i][j], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    s += __shfl_xor_sync(0xffffffffu, s, 4);
    if (lc == 0) s_part[wn * kRows + ar + i] = s;
  }
  __syncthreads();
  if (tid < kRows && row0 + tid < R) {
    float v = s_part[tid];
#pragma unroll
    for (int w = 1; w < 4; ++w) v += s_part[w * kRows + tid];
    out[row0 + tid] = v;
  }
}

// Set once per process: both kernels may take up to 227 KB.
std::once_flag g_once;
cudaError_t g_setup_error = cudaSuccess;

void set_up() {
  g_setup_error = cudaFuncSetAttribute(
      power_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (g_setup_error == cudaSuccess)
    g_setup_error = cudaFuncSetAttribute(
        power_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" const char* power_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// powers [R] f32 of a_re, a_im [R, F] (bf16 when is_bf16, else f32) and
// pc, ps [F, Tp] f32, every pointer 16-byte aligned, on `stream`.  plan[6]
// is the launch plan {grid, threads, cluster, tile rows, padded K, shared
// bytes} (ops/fft_das.py::power_matmul_plan); a plan that is not the
// kernel's, a shape it does not take or a misaligned pointer returns
// cudaErrorInvalidValue.  Returns cudaGetLastError() (0 on success).
extern "C" int power_matmul_launch(const void* a_re, const void* a_im,
                                   const float* pc, const float* ps, float* out,
                                   int R, int F, int Tp, int is_bf16,
                                   const int* plan, void* stream) {
  if (R < 1 || F < 1 || Tp != kTp || !aligned16(a_re) || !aligned16(a_im) ||
      !aligned16(pc) || !aligned16(ps))
    return (int)cudaErrorInvalidValue;
  const int tiles = (R + kRows - 1) / kRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (plan[1] != (is_bf16 ? kBf16Threads : kThreads) || plan[3] != kRows)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const Bf16Layout L = bf16_layout(F);
    if (plan[2] != kCluster || plan[0] % kCluster || plan[0] < kCluster ||
        plan[0] / kCluster > tiles || plan[4] != L.k_pad ||
        (size_t)plan[5] != L.total || L.total > kMaxSmem)
      return (int)cudaErrorInvalidValue;
    std::call_once(g_once, set_up);
    if (g_setup_error != cudaSuccess) return (int)g_setup_error;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(plan[0]);
    cfg.blockDim = dim3(kBf16Threads);
    cfg.dynamicSmemBytes = L.total;
    cfg.stream = s;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, power_bf16_kernel, static_cast<const __nv_bfloat16*>(a_re),
        static_cast<const __nv_bfloat16*>(a_im), pc, ps, out, R, F);
    if (e != cudaSuccess) return (int)e;
  } else {
    if (plan[0] != tiles || plan[2] != 1 ||
        plan[4] != (2 * F + kKTile - 1) / kKTile * kKTile ||
        (size_t)plan[5] != kF32Smem)
      return (int)cudaErrorInvalidValue;
    std::call_once(g_once, set_up);
    if (g_setup_error != cudaSuccess) return (int)g_setup_error;
    power_f32_kernel<<<tiles, kThreads, kF32Smem, s>>>(
        static_cast<const float*>(a_re), static_cast<const float*>(a_im), pc, ps,
        out, R, F);
  }
  return (int)cudaGetLastError();
}
