// The per-block swarm update of the acoustic tracker as CUDA kernels.
//
// swarm_chain_kernel replaces beamforming_lk_tpu/ops/pallas_tracker.py::
// swarm_chain_pallas (kernel _swarm_kernel, block update
// _make_swarm_block_update): n_iter iterations of [n_sub chained 4-probe
// monopulse sub-steps + merge + seeker jump + promote], then the publish
// prune (seeker mean, reference power, sidelobe gate) and the f32 MISO
// audio beam at the listener's direction.
//
// swarm_chunk_kernel replaces swarm_chunk_pallas (kernel
// _swarm_chunk_kernel): K consecutive blocks of that update in one launch.
// Before block k it applies the seeker reset of the reset table; after it,
// it writes block k's state, mean and beam, and carries the published
// trackers into block k+1's target rows.  Both kernels call the same
// __device__ block_update over the particle rows in shared memory, as the
// TPU kernels share _make_swarm_block_update, so block k of a chunk equals
// k+1 calls of the single-block kernel.
//
// monopulse_chain_kernel replaces monopulse_chain_pallas (kernel
// _chain_kernel): n_sub chained sub-steps with a per-sub-step row mask and
// no iteration boundary (the unfused tracker and MISO steps run those in
// PyTorch).  Its sub-step computes what block_update's monopulse_substep
// computes, in the same order (see "The monopulse chain" below).  The
// plain PyTorch twins are ops/cuda_tracker.py::swarm_chain_reference,
// swarm_chunk_reference and monopulse_chain_reference.
//
// What bounds them on an H100: each sub-step's probe directions depend on
// the previous sub-step's powers, so the update is a chain of about 12
// dependent phases a block, latency-bound, not bound by bytes or FLOPs (a
// block's window is 37 KB at 64 mics in bf16, 163 KB at 256 mics).  Inside
// an iteration the rows never meet: a row's sub-step reads only its own
// row and the window, and its active flag changes only at the boundaries.
// So the swarm kernels run as ONE thread block cluster of kClusterMax CTAs
// (kClusterPortable where the card cannot schedule that many), and row r
// belongs to CTA r mod N.  Each CTA holds a full copy of the rows and its
// own copy of the window, runs every sub-step of an iteration on its own
// rows with no cluster barrier, and at the iteration boundary reads the
// six fields the sub-steps write (theta .. error) of the other CTAs' rows
// through distributed shared memory.  Then every CTA runs the same
// deterministic boundary on identical inputs, so every copy stays equal;
// the MISO beam's samples are split over the CTAs and rank 0 writes the
// rows.  Inside a CTA a probe beam's channel sum is split over the warps
// left idle when there are fewer probes than warps; the partial beams are
// summed in a fixed warp order, so results do not depend on timing.
//
// The monopulse chain has no iteration boundary, so its rows never meet
// inside a launch: it runs as a grid of P CTAs, CTA r owning row r for all
// n_sub sub-steps, with no barrier between CTAs.  A CTA whose row is
// inactive in every sub-step copies the row out and exits.  Inside a CTA
// the row's 4 probes run at once on 4 warps each, and a probe's n_out =
// T - 2 beam samples are split over its warps by TIME, never by channel:
// warp k of a probe owns the 64-sample segments k, k + 4, ... (2 samples a
// lane, 32 apart), each sample summed over all channels then taps as one
// warp of the single-CTA kernel summed it.  Each probe's 4 warps build its
// stencil once (a quarter of the channels each), the beams meet in shared
// memory, and one warp per probe squares and sums them in the lane order
// of monopulse_substep (lane l sums samples l + 32 i in i order, then
// warp_sum), so the chain gives monopulse_substep's bits with one warp per
// probe.  The window is staged whole in each CTA with cp.async where it
// fits beside the scratch (64 mics f32, bf16 at 64 and 256 mics); the f32
// 256-mic window (325 KB) is read from L2 through L1 in place: K1's f32
// window in L2 cost 9% over bf16 in shared memory, and splitting a row's
// samples over a cluster would add a cluster barrier and a distributed-
// shared-memory gather to each of the chain's dependent sub-steps.  The
// launch plan (grid, threads, staged window, shared bytes) is
// ops/cuda_tracker.py::monopulse_chain_plan, checked here against
// make_chain_layout.
//
// Why it gathers: the TPU kernel multiplies a dense one-hot stencil
// [4P, span*C] with an s-major window because Mosaic has no gathers.  Here
// each probe beam is gathered straight from the compact window,
//     beam[t] = sum_c sum_j w_j(c) * bp[c, shift(c) + j + t],
// which is taps/span of the dense work (2/32 at 64 mics), and rows that are
// inactive in a sub-step are not computed at all: they keep their values,
// exactly as in the masked computation.  Lanes run over time samples; the
// iteration boundaries run in warp 0 with lanes over particle rows.  The
// chunk kernel stages one block's window at a time (the TPU kernel holds
// all K in VMEM; two 256-mic windows do not fit in 227 KB) and, where two
// fit, copies block k+1's window with cp.async while block k runs.
//
// Later work: multicast the window to the cluster with TMA instead of one
// copy per CTA, split the f32 256-mic window's channels over a CTA pair,
// run the contraction on tensor cores over a banded stencil, and capture
// the per-block host ops of the live path in a CUDA graph.
//
// Numerics: the probe weights are rounded to the window's dtype before the
// product and every sum is f32 (as w.astype(win.dtype) with an f32 dot);
// the beam contraction uses explicit fused multiply-adds, the row
// arithmetic none (the library is built with -fmad=false, so it rounds as
// the twins' tensor ops do); sinf/cosf/sqrtf/floorf without fast math; the
// merge tests compare cos(angle) > cos(closeness) as the TPU kernel does.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTaps = 16;
constexpr int kPerLane = 8;                 // beam samples per lane per pass
constexpr int kTile = 32 * kPerLane;
constexpr size_t kMaxSmem = 232448;         // 227 KB a block can use on sm_90
constexpr int kClusterMax = 16;             // CTAs of a swarm launch
constexpr int kClusterPortable = 8;         // where kClusterMax cannot run
// The monopulse chain: warps per probe, beam samples per warp segment.
constexpr int kChainProbeWarps = kWarps / 4;
constexpr int kChainSeg = 64;
constexpr int kChainPerLane = kChainSeg / 32;
constexpr float kPiF = (float)M_PI;
constexpr float kPiHalfF = (float)(M_PI / 2.0);
constexpr float kTwoPiF = (float)(2.0 * M_PI);

// Rows of the packed per-particle operand (ops/cuda_tracker.py ROW_FIELDS).
enum Row {
  TH, PH, GT, GP, RAD, ERR, TRK, START, RATE, SPREAD,
  FAM_T, FAM_S, FAM_M, TGT_TH, TGT_PH, TGT_VA, NROWS
};
constexpr int kStateRows = 8;
// The fields a sub-step writes (theta .. error), and the monopulse chain's
// operand rows: those six, rate, spread.
constexpr int kChainState = 6;
constexpr int kChainRows = 8;

// Launch operands.  Per-block operands are stacked on a leading block axis
// of n_blocks (1 for the single-block kernel).
struct Params {
  const float* xyz;         // [4, C]
  const void* win_bp;       // [K, C, span+T-2] f32 or bf16
  const float* win_raw;     // [K, C, span+T]
  const float* rows_in;     // [NROWS, P] rows entering block 0 (chain: [8, P])
  const float* jumps;       // [K, 2, n_iter, P]
  const float* resets;      // [K, 3, P] (flag, theta, phi); chunk kernel only
  const float* active;      // [n_sub, P]; monopulse chain only
  const float* references;  // [K]
  const float* stamp;       // [] the promote stamp on the card; K1 only
  float* out_rows;          // [K, kStateRows, P] (chain: [6, P])
  float* out_mean;          // [K]
  float* out_beam;          // [K, T]
  long long block_index0;   // global index of block 0; K2 only
  int n_blocks;
  int C, P, T, span, taps, n_iter, n_sub, refine, n_trackers;
  int quadrant, fir, fir_phases;
  int n_win;                // windows staged in shared memory: 0, 1 or 2
  float theta_limit, sin_tl, cos_tl, inv_div, cos_closeness;
  float error_threshold, min_power_fraction;
  float cos_b[4], sin_b[4], blackman[kMaxTaps];
};

// Block k's slices of the stacked operands.
struct Block {
  const void* win_bp;
  const float* win_raw;
  const float* jumps;
  float reference, block_index;
  float* out_rows;
  float* out_mean;
  float* out_beam;
};

template <typename WT>
__device__ Block block_at(const Params& p, int k) {
  const size_t ldw = p.span + p.T - 2, ldr = p.span + p.T;
  Block b;
  b.win_bp = static_cast<const WT*>(p.win_bp) + (size_t)k * p.C * ldw;
  b.win_raw = p.win_raw + (size_t)k * p.C * ldr;
  b.jumps = p.jumps + (size_t)k * 2 * p.n_iter * p.P;
  b.reference = p.references[k];
  b.block_index = (float)(p.block_index0 + k);
  b.out_rows = p.out_rows + (size_t)k * kStateRows * p.P;
  b.out_mean = p.out_mean + k;
  b.out_beam = p.out_beam + (size_t)k * p.T;
  return b;
}

struct Layout {
  size_t win, win_bytes, w, sh, part, rows, pow, act, flags, list, misc, total;
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Dynamic shared memory: [n_win windows] [per-warp stencil weights]
// [per-warp shifts] [per-warp partial beams] [particle rows] [probe
// powers] [active flags] [merge / capture-zone flags] [active row list]
// [scalars].
__host__ __device__ inline Layout make_layout(int C, int P, int T, int span,
                                              int taps, int elem, int n_win) {
  Layout L;
  size_t off = 0;
  L.win = off;
  L.win_bytes = align16((size_t)C * (span + T - 2) * elem);
  off += n_win * L.win_bytes;
  L.w = off;
  off += align16((size_t)kWarps * C * taps * sizeof(float));
  L.sh = off;
  off += align16((size_t)kWarps * C * sizeof(int));
  L.part = off;
  off += align16((size_t)kWarps * kTile * sizeof(float));
  L.rows = off;
  off += align16((size_t)NROWS * P * sizeof(float));
  L.pow = off;
  off += align16((size_t)4 * P * sizeof(float));
  L.act = off;
  off += align16((size_t)P * sizeof(int));
  L.flags = off;
  off += align16((size_t)2 * P * sizeof(int));
  L.list = off;
  off += align16((size_t)(P + 1) * sizeof(int));
  L.misc = off;
  off += align16(4 * sizeof(float));
  L.total = off;
  return L;
}

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float round_as(float w, const float*) { return w; }
__device__ __forceinline__ float round_as(float w, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(w));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ int warp_min_int(int v) {
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Steering direction of probe b around (theta, phi): the ring point at
// inclination `spread` rotated by Rz(phi) Ry(rt) with the FoV-edge back-off,
// pulled to the theta limit at the same azimuth when it falls outside.
__device__ void probe_dir(const Params& p, float theta, float phi,
                          float spread, int b, float* ux, float* uy,
                          float* uz) {
  const bool near = theta + spread > kPiHalfF;
  const float rt = near ? theta - spread : theta;
  const float c_t = cosf(rt), s_t = sinf(rt);
  const float c_p = cosf(phi), s_p = sinf(phi);
  const float sin_sp = sinf(spread), cos_sp = cosf(spread);
  const float bx = sin_sp * p.cos_b[b];
  const float by = sin_sp * p.sin_b[b];
  const float vx = c_t * bx + s_t * cos_sp;
  const float vz = -s_t * bx + c_t * cos_sp;
  const float wx = c_p * vx - s_p * by;
  const float wy = s_p * vx + c_p * by;
  if (vz < p.cos_tl) {
    const float r = fmaxf(sqrtf(wx * wx + wy * wy), 1e-12f);
    *ux = p.sin_tl * wx / r;
    *uy = -(p.sin_tl * wy / r);
    *uz = p.cos_tl;
  } else {
    *ux = wx;
    *uy = -wy;
    *uz = vz;
  }
}

// Warp-cooperative stencil of direction u on channels [c0, c1):
// min-subtracted delays (the min over ALL channels, masked ones included),
// split at shift = (span - taps) - floor(tau), weighted [frac, 1-frac] or
// by the closed-form windowed-sinc row, times the channel mask; written to
// this warp's scratch at the channels' own offsets.
template <typename WT>
__device__ void warp_stencil(const Params& p, float ux, float uy, float uz,
                             bool round_w, int c0, int c1, float* sw,
                             int* ssh, int lane) {
  const int C = p.C, taps = p.taps, base = p.span - p.taps;
  const float* px = p.xyz;
  const float* py = px + C;
  const float* pz = py + C;
  const float* mask = pz + C;
  float tmin = INFINITY;
  for (int c = lane; c < C; c += 32)
    tmin = fminf(tmin, ux * px[c] + uy * py[c] + uz * pz[c]);
  tmin = warp_min(tmin);
  for (int c = c0 + lane; c < c1; c += 32) {
    float tau = ux * px[c] + uy * py[c] + uz * pz[c];
    tau = fminf(fmaxf(tau - tmin, 0.0f), (float)base);
    const float whole = floorf(tau);
    const float frac = tau - whole;
    ssh[c] = base - (int)whole;
    const float m = mask[c];
    float* wc = sw + c * taps;
    if (!p.fir) {
      wc[0] = frac * m;
      wc[1] = (1.0f - frac) * m;
    } else {
      // sin(pi (t - d)) = -(-1)^t sin(pi d): one sinf per channel.
      const float fq = rintf(frac * (float)(p.fir_phases - 1)) /
                       (float)(p.fir_phases - 1);
      const float d = 4.0f - fq;  // the bank's centre tap, delay.py
      const float sin_pd = sinf(kPiF * d);
      float hs[kMaxTaps];
      for (int t = 0; t < taps; ++t) {
        const float x = kPiF * ((float)t - d);
        const float sign = (t & 1) ? 1.0f : -1.0f;
        const float s = fabsf(x) < 1e-4f ? 1.0f - x * x * (1.0f / 6.0f)
                                         : (sign * sin_pd) / x;
        hs[t] = s * p.blackman[t];
      }
      float hsum = hs[0];
      for (int t = 1; t < taps; ++t) hsum = hsum + hs[t];
      for (int t = 0; t < taps; ++t) wc[t] = hs[t] / hsum * m;
    }
    if (round_w)
      for (int t = 0; t < taps; ++t) wc[t] = round_as(wc[t], (const WT*)nullptr);
  }
  __syncwarp();
}

// One warp's part of a probe beam: samples t0 + lane + 32 i (i < kPerLane)
// summed over channels [c0, c1) into acc, by fused multiply-adds.  Samples
// at or past n_out re-read sample n_out - 1 (so every read stays in the
// window and the loop carries no bound test); the caller drops them.
// TAPS > 0 fixes the tap count at compile time, 0 reads it from `taps`.
template <int TAPS, typename WT>
__device__ __forceinline__ void warp_beam_part(
    const WT* win, int ldw, int c0, int c1, int taps, int t0, int n_out,
    const float* sw, const int* ssh, int lane, float* acc) {
  const int nt = TAPS > 0 ? TAPS : taps;
  int off[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    off[i] = min(t0 + lane + 32 * i, n_out - 1);
    acc[i] = 0.0f;
  }
#pragma unroll 2
  for (int c = c0; c < c1; ++c) {
    const WT* rp = win + (size_t)c * ldw + ssh[c];
    const float* wc = sw + c * nt;
    for (int j = 0; j < nt; ++j) {
      const float w = wc[j];
#pragma unroll
      for (int i = 0; i < kPerLane; ++i)
        acc[i] = __fmaf_rn(w, load_f(rp + off[i] + j), acc[i]);
    }
  }
}

// Iteration boundary, run by warp 0 (lanes over rows): merge close
// trackers (oldest / lowest index survives), jump seekers out of the
// previous block's published capture zones, promote the best converged
// seeker to every free tracker, and the mean valid-seeker power.
__device__ void iteration_boundary(const Params& p, const Block& b,
                                   float* rows, int* flags, float* misc,
                                   int it, int lane) {
  const int P = p.P, nt = p.n_trackers;
  float* th = rows + TH * P;
  float* ph = rows + PH * P;
  float* rad = rows + RAD * P;
  float* err = rows + ERR * P;
  float* trk = rows + TRK * P;
  float* start = rows + START * P;
  const float* ft = rows + FAM_T * P;
  const float* fs = rows + FAM_S * P;
  const float* tgt_th = rows + TGT_TH * P;
  const float* tgt_ph = rows + TGT_PH * P;
  const float* tgt_va = rows + TGT_VA * P;
  int* stop = flags;
  int* too_close = flags + P;

  float cnt = 0.0f;  // pre-merge tracker count gates promotion
  for (int r = lane; r < P; r += 32) cnt += trk[r] > 0.5f ? 1.0f : 0.0f;
  const float n_tracking = warp_sum(cnt);

  for (int r = lane; r < P; r += 32) {
    const float cos_t = cosf(th[r]), sin_t = sinf(th[r]), phi = ph[r];
    const bool trk_r = trk[r] > 0.5f, is_t = ft[r] > 0.5f;
    int s = 0, tc = 0;
    for (int n = 0; n < nt; ++n) {
      const float cos_ang =
          cos_t * cosf(th[n]) + sin_t * sinf(th[n]) * cosf(phi - ph[n]);
      const bool close = cos_ang > p.cos_closeness && trk_r &&
                         trk[n] > 0.5f && r != n && is_t;
      const bool older =
          start[r] > start[n] || (start[r] == start[n] && r > n);
      if (close && older) s = 1;
      const float cos_tg = cos_t * cosf(tgt_th[n]) +
                           sin_t * sinf(tgt_th[n]) * cosf(phi - tgt_ph[n]);
      if (cos_tg > p.cos_closeness && tgt_va[n] > 0.5f) tc = 1;
    }
    stop[r] = s;
    too_close[r] = tc && fs[r] > 0.5f;
  }
  __syncwarp();

  const float* jt = b.jumps + (size_t)it * P;
  const float* jp = b.jumps + (size_t)(p.n_iter + it) * P;
  for (int r = lane; r < P; r += 32) {
    if (stop[r]) trk[r] = 0.0f;
    if (too_close[r]) {
      th[r] = fminf(fmaxf(th[r] + jt[r], 0.0f), p.theta_limit);
      const float raw = ph[r] + jp[r];
      ph[r] = raw - floorf(raw / kTwoPiF) * kTwoPiF;
    }
  }
  __syncwarp();

  float maxv = -INFINITY, better = 0.0f, n_valid = 0.0f, sum_valid = 0.0f;
  for (int r = lane; r < P; r += 32) {
    const bool valid = fs[r] > 0.5f && !too_close[r];
    const bool conv = valid && err[r] < p.error_threshold;
    maxv = fmaxf(maxv, conv ? rad[r] : -3.0e38f);
    if (conv && rad[r] > 0.0f) better = 1.0f;
    if (valid) {
      n_valid += 1.0f;
      sum_valid += rad[r];
    }
  }
  maxv = warp_max(maxv);
  better = warp_max(better);
  n_valid = warp_sum(n_valid);
  sum_valid = warp_sum(sum_valid);
  int best = 1 << 30;  // first index of the maximum
  for (int r = lane; r < P; r += 32) {
    const bool conv =
        fs[r] > 0.5f && !too_close[r] && err[r] < p.error_threshold;
    if (conv && rad[r] >= maxv) best = min(best, r);
  }
  best = warp_min_int(best);
  const float th_b = best < P ? th[best] : 0.0f;
  const float ph_b = best < P ? ph[best] : 0.0f;
  __syncwarp();
  if (better > 0.5f && n_tracking < (float)nt) {
    for (int r = lane; r < P; r += 32) {
      if (!(trk[r] > 0.5f) && ft[r] > 0.5f) {
        th[r] = th_b;
        ph[r] = ph_b;
        start[r] = b.block_index;
        trk[r] = 1.0f;
      }
    }
  }
  if (lane == 0) misc[0] = sum_valid / fmaxf(n_valid, 1.0f);
  __syncwarp();
}

// Publish boundary, run by warp 0: prune weak or diverged trackers, then
// the sidelobe gate against the strongest tracked power.
__device__ void publish_prune(const Params& p, const Block& b, float* rows,
                              const float* misc, int lane) {
  const int P = p.P;
  const float* rad = rows + RAD * P;
  const float* err = rows + ERR * P;
  float* trk = rows + TRK * P;
  const float mean = misc[0], ref = b.reference;
  for (int r = lane; r < P; r += 32)
    if (rad[r] < mean || rad[r] < ref || err[r] > p.error_threshold)
      trk[r] = 0.0f;
  if (p.min_power_fraction > 0.0f) {
    float strongest = -INFINITY;
    for (int r = lane; r < P; r += 32)
      strongest = fmaxf(strongest, trk[r] > 0.5f ? rad[r] : 0.0f);
    strongest = warp_max(strongest);
    const float floor_p = p.min_power_fraction * strongest;
    for (int r = lane; r < P; r += 32)
      if (!(rad[r] >= floor_p)) trk[r] = 0.0f;
  }
  __syncwarp();
}

// Shared-memory regions of the dynamic layout.
struct Smem {
  float* rows;
  float* pow4;
  int* act;
  int* flags;
  int* list;
  float* misc;
  float* sw;     // this warp's stencil weights
  int* ssh;      // this warp's shifts
  float* part;   // the partial beams, kTile per warp
  const float* sw0;
  const int* ssh0;
  void* win[2];  // the staged windows (when n_win says so)
};

__device__ Smem carve(const Params& p, const Layout& L, unsigned char* smem,
                      int warp) {
  Smem s;
  s.rows = reinterpret_cast<float*>(smem + L.rows);
  s.pow4 = reinterpret_cast<float*>(smem + L.pow);
  s.act = reinterpret_cast<int*>(smem + L.act);
  s.flags = reinterpret_cast<int*>(smem + L.flags);
  s.list = reinterpret_cast<int*>(smem + L.list);
  s.misc = reinterpret_cast<float*>(smem + L.misc);
  s.sw = reinterpret_cast<float*>(smem + L.w) + (size_t)warp * p.C * p.taps;
  s.ssh = reinterpret_cast<int*>(smem + L.sh) + (size_t)warp * p.C;
  s.part = reinterpret_cast<float*>(smem + L.part);
  s.sw0 = reinterpret_cast<const float*>(smem + L.w);
  s.ssh0 = reinterpret_cast<const int*>(smem + L.sh);
  s.win[0] = smem + L.win;
  s.win[1] = smem + L.win + L.win_bytes;
  return s;
}

// Start copying a window [C, span+T-2] from global to shared memory: one
// cp.async group of 16-byte copies where both ends allow it, else plain
// loads (complete when this returns).  The caller waits for the group
// (__pipeline_wait_prior) and then its barrier publishes the copy.
template <typename WT>
__device__ void stage_window_async(const Params& p, const void* src,
                                   void* dst) {
  const size_t n = (size_t)p.C * (p.span + p.T - 2);
  const size_t bytes = n * sizeof(WT);
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (bytes & 15) == 0) {
    const float4* s4 = static_cast<const float4*>(src);
    float4* d4 = static_cast<float4*>(dst);
    for (size_t i = threadIdx.x; i < bytes / 16; i += kThreads)
      __pipeline_memcpy_async(d4 + i, s4 + i, 16);
  } else {
    const WT* s = static_cast<const WT*>(src);
    WT* d = static_cast<WT*>(dst);
    for (size_t i = threadIdx.x; i < n; i += kThreads) d[i] = s[i];
  }
  __pipeline_commit();
}

// The active-row list of this CTA, built by warp 0: rows r with
// r mod n_cta == rank and is_active(r), in increasing order, into s.list
// (count in s.list[0]) and the flags s.act.  Ends with a barrier.
template <typename F>
__device__ void build_list(const Smem& s, int P, int rank, int n_cta,
                           F is_active) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    int n = 0;
    for (int r0 = 0; r0 < P; r0 += 32) {
      const int r = r0 + lane;
      const bool a = r < P && r % n_cta == rank && is_active(r);
      if (r < P) s.act[r] = a;
      const unsigned m = __ballot_sync(0xffffffffu, a);
      if (a) s.list[1 + n + __popc(m & ((1u << lane) - 1u))] = r;
      n += __popc(m);
    }
    if (lane == 0) s.list[0] = n;
  }
  __syncthreads();
}

// One 4-probe monopulse sub-step of the rows listed in s.list (count in
// s.list[0], flags in s.act), then the discriminants and the
// theta-then-phi step per row.  With fewer probes than warps, each
// probe's channel sum is split over g = kWarps / n_probe consecutive
// warps; their partial beams meet in shared memory and the group's first
// warp sums them in warp order before squaring.  Otherwise one warp sums
// a probe over all channels.  Rows not in the list keep their values.
// Called by every thread after the barrier that publishes the list; ends
// with a barrier.
template <typename WT>
__device__ void monopulse_substep(const Params& p, const WT* win,
                                  const Smem& s) {
  const int C = p.C, P = p.P, T = p.T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldw = p.span + T - 2, n_out = T - 2;
  float* rows = s.rows;
  float* th = rows + TH * P;
  float* ph = rows + PH * P;
  float* gt = rows + GT * P;
  float* gp = rows + GP * P;
  float* rad = rows + RAD * P;
  float* err = rows + ERR * P;
  const float* rate = rows + RATE * P;
  const float* spread = rows + SPREAD * P;

  const int n_probe = 4 * s.list[0];
  const int g = n_probe == 0 || n_probe >= kWarps ? 1 : kWarps / n_probe;
  const int n_group = kWarps / g, grp = warp / g, sub = warp - grp * g;
  const int c0 = sub * C / g, c1 = (sub + 1) * C / g;
  float* part = s.part + warp * kTile;
  for (int q0 = 0; q0 < n_probe; q0 += n_group) {
    const int q = q0 + grp;
    const bool busy = grp < n_group && q < n_probe;
    const int r = busy ? s.list[1 + (q >> 2)] : 0, pb = q & 3;
    if (busy) {
      float ux, uy, uz;
      probe_dir(p, th[r], ph[r], spread[r], pb, &ux, &uy, &uz);
      warp_stencil<WT>(p, ux, uy, uz, true, c0, c1, s.sw, s.ssh, lane);
    }
    float pw = 0.0f;
    for (int t0 = 0; t0 < n_out; t0 += kTile) {
      float acc[kPerLane];
      if (busy) {
        if (p.taps == 2)
          warp_beam_part<2>(win, ldw, c0, c1, 2, t0, n_out, s.sw, s.ssh,
                            lane, acc);
        else
          warp_beam_part<0>(win, ldw, c0, c1, p.taps, t0, n_out, s.sw,
                            s.ssh, lane, acc);
      }
      if (g > 1) {
        if (busy) {
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) part[lane + 32 * i] = acc[i];
        }
        __syncthreads();
        if (busy && sub == 0) {
#pragma unroll
          for (int i = 0; i < kPerLane; ++i) {
            float v = part[lane + 32 * i];
            for (int k = 1; k < g; ++k) v = v + part[k * kTile + lane + 32 * i];
            acc[i] = v;
          }
        }
        __syncthreads();  // the partials are rewritten by the next pass
      }
      if (busy && sub == 0) {
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          if (t0 + lane + 32 * i < n_out) pw = pw + acc[i] * acc[i];
      }
    }
    if (busy && sub == 0) {
      pw = warp_sum(pw);
      if (lane == 0) s.pow4[r * 4 + pb] = pw * p.inv_div;
    }
    __syncwarp();  // the stencil scratch is rewritten by the next probe
  }
  __syncthreads();
  for (int r = tid; r < P; r += kThreads) {
    if (!s.act[r]) continue;
    const float q1 = s.pow4[r * 4], q2 = s.pow4[r * 4 + 1];
    const float q3 = s.pow4[r * 4 + 2], q4 = s.pow4[r * 4 + 3];
    const float total = fmaxf(q1 + q2 + q3 + q4, 1e-30f);
    float g_t, g_p;
    if (p.quadrant) {
      g_t = ((q1 + q2) - (q3 + q4)) / total;
      g_p = ((q1 + q4) - (q2 + q3)) / total;
    } else {
      g_t = (q1 - q3) / fmaxf(fmaxf(q1, q3), 1e-30f);
      g_p = (q2 - q4) / fmaxf(fmaxf(q2, q4), 1e-30f);
    }
    const float theta = th[r], sp = spread[r], k = rate[r];
    const float adj = theta + sp > kPiHalfF ? theta - sp / 2.0f : theta;
    float new_t = adj + k * g_t;
    float new_p = ph[r] + (k * g_p) / sinf(1e-9f + new_t);
    new_t = fminf(fmaxf(new_t, 0.0f), p.theta_limit);
    new_p = new_p - floorf(new_p / kTwoPiF) * kTwoPiF;
    th[r] = new_t;
    ph[r] = new_p;
    gt[r] = g_t;
    gp[r] = g_p;
    rad[r] = total * 0.25f;
    err[r] = fabsf(g_t) + fabsf(g_p);
  }
  __syncthreads();
}

// Bring every CTA's copy of the rows up to date after the sub-steps: each
// row's sub-step fields (theta .. error) come from the CTA that owns it,
// through distributed shared memory.  The first cluster barrier waits for
// every CTA's sub-steps, the second for every read, so no CTA writes its
// rows while another still reads them.
__device__ void gather_rows(const Params& p, const Smem& s,
                            cg::cluster_group& cluster) {
  const int P = p.P;
  const int rank = (int)cluster.block_rank(), n = (int)cluster.num_blocks();
  cluster.sync();
  for (int i = threadIdx.x; i < kChainState * P; i += kThreads) {
    const int owner = (i % P) % n;
    if (owner != rank) s.rows[i] = cluster.map_shared_rank(s.rows, owner)[i];
  }
  cluster.sync();
}

// One block's whole update over the particle rows in shared memory (the
// counterpart of _make_swarm_block_update), on the block's window `win`
// (staged and published by the caller): the iterations, the publish prune,
// the block's state and mean (rank 0) and this CTA's samples of the MISO
// beam.  Called by every thread of every CTA of the cluster; ends with a
// barrier, and every CTA leaves with the same rows.
template <typename WT>
__device__ void block_update(const Params& p, const Block& b, const Smem& s,
                             const WT* win, cg::cluster_group& cluster) {
  const int C = p.C, P = p.P, T = p.T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = (int)cluster.block_rank(), n_cta = (int)cluster.num_blocks();
  float* rows = s.rows;
  float* th = rows + TH * P;
  float* ph = rows + PH * P;
  const float* trk = rows + TRK * P;
  const float* ft = rows + FAM_T * P;
  const float* fs = rows + FAM_S * P;
  const float* fm = rows + FAM_M * P;

  if (tid == 0) s.misc[0] = 0.0f;
  __syncwarp();  // warp 0 reads the mean, even with no iteration
  for (int it = 0; it < p.n_iter; ++it) {
    for (int j = 0; j < p.n_sub; ++j) {
      // Trackers step while tracking, seekers ride sub-step 0, the MISO
      // row while its refine budget lasts; only this CTA's active rows
      // are computed.
      const int slot = it * p.n_sub + j;
      build_list(s, P, rank, n_cta, [&](int r) {
        return (ft[r] > 0.5f && trk[r] > 0.5f) || (j == 0 && fs[r] > 0.5f) ||
               (slot < p.refine && fm[r] > 0.5f);
      });
      monopulse_substep<WT>(p, win, s);
    }
    gather_rows(p, s, cluster);
    if (warp == 0) iteration_boundary(p, b, rows, s.flags, s.misc, it, lane);
    __syncthreads();
  }

  if (warp == 0) {
    publish_prune(p, b, rows, s.misc, lane);
    // MISO beam stencil at the listener row's final direction, in f32.
    float tm = 0.0f, pm = 0.0f;
    for (int r = lane; r < P; r += 32)
      if (fm[r] > 0.5f) {
        tm += th[r];
        pm += ph[r];
      }
    tm = warp_sum(tm);
    pm = warp_sum(pm);
    const float st = sinf(tm), ct = cosf(tm), sp = sinf(pm), cp = cosf(pm);
    warp_stencil<WT>(p, st * cp, -st * sp, ct, false, 0, C, s.sw, s.ssh, lane);
  }
  __syncthreads();
  // This CTA's samples [t_lo, t_hi) of the MISO beam, in passes of at most
  // kThreads samples; each sample's channel sum is split over the
  // kThreads / m threads of a pass and summed in group order.
  const int ldr = p.span + T, per = (T + n_cta - 1) / n_cta;
  const int t_lo = min(T, rank * per), t_hi = min(T, t_lo + per);
  for (int ta = t_lo; ta < t_hi; ta += kThreads) {
    const int m = min(kThreads, t_hi - ta), groups = kThreads / m;
    if (tid < groups * m) {
      const int t = ta + tid % m;
      float acc = 0.0f;
      for (int c = tid / m; c < C; c += groups) {
        const float* rp = b.win_raw + (size_t)c * ldr + s.ssh0[c] + t;
        for (int j = 0; j < p.taps; ++j)
          acc = acc + s.sw0[c * p.taps + j] * rp[j];
      }
      s.part[tid] = acc;
    }
    __syncthreads();
    if (tid < m) {
      float v = s.part[tid];
      for (int k = 1; k < groups; ++k) v = v + s.part[k * m + tid];
      b.out_beam[ta + tid] = v;
    }
    __syncthreads();
  }
  if (rank == 0) {
    for (int i = tid; i < kStateRows * P; i += kThreads) b.out_rows[i] = rows[i];
    if (tid == 0) *b.out_mean = s.misc[0];
  }
  __syncthreads();
}

template <typename WT>
__device__ Smem enter(const Params& p, unsigned char* smem) {
  const Layout L = make_layout(p.C, p.P, p.T, p.span, p.taps,
                               (int)sizeof(WT), p.n_win);
  const Smem s = carve(p, L, smem, threadIdx.x >> 5);
  for (int i = threadIdx.x; i < NROWS * p.P; i += kThreads)
    s.rows[i] = p.rows_in[i];
  return s;  // the caller's next barrier publishes the rows
}

template <typename WT>
__global__ void __launch_bounds__(kThreads, 1)
    swarm_chain_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Smem s = enter<WT>(p, smem);
  Block b = block_at<WT>(p, 0);
  b.block_index = *p.stamp;  // an operand, so that a CUDA graph replays it
  const WT* win = static_cast<const WT*>(b.win_bp);
  if (p.n_win) {
    stage_window_async<WT>(p, b.win_bp, s.win[0]);
    __pipeline_wait_prior(0);
    win = static_cast<const WT*>(s.win[0]);
  }
  __syncthreads();
  block_update<WT>(p, b, s, win, cluster);
  cluster.sync();  // no CTA exits while another may read its rows
}

template <typename WT>
__global__ void __launch_bounds__(kThreads, 1)
    swarm_chunk_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Smem s = enter<WT>(p, smem);
  const int P = p.P;
  float* rows = s.rows;
  if (p.n_win) stage_window_async<WT>(p, block_at<WT>(p, 0).win_bp, s.win[0]);
  for (int k = 0; k < p.n_blocks; ++k) {
    const Block b = block_at<WT>(p, k);
    // Seeker reset from the pre-drawn table (gradient_ascend.cpp:295-299).
    // Every CTA applies it, and the carry below, to its full copy.
    const float* rs = p.resets + (size_t)k * 3 * P;
    for (int r = threadIdx.x; r < P; r += kThreads)
      if (rs[r] > 0.5f && rows[FAM_S * P + r] > 0.5f) {
        rows[TH * P + r] = rs[P + r];
        rows[PH * P + r] = rs[2 * P + r];
      }
    const WT* win = static_cast<const WT*>(b.win_bp);
    if (p.n_win == 2) {
      // Block k+1's window streams into the other buffer while block k
      // runs (that buffer was last read by block k-1).
      if (k + 1 < p.n_blocks) {
        stage_window_async<WT>(p, block_at<WT>(p, k + 1).win_bp,
                               s.win[(k + 1) & 1]);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      win = static_cast<const WT*>(s.win[k & 1]);
    } else if (p.n_win == 1) {
      if (k > 0) stage_window_async<WT>(p, b.win_bp, s.win[0]);
      __pipeline_wait_prior(0);
      win = static_cast<const WT*>(s.win[0]);
    }
    __syncthreads();
    block_update<WT>(p, b, s, win, cluster);
    // The published trackers feed block k+1's seeker avoidance.
    for (int r = threadIdx.x; r < P; r += kThreads) {
      const bool is_t = rows[FAM_T * P + r] > 0.5f;
      rows[TGT_TH * P + r] = is_t ? rows[TH * P + r] : 0.0f;
      rows[TGT_PH * P + r] = is_t ? rows[PH * P + r] : 0.0f;
      rows[TGT_VA * P + r] = rows[TRK * P + r];
    }
  }
  cluster.sync();  // no CTA exits while another may read its rows
}

// The monopulse chain's dynamic shared memory: [the window, when staged]
// [4 probes' stencil weights] [4 probes' shifts] [4 probe beams] [the
// row's 8 fields, 4 probe powers].  ops/cuda_tracker.py::
// monopulse_chain_plan computes the same bytes.
struct ChainLayout {
  size_t win, w, sh, beam, row, total;
};

__host__ __device__ inline ChainLayout make_chain_layout(int C, int T,
                                                         int span, int taps,
                                                         int elem, int n_win) {
  ChainLayout L;
  size_t off = 0;
  L.win = off;
  off += n_win * align16((size_t)C * (span + T - 2) * elem);
  L.w = off;
  off += align16((size_t)4 * C * taps * sizeof(float));
  L.sh = off;
  off += align16((size_t)4 * C * sizeof(int));
  L.beam = off;
  off += align16((size_t)4 * (T - 2) * sizeof(float));
  L.row = off;
  off += align16((size_t)(kChainRows + 4) * sizeof(float));
  L.total = off;
  return L;
}

// One warp's segment of a probe beam: samples t0 + lane + 32 i
// (i < kChainPerLane) summed over all channels, then taps, by fused
// multiply-adds (warp_beam_part's order), written to beam[t] for t < n_out.
template <int TAPS, typename WT>
__device__ __forceinline__ void chain_beam_segment(
    const WT* win, int ldw, int C, int taps, int t0, int n_out,
    const float* sw, const int* ssh, int lane, float* beam) {
  int off[kChainPerLane];
  float acc[kChainPerLane];
#pragma unroll
  for (int i = 0; i < kChainPerLane; ++i) {
    off[i] = min(t0 + lane + 32 * i, n_out - 1);
    acc[i] = 0.0f;
  }
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const WT* rp = win + (size_t)c * ldw + ssh[c];
    if constexpr (TAPS == 2) {
      const float2 w = reinterpret_cast<const float2*>(sw)[c];
#pragma unroll
      for (int i = 0; i < kChainPerLane; ++i) {
        acc[i] = __fmaf_rn(w.x, load_f(rp + off[i]), acc[i]);
        acc[i] = __fmaf_rn(w.y, load_f(rp + off[i] + 1), acc[i]);
      }
    } else {
      const float* wc = sw + c * taps;
      for (int j = 0; j < taps; ++j) {
        const float w = wc[j];
#pragma unroll
        for (int i = 0; i < kChainPerLane; ++i)
          acc[i] = __fmaf_rn(w, load_f(rp + off[i] + j), acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kChainPerLane; ++i)
    if (t0 + lane + 32 * i < n_out) beam[t0 + lane + 32 * i] = acc[i];
}

// The discriminants and the theta-then-phi step of one row (fields theta,
// phi, grad_theta, grad_phi, radius, error, rate, spread) from its 4 probe
// powers: monopulse_substep's row arithmetic.
__device__ void chain_row_step(const Params& p, float* row, const float* pw) {
  const float q1 = pw[0], q2 = pw[1], q3 = pw[2], q4 = pw[3];
  const float total = fmaxf(q1 + q2 + q3 + q4, 1e-30f);
  float g_t, g_p;
  if (p.quadrant) {
    g_t = ((q1 + q2) - (q3 + q4)) / total;
    g_p = ((q1 + q4) - (q2 + q3)) / total;
  } else {
    g_t = (q1 - q3) / fmaxf(fmaxf(q1, q3), 1e-30f);
    g_p = (q2 - q4) / fmaxf(fmaxf(q2, q4), 1e-30f);
  }
  const float theta = row[TH], sp = row[kChainState + 1];
  const float k = row[kChainState];
  const float adj = theta + sp > kPiHalfF ? theta - sp / 2.0f : theta;
  float new_t = adj + k * g_t;
  float new_p = row[PH] + (k * g_p) / sinf(1e-9f + new_t);
  new_t = fminf(fmaxf(new_t, 0.0f), p.theta_limit);
  new_p = new_p - floorf(new_p / kTwoPiF) * kTwoPiF;
  row[TH] = new_t;
  row[PH] = new_p;
  row[GT] = g_t;
  row[GP] = g_p;
  row[RAD] = total * 0.25f;
  row[ERR] = fabsf(g_t) + fabsf(g_p);
}

// n_sub chained sub-steps of the rows (monopulse_chain_pallas, kernel
// _chain_kernel), CTA r on row r: rows_in [8, P] holds theta, phi,
// grad_theta, grad_phi, radius, error, rate, spread; row r steps in
// sub-step j where active[j, r] > 0 and keeps its values otherwise.
// Writes the first six rows after the chain to out_rows [6, P].
template <typename WT>
__global__ void __launch_bounds__(kThreads, 1)
    monopulse_chain_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = p.C, P = p.P, T = p.T, r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bool any = false;
  for (int j = 0; j < p.n_sub; ++j) any |= p.active[(size_t)j * P + r] > 0.0f;
  if (!any) {
    if (tid < kChainState) p.out_rows[(size_t)tid * P + r] = p.rows_in[(size_t)tid * P + r];
    return;
  }
  const ChainLayout L = make_chain_layout(C, T, p.span, p.taps,
                                          (int)sizeof(WT), p.n_win);
  const int q = warp / kChainProbeWarps, sub = warp % kChainProbeWarps;
  float* sw = reinterpret_cast<float*>(smem + L.w) + (size_t)q * C * p.taps;
  int* ssh = reinterpret_cast<int*>(smem + L.sh) + (size_t)q * C;
  float* beams = reinterpret_cast<float*>(smem + L.beam);
  float* row = reinterpret_cast<float*>(smem + L.row);
  float* pw4 = row + kChainRows;
  if (tid < kChainRows) row[tid] = p.rows_in[(size_t)tid * P + r];
  const WT* win = static_cast<const WT*>(p.win_bp);
  if (p.n_win) {
    stage_window_async<WT>(p, p.win_bp, smem + L.win);
    __pipeline_wait_prior(0);
    win = reinterpret_cast<const WT*>(smem + L.win);
  }
  __syncthreads();  // the row and the window
  const int ldw = p.span + T - 2, n_out = T - 2;
  const int c0 = sub * C / kChainProbeWarps, c1 = (sub + 1) * C / kChainProbeWarps;
  for (int j = 0; j < p.n_sub; ++j) {
    if (!(p.active[(size_t)j * P + r] > 0.0f)) continue;
    float ux, uy, uz;
    probe_dir(p, row[TH], row[PH], row[kChainState + 1], q, &ux, &uy, &uz);
    warp_stencil<WT>(p, ux, uy, uz, true, c0, c1, sw, ssh, lane);
    __syncthreads();  // every probe's stencil
    for (int t0 = sub * kChainSeg; t0 < n_out; t0 += kChainProbeWarps * kChainSeg) {
      if (p.taps == 2)
        chain_beam_segment<2>(win, ldw, C, 2, t0, n_out, sw, ssh, lane,
                              beams + q * n_out);
      else
        chain_beam_segment<0>(win, ldw, C, p.taps, t0, n_out, sw, ssh, lane,
                              beams + q * n_out);
    }
    __syncthreads();  // the probe beams
    if (warp < 4) {
      const float* b = beams + warp * n_out;
      float pw = 0.0f;
      for (int t = lane; t < n_out; t += 32) pw = pw + b[t] * b[t];
      pw = warp_sum(pw);
      if (lane == 0) pw4[warp] = pw * p.inv_div;
    }
    __syncthreads();  // the powers
    if (tid == 0) chain_row_step(p, row, pw4);
    __syncthreads();  // the row, and the stencils are free again
  }
  if (tid < kChainState) p.out_rows[(size_t)tid * P + r] = row[tid];
}

enum Kind { kSwarmChain, kSwarmChunk, kMonopulseChain };

using KernelFn = void (*)(const Params);

template <typename WT>
KernelFn kernel_of(Kind kind) {
  return kind == kSwarmChain   ? &swarm_chain_kernel<WT>
         : kind == kSwarmChunk ? &swarm_chunk_kernel<WT>
                               : &monopulse_chain_kernel<WT>;
}

// Set once per process: every kernel may take the whole 227 KB, and the
// swarm kernels run kClusterMax CTAs a cluster where the card can schedule
// such a cluster at that size (a non-portable size above 8), else
// kClusterPortable.  One size for every launch keeps a chunk bitwise equal
// to its single-block launches.
struct Setup {
  std::once_flag once;
  cudaError_t error = cudaSuccess;          // setting the attributes
  cudaError_t cluster_error = cudaSuccess;  // no cluster size schedulable
  int cluster = 0;
};
Setup g_setup;

bool cluster_fits(KernelFn kernel, int n) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(n);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kMaxSmem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) != cudaSuccess) {
    cudaGetLastError();  // an unschedulable size is not a sticky error
    return false;
  }
  return clusters > 0;
}

void set_up() {
  const KernelFn swarm[4] = {
      kernel_of<float>(kSwarmChain), kernel_of<float>(kSwarmChunk),
      kernel_of<__nv_bfloat16>(kSwarmChain),
      kernel_of<__nv_bfloat16>(kSwarmChunk)};
  const KernelFn chain[2] = {kernel_of<float>(kMonopulseChain),
                             kernel_of<__nv_bfloat16>(kMonopulseChain)};
  for (KernelFn kernel : chain) {
    g_setup.error = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (g_setup.error != cudaSuccess) return;
  }
  for (KernelFn kernel : swarm) {
    g_setup.error = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (g_setup.error == cudaSuccess && kClusterMax > 8)
      g_setup.error = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (g_setup.error != cudaSuccess) return;
  }
  for (int n : {kClusterMax, kClusterPortable}) {
    bool all = true;
    for (KernelFn kernel : swarm) all = all && cluster_fits(kernel, n);
    if (all) {
      g_setup.cluster = n;
      return;
    }
  }
  g_setup.cluster_error = cudaErrorLaunchOutOfResources;
}

// The swarm kernels' cluster size; sets *error when a launch cannot go.
int cluster_size(Kind kind, cudaError_t* error) {
  std::call_once(g_setup.once, set_up);
  *error = g_setup.error != cudaSuccess ? g_setup.error
           : kind != kMonopulseChain   ? g_setup.cluster_error
                                       : cudaSuccess;
  return g_setup.cluster;
}

// One launch: the swarm kernels as one cluster of cluster_size() CTAs,
// the monopulse chain as a grid of `grid` CTAs.
template <typename WT>
cudaError_t launch(const Params& p, Kind kind, size_t smem, int grid,
                   cudaStream_t stream) {
  cudaError_t e;
  const int n = cluster_size(kind, &e);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  if (kind != kMonopulseChain) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(n);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  e = cudaLaunchKernelEx(&cfg, kernel_of<WT>(kind), p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Copy the host constants into the operands; false if the dimensions do
// not fit the kernels.
bool set_consts(Params& p, const float* host_consts) {
  if (p.taps < 1 || p.taps > kMaxTaps || (!p.fir && p.taps != 2) || p.C < 1 ||
      p.P < 1 || p.T < 3 || p.n_trackers > p.P || p.n_blocks < 1)
    return false;
  memcpy(p.cos_b, host_consts, sizeof(p.cos_b));
  memcpy(p.sin_b, host_consts + 4, sizeof(p.sin_b));
  memcpy(p.blackman, host_consts + 8, sizeof(p.blackman));
  return true;
}

int launch_blocks(Params& p, int win_bf16, Kind kind, const float* host_consts,
                  void* stream) {
  if (!set_consts(p, host_consts)) return (int)cudaErrorInvalidValue;
  const int elem = win_bf16 ? 2 : 4;
  // As many staged windows as fit: two let the chunk kernel prefetch.
  Layout L;
  for (p.n_win = kind == kSwarmChunk && p.n_blocks > 1 ? 2 : 1; p.n_win >= 0;
       --p.n_win) {
    L = make_layout(p.C, p.P, p.T, p.span, p.taps, elem, p.n_win);
    if (L.total <= kMaxSmem) break;
  }
  if (p.n_win < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(win_bf16 ? launch<__nv_bfloat16>(p, kind, L.total, 1, s)
                        : launch<float>(p, kind, L.total, 1, s));
}

// The monopulse chain on the caller's plan {grid, threads, staged windows,
// shared bytes}, which must be the kernel's: one CTA of kThreads per row,
// and the bytes of make_chain_layout within the 227 KB.
int launch_chain(Params& p, int win_bf16, const int* plan,
                 const float* host_consts, void* stream) {
  if (!set_consts(p, host_consts) || p.n_sub < 1)
    return (int)cudaErrorInvalidValue;
  p.n_win = plan[2];
  const ChainLayout L = make_chain_layout(p.C, p.T, p.span, p.taps,
                                          win_bf16 ? 2 : 4, p.n_win);
  if (plan[0] != p.P || plan[1] != kThreads || (p.n_win != 0 && p.n_win != 1) ||
      (size_t)plan[3] != L.total || L.total > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(win_bf16
                   ? launch<__nv_bfloat16>(p, kMonopulseChain, L.total, p.P, s)
                   : launch<float>(p, kMonopulseChain, L.total, p.P, s));
}

Params make_params(const float* xyz, const void* win_bp, const float* win_raw,
                   const float* rows_in, const float* jumps,
                   const float* references, float* out_rows, float* out_mean,
                   float* out_beam, const int* dims, const float* scalars) {
  Params p;
  memset(&p, 0, sizeof(p));
  p.xyz = xyz;
  p.win_bp = win_bp;
  p.win_raw = win_raw;
  p.rows_in = rows_in;
  p.jumps = jumps;
  p.references = references;
  p.out_rows = out_rows;
  p.out_mean = out_mean;
  p.out_beam = out_beam;
  p.C = dims[0];
  p.P = dims[1];
  p.T = dims[2];
  p.span = dims[3];
  p.taps = dims[4];
  p.n_iter = dims[5];
  p.n_sub = dims[6];
  p.refine = dims[7];
  p.n_trackers = dims[8];
  p.quadrant = dims[9];
  p.fir = dims[10];
  p.fir_phases = dims[11];
  p.theta_limit = scalars[0];
  p.sin_tl = scalars[1];
  p.cos_tl = scalars[2];
  p.inv_div = scalars[3];
  p.cos_closeness = scalars[4];
  p.error_threshold = scalars[5];
  p.min_power_fraction = scalars[6];
  return p;
}

}  // namespace

extern "C" const char* swarm_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The CTAs of every swarm-chain and swarm-chunk launch (one cluster), or
// minus the CUDA error that made no cluster size schedulable.
extern "C" int swarm_cluster_size() {
  cudaError_t e;
  const int n = cluster_size(kSwarmChain, &e);
  return e == cudaSuccess ? n : -(int)e;
}

// The entry points launch on `stream` and return cudaGetLastError() (0 on
// success).  Host-memory operands:
//   dims[12]    C, P, T, span, taps, n_iter, n_sub, refine, n_trackers,
//               quadrant, fir, fir_phases;
//   scalars[7]  theta_limit, sin(theta_limit), cos(theta_limit), 1/divisor,
//               cos(closeness), error_threshold, min_power_fraction;
//   host_consts the probe ring's cos[4], sin[4], then the Blackman window
//               padded to kMaxTaps.
// The window goes to shared memory when it fits beside the scratch, else it
// is read from global memory (L2) in place.

// One block (swarm_chain_pallas): win_bp [C, span+T-2], win_raw [C, span+T],
// jumps [2, n_iter, P], reference [], stamp [] (the block's index as f32,
// the start of a tracker promoted in it); out_rows [8, P], out_mean [],
// out_beam [T].
extern "C" int swarm_chain_launch(
    const float* xyz, const void* win_bp, int win_bf16, const float* win_raw,
    const float* rows_in, const float* jumps, const float* reference,
    const float* stamp, float* out_rows, float* out_mean, float* out_beam,
    const int* dims, const float* scalars, const float* host_consts,
    void* stream) {
  Params p = make_params(xyz, win_bp, win_raw, rows_in, jumps, reference,
                         out_rows, out_mean, out_beam, dims, scalars);
  p.n_blocks = 1;
  p.stamp = stamp;
  return launch_blocks(p, win_bf16, kSwarmChain, host_consts, stream);
}

// K blocks (swarm_chunk_pallas): the same operands stacked on a leading
// axis of n_blocks, plus resets [K, 3, P] (flag, theta, phi; a seeker row
// takes (theta, phi) before block k when the flag is set).
extern "C" int swarm_chunk_launch(
    const float* xyz, const void* wins_bp, int win_bf16, const float* wins_raw,
    const float* rows_in, const float* jumps, const float* resets,
    const float* references, float* out_rows, float* out_mean,
    float* out_beams, int n_blocks, long long block_index0, const int* dims,
    const float* scalars, const float* host_consts, void* stream) {
  Params p = make_params(xyz, wins_bp, wins_raw, rows_in, jumps, references,
                         out_rows, out_mean, out_beams, dims, scalars);
  p.resets = resets;
  p.n_blocks = n_blocks;
  p.block_index0 = block_index0;
  return launch_blocks(p, win_bf16, kSwarmChunk, host_consts, stream);
}

// n_sub chained sub-steps (monopulse_chain_pallas): win_bp [C, span+T-2],
// rows_in [8, P] (theta, phi, grad_theta, grad_phi, radius, error, rate,
// spread), active [n_sub, P]; out_rows [6, P].  dims and scalars as above;
// the fields the chain does not read (n_iter, refine, n_trackers,
// cos(closeness), error_threshold, min_power_fraction) are ignored.
// plan[4] is the launch plan {grid, threads, staged windows, shared bytes}
// (ops/cuda_tracker.py::monopulse_chain_plan); a plan that is not the
// kernel's returns cudaErrorInvalidValue.
extern "C" int monopulse_chain_launch(
    const float* xyz, const void* win_bp, int win_bf16, const float* rows_in,
    const float* active, float* out_rows, const int* plan, const int* dims,
    const float* scalars, const float* host_consts, void* stream) {
  Params p = make_params(xyz, win_bp, nullptr, rows_in, nullptr, nullptr,
                         out_rows, nullptr, nullptr, dims, scalars);
  p.active = active;
  p.n_blocks = 1;
  p.n_trackers = 0;
  return launch_chain(p, win_bf16, plan, host_consts, stream);
}
