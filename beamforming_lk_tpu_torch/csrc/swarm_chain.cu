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
// PyTorch).  Its sub-step is block_update's: both call the __device__
// monopulse_substep on a list of active rows.  The plain PyTorch twins are
// ops/cuda_tracker.py::swarm_chain_reference, swarm_chunk_reference and
// monopulse_chain_reference.
//
// What bounds them on an H100: each runs as ONE thread block on one SM, and
// each sub-step's probe directions depend on the previous sub-step's
// powers, so they are latency-bound by that chain, not by bytes or FLOPs (a
// block's window is 37 KB at 64 mics in bf16, 163 KB at 256 mics).  The
// chunk kernel runs K times the single-block chain back to back on that SM,
// so it saves host launches and operand prep, not device time.  The
// monopulse chain is one iteration's sub-steps of the same chain (the
// default profile launches it 10 times a block, plus once for the MISO
// step); at 64 mics the PyTorch boundary ops around it, not its device
// time, bound that profile.
//
// Why it gathers: the TPU kernel multiplies a dense one-hot stencil
// [4P, span*C] with an s-major window because Mosaic has no gathers.  Here
// each probe beam is gathered straight from the compact window,
//     beam[t] = sum_c sum_j w_j(c) * bp[c, shift(c) + j + t],
// which is taps/span of the dense work (2/32 at 64 mics), and rows that are
// inactive in a sub-step are not computed at all: they keep their values,
// exactly as in the masked computation.  One warp owns one probe row at a
// time (lanes over time samples, a shuffle reduction for the power); the
// iteration boundaries run in warp 0 with lanes over particle rows.  The
// chunk kernel stages one block's window at a time (the TPU kernel holds
// all K in VMEM; two 256-mic windows do not fit in 227 KB).
//
// Later work: spread a sub-step's probe rows over several SMs (a cluster
// sharing the window through distributed shared memory), stage the window
// with TMA and overlap block k+1's window load with block k's chain, run
// the contraction on tensor cores over a banded stencil, and capture the
// per-block host ops of the live path in a CUDA graph.
//
// Numerics: the probe weights are rounded to the window's dtype before the
// product and every sum is f32 (as w.astype(win.dtype) with an f32 dot);
// sinf/cosf/sqrtf/floorf without fast math; the merge tests compare
// cos(angle) > cos(closeness) as the TPU kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTaps = 16;
constexpr int kPerLane = 8;                 // beam samples per lane per pass
constexpr int kTile = 32 * kPerLane;
constexpr size_t kMaxSmem = 232448;         // 227 KB a block can use on sm_90
constexpr float kPiF = (float)M_PI;
constexpr float kPiHalfF = (float)(M_PI / 2.0);
constexpr float kTwoPiF = (float)(2.0 * M_PI);

// Rows of the packed per-particle operand (ops/cuda_tracker.py ROW_FIELDS).
enum Row {
  TH, PH, GT, GP, RAD, ERR, TRK, START, RATE, SPREAD,
  FAM_T, FAM_S, FAM_M, TGT_TH, TGT_PH, TGT_VA, NROWS
};
constexpr int kStateRows = 8;
// The monopulse chain's operand rows: the six particle fields, rate, spread.
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
  float* out_rows;          // [K, kStateRows, P] (chain: [6, P])
  float* out_mean;          // [K]
  float* out_beam;          // [K, T]
  long long block_index0;   // global index of block 0
  int n_blocks;
  int C, P, T, span, taps, n_iter, n_sub, refine, n_trackers;
  int quadrant, fir, fir_phases, win_smem;
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
  size_t win, w, sh, rows, pow, act, flags, list, misc, total;
};

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Dynamic shared memory: [window (optional)] [per-warp stencil weights]
// [per-warp shifts] [particle rows] [probe powers] [active flags]
// [merge / capture-zone flags] [active row list] [scalars].
__host__ __device__ inline Layout make_layout(int C, int P, int T, int span,
                                              int taps, int elem,
                                              bool win_smem) {
  Layout L;
  size_t off = 0;
  L.win = off;
  if (win_smem) off += align16((size_t)C * (span + T - 2) * elem);
  L.w = off;
  off += align16((size_t)kWarps * C * taps * sizeof(float));
  L.sh = off;
  off += align16((size_t)kWarps * C * sizeof(int));
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

// Warp-cooperative stencil of direction u: min-subtracted delays over ALL
// channels (masked ones included), split at shift = (span - taps) -
// floor(tau), weighted [frac, 1-frac] or by the closed-form windowed-sinc
// row, times the channel mask; written to this warp's scratch.
template <typename WT>
__device__ void warp_stencil(const Params& p, float ux, float uy, float uz,
                             bool round_w, float* sw, int* ssh, int lane) {
  const int C = p.C, taps = p.taps, base = p.span - p.taps;
  const float* px = p.xyz;
  const float* py = px + C;
  const float* pz = py + C;
  const float* mask = pz + C;
  float tmin = INFINITY;
  for (int c = lane; c < C; c += 32)
    tmin = fminf(tmin, ux * px[c] + uy * py[c] + uz * pz[c]);
  tmin = warp_min(tmin);
  for (int c = lane; c < C; c += 32) {
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

// Power of one probe beam over n_out samples, by one warp: lanes own time
// samples, the weights and shifts come from the warp's scratch.
template <typename WT>
__device__ float warp_probe_power(const WT* win, int ldw, int C, int taps,
                                  int n_out, const float* sw, const int* ssh,
                                  int lane) {
  float pw = 0.0f;
  for (int t0 = 0; t0 < n_out; t0 += kTile) {
    float acc[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) acc[i] = 0.0f;
    for (int c = 0; c < C; ++c) {
      const WT* rp = win + (size_t)c * ldw + ssh[c] + t0 + lane;
      const float* wc = sw + c * taps;
      for (int j = 0; j < taps; ++j) {
        const float w = wc[j];
#pragma unroll
        for (int i = 0; i < kPerLane; ++i)
          if (t0 + lane + 32 * i < n_out)
            acc[i] = acc[i] + w * load_f(rp + j + 32 * i);
      }
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      if (t0 + lane + 32 * i < n_out) pw = pw + acc[i] * acc[i];
  }
  return warp_sum(pw);
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
  float* sw;   // this warp's stencil weights
  int* ssh;    // this warp's shifts
  const float* sw0;
  const int* ssh0;
  void* win;
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
  s.sw0 = reinterpret_cast<const float*>(smem + L.w);
  s.ssh0 = reinterpret_cast<const int*>(smem + L.sh);
  s.win = smem + L.win;
  return s;
}

// The probe window the sub-steps read: staged in shared memory when the
// layout has room for it, else read in place.  The caller's next barrier
// publishes the staged copy.
template <typename WT>
__device__ const WT* stage_window(const Params& p, const void* win_bp,
                                  const Smem& s) {
  const WT* win = static_cast<const WT*>(win_bp);
  if (p.win_smem) {
    WT* s_win = static_cast<WT*>(s.win);
    const size_t n = (size_t)p.C * (p.span + p.T - 2);
    for (size_t i = threadIdx.x; i < n; i += kThreads) s_win[i] = win[i];
    win = s_win;
  }
  return win;
}

// One 4-probe monopulse sub-step of the rows listed in s.list (count in
// s.list[0], flags in s.act): one warp per probe beam gathered from the
// window, then the discriminants and the theta-then-phi step per row.
// Rows not in the list keep their values.  Called by every thread after the
// barrier that publishes the list; ends with a barrier.
template <typename WT>
__device__ void monopulse_substep(const Params& p, const WT* win,
                                  const Smem& s) {
  const int C = p.C, P = p.P, T = p.T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ldw = p.span + T - 2;
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
  for (int q = warp; q < n_probe; q += kWarps) {
    const int r = s.list[1 + (q >> 2)], pb = q & 3;
    float ux, uy, uz;
    probe_dir(p, th[r], ph[r], spread[r], pb, &ux, &uy, &uz);
    warp_stencil<WT>(p, ux, uy, uz, true, s.sw, s.ssh, lane);
    const float pw =
        warp_probe_power(win, ldw, C, p.taps, T - 2, s.sw, s.ssh, lane);
    if (lane == 0) s.pow4[r * 4 + pb] = pw * p.inv_div;
    __syncwarp();  // the scratch is rewritten by the next probe
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

// One block's whole update over the particle rows in shared memory (the
// counterpart of _make_swarm_block_update): stage the block's window, run
// the iterations and the publish prune, write the block's state, mean and
// MISO beam.  Called by every thread; ends with a barrier, so the caller
// may touch the rows right after it.
template <typename WT>
__device__ void block_update(const Params& p, const Block& b, const Smem& s) {
  const int C = p.C, P = p.P, T = p.T;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* rows = s.rows;

  const WT* win = stage_window<WT>(p, b.win_bp, s);
  if (tid == 0) s.misc[0] = 0.0f;
  __syncthreads();

  float* th = rows + TH * P;
  float* ph = rows + PH * P;
  const float* trk = rows + TRK * P;
  const float* ft = rows + FAM_T * P;
  const float* fs = rows + FAM_S * P;
  const float* fm = rows + FAM_M * P;

  for (int it = 0; it < p.n_iter; ++it) {
    for (int j = 0; j < p.n_sub; ++j) {
      // Trackers step while tracking, seekers ride sub-step 0, the MISO
      // row while its refine budget lasts; only active rows are computed.
      const int slot = it * p.n_sub + j;
      if (tid == 0) {
        int n = 0;
        for (int r = 0; r < P; ++r) {
          const bool a = (ft[r] > 0.5f && trk[r] > 0.5f) ||
                         (j == 0 && fs[r] > 0.5f) ||
                         (slot < p.refine && fm[r] > 0.5f);
          s.act[r] = a;
          if (a) s.list[1 + n++] = r;
        }
        s.list[0] = n;
      }
      __syncthreads();
      monopulse_substep<WT>(p, win, s);
    }
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
    warp_stencil<WT>(p, st * cp, -st * sp, ct, false, s.sw, s.ssh, lane);
  }
  __syncthreads();
  const int ldr = p.span + T;
  for (int t = tid; t < T; t += kThreads) {
    float acc = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float* rp = b.win_raw + (size_t)c * ldr + s.ssh0[c] + t;
      for (int j = 0; j < p.taps; ++j)
        acc = acc + s.sw0[c * p.taps + j] * rp[j];
    }
    b.out_beam[t] = acc;
  }
  for (int i = tid; i < kStateRows * P; i += kThreads) b.out_rows[i] = rows[i];
  if (tid == 0) *b.out_mean = s.misc[0];
  __syncthreads();
}

template <typename WT>
__device__ Smem enter(const Params& p, unsigned char* smem) {
  const Layout L = make_layout(p.C, p.P, p.T, p.span, p.taps,
                               (int)sizeof(WT), p.win_smem != 0);
  const Smem s = carve(p, L, smem, threadIdx.x >> 5);
  for (int i = threadIdx.x; i < NROWS * p.P; i += kThreads)
    s.rows[i] = p.rows_in[i];
  return s;  // block_update's first barrier publishes the rows
}

template <typename WT>
__global__ void __launch_bounds__(kThreads, 1)
    swarm_chain_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = enter<WT>(p, smem);
  block_update<WT>(p, block_at<WT>(p, 0), s);
}

template <typename WT>
__global__ void __launch_bounds__(kThreads, 1)
    swarm_chunk_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem s = enter<WT>(p, smem);
  const int P = p.P;
  float* rows = s.rows;
  for (int k = 0; k < p.n_blocks; ++k) {
    // Seeker reset from the pre-drawn table (gradient_ascend.cpp:295-299).
    // Each row is handled by one thread here and in the carry below.
    const float* rs = p.resets + (size_t)k * 3 * P;
    for (int r = threadIdx.x; r < P; r += kThreads)
      if (rs[r] > 0.5f && rows[FAM_S * P + r] > 0.5f) {
        rows[TH * P + r] = rs[P + r];
        rows[PH * P + r] = rs[2 * P + r];
      }
    block_update<WT>(p, block_at<WT>(p, k), s);
    // The published trackers feed block k+1's seeker avoidance.
    for (int r = threadIdx.x; r < P; r += kThreads) {
      const bool is_t = rows[FAM_T * P + r] > 0.5f;
      rows[TGT_TH * P + r] = is_t ? rows[TH * P + r] : 0.0f;
      rows[TGT_PH * P + r] = is_t ? rows[PH * P + r] : 0.0f;
      rows[TGT_VA * P + r] = rows[TRK * P + r];
    }
  }
}

// n_sub chained sub-steps of the rows (monopulse_chain_pallas, kernel
// _chain_kernel): rows_in [8, P] holds theta, phi, grad_theta, grad_phi,
// radius, error, rate, spread; row r steps in sub-step j where
// active[j, r] > 0 and keeps its values otherwise.  Writes the first six
// rows after the chain to out_rows [6, P].
template <typename WT>
__global__ void __launch_bounds__(kThreads, 1)
    monopulse_chain_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = make_layout(p.C, p.P, p.T, p.span, p.taps,
                               (int)sizeof(WT), p.win_smem != 0);
  const Smem s = carve(p, L, smem, threadIdx.x >> 5);
  const int P = p.P, tid = threadIdx.x;
  for (int i = tid; i < kChainRows * P; i += kThreads) {
    const int f = i / P;
    s.rows[(f < kChainState ? f : RATE + f - kChainState) * P + i - f * P] =
        p.rows_in[i];
  }
  const WT* win = stage_window<WT>(p, p.win_bp, s);
  for (int j = 0; j < p.n_sub; ++j) {
    if (tid == 0) {
      int n = 0;
      for (int r = 0; r < P; ++r) {
        const bool a = p.active[(size_t)j * P + r] > 0.0f;
        s.act[r] = a;
        if (a) s.list[1 + n++] = r;
      }
      s.list[0] = n;
    }
    __syncthreads();  // (and, at j == 0, the staged rows and window)
    monopulse_substep<WT>(p, win, s);
  }
  for (int i = tid; i < kChainState * P; i += kThreads)
    p.out_rows[i] = s.rows[i];
}

enum Kind { kSwarmChain, kSwarmChunk, kMonopulseChain };

template <typename WT>
cudaError_t launch(const Params& p, Kind kind, size_t smem,
                   cudaStream_t stream) {
  void (*kernel)(const Params) =
      kind == kSwarmChain   ? &swarm_chain_kernel<WT>
      : kind == kSwarmChunk ? &swarm_chunk_kernel<WT>
                            : &monopulse_chain_kernel<WT>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kernel<<<1, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

int launch_blocks(Params& p, int win_bf16, Kind kind, const float* host_consts,
                  void* stream) {
  if (p.taps < 1 || p.taps > kMaxTaps || (!p.fir && p.taps != 2) || p.C < 1 ||
      p.P < 1 || p.T < 3 || p.n_trackers > p.P || p.n_blocks < 1 ||
      (kind == kMonopulseChain && p.n_sub < 1))
    return (int)cudaErrorInvalidValue;
  memcpy(p.cos_b, host_consts, sizeof(p.cos_b));
  memcpy(p.sin_b, host_consts + 4, sizeof(p.sin_b));
  memcpy(p.blackman, host_consts + 8, sizeof(p.blackman));
  const int elem = win_bf16 ? 2 : 4;
  Layout L = make_layout(p.C, p.P, p.T, p.span, p.taps, elem, true);
  p.win_smem = L.total <= kMaxSmem;
  if (!p.win_smem) L = make_layout(p.C, p.P, p.T, p.span, p.taps, elem, false);
  if (L.total > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(win_bf16 ? launch<__nv_bfloat16>(p, kind, L.total, s)
                        : launch<float>(p, kind, L.total, s));
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

// Both entry points launch on `stream` and return cudaGetLastError() (0 on
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
// jumps [2, n_iter, P], reference []; out_rows [8, P], out_mean [],
// out_beam [T].
extern "C" int swarm_chain_launch(
    const float* xyz, const void* win_bp, int win_bf16, const float* win_raw,
    const float* rows_in, const float* jumps, const float* reference,
    float* out_rows, float* out_mean, float* out_beam, long long block_index,
    const int* dims, const float* scalars, const float* host_consts,
    void* stream) {
  Params p = make_params(xyz, win_bp, win_raw, rows_in, jumps, reference,
                         out_rows, out_mean, out_beam, dims, scalars);
  p.n_blocks = 1;
  p.block_index0 = block_index;
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
extern "C" int monopulse_chain_launch(
    const float* xyz, const void* win_bp, int win_bf16, const float* rows_in,
    const float* active, float* out_rows, const int* dims,
    const float* scalars, const float* host_consts, void* stream) {
  Params p = make_params(xyz, win_bp, nullptr, rows_in, nullptr, nullptr,
                         out_rows, nullptr, nullptr, dims, scalars);
  p.active = active;
  p.n_blocks = 1;
  p.n_trackers = 0;
  return launch_blocks(p, win_bf16, kMonopulseChain, host_consts, stream);
}
