#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is non-zero):

1. require a CUDA device; print the card's name and power limit;
2. build the kernels from ``beamforming_lk_tpu_torch/csrc``, one ``nvcc``
   per source, all at once;
3. the swarm-chain kernel (K1) against its plain twin at the deployment
   shapes (64 and 256 mics, 27 particle rows, bf16 and f32 windows), with
   times from CUDA events, and with the FIR stencil at two of them;
4. the chunk kernel (K2, 12 blocks a launch) against its twin and against
   12 launches of K1, at the same shapes, with times (K1 and K2 each run
   as one thread block cluster, whose size is printed after the build);
5. the power-stage kernel (K3) against its twin at the replay shapes
   (16 384 and 32 768 rows and a ragged 16 397, F = 161, Tp = 256, bf16
   and f32, pc/ps f32 as the path passes them), with its launch plan, its
   time, the twin's, ``torch.matmul``'s alone and the fused path's;
6. a small end-to-end check: 9 blocks through the f32 profile on the card
   and on the CPU (the twin), outputs compared;
6b. the 64-mic realtime path in f32 assembled from the low-level builders
   (``ring_init``, ``swarm_init`` with a CUDA generator, ``miso_init``,
   ``pack_geometry``, ``make_fft_heatmap_model``, ``make_mimo_model``,
   ``make_fused_step_impl``, ``make_fused_chunk_impl``,
   ``convert.awpu_state_from_jax``), each called with no device argument:
   every tensor on the card, the seekers the CUDA generator's stream; 3
   blocks through K1, a 12-block chunk through K2 and a dense map through
   K4, held against the same pieces built with ``device="cpu"``;
7. the live slice: ``AwpuPipeline(realtime(Config()), channels=64|256)`` on
   96 plane-wave blocks through ``process_block``, locked on the source,
   with K1 launched once per block and the ms per block; at 256 mics the
   median and p99 per-block latency over 1008 more blocks;
8. the replay slice: the same pipelines on 96 blocks through
   ``process_blocks``, with K2 launched once per 12 blocks, its first 24
   blocks held against ``process_block`` from the same seed, and the ms
   per block;
9. the chunked heatmap at 256 mics through K3 (``power_path="pallas"``, as
   ``bench.py``'s chunked variant) against the fused path, and the
   heatmap-only replay on 96 blocks;
9a. the lattice-ordered, SRP-PHAT and PHAT + lattice-ordered heatmaps at
   256 mics (8 windows of a broadband source, bf16): one K3 launch each,
   against the fused path and the plain models, with times;
9b. startup calibration at 256 mics (a dead mic masked, card vs CPU), 96
   calibrated blocks (K1, lock, ms/block), then ``apply_gains`` (the dense
   fallback, K4);
9c. save and restore at 64 mics: the restored pipeline's next 12 blocks,
   live and as one replay chunk (K2), bitwise equal to the uninterrupted
   run's;
9d. two 256-mic arrays at x = -1, +1 m fused into a 3D track over 96
   blocks (``TargetFusion`` on the card), against the source and a numpy
   triangulation of the published rays, with the fusion step's time; then
   the fusion's ray log replayed by ``tools.track_replay`` on the card and
   on the CPU, results equal, with the replay's time on each;
9e. the adaptive heatmaps on the realtime profile's 64 x 64 grid: (a) each
   estimator on the card against the CPU over 6 blocks (MVDR, MUSIC
   subspace and eigh at 64 mics, MVDR at 256); (b) MVDR, MVDR with its
   solve every 3rd block and MUSIC (subspace) in
   ``AwpuPipeline(realtime(Config()), heatmap_mode=...)`` with the tracker
   and MISO, 96 blocks through ``process_block`` at 64 and 256 mics: K1
   once a block, the estimator's peak within one cell of the source, the
   block's ms; (c) the estimator's ms a block alone (CUDA events), its
   stage split and its bound; (d) the syncs a call of the estimator and of
   the whole block after a warm one (``torch.cuda.set_sync_debug_mode``,
   and whether the host waited behind a spin kernel): none for MVDR and
   MUSIC subspace; (e) MUSIC eigh on 8 blocks at each size, timed;
   (f) MVDR at 256 mics through ``process_blocks``: K2 once per 12 blocks,
   the last powers equal to the ``process_block`` run's;
10. the DAS-beam kernel (K4) against its twin at the heatmap's shapes (a
    64 x 64 grid, 64 and 256 mics, f32 and bf16, one window and a stack
    of 8), and the monopulse-chain kernel (K0) against its twin (64 and
    256 mics, f32 and bf16, 26 rows under a random 5-sub-step mask and the
    listener's 1 row under 3 sub-steps), with their launch plans and
    times, and both with the FIR stencil at two of those shapes;
11. a small end-to-end check of the default profile (``Config()``: dense
    heatmap, 10 iterations on the XLA-chain backend, the unfused MISO):
    6 blocks on the card and on the CPU, outputs compared;
12. the default profile: ``AwpuPipeline(Config(), channels=64|256)`` on 96
    plane-wave blocks through ``process_block``, locked on the source,
    with 11 K0 launches (10 iterations and the MISO step) and 1 K4 launch
    per block and the ms per block, then K0's and K4's device ms in one
    more block from CUDA events around each launch;
13. the realtime profile's fallback to the dense heatmap (a gain mask, 64
    mics), live (K1 per block, K4 per heatmap) and through
    ``process_blocks`` (K2 and K4 once per 12 blocks);
13a. the CLI, ``beamforming_lk_tpu_torch.app.cli.main`` in this process on
    the card, replaying a wire-format pcap of 96 blocks at 256 mics in the
    realtime profile (``--realtime --mimo --tracking --miso --miso-wav
    --output-dir --fps``): 8 K2 launches and no K1, the printed targets on
    the source, the WAV's tone SNR, the last heatmap's peak on the source
    cell, blocks/s and the host stages; then once more with ``--profile``:
    the trace names the chunk kernel, and gives the device's busy time;
13b. the CLI's live ingest over loopback at 256 mics (``--source native
    --blocks 0 --realtime``): a sender process sends 1008 blocks of wire
    packets at the wire rate (a block of 256 packets every 5.24 ms, in
    groups of 32, one ``sendmmsg`` each); every block sent is processed or
    counted as dropped by
    the ingest, K1 once per processed block, lock, and the latency p50/p99
    against the 5.24 ms budget (printed, not gated);
13c. the CLI's default profile (no ``--realtime``) on a 24-block pcap at
    64 mics: 11 K0 and 1 K4 launches per block, lock;
13d. the CLI with two 256-mic links in one pcap (``--arrays 2 --realtime
    --tracking --wara-ps --telemetry-file``), a source placed as in 9d: K1
    once a block an array, every published GeoPoint, inverted, within
    0.5 m of the source;
13e. the CLI with ``--mvdr``, then ``--music`` (``--realtime --tracking
    --miso --channels 64 --blocks 24 --output-dir --fps``, a synthetic
    source placed as in 13a): K2 twice and no K1, frames written, the
    target and the last heatmap's peak on the source, the stages;
14. one JSON line of kernel results (each kernel's time, its plain twin's,
    its bound from this run's operands and active rows against the H100's
    published peaks, and a library call's time where one exists: for K4,
    10's ``torch.matmul`` of the dense stencil by the unfolded window, the
    JAX package's ``das_beam``), then the final status line; printed after
    phase 15, whose K0 and K4 launches they count:
15a. the mesh on one rank: a world-size-1 NCCL group and a 1x1 mesh; a
    state carried over by ``convert.awpu_state_from_jax(..., mesh=mesh)``
    with no device argument lies on the rank's card and equals
    ``awpu_init``'s; then
    ``AwpuPipeline(realtime(Config()), channels=256, mesh=mesh)`` on 96
    blocks through ``process_block`` and 24 through ``process_blocks``,
    block by block against the unsharded pipeline on the XLA chain from
    the same seed at the JAX package's sharded bounds; K0 twice a block, no
    K4, locked, the ms a block of both;
15b. two ranks of this script sharing the card through gloo (NCCL refuses
    two ranks of one communicator on one GPU), realtime, 256 mics, 48
    blocks, at (ch, dir) = (2, 1) (the dense heatmap through K4 every 3rd
    block, K4 for the probe beams of each of the 10 sub-steps) and (1, 2)
    (the fft heatmap sliced per rank, K0 as in 15a): launches and
    all-reduces a block, the ms a block, the lock; then each block started
    from a one-rank pipeline's carried state on the same card and held
    against it at the sharded bounds, K4's operands of the first such block
    at (2, 1) (a sub-step's 108 probe rows, the last of its 32-row blocks
    partly empty, and the map's (dir, ch) block, each over the rank's 128
    channels) held against its twin on the same tensors at 1e-5 of the
    peak;
15c. ``make_sharded_das_power`` over ch = 2 at 1024 mics (shift_range 192)
    against one rank, the peak on the source; the time-sharded beam over
    (dir, t) = (1, 2), the second rank's halo from the first through host
    memory (gloo sends no CUDA tensor point to point), against one rank,
    with the ms of a call and of one halo exchange;
15d. ``make_sharded_mvdr_step`` and ``make_sharded_music_step`` (subspace)
    over dir = 2 at 64 mics against the single-device estimators on the
    card (MVDR 2e-3 relative, MUSIC by its invariants).  A rank that fails
    fails the phase.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

SOURCE = (0.5, 1.2, 5000.0)          # theta, phi [rad], frequency [Hz]
BUDGET_MS = 256 / 48828.0 * 1e3      # one block of audio: 5.24 ms
N_BLOCKS = 96
N_TRACKERS, N_SEEKERS = 10, 16       # TrackerConfig defaults: P = 27 rows
CHUNK = 12                           # realtime().dsp.fused_chunk
LIVE_LATENCY_BLOCKS = 1008           # latency samples of the 256-mic live slice
# Published H100 SXM peaks at 700 W: HBM bytes/s; FLOP/s in f32 outside the
# tensor cores (the swarm, monopulse and DAS kernels widen every operand to
# f32) and in bf16 on the tensor cores (K3's bf16 matrix product).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, n: int) -> float:
    """Mean device time of ``fn()`` over ``n`` calls, after a warm-up.  A
    spin kernel holds the device while the host enqueues the calls, so a
    kernel shorter than its host-side launch is timed on the device, not
    at the host's pace."""
    import torch

    fn()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - h0) * 1e3
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(2.0 * one_ms * n, 3000.0) * 2e6))  # ~2e6 cycles/ms
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS["float32"]):
    """(ms, "bytes" | "operations"): the least time the card could take for
    ``flops`` operations on ``nbytes`` bytes moved once, and which binds."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _probe_flops(probe_rows: int, channels: int, taps: int, n_out: int) -> float:
    """Multiply-adds (x2) of ``probe_rows`` active rows' 4 probe beams."""
    return 2.0 * 4 * probe_rows * channels * taps * n_out


def _angle(theta1, phi1, theta2, phi2) -> float:
    """Largest great-circle angle [rad] between paired directions."""
    def unit(t, p):
        t, p = np.asarray(t, np.float64), np.asarray(p, np.float64)
        return np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)])

    chord = np.linalg.norm(unit(theta1, phi1) - unit(theta2, phi2), axis=0)
    return float((2.0 * np.arcsin(np.minimum(chord / 2.0, 1.0))).max())


def chain_operands(channels: int, compute: str, device, seed: int = 0,
                   interp: str = "linear"):
    """Operands of one swarm-chain call at the deployment shapes, seeded so
    merge, jump and promote all fire: two coincident tracking trackers, a
    published target on a seeker, free trackers, a plane-wave source; the
    stencil linear or the FIR bank's windowed sinc."""
    import torch

    from beamforming_lk_tpu_torch import Config, realtime
    from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block
    from beamforming_lk_tpu_torch.ops import antenna as ant
    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk
    from beamforming_lk_tpu_torch.ops import delay as dl

    cfg = realtime(Config())
    tc, dsp = cfg.tracker, cfg.dsp
    rng = np.random.default_rng(seed)
    pts = ant.multi_array_cluster(channels)
    taps = 2 if interp == "linear" else dsp.fir_taps
    span = dl.probe_span(pts, cfg.array.samples_per_meter, taps, dsp.shift_range)
    blk = plane_wave_block(pts, [SOURCE], 0, span + dsp.block_size, cfg.array,
                           noise_std=0.02, rng=rng)
    pw = torch.as_tensor(blk, device=device)
    bp = ctk.bandpass_window(pw)
    bp = bp.to(torch.bfloat16) if compute == "bfloat16" else bp
    nt, ns = N_TRACKERS, N_SEEKERS
    p = nt + 1 + ns
    rows = np.zeros((len(ctk.ROW_FIELDS), p), np.float32)
    rows[0] = rng.uniform(0.05, 1.3, p)
    rows[1] = rng.uniform(0.0, 2 * np.pi, p)
    rows[0, :2], rows[1, :2] = (0.52, 0.53), (1.2, 1.21)
    rows[0, nt], rows[1, nt] = 0.4, 1.0                   # the listener
    rows[6, :2] = 1.0                                     # tracking
    rows[7, :2] = (1.0, 2.0)                              # start
    rate = tc.tracker_step_gain * tc.tracker_spread
    rows[8] = [rate] * nt + [rate / 3] + [tc.seeker_step_gain * tc.seeker_spread] * ns
    rows[9] = [tc.tracker_spread] * (nt + 1) + [tc.seeker_spread] * ns
    rows[10, :nt], rows[11, nt + 1:], rows[12, nt] = 1.0, 1.0, 1.0
    rows[13, 0], rows[14, 0], rows[15, 0] = rows[0, nt + 1], rows[1, nt + 1], 1.0
    jumps = np.zeros((2, tc.iterations, p), np.float32)
    jumps[:, :, nt + 1:] = rng.uniform(-1, 1, (2, tc.iterations, ns)) * tc.theta_limit / 2
    ops = (
        ctk.pack_geometry(pts, cfg.array.samples_per_meter, device=device),
        bp.contiguous(), pw.contiguous(),
        torch.as_tensor(rows, device=device),
        torch.as_tensor(jumps, device=device),
        dl.das_power(pw[0, span - 2:span - 2 + dsp.block_size], divisor=dsp.block_size - 2),
    )
    kw = dict(block_index=3, n_iter=tc.iterations, n_sub=tc.tracker_steps,
              refine=3, n_trackers=nt, span=span, taps=taps, interp=interp,
              fir_phases=dsp.fir_phases,
              theta_limit=tc.theta_limit, divisor=float(dsp.block_size),
              closeness=tc.tracker_closeness,
              error_threshold=tc.error_threshold,
              min_power_fraction=tc.min_power_fraction)
    return ops, kw


def full_chain_tol(compute: str) -> dict:
    """Kernel-vs-twin bounds over the full chain (see compare_kernel)."""
    if compute == "bfloat16":
        return dict(pub=1e-3, seek=5e-2, grad=1e-2, beam=1e-3, mean=1e-2)
    return dict(pub=1e-4, seek=5e-2, grad=1e-3, beam=1e-4, mean=1e-2)


def chain_errors(got, want, tol, what: str, all_grads: bool = False) -> dict:
    """Errors of one block's kernel outputs ``got = (state [8, P], mean,
    beam)`` against ``want``: tracking flags and start stamps must be
    equal, and each error within ``tol`` (directions by great-circle angle,
    published rows and seekers apart; gradients, beam and mean relative to
    their scale).  Raises on a miss; returns the errors."""
    gs, gm, gb = got
    ws, wm, wb = want
    pub = slice(0, N_TRACKERS + 1)                  # trackers | listener
    seek = slice(N_TRACKERS + 1, None)
    for name, x, y in (("tracking", gs[6], ws[6]), ("start", gs[7], ws[7])):
        if not np.array_equal(x, y):
            raise AssertionError(f"{name} differs at {what}: {x} vs {y}")
    scale = lambda v: max(float(np.abs(v).max()), 1e-30)  # noqa: E731
    grad_rows = slice(None) if all_grads else pub
    errs = {
        "pub": _angle(gs[0, pub], gs[1, pub], ws[0, pub], ws[1, pub]),
        "seek": _angle(gs[0, seek], gs[1, seek], ws[0, seek], ws[1, seek]),
        "grad": max(float(np.abs(gs[i, grad_rows] - ws[i, grad_rows]).max())
                    / scale(ws[i, grad_rows]) for i in range(2, 6)),
        "beam": float(np.abs(gb - wb).max()) / scale(wb),
        "mean": float(abs(gm - wm)) / scale(wm),
    }
    for name, e in errs.items():
        if not np.isfinite(e) or e > tol[name]:
            raise AssertionError(f"kernel vs twin {name} error {e:.3g} > "
                                 f"{tol[name]} at {what}")
    return errs


def compare_kernel(channels: int, compute: str, device, timing: bool,
                   interp: str = "linear"):
    """Kernel (``swarm_chain``) against the twin on identical operands, at
    the deployment shapes, in two settings.  Directions are compared by
    great-circle angle (at theta = 0 phi is arbitrary, and the phi step,
    divided by sin(theta), is ill-conditioned there).

    - One sub-step of one iteration pins the arithmetic: every row's
      direction within 1e-5 rad, gradients/error/radius within 1e-4 of
      their scale, the MISO beam within 1e-5 of its peak.
    - The full chain (2 iterations x 5 sub-steps) amplifies rounding: bf16
      rounding of a stencil weight is discontinuous in the delay fraction,
      and a seeker that crosses the pole turns its probe ring.
      Accumulating the twin alone in float64 moves directions by up to
      3e-4 rad at 256 mics.  Tracker and listener rows (what is published)
      within 1e-3 rad (bf16) / 1e-4 rad (f32), their gradients within 1e-2
      / 1e-3 of scale; seekers (exploration state) within 5e-2 rad; beam
      within 1e-3 / 1e-4 of its peak; mean seeker power within 1e-2.

    Both settings: tracking flags and start stamps equal.  Returns the
    full-chain tracker/listener direction error ``err`` and, with
    ``timing``, the kernel's and the twin's ms and the full chain's bound
    (its active rows' probe beams and the MISO beam)."""
    import torch

    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk

    ops, kw = chain_operands(channels, compute, device, interp=interp)
    counts = []
    settings = (
        ("1 sub-step", dict(kw, n_iter=1, n_sub=1, refine=1),
         dict(pub=1e-5, seek=1e-5, grad=1e-4, beam=1e-5, mean=1e-5)),
        ("full chain", kw, full_chain_tol(compute)),
    )
    for label, kws, tol in settings:
        jumps = ops[4][:, :kws["n_iter"]].contiguous()
        args = ops[:4] + (jumps,) + ops[5:]
        got = ctk.swarm_chain(*args, **kws)
        want = ctk.swarm_chain_reference(
            *args, **kws, active_counts=counts if label == "full chain" else None)
        if device != "cpu":
            torch.cuda.synchronize()
        what = f"{channels} mics {compute} {interp} {label}"
        errs = chain_errors([x.cpu().numpy() for x in got],
                            [x.cpu().numpy() for x in want], tol, what,
                            all_grads=label == "1 sub-step")
        print(f"kernel vs twin {channels:3d} mics {compute:8s} {interp:6s} "
              f"{label:10s}: "
              + "  ".join(f"{k} {e:.3g} (tol {tol[k]:g})"
                          for k, e in errs.items()), flush=True)
    out = dict(err=errs["pub"], library_ms=None)
    if timing:
        c, t_len = ops[0].shape[1], ops[2].shape[1] - kw["span"]
        p = ops[3].shape[1]
        out["bound_ms"], out["bound_by"] = bound(
            _probe_flops(sum(counts), c, kw["taps"], t_len - 2)
            + 2.0 * c * kw["taps"] * t_len,
            _nbytes(*ops) + 4 * (ctk.STATE_ROWS * p + 1 + t_len))
        out["ms"] = _cuda_ms(lambda: ctk.swarm_chain(*ops, **kw), 50)
        out["plain_ms"] = _cuda_ms(lambda: ctk.swarm_chain_reference(*ops, **kw), 5)
        print(f"  time per call, full chain: kernel {out['ms']:.4f} ms, twin "
              f"{out['plain_ms']:.4f} ms; bound {out['bound_ms'] * 1e3:.3f} us "
              f"({out['bound_by']}, {sum(counts)} active rows)", flush=True)
    return out


def end_to_end_check(device):
    """9 blocks of the f32 profile (16x16 heatmap, 64 mics) on ``device``
    and on the CPU from the same state with the same draws.  Bounds:
    heatmap powers within 1e-4 of the peak, equal target flags, tracker
    and listener directions within 2e-3 rad, the MISO beam within 1e-2 of
    its peak (a 5e-5 rad listener difference moves a 5 kHz beam by ~1e-3)."""
    from beamforming_lk_tpu_torch import Config, MimoConfig, realtime
    from beamforming_lk_tpu_torch.app import AwpuPipeline
    from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block

    cfg = realtime(Config(mimo=MimoConfig(rows=16, columns=16)))
    cfg = dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, compute="float32", probe_compute="float32"))
    pipes = [AwpuPipeline(cfg, channels=64, seed=0, device=d) for d in (device, "cpu")]
    pipes[1].state = _state_to(pipes[0].state, "cpu")  # same start on both
    rng = np.random.default_rng(5)
    tc = cfg.tracker
    worst = dict(powers=0.0, direction=0.0, beam=0.0)
    for i in range(9):
        blk = plane_wave_block(pipes[0].points, [SOURCE], i * 256, 256, cfg.array,
                               noise_std=0.02, rng=rng)
        draws = (rng.uniform(0, tc.theta_limit, tc.n_seekers).astype(np.float32),
                 rng.uniform(0, 2 * np.pi, tc.n_seekers).astype(np.float32),
                 *(rng.uniform(-1, 1, (2, tc.iterations, tc.n_seekers))
                   * tc.theta_limit / 2).astype(np.float32))
        a, b = (_state_to(p.process_block(blk, draws=draws), "cpu") for p in pipes)
        if not np.array_equal(a.targets.valid.numpy(), b.targets.valid.numpy()):
            raise AssertionError(f"block {i}: target flags differ from the CPU run")
        ma, mb = (p.state.miso.particle for p in pipes)
        errs = dict(
            powers=float((a.powers - b.powers).abs().max() / b.powers.abs().max()),
            direction=max(
                _angle(a.targets.theta, a.targets.phi, b.targets.theta, b.targets.phi),
                _angle(ma.theta.cpu(), ma.phi.cpu(), mb.theta, mb.phi)),
            beam=float((a.miso_beam - b.miso_beam).abs().max()
                       / b.miso_beam.abs().max()),
        )
        worst = {k: max(worst[k], v) for k, v in errs.items()}
    print(f"end to end, {device} vs cpu, 9 blocks f32: flags equal, "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()), flush=True)
    for k, tol in (("powers", 1e-4), ("direction", 2e-3), ("beam", 1e-2)):
        if not worst[k] <= tol:
            raise AssertionError(f"end to end {k} error {worst[k]:.3g} > {tol}")


def _state_to(state, device):
    import torch

    def move(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, tuple):
            return type(x)(*(move(v) for v in x))
        return x

    return move(state)


def _wrappers() -> dict:
    """Every kernel wrapper by its kernel's name."""
    from beamforming_lk_tpu_torch.ops import cuda_das as cd
    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk
    from beamforming_lk_tpu_torch.ops import fft_das as fd

    return {"swarm_chain": ctk.swarm_chain, "swarm_chunk": ctk.swarm_chunk,
            "power_matmul": fd.power_matmul,
            "monopulse_chain": ctk.monopulse_chain, "das_beam": cd.das_beam}


def _reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def _counts(**expected) -> dict:
    """The launch counts; raises unless they equal ``expected`` (zero for a
    kernel not named)."""
    got = {name: fn.launches for name, fn in _wrappers().items()}
    want = {name: expected.get(name, 0) for name in got}
    if got != want:
        raise AssertionError(f"launches {got}, expected {want}")
    return got


def _numpy_tree(tree):
    """A state tree with numpy leaves, the form ``convert`` reads."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    if isinstance(tree, tuple):
        return type(tree)(*(_numpy_tree(v) for v in tree))
    return tree


def _tensors(tree) -> list:
    """The tensors of a state tree, or a module's parameters and buffers."""
    import torch

    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _tensors(v)]
    return []


def run_default_built():
    """Phase 6b: the 64-mic realtime main path in f32 assembled from the
    low-level builders, each called with no device argument, then the
    same pieces built with ``device="cpu"`` (the twins).  Every tensor of
    the default build must lie on the card; the start state goes through
    ``convert.awpu_state_from_jax`` of its numpy leaves on each device;
    3 blocks through K1, one 12-block chunk through K2 and one dense map
    through K4, each held against the twins at :func:`end_to_end_check`'s
    bounds (maps within 1e-4 of the peak, equal target flags, directions
    within 2e-3 rad, MISO beams within 1e-2 of the peak).  Returns the
    launches of the card's run by kernel."""
    import torch

    from beamforming_lk_tpu_torch import Config, convert, realtime
    from beamforming_lk_tpu_torch.app.awpu import AwpuState
    from beamforming_lk_tpu_torch.io import ring as rg
    from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block
    from beamforming_lk_tpu_torch.models import miso as ms
    from beamforming_lk_tpu_torch.models import tracker as tk
    from beamforming_lk_tpu_torch.models.mimo import make_mimo_model, mimo_power
    from beamforming_lk_tpu_torch.ops import antenna as ant
    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk
    from beamforming_lk_tpu_torch.ops import delay as dl
    from beamforming_lk_tpu_torch.ops import fft_das as fd

    cfg = realtime(Config())
    cfg = dataclasses.replace(cfg, dsp=dataclasses.replace(
        cfg.dsp, compute="float32", probe_compute="float32"))
    dsp, tc, arr = cfg.dsp, cfg.tracker, cfg.array
    pts = ant.multi_array_cluster(64)
    taps = dl.LINEAR_TAPS if dsp.interp == "linear" else dsp.fir_taps
    span = dl.probe_span(pts, arr.samples_per_meter, taps, dsp.shift_range)

    def build(**dev):
        return dict(
            xyz=ctk.pack_geometry(pts, arr.samples_per_meter, **dev),
            fft=fd.make_fft_heatmap_model(pts, cfg.mimo, dsp, arr,
                                          compute=dsp.compute, **dev),
            dense=make_mimo_model(pts, cfg.mimo, dsp, arr, compute=dsp.compute,
                                  **dev),
            fused=tk.make_fused_step_impl(tc, dsp, arr, pts, probe_span=span, **dev),
            chunk=tk.make_fused_chunk_impl(tc, dsp, arr, pts, probe_span=span, **dev),
        )

    card, cpu = build(), build(device="cpu")
    seed = 0
    fresh = AwpuState(
        history=rg.ring_init(64, dsp.history),
        swarm=tk.swarm_init(tc, torch.Generator(device="cuda").manual_seed(seed)),
        miso=ms.miso_init(), prev_max=torch.zeros((), device="cuda"),
        block_index=0, powers=torch.zeros((cfg.mimo.n_directions,), device="cuda"))
    # The seekers are the generator's stream as the draw defines it.
    u = torch.rand((2, tc.n_seekers), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(seed))
    if not (torch.equal(fresh.swarm.seekers.theta, u[0] * tc.theta_limit)
            and torch.equal(fresh.swarm.seekers.phi, u[1] * (2.0 * math.pi))):
        raise AssertionError("swarm_init's draw is not the generator's stream")
    as_numpy = _numpy_tree(fresh)
    start = {"card": convert.awpu_state_from_jax(as_numpy),
             "cpu": convert.awpu_state_from_jax(as_numpy, device="cpu")}
    if not _same(start["card"], fresh):
        raise AssertionError("awpu_state_from_jax did not carry the state over")
    if not torch.equal(card["xyz"], card["fused"].probes.xyz):
        raise AssertionError("pack_geometry differs from the step's geometry")
    placed = _tensors(tuple(card.values())) + _tensors(fresh) + _tensors(start["card"])
    off = sorted({str(t.device) for t in placed if t.device.type != "cuda"})
    if off:
        raise AssertionError(f"default-built tensors on {off}, not the card")

    rng = np.random.default_rng(6)
    n = 3 + CHUNK
    blocks = np.stack([plane_wave_block(pts, [SOURCE], i * 256, 256, arr,
                                        noise_std=0.02, rng=rng) for i in range(n)])
    draws = [(rng.uniform(0, tc.theta_limit, tc.n_seekers).astype(np.float32),
              rng.uniform(0, 2 * np.pi, tc.n_seekers).astype(np.float32),
              *(rng.uniform(-1, 1, (2, tc.iterations, tc.n_seekers))
                * tc.theta_limit / 2).astype(np.float32)) for _ in range(n)]
    chunk_draws = tuple(np.stack([d[j] for d in draws[3:]]) for j in range(4))
    runs, counts = {}, None
    for name, parts, dev in (("card", card, "cuda"), ("cpu", cpu, "cpu")):
        st = start[name]
        hist, swarm, miso_p = st.history, st.swarm, st.miso.particle
        out = []
        if name == "card":
            _reset_counts()
        for i in range(3):
            hist = rg.ring_push(hist, torch.as_tensor(blocks[i], device=dev))
            window = rg.ring_window(hist, dsp.block_size, dsp.shift_range, taps)
            powers = parts["fft"](window)
            swarm, tg, miso_p, beam = parts["fused"](swarm, miso_p, window, i,
                                                     draws=draws[i])
            out.append((tg, beam))
        # The replay's windows: views of the history and the chunk's blocks
        # behind it (as ``AwpuStep.scan_chunks`` makes them).
        big = torch.cat([hist, torch.as_tensor(blocks[3:], device=dev).permute(
            1, 0, 2).reshape(64, CHUNK * dsp.block_size)], dim=1)
        windows = rg.ring_windows(big, dsp.block_size, dsp.shift_range, taps, CHUNK)
        swarm, tgs, miso_p, beams = parts["chunk"](swarm, miso_p, windows, 3,
                                                   draws=chunk_draws)
        out += [(tk.Targets(*(f[k] for f in tgs)), beams[k]) for k in range(CHUNK)]
        dense = mimo_power(windows[-1], parts["dense"])
        if name == "card":
            torch.cuda.synchronize()
            counts = _counts(swarm_chain=3, swarm_chunk=1, das_beam=1)
        runs[name] = (powers.cpu(), dense.cpu(), _state_to(miso_p, "cpu"),
                      [(_state_to(tg, "cpu"), b.cpu()) for tg, b in out])
    (fft_a, dense_a, m_a, out_a), (fft_b, dense_b, m_b, out_b) = runs["card"], runs["cpu"]
    for what, p in (("fft map", fft_a), ("dense map", dense_a)):
        check_map(f"6b {what}", cfg, p)
    worst = dict(
        fft=float((fft_a - fft_b).abs().max() / fft_b.abs().max()),
        dense=float((dense_a - dense_b).abs().max() / dense_b.abs().max()),
        direction=_angle(m_a.theta, m_a.phi, m_b.theta, m_b.phi), beam=0.0)
    for k, ((ta, ba), (tb, bb)) in enumerate(zip(out_a, out_b)):
        if not torch.equal(ta.valid, tb.valid):
            raise AssertionError(f"6b block {k}: target flags differ from the twins'")
        worst["direction"] = max(worst["direction"], _angle(
            ta.theta, ta.phi, tb.theta, tb.phi))
        worst["beam"] = max(worst["beam"], float((ba - bb).abs().max()
                                                 / bb.abs().max()))
    published = sum(bool(ta.valid.any()) for ta, _ in out_a)
    print(f"6b default-built realtime path, 64 mics f32: {len(placed)} tensors "
          f"all on cuda; launches {counts}; vs device='cpu' over {n} blocks "
          f"(targets published in {published}): flags equal, "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + " (tol: maps 1e-4, direction 2e-3, beam 1e-2)", flush=True)
    for k, tol in (("fft", 1e-4), ("dense", 1e-4), ("direction", 2e-3), ("beam", 1e-2)):
        if not worst[k] <= tol:
            raise AssertionError(f"6b {k} error {worst[k]:.3g} > {tol}")
    return counts


def chunk_operands(channels: int, compute: str, device, seed: int = 0):
    """Operands of one chunk-kernel launch of CHUNK blocks at the deployment
    shapes: the rows of :func:`chain_operands` (so merge, jump and promote
    fire), CHUNK consecutive windows of the plane wave, per-block reference
    powers and jump draws, and a seeker reset before block 5."""
    import torch

    from beamforming_lk_tpu_torch import Config, realtime
    from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block
    from beamforming_lk_tpu_torch.ops import antenna as ant
    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk
    from beamforming_lk_tpu_torch.ops import delay as dl

    ops, kw = chain_operands(channels, compute, device, seed)
    xyz, rows = ops[0], ops[3]
    cfg = realtime(Config())
    tc, t = cfg.tracker, cfg.dsp.block_size
    span, nt, ns, p = kw["span"], N_TRACKERS, N_SEEKERS, rows.shape[1]
    rng = np.random.default_rng(seed + 1)
    stream = plane_wave_block(ant.multi_array_cluster(channels), [SOURCE], 0,
                              span + CHUNK * t, cfg.array, noise_std=0.02,
                              rng=rng)
    pw = torch.as_tensor(np.stack([stream[:, k * t:k * t + span + t]
                                   for k in range(CHUNK)]), device=device)
    bp = ctk.bandpass_window(pw)
    bp = bp.to(torch.bfloat16) if compute == "bfloat16" else bp
    jumps = np.zeros((CHUNK, 2, tc.iterations, p), np.float32)
    jumps[..., nt + 1:] = (rng.uniform(-1, 1, (CHUNK, 2, tc.iterations, ns))
                           * tc.theta_limit / 2)
    resets = np.zeros((CHUNK, 3, p), np.float32)
    resets[5, 0] = 1.0
    resets[:, 1, nt + 1:] = rng.uniform(0, tc.theta_limit, (CHUNK, ns))
    resets[:, 2, nt + 1:] = rng.uniform(0, 2 * np.pi, (CHUNK, ns))
    refs = dl.das_power(pw[:, 0, span - 2:span - 2 + t], divisor=t - 2)
    ops = (xyz, bp.contiguous(), pw.contiguous(), rows,
           torch.as_tensor(jumps, device=device),
           torch.as_tensor(resets, device=device), refs.contiguous())
    kw = dict(kw)
    kw["block_index0"] = kw.pop("block_index")
    return ops, kw


def compare_chunk(channels: int, compute: str, device):
    """The chunk kernel (``swarm_chunk``, CHUNK blocks) against its twin and
    against CHUNK launches of the single-block kernel on the same operands.

    - Each block k against one twin block from the state the kernel carried
      into it, held to the full-chain bounds of :func:`compare_kernel`.
      (Chained over 12 bf16 blocks, twin and kernel seekers drift apart by
      up to 0.4 rad at 256 mics: bf16 rounding is discontinuous and the
      seekers explore; the published rows and flags stay together.)
    - Against CHUNK launches of K1 (the same device code, the operands
      carried between launches by the twin's carry): tracking flags equal,
      every row's direction within 1e-5 rad.

    Returns the worst published-row error vs the twin ``err``, the K2 and
    twin ms, and the bound of the 12 blocks' work."""
    import torch

    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk

    ops, kw = chunk_operands(channels, compute, device)
    counts = []
    got = ctk.swarm_chunk(*ops, **kw)
    repeated = ctk.swarm_chunk_reference(*ops, chain=ctk.swarm_chain, **kw)
    tol = full_chain_tol(compute)
    worst = dict.fromkeys(tol, 0.0)
    rows = ops[3]
    for k in range(CHUNK):
        one = ops[:1] + tuple(x[k:k + 1] for x in ops[1:3]) + (rows,) + tuple(
            x[k:k + 1] for x in ops[4:])
        want = ctk.swarm_chunk_reference(
            *one, **dict(kw, block_index0=kw["block_index0"] + k),
            active_counts=counts)
        errs = chain_errors([o[k].cpu().numpy() for o in got],
                            [o[0].cpu().numpy() for o in want], tol,
                            f"{channels} mics {compute} chunk block {k}")
        worst = {n: max(worst[n], e) for n, e in errs.items()}
        rows = ctk.carry_rows(rows, got[0][k])
    gs, rs = got[0].cpu().numpy(), repeated[0].cpu().numpy()
    if not np.array_equal(gs[:, 6], rs[:, 6]):
        raise AssertionError(f"chunk vs repeated K1 flags differ at {channels} "
                             f"mics {compute}")
    rep = max(_angle(gs[k, 0], gs[k, 1], rs[k, 0], rs[k, 1]) for k in range(CHUNK))
    bitwise = all(torch.equal(a, b) for a, b in zip(got, repeated))
    if not rep <= 1e-5:
        raise AssertionError(f"chunk vs repeated K1 direction {rep:.3g} > 1e-5 "
                             f"at {channels} mics {compute}")
    c, t_len, p = ops[0].shape[1], ops[2].shape[-1] - kw["span"], rows.shape[1]
    bound_ms, bound_by = bound(
        _probe_flops(sum(counts), c, 2, t_len - 2) + CHUNK * 2.0 * c * 2 * t_len,
        _nbytes(*ops) + 4 * CHUNK * (ctk.STATE_ROWS * p + 1 + t_len))
    ms = _cuda_ms(lambda: ctk.swarm_chunk(*ops, **kw), 20)
    plain_ms = _cuda_ms(lambda: ctk.swarm_chunk_reference(*ops, **kw), 2)
    k1_ms = _cuda_ms(
        lambda: ctk.swarm_chunk_reference(*ops, chain=ctk.swarm_chain, **kw), 5)
    print(f"chunk vs twin {channels:3d} mics {compute:8s} {CHUNK} blocks, worst "
          "block: " + "  ".join(f"{k} {e:.3g} (tol {tol[k]:g})"
                                for k, e in worst.items())
          + f"; vs {CHUNK} x K1: flags equal, direction {rep:.3g} (tol 1e-5), "
          f"bitwise equal {bitwise}", flush=True)
    print(f"  time per launch: K2 {ms:.4f} ms, twin {plain_ms:.4f} ms, "
          f"{CHUNK} x K1 {k1_ms:.4f} ms; bound {bound_ms * 1e3:.3f} us "
          f"({bound_by}, {sum(counts)} active rows)", flush=True)
    return dict(err=worst["pub"], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


POWER_ROWS = (16384, 32768, 16397)   # 4 and 8 heatmaps of 64 x 64; a ragged tail


def power_operands(rows: int, compute: str, device):
    """[rows, 161] planes in ``compute`` and the [161, 256] f32 power
    matrix halves, as ``_power_stage`` passes them to ``power_matmul``."""
    import torch

    g = torch.Generator(device=device).manual_seed(rows)
    dtype = getattr(torch, compute)
    a_re, a_im = (torch.randn((rows, 161), generator=g, device=device).to(dtype)
                  for _ in range(2))
    pc, ps = (0.05 * torch.randn((161, 256), generator=g, device=device)
              for _ in range(2))
    return a_re, a_im, pc, ps


def compare_power(rows: int, compute: str, device):
    """The power-stage kernel (``power_matmul``) against its twin on
    :func:`power_operands`.  Both take the same bf16-rounded (or f32)
    inputs with f32 products and differ only in summation order: powers
    within 2e-5 of the largest.  Prints the launch plan.  Returns the max
    abs error ``err``, the kernel's and twin's ms (one call each, the
    rounding of pc/ps included), the bound, the ms of the library's product
    alone (``torch.matmul`` of ``[a_re | a_im]`` by ``[pow_cos ; pow_msin]``
    in the planes' type, without the square-sum) and of the fused path on
    the same rows (``fused_ms``: the cat, the einsum of the rounded operands
    in f32, the square-sum)."""
    import torch

    from beamforming_lk_tpu_torch.ops import fft_das as fd

    dtype = getattr(torch, compute)
    a_re, a_im, pc, ps = power_operands(rows, compute, device)
    plan = fd.power_matmul_plan(rows, 161, 256, dtype)
    print(f"power_matmul plan {rows:5d} rows {compute:8s}: grid {plan['grid']} x "
          f"{plan['threads']} threads, cluster {plan['cluster']}, {plan['tiles']} "
          f"tiles of {plan['tile_rows']} rows, K {plan['k_pad']} (im from "
          f"{plan['im_k0']}), a ring of {plan['a_tiles']} A tiles, "
          f"{plan['smem_bytes']} bytes of shared memory", flush=True)
    got = fd.power_matmul(a_re, a_im, pc, ps)
    want = fd.power_matmul_reference(a_re, a_im, pc, ps)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    rel = err / float(want.abs().max())
    if not (got.shape == want.shape and torch.isfinite(got).all() and rel <= 2e-5):
        raise AssertionError(f"power kernel vs twin {rel:.3g} > 2e-5 at "
                             f"{rows} rows {compute}")
    f, t_len = pc.shape
    bound_ms, bound_by = bound(4.0 * rows * f * t_len + 3.0 * rows * t_len,
                               _nbytes(a_re, a_im, pc, ps) + 4 * rows,
                               PEAK_FLOPS[compute])
    ms = _cuda_ms(lambda: fd.power_matmul(a_re, a_im, pc, ps), 50)
    plain_ms = _cuda_ms(lambda: fd.power_matmul_reference(a_re, a_im, pc, ps), 50)
    a_cat = torch.cat([a_re, a_im], dim=1)
    pow_ri = torch.cat([pc, ps], dim=0)
    w_cat = pow_ri.to(dtype)
    library_ms = _cuda_ms(lambda: torch.matmul(a_cat, w_cat), 50)

    def fused():
        bp = torch.einsum("rf,ft->rt", torch.cat([a_re, a_im], dim=1).float(),
                          pow_ri.to(dtype).float())
        return torch.sum(bp * bp, dim=-1)

    fused_ms = _cuda_ms(fused, 50)
    print(f"power kernel vs twin {rows:5d} rows {compute:8s}: max abs {err:.3g}, "
          f"{rel:.3g} of the largest (tol 2e-5); kernel {ms:.4f} ms, twin "
          f"{plain_ms:.4f} ms, torch.matmul alone {library_ms:.4f} ms, fused "
          f"path {fused_ms:.4f} ms; bound {bound_ms * 1e3:.3f} us ({bound_by}, "
          f"{bound_ms / ms:.1%} of it)", flush=True)
    return dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, fused_ms=fused_ms)


def _source_cell(cfg, direction=SOURCE):
    src_xyz = np.array([math.sin(direction[0]) * math.cos(direction[1]),
                        math.sin(direction[0]) * math.sin(direction[1]),
                        math.cos(direction[0])])
    rows, cols = cfg.mimo.rows, cfg.mimo.columns
    sep = math.sin(math.radians(cfg.mimo.fov_degrees / 2)) / (rows / 2)
    want_c = round((src_xyz[0] + (cols - 1) * sep / 2) / sep)
    want_r = round((src_xyz[1] + (rows - 1) * sep / 2) / sep)
    return src_xyz, (want_r, want_c)


def check_map(what: str, cfg, powers) -> tuple:
    """The heatmap ``powers`` [D] is finite and peaks within one cell of
    the source; returns (peak cell, source cell)."""
    powers = powers.cpu().numpy()
    if not np.isfinite(powers).all():
        raise AssertionError(f"{what}: heatmap not finite")
    _, want = _source_cell(cfg)
    peak = divmod(int(np.argmax(powers)), cfg.mimo.columns)
    if max(abs(peak[0] - want[0]), abs(peak[1] - want[1])) > 1:
        raise AssertionError(f"{what}: heatmap peak at {peak}, source at {want}")
    return peak, want


def check_lock(what: str, cfg, pipe, beam, powers) -> str:
    """A finite non-zero MISO beam, a published target within 5 deg of the
    source, and the heatmap peak on it; returns a line describing them."""
    beam = beam.cpu().numpy()
    if not (np.isfinite(beam).all() and np.abs(beam).max() > 0):
        raise AssertionError(f"{what}: MISO beam not finite/non-zero")
    tgts = pipe.targets()
    src_xyz, _ = _source_cell(cfg)
    off = [math.degrees(math.acos(min(1.0, float(np.dot(src_xyz, [
        math.sin(t["theta"]) * math.cos(t["phi"]),
        math.sin(t["theta"]) * math.sin(t["phi"]), math.cos(t["theta"])])))))
        for t in tgts]
    if not off or min(off) > 5.0:
        raise AssertionError(f"{what}: no target within 5 deg: {tgts}")
    peak, want = check_map(what, cfg, powers)
    return (f"target {min(off):.2f} deg off, heatmap peak {peak} vs source "
            f"{want}, beam peak {np.abs(beam).max():.4g}")


def _plane_wave_blocks(pipe, cfg, seed: int, device, n: int = N_BLOCKS,
                       direction=SOURCE):
    """``n`` consecutive blocks [n, C, T] at ``pipe``'s mics of a noisy
    5 kHz plane wave from ``direction`` (theta, phi), noise drawn from
    ``seed``, on ``device``."""
    import torch

    from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block

    rng = np.random.default_rng(seed)
    return torch.as_tensor(np.stack([
        plane_wave_block(pipe.points, [(direction[0], direction[1], 5000.0)],
                         i * 256, 256, cfg.array, noise_std=0.02, rng=rng)
        for i in range(n)
    ]), device=device)


def run_slice(channels: int, device):
    """96 plane-wave blocks through the realtime profile, block by block;
    returns (K1 launches, ms per block on the device clock, host
    ms/block).  At 256 mics it then measures the per-block latency
    (``process_block`` + synchronize, host clock) over
    LIVE_LATENCY_BLOCKS more blocks and prints its median and p99."""
    import torch

    from beamforming_lk_tpu_torch import Config, realtime
    from beamforming_lk_tpu_torch.app import AwpuPipeline

    cfg = realtime(Config())
    pipe = AwpuPipeline(cfg, channels=channels, seed=0, device=device)
    blocks = _plane_wave_blocks(pipe, cfg, channels, device)
    warm = 16
    _reset_counts()
    last_map = None
    for i in range(N_BLOCKS):
        if i == warm:
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            h0 = time.perf_counter()
        out = pipe.process_block(blocks[i])
        if i % cfg.mimo.heatmap_every == 0:
            last_map = out.powers
    e1 = torch.cuda.Event(enable_timing=True)
    e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3 / (N_BLOCKS - warm)
    ms = e0.elapsed_time(e1) / (N_BLOCKS - warm)
    counts = _counts(swarm_chain=N_BLOCKS)
    lock = check_lock(f"{channels} mics live", cfg, pipe, out.miso_beam, last_map)
    print(f"live slice {channels:3d} mics: {counts['swarm_chain']} K1 launches / "
          f"{N_BLOCKS} blocks, {lock}; {ms:.4f} ms/block device, "
          f"{host_ms:.4f} ms/block host (budget {BUDGET_MS:.2f} ms)", flush=True)
    if channels == 256:
        lat = []
        for i in range(LIVE_LATENCY_BLOCKS):
            t = time.perf_counter()
            pipe.process_block(blocks[i % N_BLOCKS])
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
        print(f"live slice 256 mics latency over {LIVE_LATENCY_BLOCKS} blocks: "
              f"median {np.median(lat):.4f} ms, p99 {np.percentile(lat, 99):.4f} "
              f"ms per block (budget {BUDGET_MS:.2f} ms)", flush=True)
    return counts["swarm_chain"], ms, host_ms


def run_replay(channels: int, device):
    """The replay path: the realtime profile (fused_chunk 12) on 96
    plane-wave blocks through ``process_blocks``, 24 then 72 blocks (the
    second call is timed).  K2 must launch once per 12 blocks and K1 never.
    The first 24 blocks are held against ``process_block`` from the same
    seed: equal flags, directions within 1e-5 rad, powers within 1e-4 of
    the peak.  Returns (K2 launches, device ms/block, host ms/block)."""
    import torch

    from beamforming_lk_tpu_torch import Config, realtime
    from beamforming_lk_tpu_torch.app import AwpuPipeline

    cfg = realtime(Config())
    pipe = AwpuPipeline(cfg, channels=channels, seed=0, device=device)
    blocks = _plane_wave_blocks(pipe, cfg, channels, device)
    head = 24
    _reset_counts()
    first = pipe.process_blocks(blocks[:head])
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    h0 = time.perf_counter()
    out = pipe.process_blocks(blocks[head:])
    e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3 / (N_BLOCKS - head)
    ms = e0.elapsed_time(e1) / (N_BLOCKS - head)
    counts = _counts(swarm_chunk=N_BLOCKS // CHUNK)
    lock = check_lock(f"{channels} mics replay", cfg, pipe, out.miso_beam[-1],
                      out.powers[-1])

    ref = AwpuPipeline(cfg, channels=channels, seed=0, device=device)
    worst = dict(direction=0.0, powers=0.0)
    for i in range(head):
        b = ref.process_block(blocks[i])
        if not torch.equal(first.targets.valid[i], b.targets.valid):
            raise AssertionError(f"{channels} mics replay block {i}: flags "
                                 "differ from process_block")
        worst["direction"] = max(worst["direction"], _angle(
            first.targets.theta[i].cpu(), first.targets.phi[i].cpu(),
            b.targets.theta.cpu(), b.targets.phi.cpu()))
        worst["powers"] = max(worst["powers"], float(
            (first.powers[i] - b.powers).abs().max() / b.powers.abs().max()))
    if not (worst["direction"] <= 1e-5 and worst["powers"] <= 1e-4):
        raise AssertionError(f"{channels} mics replay vs process_block: {worst}")
    print(f"replay slice {channels:3d} mics: {counts['swarm_chunk']} K2 launches, "
          f"0 K1 / {N_BLOCKS} blocks, {lock}; first {head} blocks vs "
          f"process_block: flags equal, direction {worst['direction']:.3g}, "
          f"powers {worst['powers']:.3g}; {ms:.4f} ms/block device, "
          f"{host_ms:.4f} ms/block host", flush=True)
    return counts["swarm_chunk"], ms, host_ms


def run_chunked_heatmap(device):
    """The chunked heatmap at 256 mics on a 64 x 64 grid over 8 windows, as
    ``bench.py``'s chunked variant runs it: ``power_path="pallas"`` (one K3
    launch for all 8 x 4096 rows) against ``"fused"``, powers within 1e-4
    of the peak and on the source; then the heatmap-only replay
    (``heatmap_chunk=8``, a map per block) on 96 blocks.  Returns (K3
    launches, K3 path ms, fused path ms)."""
    import torch

    from beamforming_lk_tpu_torch import Config, realtime
    from beamforming_lk_tpu_torch.app import AwpuPipeline
    from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block
    from beamforming_lk_tpu_torch.ops import antenna as ant
    from beamforming_lk_tpu_torch.ops import fft_das as fd

    cfg = realtime(Config())
    dsp, n_win = cfg.dsp, 8
    pts = ant.multi_array_cluster(256)
    models = {pp: fd.make_fft_heatmap_model(pts, cfg.mimo, dsp, cfg.array,
                                            compute=dsp.compute, power_path=pp,
                                            device=device)
              for pp in ("pallas", "fused")}
    stream = plane_wave_block(pts, [SOURCE], 0, dsp.shift_range + n_win * 256,
                              cfg.array, noise_std=0.02,
                              rng=np.random.default_rng(8))
    windows = torch.as_tensor(stream, device=device).unfold(
        -1, dsp.shift_range + 256, 256).movedim(-2, 0)
    _reset_counts()
    got = fd.fft_heatmap_powers_chunked(windows, models["pallas"])
    torch.cuda.synchronize()
    counts = _counts(power_matmul=1)
    want = fd.fft_heatmap_powers_chunked(windows, models["fused"])
    err = float((got - want).abs().max() / want.abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"chunked heatmap pallas vs fused {err:.3g} > 1e-4")
    for i in range(n_win):
        check_map(f"chunked heatmap window {i}", cfg, got[i])
    ms = _cuda_ms(lambda: fd.fft_heatmap_powers_chunked(windows, models["pallas"]), 20)
    fused_ms = _cuda_ms(lambda: fd.fft_heatmap_powers_chunked(windows, models["fused"]), 20)
    print(f"chunked heatmap 256 mics {n_win} x 64x64 {dsp.compute}: 1 K3 launch, "
          f"pallas vs fused {err:.3g} of the peak (tol 1e-4), peaks on the source; "
          f"{ms:.4f} ms per call through K3, {fused_ms:.4f} ms fused", flush=True)

    hcfg = dataclasses.replace(cfg, mimo=dataclasses.replace(
        cfg.mimo, heatmap_every=1, heatmap_chunk=n_win))
    pipe = AwpuPipeline(hcfg, channels=256, enable_tracker=False,
                        enable_miso=False, device=device)
    if pipe.step.chunk != n_win:
        raise AssertionError(f"heatmap-only replay chunk {pipe.step.chunk}")
    blocks = _plane_wave_blocks(pipe, hcfg, 256, device)
    head = 16
    pipe.process_blocks(blocks[:head])
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    h0 = time.perf_counter()
    out = pipe.process_blocks(blocks[head:])
    e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3 / (N_BLOCKS - head)
    hm_ms = e0.elapsed_time(e1) / (N_BLOCKS - head)
    peak, src = check_map("heatmap-only replay", hcfg, out.powers[-1])
    if out.miso_beam.any() or out.targets.valid.any():
        raise AssertionError("heatmap-only replay published a target or a beam")
    print(f"heatmap-only replay 256 mics, chunks of {n_win}: peak {peak} vs "
          f"source {src}; {hm_ms:.4f} ms/block device, {host_ms:.4f} ms/block "
          "host", flush=True)
    return counts["power_matmul"], ms, fused_ms


PHAT_TONES = (1000.0, 2500.0, 4000.0, 5500.0, 7000.0, 8500.0, 10000.0, 12000.0)
# Phase d's source [m] and arrays.  The source sits 19-22 deg off both
# arrays' boresight: at (0.4, 0.6, 6.0) it would be 8 deg off the +1 m
# array's, inside its 5 kHz main lobe at 256 mics, where the swarm's
# seekers can stick at theta = 0 (the phi step divides by sin theta) and
# never lock (3 of 9 torch seeds and 8 of 12 JAX seeds locked in 96
# blocks; at (0.4, 2.0, 6.0) 16 of 16 torch seeds locked within 6).
FUSION_TARGET = (0.4, 2.0, 6.0)
FUSION_ARRAYS = ((-1.0, 0.0, 0.0), (1.0, 0.0, 0.0))
# The fused position's distance from the source that phase d allows: 10x
# the 0.0029 m of the same phase on the CPU (the kernels' twins); a
# published direction may differ from the twin's by 1e-3 rad (phase 3's
# bound), ~6 mm at 6.3 m.
FUSION_BOUND_M = 0.03


def run_phat_lattice(device):
    """The heatmap's SRP-PHAT and lattice-ordered models at 256 mics on a
    64 x 64 grid, bf16, over 8 windows of a broadband source (tones from
    SOURCE's direction), through ``fft_heatmap_powers_chunked``: the
    lattice-ordered model, PHAT, and PHAT + lattice-ordered.  For each,
    the ``"pallas"`` run is one K3 launch and agrees with ``"fused"`` within
    1e-4 of the peak, and its maps peak on the source.  The lattice models,
    fed the windows reordered by ``channel_perm``, agree with the plain
    models on the raw windows within 1e-5 of the peak; under PHAT that holds
    in f32 (the bf16 plain model rounds the spectra before its permutation
    product, and the lattice model does not, as in the JAX package, which
    moves the bf16 maps ~2e-3 apart, a bf16 ulp: bounded at 4e-3).  Returns (K3
    launches, {model: (K3 path ms, fused ms)})."""
    import torch

    from beamforming_lk_tpu_torch import Config, realtime
    from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block
    from beamforming_lk_tpu_torch.ops import antenna as ant
    from beamforming_lk_tpu_torch.ops import fft_das as fd

    cfg = realtime(Config())
    dsp, n_win = cfg.dsp, 8
    pts = ant.multi_array_cluster(256)
    stream = plane_wave_block(pts, [(SOURCE[0], SOURCE[1], f) for f in PHAT_TONES],
                              0, dsp.shift_range + n_win * 256, cfg.array,
                              noise_std=0.02, rng=np.random.default_rng(9))
    windows = torch.as_tensor(stream, device=device).unfold(
        -1, dsp.shift_range + 256, 256).movedim(-2, 0)

    def model(phat, lattice, power_path, compute=dsp.compute):
        return fd.make_fft_heatmap_model(
            pts, dataclasses.replace(cfg.mimo, phat=phat), dsp, cfg.array,
            compute=compute, power_path=power_path,
            assume_lattice_order=lattice, device=device)

    launches, times = 0, {}
    for name, phat, lattice in (("lattice", False, True), ("phat", True, False),
                                ("phat+lattice", True, True)):
        pal, fus = model(phat, lattice, "pallas"), model(phat, lattice, "fused")
        wins = windows if pal.channel_perm is None else \
            windows[:, torch.as_tensor(pal.channel_perm, device=device)]
        _reset_counts()
        got = fd.fft_heatmap_powers_chunked(wins, pal)
        torch.cuda.synchronize()
        launches += _counts(power_matmul=1)["power_matmul"]
        want = fd.fft_heatmap_powers_chunked(wins, fus)
        err = float((got - want).abs().max() / want.abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"{name} heatmap pallas vs fused {err:.3g} > 1e-4")
        for i in range(n_win):
            check_map(f"{name} heatmap window {i}", cfg, got[i])
        line = f"pallas vs fused {err:.3g} of the peak (tol 1e-4)"
        if lattice:
            checks = [(dsp.compute, 4e-3 if phat else 1e-5)]
            if phat:
                checks.append(("float32", 1e-5))
            for compute, tol in checks:
                lat = fd.fft_heatmap_powers_chunked(
                    wins, model(phat, True, "fused", compute))
                ref = fd.fft_heatmap_powers_chunked(
                    windows, model(phat, False, "fused", compute))
                lerr = float((lat - ref).abs().max() / ref.abs().max())
                if not lerr <= tol:
                    raise AssertionError(f"{name} vs the plain model ({compute}) "
                                         f"{lerr:.3g} > {tol}")
                line += (f"; vs the plain model on raw windows ({compute}) "
                         f"{lerr:.3g} (tol {tol:g})")
        ms = _cuda_ms(lambda: fd.fft_heatmap_powers_chunked(wins, pal), 20)
        fused_ms = _cuda_ms(lambda: fd.fft_heatmap_powers_chunked(wins, fus), 20)
        times[name] = (ms, fused_ms)
        print(f"{name} heatmap 256 mics {n_win} x 64x64 {dsp.compute}: 1 K3 launch, "
              f"{line}; peaks on the source; {ms:.4f} ms per call through K3, "
              f"{fused_ms:.4f} ms fused", flush=True)
    return launches, times


def run_calibration(device):
    """Startup calibration at 256 mics on the realtime profile: the first 4
    blocks (one ring) with mic 21 zeroed through ``calibrate``.  The mask
    drops mic 21 and keeps >= 250 mics; the card's ``CalibrationResult``
    equals the CPU's on the same history within rtol 1e-6; the rebuilt
    step keeps the fft heatmap with its dead-channel term.  Then 96 blocks
    (K1 per block, lock, ms/block), then ``calibrate(apply_gains=True)``
    on the carried history: a gain mask, so the dense fallback (K4 on
    every 3rd block) on 48 more blocks, locked.  Returns (K1 launches, K4
    launches, ms/block)."""
    import torch

    from beamforming_lk_tpu_torch import Config, realtime
    from beamforming_lk_tpu_torch.app import AwpuPipeline
    from beamforming_lk_tpu_torch.models import calibration as cal

    cfg = realtime(Config())
    pipe = AwpuPipeline(cfg, channels=256, seed=0, device=device)
    blocks = _plane_wave_blocks(pipe, cfg, 21, device, 4 + N_BLOCKS + 48)
    first = blocks[:4].clone()
    first[:, 21] = 0.0
    _reset_counts()
    result = pipe.calibrate(first)
    mask = result.mask.cpu().numpy()
    if mask[21] != 0.0 or mask.sum() < 250:
        raise AssertionError(f"calibration kept mic 21 or dropped too many: "
                             f"{int(mask.sum())} mics")
    want = cal.calibrate(pipe.state.history.cpu())
    worst = 0.0
    for field in dataclasses.fields(want):
        a = getattr(result, field.name).cpu().double()
        b = getattr(want, field.name).double()
        worst = max(worst, float(((a - b).abs() / b.abs().clamp(min=1e-30)).max()))
    if not worst <= 1e-6:
        raise AssertionError(f"calibration card vs CPU {worst:.3g} > 1e-6")
    model = pipe.step.fft_model
    if model is None or model.dead_chan.tolist() != [21]:
        raise AssertionError("the calibrated step lost the fft heatmap's dead term")
    _counts(swarm_chain=4)
    _reset_counts()
    out, ms, host_ms = _timed_blocks(pipe, blocks[4:4 + N_BLOCKS], 16)
    k1 = _counts(swarm_chain=N_BLOCKS)["swarm_chain"]
    last_map = pipe.state.powers
    lock = check_lock("calibrated 256 mics", cfg, pipe, out.miso_beam, last_map)
    print(f"calibration 256 mics: mic 21 masked, {int(mask.sum())} mics kept "
          f"(tol >= 250), card vs CPU {worst:.3g} (tol 1e-6); {k1} K1 launches / "
          f"{N_BLOCKS} blocks, {lock}; {ms:.4f} ms/block device, {host_ms:.4f} "
          "ms/block host", flush=True)
    gains = pipe.calibrate(apply_gains=True)
    if pipe.step.mimo_model is None:
        raise AssertionError("apply_gains did not fall back to the dense heatmap")
    _reset_counts()
    n = 48
    out, gain_ms, _ = _timed_blocks(pipe, blocks[4 + N_BLOCKS:], 12)
    k4 = n // cfg.mimo.heatmap_every
    counts = _counts(swarm_chain=n, das_beam=k4)
    lock = check_lock("gain-calibrated 256 mics", cfg, pipe, out.miso_beam,
                      pipe.state.powers)
    print(f"  apply_gains ({int(gains.usable)} mics, gains "
          f"{float(gains.gains[gains.mask > 0].min()):.4g}-"
          f"{float(gains.gains.max()):.4g}): dense fallback, {counts['swarm_chain']} "
          f"K1 + {counts['das_beam']} K4 launches / {n} blocks, {lock}; "
          f"{gain_ms:.4f} ms/block device", flush=True)
    return k1 + n + 4, k4, ms


def _same(a, b) -> bool:
    """Bitwise equality of two trees of tensors and host values."""
    import torch

    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def run_save_restore(device):
    """Save and restore on the card (realtime, 64 mics): 12 blocks (one
    chunk, so the next block starts on the decimation phase), ``save``,
    ``restore`` into a pipeline built with another seed; the next 12
    blocks once through ``process_block`` (12 K1 launches) and once as one
    ``process_blocks`` chunk (one K2 launch) are bitwise equal to the
    uninterrupted pipeline's outputs and final state.  Returns (K1
    launches, K2 launches)."""
    import os
    import tempfile

    from beamforming_lk_tpu_torch import Config, realtime
    from beamforming_lk_tpu_torch.app import AwpuPipeline

    cfg = realtime(Config())
    k1 = k2 = 0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        for replay in (False, True):
            pipe = AwpuPipeline(cfg, channels=64, seed=0, device=device)
            blocks = _plane_wave_blocks(pipe, cfg, 12, device, 2 * CHUNK)
            pipe.process_blocks(blocks[:CHUNK])
            pipe.save(path)
            restored = AwpuPipeline(cfg, channels=64, seed=1, device=device)
            restored.restore(path)
            if not _same(restored.state, pipe.state):
                raise AssertionError("the restored state differs from the saved one")
            outs = []
            for p in (pipe, restored):
                _reset_counts()
                outs.append(p.process_blocks(blocks[CHUNK:]) if replay else
                            [p.process_block(b) for b in blocks[CHUNK:]])
                if replay:
                    k2 += _counts(swarm_chunk=1)["swarm_chunk"]
                else:
                    k1 += _counts(swarm_chain=CHUNK)["swarm_chain"]
            if not (_same(outs[1], outs[0]) and _same(restored.state, pipe.state)):
                raise AssertionError(f"the restored pipeline's {'replay' if replay else 'live'} "
                                     "blocks differ from the uninterrupted one's")
    print(f"save/restore 64 mics: restored into another seed's pipeline, the next "
          f"{CHUNK} blocks bitwise equal to the uninterrupted run's, live ({CHUNK} "
          "K1 launches) and as one replay chunk (1 K2 launch), state included",
          flush=True)
    return k1, k2


def _triangulate_np(o1, d1, o2, d2, cfg):
    """The reference's triangulatePoint (triangulate.cpp:10-41) in float64
    numpy, one ray pair: the midpoint, or None where a gate fails."""
    o1, d1, o2, d2 = (np.asarray(v, np.float64) for v in (o1, d1, o2, d2))
    n = np.cross(d1, d2)
    nn = float(n @ n)
    if nn <= 1e-20:
        return None
    p1 = o1 + d1 * float(np.cross(d2, n) @ (o2 - o1)) / nn
    p2 = o2 + d2 * float(np.cross(d1, n) @ (o2 - o1)) / nn
    mid = (p1 + p2) / 2.0
    if (np.linalg.norm(p1 - p2) > cfg.distance_threshold
            or np.linalg.norm(mid) > cfg.max_range or p1[2] + p2[2] < cfg.min_z
            or mid[2] < cfg.near_z or np.linalg.norm(mid) > cfg.norm_limit):
        return None
    return mid


def fuse_two_arrays(device, n_blocks: int = N_BLOCKS, log_path=None):
    """Two realtime 256-mic pipelines at x = -1 and +1 m, each hearing a
    5 kHz plane wave from the direction of a source at FUSION_TARGET, in the
    published convention: the wave's (theta, phi) are those whose
    ``spherical_to_cartesian`` ray points at the source.  (The steering
    row's y is negated, u = (sin t cos p, -sin t sin p, cos t), so a wave
    made from world geometry would fuse at the source's mirror image in
    y.)  ``TargetFusion`` fuses their targets after every block, and writes
    its ray log to ``log_path`` where one is given.  Returns (the best
    track, its distance from the source [m], the worst distance of a best
    track hit in a step from the float64 numpy triangulation of that step's
    published rays, the steps so checked, the fusion step's median host
    ms)."""
    import torch

    from beamforming_lk_tpu_torch import Config, realtime
    from beamforming_lk_tpu_torch.app import AwpuPipeline
    from beamforming_lk_tpu_torch.models.fusion import TargetFusion, target_rays

    cfg = realtime(Config())
    target = np.asarray(FUSION_TARGET)
    fusion = TargetFusion(cfg.triangulation, log_path=log_path, device=device)
    pipes, streams = [], []
    for seed, pos in enumerate(FUSION_ARRAYS):
        d = target - np.asarray(pos)
        d /= np.linalg.norm(d)
        pipe = AwpuPipeline(cfg, channels=256, seed=seed, device=device)
        fusion.add_array(pipe, pos)
        pipes.append(pipe)
        streams.append(_plane_wave_blocks(pipe, cfg, 30 + seed, device, n_blocks,
                                          (math.acos(d[2]), math.atan2(d[1], d[0]))))
    step_ms, worst, checked = [], 0.0, 0
    for i in range(n_blocks):
        for pipe, blocks in zip(pipes, streams):
            pipe.process_block(blocks[i])
        if device != "cpu":
            torch.cuda.synchronize()
        now = i * 256 / cfg.array.sample_rate
        h0 = time.perf_counter()
        best = fusion.step(now)
        step_ms.append((time.perf_counter() - h0) * 1e3)
        if best is not None and best.time_last_hit == now:
            rays = [target_rays(p.targets(), pos)
                    for p, pos in zip(pipes, FUSION_ARRAYS)]
            pts = [_triangulate_np(o1, d1, o2, d2, cfg.triangulation)
                   for o1, d1 in zip(*rays[0]) for o2, d2 in zip(*rays[1])]
            pts = [p for p in pts if p is not None]
            if not pts:
                raise AssertionError(f"block {i}: a track was hit but numpy "
                                     "triangulates no valid pair")
            worst = max(worst, min(float(np.linalg.norm(best.position - p))
                                   for p in pts))
            checked += 1
    fusion.close()
    if best is None or best.hits < 2:
        raise AssertionError(f"fusion found no track with 2 hits: {best}")
    return (best, float(np.linalg.norm(best.position - target)), worst, checked,
            float(np.median(step_ms[8:])))


def run_fusion(device):
    """Phase d on the card: :func:`fuse_two_arrays` for 96 blocks, K1 once
    per block per array; the best track within FUSION_BOUND_M of the
    source; every best-track hit within 1e-5 m of the numpy triangulation
    of the same published rays; then :func:`run_track_replay` of the
    phase's ray log.  Returns (K1 launches, median fusion step ms)."""
    import tempfile

    _reset_counts()
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "Targets.txt")
        best, err, worst, checked, step_ms = fuse_two_arrays(device, log_path=log)
        counts = _counts(swarm_chain=2 * N_BLOCKS)
        replayed = run_track_replay(log, device)
    if not err <= FUSION_BOUND_M:
        raise AssertionError(f"fused track {err:.4g} m from the source > "
                             f"{FUSION_BOUND_M} m")
    if not (checked and worst <= 1e-5):
        raise AssertionError(f"fused position vs numpy triangulation {worst:.3g} m "
                             f"> 1e-5 m over {checked} steps")
    print(f"fusion of two 256-mic arrays at x = -1, +1 m, {N_BLOCKS} blocks: "
          f"{counts['swarm_chain']} K1 launches; best track {np.round(best.position, 4)} "
          f"with {best.hits} hits, {err:.4g} m from the source {FUSION_TARGET} (tol "
          f"{FUSION_BOUND_M} m); vs numpy triangulation of the published rays "
          f"{worst:.3g} m over {checked} steps (tol 1e-5 m); fusion step "
          f"{step_ms:.4f} ms median (host clock, 2 target fetches)", flush=True)
    print(replayed, flush=True)
    return counts["swarm_chain"], step_ms


def run_track_replay(log: str, device) -> str:
    """Phase d's ray log through the port's ``tools.track_replay`` on
    ``device`` against the same tool on the CPU: valid flags equal, every
    intersection and track position within 1e-5 m, the tracks' hits and
    flags equal, the same best track, the same printed summary.  Times the
    whole replay on each (host clock, median of 5: the parse, one batched
    triangulation, one fetch, the track store).  Returns the phase's line."""
    import io

    from beamforming_lk_tpu_torch.tools import track_replay as tr

    def replay(dev):
        runs, ms = [], []
        for _ in range(5):
            printed = io.StringIO()
            h0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                runs.append(tr.replay(log, device=dev))
            ms.append((time.perf_counter() - h0) * 1e3)
        return runs[-1], printed.getvalue(), float(np.median(ms))

    (card, card_out, card_ms), (cpu, cpu_out, cpu_ms) = replay(device), replay("cpu")
    tracks = list(zip(card.store.tracks, cpu.store.tracks))
    pos = max([float(np.abs(card.points - cpu.points).max())]
              + [float(np.abs(a.position - b.position).max()) for a, b in tracks])
    best = [next((i for i, t in enumerate(r.store.tracks) if t is r.store.best), None)
            for r in (card, cpu)]
    if not (card.valid.any() and np.array_equal(card.valid, cpu.valid)
            and len(card.store.tracks) == len(cpu.store.tracks)
            and all((a.hits, a.valid) == (b.hits, b.valid) for a, b in tracks)
            and pos <= 1e-5 and best[0] == best[1] is not None
            and card_out == cpu_out):
        raise AssertionError(f"track replay {device} vs CPU: position {pos:.3g} m, "
                             f"best {best}\n{card_out}\n{cpu_out}")
    lines = card_out.splitlines()
    return (f"9d track replay of that ray log (tools.track_replay): {lines[0]}; "
            f"{lines[1]}; {lines[-1]}; {device} vs CPU: valid flags, tracks' hits "
            f"and the best track equal, worst position {pos:.3g} m (tol 1e-5 m); "
            f"{card_ms:.4f} ms on the card, {cpu_ms:.4f} ms on the CPU (the whole "
            f"replay, host clock, median of 5)")


# Phase 9e: the adaptive heatmaps.  The pipelines' estimator settings, by
# name; "music" is the subspace solver.
ADAPTIVE = {"mvdr": dict(heatmap_mode="mvdr"),
            "mvdr refresh 3": dict(heatmap_mode="mvdr", mvdr_refresh=3),
            "music": dict(heatmap_mode="music")}
ADAPTIVE_BLOCKS = 6                  # card vs CPU
EIGH_BLOCKS = 8
# Card vs CPU bounds, as in tests/test_torch_mvdr.py and test_torch_music.py:
# MVDR's powers through a Cholesky whose conditioning the 1e-3 loading
# bounds (rounding grows ~1e3-1e4x): 2e-3 relative.  MUSIC by its
# invariants: the argmax cell, correlation, and log10 outside the top 4
# cells; 1e-2 decades, as K = 3 above the one source puts the eigh split in
# the noise floor, whose eigenvectors cuSOLVER and LAPACK pick differently.
MVDR_RTOL = 2e-3
MUSIC_CORR, MUSIC_LOG10 = 0.999, 1e-2
SYNC_SPIN_MS = 200.0                 # the spin ahead of the calls whose syncs count


def _estimator(channels: int, device, solver: str = "", **kw):
    """(estimator, config, a namespace with its ``points``): the realtime
    profile's estimator on its 64 x 64 grid, MVDR or MUSIC with
    ``solver``."""
    import types

    from beamforming_lk_tpu_torch import Config, realtime
    from beamforming_lk_tpu_torch.models import music as mu
    from beamforming_lk_tpu_torch.models import mvdr as mv
    from beamforming_lk_tpu_torch.models.mimo import make_mimo_grid
    from beamforming_lk_tpu_torch.ops import antenna as ant

    cfg = realtime(Config())
    points = ant.multi_array_cluster(channels, 8, 8, 0.02)
    theta, phi = make_mimo_grid(cfg.mimo)
    if solver:
        step = mu.make_music_step(points, theta, phi, cfg.array, solver=solver,
                                  device=device, **kw)[0]
    else:
        step = mv.make_mvdr_step(points, theta, phi, cfg.array, device=device,
                                 **kw)[0]
    return step, cfg, types.SimpleNamespace(points=points)


def _hold_estimates(what: str, got, want, music: bool) -> str:
    """Card powers against the CPU's (the bounds above); returns a line."""
    got, want = (x.cpu().double().numpy() for x in (got, want))
    if not (np.isfinite(got).all() and got.argmax() == want.argmax()):
        raise AssertionError(f"{what}: card argmax {got.argmax()}, CPU {want.argmax()}")
    if music:
        corr = float(np.corrcoef(got, want)[0, 1])
        rest = np.argsort(want)[:-4]
        dlog = float(np.abs(np.log10(got[rest]) - np.log10(want[rest])).max())
        if not (corr > MUSIC_CORR and dlog <= MUSIC_LOG10):
            raise AssertionError(f"{what}: correlation {corr}, log10 {dlog}")
        return f"correlation {corr:.9f}, log10 off the top 4 cells {dlog:.3g}"
    rel = float((np.abs(got - want) / np.abs(want)).max())
    if not rel <= MVDR_RTOL:
        raise AssertionError(f"{what}: card vs CPU {rel:.3g} > {MVDR_RTOL}")
    return f"largest relative difference {rel:.3g} (tol {MVDR_RTOL})"


def adaptive_card_vs_cpu(device):
    """9e (a): each estimator on ``device`` and on the CPU over the same 6
    plane-wave blocks: MVDR, MUSIC subspace and MUSIC eigh at 64 mics,
    MVDR at 256."""
    for channels, name, solver in ((64, "mvdr", ""), (64, "music subspace", "subspace"),
                                   (64, "music eigh", "eigh"), (256, "mvdr", "")):
        (card, cfg, array), (host, _, _) = (_estimator(channels, dev, solver)
                                            for dev in (device, "cpu"))
        blocks = _plane_wave_blocks(array, cfg, channels, "cpu", ADAPTIVE_BLOCKS)
        out = []
        for step in (card, host):
            state = step.init()
            for blk in blocks:
                state, p = step(state, blk.to(step.v_emb.device))
            out.append(p.cpu())
        line = _hold_estimates(f"{name} {channels} mics", *out, bool(solver))
        peak = check_map(f"{name} {channels} mics card", cfg, out[0])[0]
        print(f"9e card vs CPU, {name}, {channels} mics, {ADAPTIVE_BLOCKS} blocks: "
              f"argmax equal, peak {peak}; {line}", flush=True)


def _syncs(fn) -> dict:
    """The host syncs of one call of ``fn`` after a warm one, under
    ``torch.cuda.set_sync_debug_mode("warn")`` (each "synchronizing CUDA
    operation" warning a sync torch makes), behind a SYNC_SPIN_MS spin
    kernel.  Returns the syncs, the first one's place, whether the host
    waited for the spin (a wait inside a library that torch does not see
    included) and the host's ms (its enqueue, where it did not wait).  One
    call launches at most a few hundred kernels, which the launch queue
    holds behind the spin."""
    import warnings

    import torch

    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(SYNC_SPIN_MS * 2e6))          # ~2e6 cycles/ms
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        h0 = time.perf_counter()
        try:
            fn()
        finally:
            host_ms = (time.perf_counter() - h0) * 1e3
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    syncs = [w for w in seen if "called a synchronizing" in str(w.message)]
    where = (f"{os.path.basename(syncs[0].filename)}:{syncs[0].lineno}"
             if syncs else "")
    return dict(n=len(syncs), where=where,
                waited=host_ms > 0.75 * SYNC_SPIN_MS, host_ms=host_ms)


def _sync_line(label: str, r: dict) -> str:
    return (f"{label} {r['n']}{' at ' + r['where'] if r['where'] else ''} "
            f"(host waited: {r['waited']}; host {r['host_ms']:.4f} ms)")


def _spun_ms(calls) -> float:
    """Mean device ms of each of ``calls`` (run in order), each behind a
    ~20 ms spin kernel that holds the device while the host enqueues it,
    so that CUDA events time the device's work even where one call
    launches hundreds of kernels (a run of such calls fills the launch
    queue and is timed at the host's pace)."""
    import torch

    spans = []
    for fn in calls:
        torch.cuda._sleep(40_000_000)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        fn()
        e1.record()
        spans.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in spans) / len(spans)


def _estimator_ms(step, state, block, n: int = 6) -> float:
    """Device ms a block of ``n`` chained estimator calls (a refresh cycle's
    mean where the step decimates its solve)."""
    box = [state]

    def call():
        box[0], _ = step(box[0], block)
    return _spun_ms([call] * n)


def _stage_split(step, state, block) -> dict:
    """Device ms of the estimator's stages on a warm state: the covariance,
    the factorisation (Cholesky; QR rounds or eigh) and the direction
    stage."""
    from beamforming_lk_tpu_torch.models.mvdr import hermitian_embed

    cov = step.covariance(state, block)
    split = {"covariance": _spun_ms([lambda: step.covariance(state, block)] * 5)}
    if hasattr(step, "factor"):
        chol = step.factor(*cov)
        return {**split, "cholesky": _spun_ms([lambda: step.factor(*cov)] * 5),
                "directions": _spun_ms([lambda: step.directions(chol)] * 5)}
    m = hermitian_embed(*cov)
    sub = step.subspaces(m, state)
    return {**split, "subspaces": _spun_ms([lambda: step.subspaces(m, state)] * 5),
            "directions": _spun_ms([lambda: step.spectrum(*sub[:3])] * 5)}


def _adaptive_bound(step) -> tuple:
    """(ms, binding) of MVDR's least time (Cholesky and triangular solve
    operations, the steering planes' bytes) or MUSIC subspace's (its
    projection's operations, the same bytes), against the f32 peak."""
    f, d, c2 = step.n_bins, step.n_directions, 2 * step.channels
    nbytes = _nbytes(step.v_emb)
    if hasattr(step, "factor"):
        return bound(f * c2 ** 2 * d + f * c2 ** 3 / 3, nbytes)
    return bound(2.0 * f * d * c2 * 2 * step.n_sources, nbytes)


def run_adaptive(channels: int, device):
    """9e (b)-(d) at ``channels`` mics: for each of ADAPTIVE, the realtime
    pipeline with the tracker and MISO on over 96 plane-wave blocks through
    ``process_block`` (K1 once a block, the estimator's peak within one cell
    of the source), the whole block's ms; the estimator's ms a block from
    CUDA events around each of 6 chained calls of it alone and its stage
    split; the syncs of a call of the estimator and of a pipeline block,
    none allowed.  Returns (K1 launches, the
    ``process_block`` run's last MVDR powers)."""
    import torch

    from beamforming_lk_tpu_torch import Config, realtime
    from beamforming_lk_tpu_torch.app import AwpuPipeline

    cfg = realtime(Config())
    k1, mvdr_last = 0, None
    for name, kw in ADAPTIVE.items():
        pipe = AwpuPipeline(cfg, channels=channels, seed=0, device=device, **kw)
        blocks = _plane_wave_blocks(pipe, cfg, channels, device)
        _reset_counts()
        _, ms, host_ms = _timed_blocks(pipe, blocks, 16)
        k1 += _counts(swarm_chain=N_BLOCKS)["swarm_chain"]
        peak, want = check_map(f"9e {name} {channels} mics", cfg, pipe._mvdr_powers)
        img = pipe.heatmap()
        if divmod(int(img.argmax()), img.shape[1]) != peak:
            raise AssertionError(f"9e {name}: heatmap image peak differs from {peak}")
        if name == "mvdr":
            mvdr_last = pipe._mvdr_powers.clone()
        step, state = pipe._mvdr_step, pipe._mvdr_state
        est_ms = _estimator_ms(step, state, blocks[0])
        split = _stage_split(step, state, blocks[0])
        b_ms, b_by = _adaptive_bound(step)
        est = _syncs(lambda: step(state, blocks[0]))
        blk = _syncs(lambda: pipe.process_block(blocks[0]))
        _reset_counts()
        print(f"9e {name}, {channels} mics, realtime + tracker + MISO, {N_BLOCKS} "
              f"blocks: {N_BLOCKS} K1 launches; estimator peak {peak} vs source "
              f"{want}; block {ms:.4f} ms device, {host_ms:.4f} ms host (budget "
              f"{BUDGET_MS:.2f} ms); estimator alone {est_ms:.4f} ms a block "
              f"(bound {b_ms:.4f} ms, {b_by}; stages " + ", ".join(
                  f"{k} {v:.4f}" for k, v in split.items()) + " ms); syncs: "
              + _sync_line("estimator", est) + ", " + _sync_line("whole block", blk),
              flush=True)
        # MVDR and MUSIC's subspace solver wait on nothing: the counters are
        # host ints and the Cholesky's info stays on the card.
        for what, r in (("estimator", est), ("block", blk)):
            if r["n"] or r["waited"]:
                raise AssertionError(f"9e {name} {channels} mics: the {what} syncs: {r}")
    return k1, mvdr_last


def run_eigh(channels: int, device):
    """9e (e): MUSIC with ``solver="eigh"`` on 8 blocks, timed: device ms
    over the run (CUDA events) and host ms, the peak within one cell."""
    import torch

    step, cfg, array = _estimator(channels, device, "eigh")
    blocks = _plane_wave_blocks(array, cfg, channels, device, EIGH_BLOCKS)
    state = step.init()
    state, p = step(state, blocks[0])
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    h0 = time.perf_counter()
    for blk in blocks[1:]:
        state, p = step(state, blk)
    e1.record()
    torch.cuda.synchronize()
    n = EIGH_BLOCKS - 1
    host_ms = (time.perf_counter() - h0) * 1e3 / n
    peak, want = check_map(f"9e music eigh {channels} mics", cfg, p)
    sync = _syncs(lambda: step(state, blocks[0]))
    print(f"9e music eigh, {channels} mics, {EIGH_BLOCKS} blocks: peak {peak} vs "
          f"source {want}; {e0.elapsed_time(e1) / n:.4f} ms a block device, "
          f"{host_ms:.4f} ms host (budget {BUDGET_MS:.2f} ms); "
          + _sync_line("syncs", sync), flush=True)


def run_adaptive_replay(device, live_powers):
    """9e (f): MVDR at 256 mics with the tracker and MISO on, 96 blocks
    through ``process_blocks`` (24 then 72): K2 once per 12 blocks, no K1,
    and the estimator's last powers equal to the ``process_block`` run's
    (the same blocks, ``live_powers``) within 1e-6 relative.  Returns the
    K2 launches."""
    import torch

    from beamforming_lk_tpu_torch import Config, realtime
    from beamforming_lk_tpu_torch.app import AwpuPipeline

    cfg = realtime(Config())
    pipe = AwpuPipeline(cfg, channels=256, seed=0, device=device, heatmap_mode="mvdr")
    blocks = _plane_wave_blocks(pipe, cfg, 256, device)
    _reset_counts()
    pipe.process_blocks(blocks[:24])
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    pipe.process_blocks(blocks[24:])
    e1.record()
    torch.cuda.synchronize()
    counts = _counts(swarm_chunk=N_BLOCKS // CHUNK)
    rel = float(((pipe._mvdr_powers - live_powers).abs().max()
                 / live_powers.abs().max()))
    if not rel <= 1e-6:
        raise AssertionError(f"9e MVDR replay vs process_block: {rel:.3g}")
    check_map("9e mvdr replay 256 mics", cfg, pipe._mvdr_powers)
    print(f"9e mvdr replay, 256 mics, {N_BLOCKS} blocks: {counts['swarm_chunk']} K2 "
          f"+ 0 K1 launches; last powers vs process_block's {rel:.3g} relative "
          f"(bitwise: {torch.equal(pipe._mvdr_powers, live_powers)}); "
          f"{e0.elapsed_time(e1) / (N_BLOCKS - 24):.4f} ms a block device",
          flush=True)
    return counts["swarm_chunk"]


def das_operands(channels: int, device, interp: str = "linear"):
    """The default profile's heatmap model (the 64 x 64 grid's delay split
    at ``channels`` mics, linear or the FIR bank's) and a stack of 8
    windows [8, C, S+T] of a noisy plane wave, strided views of one stream
    as the ring gives them."""
    import torch

    from beamforming_lk_tpu_torch import Config
    from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block
    from beamforming_lk_tpu_torch.models.mimo import make_mimo_model
    from beamforming_lk_tpu_torch.ops import antenna as ant

    cfg = Config()
    s, t = cfg.dsp.shift_range, cfg.dsp.block_size
    pts = ant.multi_array_cluster(channels)
    model = make_mimo_model(pts, cfg.mimo,
                            dataclasses.replace(cfg.dsp, interp=interp),
                            cfg.array, device=device)
    stream = torch.as_tensor(plane_wave_block(
        pts, [SOURCE], 0, s + 8 * t, cfg.array, noise_std=0.05,
        rng=np.random.default_rng(channels)), device=device)
    return model, stream.unfold(-1, s + t, t).movedim(-2, 0)


def compare_das(channels: int, compute: str, device, interp: str = "linear",
                timing: bool = True):
    """The DAS-beam kernel (``das_beam``) against its twin on the heatmap's
    operands: the 64 x 64 grid's delay split at ``channels`` mics (linear,
    or FIR without timing), one window and a stack of 8 windows of a noisy
    plane wave.  Both round the same inputs and sum in f32 in other orders:
    beams within 1e-5 of the peak.  Returns the max abs error ``err`` and,
    with ``timing``, the kernel's and twin's ms and the bound of one
    window."""
    import torch

    from beamforming_lk_tpu_torch.ops import cuda_das as cd

    model, stack = das_operands(channels, device, interp)
    s, t = model.shift_range, stack.shape[-1] - model.shift_range
    worst = 0.0
    for what, x in (("1 window", stack[0]), ("8 windows", stack)):
        got = cd.das_beam(x, model.shift, model.tap_weights, span=s, compute=compute)
        want = cd.das_beam_reference(x, model.shift, model.tap_weights, span=s,
                                     compute=compute)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        if not (torch.isfinite(got).all() and rel <= 1e-5):
            raise AssertionError(f"das_beam vs twin {rel:.3g} > 1e-5 at {channels} "
                                 f"mics {compute} {what}")
        worst = max(worst, err) if what == "1 window" else worst
        print(f"das_beam vs twin {channels:3d} mics {compute:8s} {interp:6s} "
              f"{what:9s}: max abs {err:.3g}, {rel:.3g} of the peak (tol 1e-5)",
              flush=True)
    if not timing:
        return dict(err=worst)
    args = (model.shift, model.tap_weights)
    ms = _cuda_ms(lambda: cd.das_beam(stack[0], *args, span=s, compute=compute), 50)
    plain_ms = _cuda_ms(lambda: cd.das_beam_reference(stack[0], *args, span=s,
                                                      compute=compute), 20)
    ms8 = _cuda_ms(lambda: cd.das_beam(stack, *args, span=s, compute=compute), 20)
    plain8 = _cuda_ms(lambda: cd.das_beam_reference(stack, *args, span=s,
                                                    compute=compute), 5)
    d, c, taps = model.tap_weights.shape
    bound_ms, bound_by = bound(2.0 * d * c * taps * t,
                               _nbytes(stack[0], *args) + 4 * d * t)
    library_ms = _das_library(model, stack[0], compute, ms)
    plan = cd.das_beam_plan(1, d, c, t, s, taps)
    print(f"  tile plan: grid {plan['grid']} x {plan['threads']} threads, "
          f"{plan['dirs_per_block']} directions a block (one a warp, "
          f"{plan['run']} consecutive samples a lane), channel tiles of "
          f"{plan['channel_tile']} double-buffered, {plan['smem_bytes']} bytes "
          "of shared memory", flush=True)
    print(f"  time per call: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms; 8 windows: "
          f"kernel {ms8:.4f} ms, twin {plain8:.4f} ms; bound of one "
          f"{bound_ms * 1e3:.3f} us ({bound_by}, {bound_ms / ms:.1%} of it)",
          flush=True)
    return dict(err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def _das_library(model, window, compute: str, kernel_ms: float) -> float:
    """The library call for K4: the JAX package's ``das_beam``, one
    ``torch.matmul`` of the dense stencil [D, C*S] by the unfolded window
    [C*S, T], in ``compute`` (f32 without TF32, or bf16 with a bf16
    result), checked against the twin (1e-5 of the peak in f32, 1e-2 in
    bf16).  The unfold, a contiguous copy, is made outside the timed call;
    a second time takes it inside.  Returns the product's ms."""
    import torch

    from beamforming_lk_tpu_torch.ops import cuda_das as cd

    d, c, taps = model.tap_weights.shape
    s = model.shift_range
    t = window.shape[-1] - s
    dtype = torch.bfloat16 if compute == "bfloat16" else torch.float32
    stencil = torch.zeros((d, c, s), dtype=torch.float32, device=window.device)
    idx = model.shift.long()[..., None] + torch.arange(taps, device=window.device)
    stencil = stencil.scatter_(-1, idx, model.tap_weights).reshape(d, c * s).to(dtype)

    def unfolded():
        return window.unfold(-1, t, 1)[:, :s, :].reshape(c * s, t).to(dtype)

    unf = unfolded()
    got = torch.matmul(stencil, unf).float()
    want = cd.das_beam_reference(window, model.shift, model.tap_weights, span=s,
                                 compute=compute)
    rel = float((got - want).abs().max() / want.abs().max())
    tol = 1e-2 if compute == "bfloat16" else 1e-5
    if not rel <= tol:
        raise AssertionError(f"dense-stencil matmul vs twin {rel:.3g} > {tol}")
    lib_ms = _cuda_ms(lambda: torch.matmul(stencil, unf), 20)
    with_unfold = _cuda_ms(lambda: torch.matmul(stencil, unfolded()), 20)
    print(f"  library: torch.matmul of the dense stencil [{d}, {c * s}] by the "
          f"unfolded window [{c * s}, {t}] in {compute} (the JAX package's "
          f"das_beam), {rel:.3g} of the peak from the twin: {lib_ms:.4f} ms "
          f"with the unfold outside the timed call, {with_unfold:.4f} ms with "
          f"it inside; kernel {kernel_ms:.4f} ms "
          f"({'kernel' if kernel_ms < lib_ms else 'matmul'} faster)", flush=True)
    return lib_ms


def monopulse_operands(channels: int, compute: str, device,
                       interp: str = "linear"):
    """The monopulse-chain operands of :func:`compare_monopulse`: the
    geometry, the bandpassed window, the first 26 rows of
    :func:`chain_operands` as [8, 26] chain rows, a random 5 x 26 mask
    (the listener active in the first 3 sub-steps), and the keywords."""
    import torch

    ops, kw = chain_operands(channels, compute, device, interp=interp)
    xyz, bp, packed = ops[0], ops[1], ops[3]
    p = 26
    rows = torch.cat([packed[:6, :p], packed[8:10, :p]]).contiguous()
    mask = np.random.default_rng(channels).random((5, p)) > 0.3
    mask[:, N_TRACKERS] = [True, True, True, False, False]    # the listener
    ckw = dict(span=kw["span"], taps=kw["taps"], theta_limit=kw["theta_limit"],
               divisor=kw["divisor"], interp=interp,
               fir_phases=kw["fir_phases"])
    return xyz, bp, rows, mask, ckw


def compare_monopulse(channels: int, compute: str, device,
                      interp: str = "linear", timing: bool = True):
    """The monopulse-chain kernel (``monopulse_chain``) against its twin on
    the rows of :func:`chain_operands` (26 rows: trackers, listener,
    seekers) under a random 5 x 26 mask, and on the listener's row alone
    under 3 sub-steps (the MISO step).  Directions by great-circle angle.
    One sub-step: every row within 1e-5 rad, the other fields within 1e-4
    of their scale.  The chains: tracker and listener rows within the
    full-chain bounds of :func:`compare_kernel`, seekers within 5e-2 rad.
    Linear, or the FIR stencil without timing.  Returns the worst
    tracker/listener direction error ``err`` and, with ``timing``, the
    kernel's and twin's ms and the bound of the 26-row chain."""
    import torch

    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk

    xyz, bp, rows, mask, ckw = monopulse_operands(channels, compute, device,
                                                  interp)
    p = rows.shape[1]
    full = full_chain_tol(compute)
    listener = slice(N_TRACKERS, N_TRACKERS + 1)
    settings = (
        ("1 sub-step", rows, mask[:1], slice(0, p), slice(0, 0),
         dict(pub=1e-5, grad=1e-4)),
        ("26 rows", rows, mask, slice(0, N_TRACKERS + 1), slice(N_TRACKERS + 1, p),
         full),
        ("listener", rows[:, listener].contiguous(), np.ones((3, 1), bool),
         slice(0, 1), slice(0, 0), full),
    )
    worst = 0.0
    for label, r, m, pub, seek, tol in settings:
        plan = ctk.monopulse_chain_plan(xyz.shape[1], r.shape[1], bp.shape[1]
                                        - ckw["span"] + 2, ckw["span"],
                                        ckw["taps"], bp.element_size())
        print(f"monopulse_chain plan {channels:3d} mics {compute:8s} {interp:6s} "
              f"{label:10s}: "
              f"{plan['grid']} CTAs (one a row) x {plan['threads']} threads, "
              f"{plan['warps_per_probe']} warps a probe on {plan['segment']}-sample "
              "segments, window " + ("staged in shared memory" if plan["staged"]
                                     else "read from L2")
              + f" ({plan['window_bytes']} bytes), {plan['smem_bytes']} bytes of "
              "shared memory", flush=True)
        act = torch.as_tensor(m.astype(np.float32), device=device)
        got = ctk.monopulse_chain(xyz, bp, r, act, **ckw).cpu().numpy()
        want = ctk.monopulse_chain_reference(xyz, bp, r, act, **ckw).cpu().numpy()
        scale = lambda v: max(float(np.abs(v).max()), 1e-30)  # noqa: E731
        errs = {
            "pub": _angle(got[0, pub], got[1, pub], want[0, pub], want[1, pub]),
            "seek": (_angle(got[0, seek], got[1, seek], want[0, seek], want[1, seek])
                     if seek.stop > seek.start else 0.0),
            "grad": max(float(np.abs(got[i, pub] - want[i, pub]).max())
                        / scale(want[i, pub]) for i in range(2, 6)),
        }
        bounds = dict(pub=tol["pub"], seek=full["seek"], grad=tol["grad"])
        for name, e in errs.items():
            if not np.isfinite(e) or e > bounds[name]:
                raise AssertionError(f"monopulse_chain vs twin {name} error {e:.3g} > "
                                     f"{bounds[name]} at {channels} mics {compute} "
                                     f"{label}")
        if label == "26 rows":
            worst = errs["pub"]
        print(f"monopulse_chain vs twin {channels:3d} mics {compute:8s} {interp:6s} "
              f"{label:10s}: "
              + "  ".join(f"{k} {e:.3g} (tol {bounds[k]:g})" for k, e in errs.items()),
              flush=True)
    if not timing:
        return dict(err=worst)
    act = torch.as_tensor(mask.astype(np.float32), device=device)
    n_out = bp.shape[1] - ckw["span"]
    bound_ms, bound_by = bound(
        _probe_flops(int(mask.sum()), xyz.shape[1], 2, n_out),
        _nbytes(xyz, bp, rows, act) + 4 * ctk.CHAIN_STATE * p)
    ms = _cuda_ms(lambda: ctk.monopulse_chain(xyz, bp, rows, act, **ckw), 50)
    plain_ms = _cuda_ms(lambda: ctk.monopulse_chain_reference(xyz, bp, rows, act,
                                                              **ckw), 5)
    print(f"  time per call, 26 rows x 5 sub-steps: kernel {ms:.4f} ms, twin "
          f"{plain_ms:.4f} ms; bound {bound_ms * 1e3:.3f} us ({bound_by}, "
          f"{bound_ms / ms:.2%} of it)", flush=True)
    return dict(err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def default_config(rows: int = 64):
    """``Config()``, the CLI's default profile, on a rows x rows grid."""
    from beamforming_lk_tpu_torch import Config, MimoConfig

    return Config(mimo=MimoConfig(rows=rows, columns=rows))


def end_to_end_default(device):
    """6 blocks of the default profile (16x16 dense heatmap, 64 mics) on
    ``device`` and on the CPU from the same state with the same draws.
    Bounds: heatmap powers within 1e-4 of the peak, the listener's
    direction within 1e-4 rad and its beam within 1e-2 of the peak; both
    publish, their strongest targets within 0.05 rad.  (Over 10 iterations
    a seeker clamped at theta = 0, where phi is arbitrary, may take another
    path on each device, so the target sets are held functionally.)"""
    from beamforming_lk_tpu_torch.app import AwpuPipeline
    from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block

    cfg = default_config(16)
    pipes = [AwpuPipeline(cfg, channels=64, seed=0, device=d) for d in (device, "cpu")]
    pipes[1].state = _state_to(pipes[0].state, "cpu")
    rng = np.random.default_rng(6)
    tc = cfg.tracker
    worst = dict(powers=0.0, listener=0.0, beam=0.0)
    for i in range(6):
        blk = plane_wave_block(pipes[0].points, [SOURCE], i * 256, 256, cfg.array,
                               noise_std=0.02, rng=rng)
        draws = (rng.uniform(0, tc.theta_limit, tc.n_seekers).astype(np.float32),
                 rng.uniform(0, 2 * np.pi, tc.n_seekers).astype(np.float32),
                 *(rng.uniform(-1, 1, (2, tc.iterations, tc.n_seekers))
                   * tc.theta_limit / 2).astype(np.float32))
        a, b = (_state_to(p.process_block(blk, draws=draws), "cpu") for p in pipes)
        ma, mb = (p.state.miso.particle for p in pipes)
        errs = dict(
            powers=float((a.powers - b.powers).abs().max() / b.powers.abs().max()),
            listener=_angle(ma.theta.cpu(), ma.phi.cpu(), mb.theta, mb.phi),
            beam=float((a.miso_beam - b.miso_beam).abs().max()
                       / b.miso_beam.abs().max()),
        )
        worst = {k: max(worst[k], v) for k, v in errs.items()}
    best = [max(p.targets(), key=lambda x: x["power"]) for p in pipes]
    off = _angle(best[0]["theta"], best[0]["phi"], best[1]["theta"], best[1]["phi"])
    print(f"end to end, default profile, {device} vs cpu, 6 blocks: "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f", strongest targets {off:.3g} rad apart", flush=True)
    for k, tol in (("powers", 1e-4), ("listener", 1e-4), ("beam", 1e-2)):
        if not worst[k] <= tol:
            raise AssertionError(f"default profile end to end {k} error "
                                 f"{worst[k]:.3g} > {tol}")
    if not off <= 0.05:
        raise AssertionError(f"default profile end to end: strongest targets "
                             f"{off:.3g} rad apart")


def _timed_blocks(pipe, blocks, warm: int):
    """Blocks through ``process_block``; returns (last outputs, device
    ms/block and host ms/block after ``warm`` blocks)."""
    import torch

    for i, blk in enumerate(blocks):
        if i == warm:
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            h0 = time.perf_counter()
        out = pipe.process_block(blk)
    e1 = torch.cuda.Event(enable_timing=True)
    e1.record()
    torch.cuda.synchronize()
    n = len(blocks) - warm
    return out, e0.elapsed_time(e1) / n, (time.perf_counter() - h0) * 1e3 / n


def _launch_ms(pipe, block) -> dict:
    """One more block through ``process_block`` with CUDA events around
    every K0 and K4 launch: the device ms of each kernel in that block.  A
    spin kernel before each launch holds the device while the host
    enqueues the events and the launch, so the events time the kernel, not
    the host's pace.  The block's draws are handed in, so its tracker and
    MISO steps run eagerly through the timed wrappers rather than as the
    graph replay the pipeline's own draws take."""
    import torch

    from beamforming_lk_tpu_torch.ops import cuda_das as cd
    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk

    spans = {"monopulse_chain": [], "das_beam": []}

    def timed(name, fn):
        def call(*args, **kw):
            torch.cuda._sleep(1_000_000)                 # ~0.5 ms
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = fn(*args, **kw)
            e1.record()
            spans[name].append((e0, e1))
            return out
        call.launches = 0      # the wrapper counts on its module's name
        return call

    tc = pipe.cfg.tracker
    rng = np.random.default_rng(0)
    draws = (rng.uniform(0, tc.theta_limit, tc.n_seekers),
             rng.uniform(0, 2 * np.pi, tc.n_seekers),
             *rng.uniform(-1, 1, (2, tc.iterations, tc.n_seekers)) * tc.theta_limit / 2)
    real = ctk.monopulse_chain, cd.das_beam
    ctk.monopulse_chain = timed("monopulse_chain", real[0])
    cd.das_beam = timed("das_beam", real[1])
    try:
        pipe.process_block(block, draws=draws)
    finally:
        ctk.monopulse_chain, cd.das_beam = real
    torch.cuda.synchronize()
    return {name: (len(ev), sum(a.elapsed_time(b) for a, b in ev))
            for name, ev in spans.items()}


def run_default(channels: int, device):
    """The default profile (``Config()``) on 96 plane-wave blocks through
    ``process_block``: the dense 64 x 64 heatmap through K4 every block,
    10 iterations of the unfused tracker (one K0 launch each) and the MISO
    step (one K0 launch), and no other kernel.  Then one more block with
    each K0 and K4 launch timed by CUDA events.  Returns (K0 launches, K4
    launches, device ms/block, host ms/block)."""
    from beamforming_lk_tpu_torch.app import AwpuPipeline

    cfg = default_config()
    pipe = AwpuPipeline(cfg, channels=channels, seed=0, device=device)
    blocks = _plane_wave_blocks(pipe, cfg, channels, device)
    per_block = cfg.tracker.iterations + 1
    _reset_counts()
    out, ms, host_ms = _timed_blocks(pipe, blocks, 16)
    counts = _counts(monopulse_chain=per_block * N_BLOCKS, das_beam=N_BLOCKS)
    lock = check_lock(f"{channels} mics default", cfg, pipe, out.miso_beam, out.powers)
    print(f"default profile {channels:3d} mics: {counts['monopulse_chain']} K0 + "
          f"{counts['das_beam']} K4 launches / {N_BLOCKS} blocks ({per_block} K0 "
          f"+ 1 K4 per block), {lock}; {ms:.4f} ms/block device, {host_ms:.4f} "
          f"ms/block host", flush=True)
    per = _launch_ms(pipe, blocks[0])
    if per["monopulse_chain"][0] != per_block or per["das_beam"][0] != 1:
        raise AssertionError(f"default profile block launched {per}")
    print(f"  one block, CUDA events around each launch: K0 "
          f"{per['monopulse_chain'][1]:.4f} ms ({per_block} launches), K4 "
          f"{per['das_beam'][1]:.4f} ms (1 launch) of device time", flush=True)
    return counts["monopulse_chain"], counts["das_beam"], ms, host_ms


def run_fallback(device):
    """The realtime profile with a gain mask at 64 mics, which the fft
    heatmap cannot take, so the pipeline falls back to the dense heatmap:
    96 blocks live (K1 per block, K4 per heatmap block, every 3rd) and 96
    through ``process_blocks`` (24 then 72; K2 and K4 once per 12 blocks),
    locked on the source.  Returns (K4 launches, live ms/block, replay
    ms/block, both on the device clock)."""
    import torch

    from beamforming_lk_tpu_torch import Config, realtime
    from beamforming_lk_tpu_torch.app import AwpuPipeline

    cfg = realtime(Config())
    gains = np.ones(64, np.float32)
    gains[::9] = 0.5
    pipes = [AwpuPipeline(cfg, channels=64, channel_mask=gains, seed=0,
                          device=device) for _ in range(2)]
    if pipes[0].step.mimo_model is None:
        raise AssertionError("the gain-mask pipeline did not fall back to dense")
    blocks = _plane_wave_blocks(pipes[0], cfg, 64, device)
    every = cfg.mimo.heatmap_every
    _reset_counts()
    out, live_ms, _ = _timed_blocks(pipes[0], blocks, 16)
    live = _counts(swarm_chain=N_BLOCKS, das_beam=N_BLOCKS // every)
    last_map = out.powers       # block 95: the map of block 93
    lock = check_lock("fallback live", cfg, pipes[0], out.miso_beam, last_map)
    head = 24
    _reset_counts()
    pipes[1].process_blocks(blocks[:head])
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    stacked = pipes[1].process_blocks(blocks[head:])
    e1.record()
    torch.cuda.synchronize()
    replay_ms = e0.elapsed_time(e1) / (N_BLOCKS - head)
    replay = _counts(swarm_chunk=N_BLOCKS // CHUNK, das_beam=N_BLOCKS // CHUNK)
    check_lock("fallback replay", cfg, pipes[1], stacked.miso_beam[-1],
               stacked.powers[-1])
    print(f"dense fallback (gain mask, 64 mics): live {live['swarm_chain']} K1 + "
          f"{live['das_beam']} K4 launches / {N_BLOCKS} blocks, {lock}, "
          f"{live_ms:.4f} ms/block; replay {replay['swarm_chunk']} K2 + "
          f"{replay['das_beam']} K4 launches, {replay_ms:.4f} ms/block (device "
          "clock)", flush=True)
    return live["das_beam"] + replay["das_beam"], live_ms, replay_ms


# The CLI phases' source: 20 deg off boresight, clear of the swarm's
# boresight lock (ROADMAP §3), 5 kHz.
CLI_SOURCE = (math.radians(20.0), math.radians(45.0))
CLI_BLOCKS = 96                      # blocks in the replay and fusion captures
LIVE_SENT_BLOCKS = 1008              # blocks the live sender sends
SEND_GROUP = 32                      # packets per send burst: 8 a block
GEO_BOUND_M = 0.5                    # a published GeoPoint's distance from the source


def _cli(argv) -> str:
    """``cli.main(argv + ["--device", "cuda"])`` in this process; raises
    unless it returns 0; returns what it printed."""
    import contextlib
    import io

    from beamforming_lk_tpu_torch.app import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv) + ["--device", "cuda"])
    if rc != 0:
        raise AssertionError(f"cli {argv} returned {rc}")
    return buf.getvalue()


def _cli_summary(out: str) -> dict:
    """The JSON summary that ``--fps`` prints."""
    return json.JSONDecoder().raw_decode(out[out.index("{\n"):])[0]


def _cli_lock(what: str, out: str, direction, array: int = 0) -> float:
    """Degrees between ``direction`` and the nearest target the CLI printed
    for ``array``; raises unless within 5 deg."""
    import re

    found = re.findall(rf"array {array}: target theta=([-\d.]+) phi=([-\d.]+)", out)
    off = [math.degrees(_angle(math.radians(float(t)), math.radians(float(p)),
                               *direction)) for t, p in found]
    if not off or min(off) > 5.0:
        raise AssertionError(f"{what}: no target within 5 deg of the source: {found}")
    return min(off)


def _wire(channels: int, n: int, direction, seed: int) -> np.ndarray:
    """``n`` blocks of a noisy 5 kHz plane wave from ``direction`` at the
    CLI's ``channels`` mics, as wire packets [n * 256, PACKET_SIZE] uint8."""
    from beamforming_lk_tpu_torch.io import packets as pk
    from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block
    from beamforming_lk_tpu_torch.ops import antenna as ant

    points = ant.multi_array_cluster(channels, 8, 8, 0.02)
    rng = np.random.default_rng(seed)
    return np.concatenate([np.frombuffer(pk.build_packets(
        plane_wave_block(points, [(*direction, 5000.0)], b * 256, 256,
                         noise_std=0.02, rng=rng), start_counter=b * 256),
        np.uint8).reshape(256, pk.PACKET_SIZE) for b in range(n)])


def _write_capture(path: str, links) -> None:
    """A pcap of wire packets, link i on port 21844 + i, interleaved per
    sample as simultaneous links appear on the wire."""
    from beamforming_lk_tpu_torch.io import pcap as pc

    pc.write_pcap(path, [(link[i].tobytes(), 21844 + a)
                         for i in range(len(links[0]))
                         for a, link in enumerate(links)])


def _tone_snr_db(path: str) -> float:
    """The 5 kHz tone's share of a WAV's power, in dB (the golden test's)."""
    from beamforming_lk_tpu_torch.io.wav import read_wav

    data, rate = read_wav(path)
    x = data[0] - data[0].mean()
    spec = np.abs(np.fft.rfft(x * np.hanning(x.size))) ** 2
    freqs = np.fft.rfftfreq(x.size, 1.0 / rate)
    tone = spec[np.abs(freqs - 5000.0) < 100.0].sum()
    return float(10.0 * np.log10(tone / max(spec.sum() - tone, 1e-30)))


def _stages(summary: dict) -> str:
    return ", ".join(f"{k} {v['mean_ms']:.3f} ms x {v['calls']}"
                     for k, v in summary["stages"].items())


def _trace_split(path: str) -> dict:
    """From a ``--profile`` Chrome trace: the kernels launched, the chunk
    kernel's count, the device's busy ms and the traced span's ms."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e.get("dur", 0) for e in events)
    return dict(kernels=len(kernels),
                k2=sum("swarm_chunk_kernel" in e["name"] for e in kernels),
                busy_ms=sum(e.get("dur", 0) for e in kernels) / 1e3,
                span_ms=(t1 - t0) / 1e3)


def run_cli_replay(tmp: str):
    """Phase 13a: the CLI replaying a 96-block 256-mic pcap in the realtime
    profile, twice (the second with ``--profile``).  Returns the K2
    launches of both runs."""
    from beamforming_lk_tpu_torch import Config, MimoConfig
    from beamforming_lk_tpu_torch.app.awpu import AwpuPipeline
    from beamforming_lk_tpu_torch.utils.profiling import TRACE_FILE

    cap = os.path.join(tmp, "replay.pcap")
    _write_capture(cap, [_wire(256, CLI_BLOCKS, CLI_SOURCE, seed=40)])
    grid = Config(mimo=MimoConfig())
    want = _source_cell(grid, CLI_SOURCE)[1]
    base = ["--source", "pcap", "--pcap", cap, "--port", "21844", "--channels",
            "256", "--realtime", "--mimo", "--tracking", "--miso", "--blocks",
            str(CLI_BLOCKS), "--fps"]
    real_heatmap, images = AwpuPipeline.heatmap, []

    def heatmap(self):
        images.append(real_heatmap(self))
        return images[-1]

    k2 = 0
    for name in ("plain", "profiled"):
        run = os.path.join(tmp, name)
        prof = ["--profile", run] if name == "profiled" else []
        wav = os.path.join(run, "beam.wav")
        os.makedirs(run, exist_ok=True)
        _reset_counts()
        AwpuPipeline.heatmap = heatmap
        try:
            out = _cli(base + ["--miso-wav", wav, "--output-dir",
                               os.path.join(run, "frames")] + prof)
        finally:
            AwpuPipeline.heatmap = real_heatmap
        counts = _counts(swarm_chunk=CLI_BLOCKS // CHUNK)
        k2 += counts["swarm_chunk"]
        off = _cli_lock("CLI replay", out, CLI_SOURCE)
        snr = _tone_snr_db(wav)
        peak = divmod(int(np.argmax(images[-1])), images[-1].shape[1])
        summary = _cli_summary(out)
        if not snr > 10.0:
            raise AssertionError(f"CLI replay: MISO WAV tone SNR {snr:.1f} dB <= 10")
        if max(abs(peak[0] - want[0]), abs(peak[1] - want[1])) > 1:
            raise AssertionError(f"CLI replay: last heatmap peak {peak}, source {want}")
        if summary["blocks"] != CLI_BLOCKS:
            raise AssertionError(f"CLI replay processed {summary['blocks']} blocks")
        print(f"CLI pcap replay ({name}), 256 mics, realtime, {CLI_BLOCKS} blocks: "
              f"{counts['swarm_chunk']} K2 + 0 K1 launches; target {off:.2f} deg off "
              f"the source; last heatmap peak {peak} vs source {want}; MISO WAV "
              f"tone SNR {snr:.1f} dB; {summary['blocks_per_s']:.1f} blocks/s "
              f"({summary['realtime_factor']:.2f}x real time), latency p50 "
              f"{summary['latency_p50_ms']:.4f} ms per block (a 12-block call / 12); "
              f"stages: {_stages(summary)}", flush=True)
        if prof:
            split = _trace_split(os.path.join(run, TRACE_FILE))
            if split["k2"] != CLI_BLOCKS // CHUNK:
                raise AssertionError(f"CLI --profile trace names the chunk kernel "
                                     f"{split['k2']} times: {split}")
            print(f"  --profile trace: {split['kernels']} kernels, "
                  f"swarm_chunk_kernel x {split['k2']}; device busy "
                  f"{split['busy_ms'] / CLI_BLOCKS:.4f} ms/block, idle share "
                  f"{1 - split['busy_ms'] / split['span_ms']:.4f} over the traced "
                  f"{split['span_ms']:.1f} ms", flush=True)
    return k2


def _send_live(port: int, wire, n_blocks: int, result) -> None:
    """The live phase's FPGA, in a process of its own (a sender thread in
    the CLI's process would take the interpreter lock from it): once a
    socket is bound at 127.0.0.1:``port``, send ``n_blocks`` blocks of the
    ``wire`` packets, cycled, with consecutive counters, SEND_GROUP packets
    a ``sendmmsg`` call at the wire rate; put (blocks sent, seconds, error)
    on ``result``."""
    import ctypes
    import socket

    from beamforming_lk_tpu_torch.io import packets as pk

    class Iovec(ctypes.Structure):
        _fields_ = [("base", ctypes.c_void_p), ("len", ctypes.c_size_t)]

    class Msghdr(ctypes.Structure):
        _fields_ = [("name", ctypes.c_void_p), ("namelen", ctypes.c_uint32),
                    ("iov", ctypes.POINTER(Iovec)), ("iovlen", ctypes.c_size_t),
                    ("control", ctypes.c_void_p), ("controllen", ctypes.c_size_t),
                    ("flags", ctypes.c_int)]

    class Mmsghdr(ctypes.Structure):
        _fields_ = [("hdr", Msghdr), ("len", ctypes.c_uint)]

    libc = ctypes.CDLL(None, use_errno=True)
    sent, seconds = 0, 0.0
    try:
        deadline = time.perf_counter() + 120.0
        while True:
            with open("/proc/net/udp") as f:
                if any(line.split()[1].endswith(f":{port:04X}")
                       for line in f.readlines()[1:]):
                    break
            if time.perf_counter() > deadline:
                raise TimeoutError("the CLI's ingest never bound its port")
            time.sleep(0.005)
        counters = np.arange(256, dtype="<u4")
        pkts = np.empty((256, pk.PACKET_SIZE), np.uint8)
        iovs = (Iovec * 256)(*[Iovec(pkts.ctypes.data + k * pk.PACKET_SIZE,
                                     pk.PACKET_SIZE) for k in range(256)])
        msgs = (Mmsghdr * 256)()
        for k in range(256):
            msgs[k].hdr.iov, msgs[k].hdr.iovlen = ctypes.pointer(iovs[k]), 1
        cycle = len(wire) // 256
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            sock.connect(("127.0.0.1", port))
            t0 = time.perf_counter()
            for i in range(n_blocks):
                b = i % cycle
                pkts[:] = wire[b * 256:(b + 1) * 256]
                pkts[:, 4:8] = (counters + i * 256).view(np.uint8).reshape(256, 4)
                for g in range(0, 256, SEND_GROUP):
                    wait = t0 + (i * 256 + g) / 48828.0 - time.perf_counter()
                    if wait > 0:
                        time.sleep(wait)
                    done = 0
                    while done < SEND_GROUP:
                        n = libc.sendmmsg(sock.fileno(), ctypes.byref(
                            msgs, (g + done) * ctypes.sizeof(Mmsghdr)),
                            SEND_GROUP - done, 0)
                        if n < 0:
                            raise OSError(ctypes.get_errno(), "sendmmsg failed")
                        done += n
                sent += 1
            seconds = time.perf_counter() - t0
        result.put((sent, seconds, None))
    except Exception as e:  # reported by the phase, which fails
        result.put((sent, seconds, repr(e)))


def run_cli_live():
    """Phase 13b: the CLI's native ingest at 256 mics fed over loopback at
    the wire rate by a sender process.  Returns the K1 launches."""
    import multiprocessing
    import queue
    import socket

    wire = _wire(256, CLI_BLOCKS, CLI_SOURCE, seed=41)
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    result = ctx.Queue()
    proc = ctx.Process(target=_send_live, args=(port, wire, LIVE_SENT_BLOCKS, result))
    _reset_counts()
    proc.start()
    try:
        out = _cli(["--source", "native", "--ip-address", "127.0.0.1", "--port",
                    str(port), "--blocks", "0", "--channels", "256", "--realtime",
                    "--mimo", "--tracking", "--miso", "--miso-wav",
                    os.devnull, "--fps"])
        try:
            n_sent, seconds, error = result.get(timeout=60)
        except queue.Empty:
            n_sent, seconds, error = 0, 0.0, "no result from the sender"
        proc.join(timeout=30)
    finally:
        if proc.is_alive():
            proc.terminate()
            proc.join()
    if error is not None:
        raise AssertionError(f"live sender failed: {error}")
    sender = {"blocks": n_sent, "seconds": seconds}
    summary = _cli_summary(out)
    (ingest,) = summary["ingest"]
    done = summary["blocks"]
    counts = _counts(swarm_chain=done)
    off = _cli_lock("CLI live", out, CLI_SOURCE)
    if done + ingest["blocks_dropped"] != sender["blocks"]:
        raise AssertionError(f"CLI live: {done} processed + "
                             f"{ingest['blocks_dropped']} dropped != "
                             f"{sender['blocks']} sent ({ingest})")
    print(f"CLI live ingest (native, loopback), 256 mics, realtime: "
          f"{done} blocks processed of {sender['blocks']} sent in "
          f"{sender['seconds']:.3f} s (wire time "
          f"{LIVE_SENT_BLOCKS * BUDGET_MS / 1e3:.3f} s); ingest "
          f"blocks_dropped {ingest['blocks_dropped']}, counter_gaps "
          f"{ingest['counter_gaps']}, packets {ingest['packets_received']}; "
          f"{counts['swarm_chain']} K1 launches; target {off:.2f} deg off; "
          f"latency p50 {summary['latency_p50_ms']:.4f} / p99 "
          f"{summary['latency_p99_ms']:.4f} / max {summary['latency_max_ms']:.4f} "
          f"ms over the last 512 blocks (budget {BUDGET_MS:.2f} ms, "
          f"{summary['deadline_misses']} blocks over it); stages: "
          f"{_stages(summary)}", flush=True)
    return counts["swarm_chain"]


def run_cli_default(tmp: str):
    """Phase 13c: the CLI's default profile on a 24-block 64-mic pcap.
    Returns (K0 launches, K4 launches)."""
    n = 24
    cap = os.path.join(tmp, "default.pcap")
    _write_capture(cap, [_wire(64, n, CLI_SOURCE, seed=42)])
    _reset_counts()
    out = _cli(["--source", "pcap", "--pcap", cap, "--port", "21844", "--channels",
                "64", "--mimo", "--tracking", "--miso", "--blocks", str(n), "--fps"])
    counts = _counts(monopulse_chain=11 * n, das_beam=n)
    off = _cli_lock("CLI default profile", out, CLI_SOURCE)
    summary = _cli_summary(out)
    print(f"CLI default profile, 64 mics, pcap, {n} blocks: "
          f"{counts['monopulse_chain']} K0 + {counts['das_beam']} K4 launches "
          f"(11 + 1 per block); target {off:.2f} deg off; "
          f"{summary['blocks_per_s']:.1f} blocks/s; stages: {_stages(summary)}",
          flush=True)
    return counts["monopulse_chain"], counts["das_beam"]


def run_cli_fusion(tmp: str):
    """Phase 13d: two 256-mic links in one pcap through the CLI with fusion
    and the WARA PS sink (tracker-only realtime: K1 once a block an
    array).  Returns the K1 launches."""
    cap = os.path.join(tmp, "two_links.pcap")
    ndjson = os.path.join(tmp, "telemetry.ndjson")
    target = np.asarray(FUSION_TARGET)
    links = []
    for a, pos in enumerate(FUSION_ARRAYS):
        d = (target - np.asarray(pos)) / np.linalg.norm(target - np.asarray(pos))
        links.append(_wire(256, CLI_BLOCKS, (math.acos(d[2]), math.atan2(d[1], d[0])),
                           seed=43 + a))
    _write_capture(cap, links)
    lat0, lon0, alt0 = 57.76, 16.68, 10.0
    _reset_counts()
    out = _cli(["--source", "pcap", "--pcap", cap, "--port", "21844", "--port",
                "21845", "--arrays", "2", "--channels", "256", "--realtime",
                "--tracking", "--wara-ps", "--telemetry-file", ndjson, "--gps",
                str(lat0), str(lon0), str(alt0), "--blocks", str(CLI_BLOCKS),
                "--fps"])
    counts = _counts(swarm_chain=2 * CLI_BLOCKS)
    with open(ndjson) as f:
        geo = [m["payload"] for m in map(json.loads, f)
               if m["topic"] == "sensor/position"]
    errs = []
    for g in geo:    # heading 0: published (x, z, y)
        x = (g["latitude"] - lat0) * 111111.0
        z = (g["longitude"] - lon0) * 111111.0 * math.cos(math.radians(lat0))
        errs.append(float(np.linalg.norm(np.array([x, g["altitude"] - alt0, z])
                                         - target)))
    if not errs or max(errs) > GEO_BOUND_M:
        raise AssertionError(f"CLI fusion: GeoPoints {errs} m from the source "
                             f"(bound {GEO_BOUND_M} m)")
    best = [line for line in out.splitlines() if line.startswith("best track")]
    print(f"CLI two-array fusion to GeoPoints, 256 mics, realtime, {CLI_BLOCKS} "
          f"blocks: {counts['swarm_chain']} K1 launches (one a block an "
          f"array); {len(errs)} GeoPoints, {max(errs):.4f} m at most "
          f"from the source {FUSION_TARGET} (bound {GEO_BOUND_M} m); "
          f"{best[0] if best else 'no best track line'}; stages: "
          f"{_stages(_cli_summary(out))}", flush=True)
    return counts["swarm_chain"]


def run_cli_adaptive(tmp: str):
    """Phase 13e: the CLI with ``--mvdr`` and then ``--music`` on a 24-block
    synthetic source at 64 mics, realtime with the tracker and MISO (12
    blocks a call: K2 twice, no K1): frames written, the printed target and
    the last heatmap's peak on the source.  Returns the K2 launches."""
    from beamforming_lk_tpu_torch import Config, MimoConfig
    from beamforming_lk_tpu_torch.app.awpu import AwpuPipeline

    n = 24
    want = _source_cell(Config(mimo=MimoConfig()), CLI_SOURCE)[1]
    real_heatmap, images = AwpuPipeline.heatmap, []

    def heatmap(self):
        images.append(real_heatmap(self))
        return images[-1]

    k2 = 0
    for flag in ("--mvdr", "--music"):
        frames = os.path.join(tmp, f"frames{flag}")
        _reset_counts()
        AwpuPipeline.heatmap = heatmap
        try:
            out = _cli([flag, "--realtime", "--tracking", "--miso", "--channels", "64",
                        "--blocks", str(n), "--output-dir", frames, "--fps",
                        "--synthetic-source", f"{math.degrees(CLI_SOURCE[0])}",
                        f"{math.degrees(CLI_SOURCE[1])}", "5000"])
        finally:
            AwpuPipeline.heatmap = real_heatmap
        counts = _counts(swarm_chunk=n // CHUNK)
        k2 += counts["swarm_chunk"]
        off = _cli_lock(f"CLI {flag}", out, CLI_SOURCE)
        peak = divmod(int(np.argmax(images[-1])), images[-1].shape[1])
        written = sorted(os.listdir(frames))
        if not written:
            raise AssertionError(f"CLI {flag}: no frames written")
        if max(abs(peak[0] - want[0]), abs(peak[1] - want[1])) > 1:
            raise AssertionError(f"CLI {flag}: last heatmap peak {peak}, source {want}")
        summary = _cli_summary(out)
        print(f"CLI {flag}, 64 mics, realtime + tracker + MISO, synthetic, {n} "
              f"blocks: {counts['swarm_chunk']} K2 + 0 K1 launches; {len(written)} "
              f"frames; target {off:.2f} deg off; last heatmap peak {peak} vs source "
              f"{want}; {summary['blocks_per_s']:.1f} blocks/s; stages: "
              f"{_stages(summary)}", flush=True)
    return k2


# Phase 15: the mesh on the card.  The JAX package's bounds for its sharded
# results (tests/test_awpu.py:50-70): powers rtol 2e-4 / atol 1e-14, the
# MISO beam rtol 2e-3 / atol 2e-5, target theta rtol 1e-3 / atol 1e-4.
MESH_BLOCKS = 48
MESH_TOL = dict(powers=(2e-4, 1e-14), beam=(2e-3, 2e-5), theta=(1e-3, 1e-4))


def _collectives():
    from beamforming_lk_tpu_torch.parallel import mesh as pm

    return pm.collectives


def _reset_mesh_counts():
    _reset_counts()
    for k in _collectives():
        _collectives()[k] = 0


def _excess(got, want, tol) -> float:
    """The largest ``|got - want| / (atol + rtol |want|)``: within the
    bound where it is at most 1."""
    rtol, atol = tol
    got, want = (np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.float64)
                 for x in (got, want))
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


def _hold_mesh(what: str, outs, refs, gather) -> dict:
    """Per-block outputs of a sharded run against a one-rank run's, at
    MESH_TOL; ``gather`` assembles a rank's powers.  Raises past a bound or
    on unequal target flags; returns the worst excess of each output."""
    worst = dict(powers=0.0, beam=0.0, theta=0.0)
    for i, (o, r) in enumerate(zip(outs, refs)):
        worst["powers"] = max(worst["powers"], _excess(gather(o.powers), r.powers,
                                                      MESH_TOL["powers"]))
        worst["beam"] = max(worst["beam"], _excess(o.miso_beam, r.miso_beam,
                                                  MESH_TOL["beam"]))
        worst["theta"] = max(worst["theta"], _excess(o.targets.theta, r.targets.theta,
                                                    MESH_TOL["theta"]))
        if not bool((o.targets.valid == r.targets.valid).all()):
            raise AssertionError(f"{what}: target flags differ at block {i}")
    if max(worst.values()) > 1.0:
        raise AssertionError(f"{what}: past the sharded bounds {worst}")
    return worst


def _xla(cfg, backend=None):
    """``cfg`` with the XLA-chain backend (and the heatmap ``backend``)."""
    tracker = dataclasses.replace(cfg.tracker, probe_kernel="xla")
    mimo = cfg.mimo if backend is None else dataclasses.replace(cfg.mimo,
                                                                backend=backend)
    return dataclasses.replace(cfg, tracker=tracker, mimo=mimo)


def run_mesh_one_rank():
    """15a: a world-size-1 NCCL group and a 1x1 mesh:
    ``AwpuPipeline(realtime(Config()), channels=256, mesh=mesh)`` on 96
    blocks through ``process_block``, then 24 through ``process_blocks``,
    against the unsharded pipeline from the same seed on the XLA chain (the
    backend a mesh takes), block by block at the sharded bounds; K0 twice a
    block, no K4; locked; ms a block of both.  Before them, a state that
    ``convert.awpu_state_from_jax`` carries over under the mesh, with no
    device argument, lies where ``awpu_init`` puts it and equals it.
    Returns (K0 launches, ms a block under the mesh, unsharded ms a
    block)."""
    import torch
    import torch.distributed as dist

    from beamforming_lk_tpu_torch import Config, convert, realtime
    from beamforming_lk_tpu_torch.app import AwpuPipeline, awpu_init
    from beamforming_lk_tpu_torch.parallel import single_device_mesh
    from beamforming_lk_tpu_torch.parallel.multihost import initialize

    initialize(backend="nccl")
    try:
        mesh = single_device_mesh()
        cfg = realtime(Config())
        init = awpu_init(cfg, 256, mesh=mesh)
        carried = convert.awpu_state_from_jax(_numpy_tree(init), mesh=mesh)
        placed = {str(t.device) for t in _tensors(carried)}
        if placed != {str(t.device) for t in _tensors(init)} or not _same(carried, init):
            raise AssertionError(f"15a: the carried-over state on {placed}, not "
                                 "as awpu_init places it")
        pipes = [AwpuPipeline(cfg, channels=256, seed=0, mesh=mesh, device="cuda"),
                 AwpuPipeline(_xla(cfg), channels=256, seed=0, device="cuda")]
        blocks = _plane_wave_blocks(pipes[0], cfg, 256, "cuda", N_BLOCKS + CHUNK * 2)
        runs, ms = [], []
        for k, pipe in enumerate(pipes):
            _reset_mesh_counts()
            outs = []
            for i in range(N_BLOCKS):
                if i == 16:
                    torch.cuda.synchronize()
                    e0 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                outs.append(pipe.process_block(blocks[i]))
            e1 = torch.cuda.Event(enable_timing=True)
            e1.record()
            torch.cuda.synchronize()
            ms.append(e0.elapsed_time(e1) / (N_BLOCKS - 16))
            stacked = pipe.process_blocks(blocks[N_BLOCKS:])
            outs += [type(stacked)(stacked.powers[i], type(stacked.targets)(
                *(f[i] for f in stacked.targets)), stacked.miso_beam[i],
                stacked.prev_max[i]) for i in range(CHUNK * 2)]
            if k == 0:
                n = N_BLOCKS + CHUNK * 2
                counts = _counts(monopulse_chain=2 * n)
                if any(_collectives().values()):
                    raise AssertionError(f"15a: collectives {_collectives()} on a 1x1 mesh")
                maps = [o.powers for o in outs[::cfg.mimo.heatmap_every]]
                lock = check_lock("15a mesh 1x1", cfg, pipe, outs[-1].miso_beam, maps[-1])
            runs.append(outs)
        worst = _hold_mesh("15a", runs[0], runs[1], lambda p: p)
    finally:
        dist.destroy_process_group()
    print(f"15a mesh 1x1 (NCCL, one rank), realtime, 256 mics, {N_BLOCKS} blocks "
          f"live + {CHUNK * 2} replayed: {counts['monopulse_chain']} K0 launches "
          f"(2 a block), no K4, no collective; state carried over on "
          f"{sorted(placed)} as awpu_init's; {lock}; {ms[0]:.4f} ms/block "
          f"device under the mesh, {ms[1]:.4f} unsharded on the XLA chain; vs "
          f"unsharded, worst excess over the sharded bounds "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()), flush=True)
    return counts["monopulse_chain"], ms[0], ms[1]


def _clone(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple):
        return type(tree)(*(_clone(v) for v in tree))
    return tree


@contextlib.contextmanager
def _keep_das_operands():
    """While open, ``ops.cuda_das.das_beam`` keeps a copy of the operands
    of its first call at each row count D, in the dict it yields (D ->
    (window, shift, tap_weights, keywords)); each call still launches the
    kernel once (the wrapper counts on its module's name, so the stand-in
    carries the count)."""
    from beamforming_lk_tpu_torch.ops import cuda_das as cd

    kernel, kept = cd.das_beam, {}

    def keep(window, shift, tap_weights, **kw):
        if shift.shape[0] not in kept:
            kept[shift.shape[0]] = (window.clone(), shift.clone(),
                                    tap_weights.clone(), kw)
        return kernel(window, shift, tap_weights, **kw)

    keep.launches = kernel.launches
    cd.das_beam = keep
    try:
        yield kept
    finally:
        kernel.launches = keep.launches
        cd.das_beam = kernel


def _hold_das_operands(kept) -> dict:
    """K4 on operands the sharded step gave it (:func:`_keep_das_operands`)
    against its twin on the same tensors: beams within 1e-5 of the peak,
    as :func:`compare_das` holds it, over all rows and over the rows past
    the last full block of 32 directions (a block partly empty); the shift
    within [0, span - taps].  Returns, by row count, (channels, compute,
    rows in the partly empty block, max abs error, its share of the peak,
    the tail's share)."""
    import torch

    from beamforming_lk_tpu_torch.ops import cuda_das as cd

    held = {}
    for d, (window, shift, w, kw) in sorted(kept.items()):
        span, taps = kw["span"], w.shape[-1]
        if not (0 <= int(shift.min()) and int(shift.max()) <= span - taps):
            raise AssertionError(f"15b K4 operands at {d} rows: shift outside "
                                 f"[0, {span - taps}]")
        got = cd.das_beam(window, shift, w, **kw)
        want = cd.das_beam_reference(window, shift, w, **kw)
        torch.cuda.synchronize()
        err = (got - want).abs()
        peak = float(want.abs().max())
        per_block = cd.das_beam_plan(1, d, 1, 1, span, taps)["dirs_per_block"]
        full = d // per_block * per_block
        rel = float(err.max()) / peak
        tail = float(err[full:].max()) / peak if full < d else 0.0
        if not (torch.isfinite(got).all() and rel <= 1e-5 and tail <= 1e-5):
            raise AssertionError(f"15b K4 vs twin at {d} rows x {shift.shape[1]} "
                                 f"channels: {rel:.3g} of the peak, tail "
                                 f"{tail:.3g} > 1e-5")
        held[d] = (shift.shape[1], kw["compute"], d - full, float(err.max()),
                   rel, tail)
    return held


def _mesh_awpu(shape) -> dict:
    """15b on this rank: the realtime profile at 256 mics on a (ch, dir)
    ``shape`` mesh.  A free run of MESH_BLOCKS blocks (launches, all-reduces
    and ms a block after 8 warm blocks, the lock), then a lockstep run
    against a one-rank pipeline on the same card (the same profile on the
    XLA chain, its heatmap dense where ch > 1, as the mesh's), the sharded
    step started each block from the one-rank run's carried swarm,
    listener and EMA, held at the sharded bounds."""
    import torch

    from beamforming_lk_tpu_torch import Config, realtime
    from beamforming_lk_tpu_torch.app import AwpuPipeline
    from beamforming_lk_tpu_torch.parallel import make_mesh

    cfg = realtime(Config())
    mesh = make_mesh(shape)
    pipe = AwpuPipeline(cfg, channels=256, seed=0, mesh=mesh, device="cuda")
    blocks = _plane_wave_blocks(pipe, cfg, 256, pipe.device, MESH_BLOCKS)
    warm = 8
    _reset_mesh_counts()
    for i in range(MESH_BLOCKS):
        if i == warm:
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            h0 = time.perf_counter()
        out = pipe.process_block(blocks[i])
        if i % cfg.mimo.heatmap_every == 0:
            last_map = out.powers
    e1 = torch.cuda.Event(enable_timing=True)
    e1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3 / (MESH_BLOCKS - warm)
    ms = e0.elapsed_time(e1) / (MESH_BLOCKS - warm)
    launches = {k: v.launches for k, v in _wrappers().items()}
    coll = dict(_collectives())
    ch = shape[0]
    maps = -(-MESH_BLOCKS // cfg.mimo.heatmap_every)
    want = (dict(das_beam=maps + 10 * MESH_BLOCKS) if ch > 1
            else dict(monopulse_chain=2 * MESH_BLOCKS))
    _counts(**want)
    lock = check_lock(f"15b mesh {shape}", cfg, pipe, out.miso_beam,
                      pipe.layout.dir.all_gather(last_map))
    # One all-reduce of a sub-step's partial probe beams (27 rows x 4
    # probes x 254 samples, f32), host clock, as a block issues it.
    beams = torch.zeros((108, 254), device=pipe.device)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(20):
        pipe.layout.ch.all_reduce(beams)
    torch.cuda.synchronize()
    reduce_ms = (time.perf_counter() - h0) * 1e3 / 20

    ref = AwpuPipeline(_xla(cfg, "dense" if ch > 1 else None), channels=256,
                       seed=0, device="cuda")
    step = AwpuPipeline(cfg, channels=256, seed=0, mesh=mesh, device="cuda")
    outs, refs = [], []
    for i, blk in enumerate(blocks):
        step.state = step.state._replace(
            swarm=_clone(ref.state.swarm), miso=_clone(ref.state.miso),
            prev_max=ref.state.prev_max.clone())
        step.generator.set_state(ref.generator.get_state())
        if i == 0:
            # The first block keeps K4's operands where ch > 1: a
            # sub-step's probe beams and the dense map's (dir, ch) block.
            with _keep_das_operands() as kept:
                outs.append(_clone(step.process_block(blk)))
            das = _hold_das_operands(kept)
            if len(das) != (2 if ch > 1 else 0):
                raise AssertionError(f"15b: K4 took {sorted(das)} rows on the "
                                     f"first block at ch = {ch}")
        else:
            outs.append(_clone(step.process_block(blk)))
        refs.append(_clone(ref.process_block(blk)))
    worst = _hold_mesh(f"15b mesh {shape}", outs, refs, step.layout.dir.all_gather)
    return dict(launches=launches, collectives=coll, ms=ms, host_ms=host_ms,
                lock=lock, worst=worst, reduce_ms=reduce_ms, das=das)


def _mesh_power() -> dict:
    """15c on this rank: ``make_sharded_das_power`` over ch = 2 at 1024 mics
    (16 arrays, shift_range 192, an 8x8 grid), against the one-rank dense
    power, rtol 3e-4 / atol 1e-13 (tests/test_parallel.py:117-142), the
    peak on the source; then the time-sharded beam over (dir, t) = (1, 2)
    on the first array's 64 mics: each rank beams its half of the block, the
    second behind the first's last 64 samples (the halo, which gloo stages
    through host memory).  Held against the one-rank beam of the rank's own
    span of the window at rtol 2e-4 / atol 1e-10, and against the one-rank
    beam of the whole block within 1e-5 of its peak (a product of another
    width sums in another order); timed a call, and one halo exchange
    alone (host clock, both ranks in step)."""
    import torch

    from beamforming_lk_tpu_torch import ArrayConfig, MimoConfig
    from beamforming_lk_tpu_torch.io import ring as rg
    from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block
    from beamforming_lk_tpu_torch.models.mimo import make_mimo_grid
    from beamforming_lk_tpu_torch.ops import antenna as ant
    from beamforming_lk_tpu_torch.ops import delay as dl
    from beamforming_lk_tpu_torch.parallel import (
        halo_exchange_time, make_mesh, make_sharded_das_power,
        make_time_sharded_beam, shard_weights, shard_window,
    )
    from beamforming_lk_tpu_torch.parallel import mesh as pm

    acfg, mics, s = ArrayConfig(), 1024, 192
    points = ant.multi_array_cluster(mics)
    theta, phi = make_mimo_grid(MimoConfig(rows=8, columns=8))
    delays = ant.steering_delays_np(points, theta, phi, acfg.samples_per_meter)
    weights = torch.as_tensor(dl.das_weights_np(delays, s), device="cuda")
    block = torch.as_tensor(plane_wave_block(points, [(0.3, 0.6, 3000.0)], 0, 256,
                                             acfg, noise_std=0.02), device="cuda")
    hist = rg.ring_push(rg.ring_init(mics, 1024, device="cuda"), block)
    window = rg.ring_window(hist, 256, s, 2)
    mesh = make_mesh((2, 1))
    f = make_sharded_das_power(mesh)
    local = (shard_window(window, mesh), shard_weights(weights, mesh))
    got = f(*local)
    want = dl.das_power(dl.das_beam(window, weights), divisor=256 * mics)
    excess = _excess(got, want, (3e-4, 1e-13))
    d = int(torch.argmax(got))
    off = _angle(theta[d], phi[d], 0.3, 0.6)
    if not (excess <= 1.0 and off < math.radians(15)):
        raise AssertionError(f"15c: excess {excess:.3g}, peak {off:.3g} rad off")
    ms = _cuda_ms(lambda: f(*local), 10)
    one_ms = _cuda_ms(lambda: dl.das_power(dl.das_beam(window, weights),
                                           divisor=256 * mics), 10)
    # The time-sharded beam on the first array's 64 mics (span 64).
    window, weights = window[:64, s - 64:], torch.as_tensor(dl.das_weights_np(
        ant.steering_delays_np(points[:, :64], theta, phi, acfg.samples_per_meter),
        64), device=window.device)
    tmesh = make_mesh((1, 2), axis_names=(pm.DIR_AXIS, pm.TIME_AXIS))
    part = pm.Axis(tmesh, pm.TIME_AXIS).part(256)
    weights = shard_weights(weights, tmesh)
    chunk, tail = window[:, 64:][:, part].contiguous(), window[:, :64]
    f = make_time_sharded_beam(tmesh)
    beam = f(chunk, tail, weights)
    own = dl.das_beam(window[:, part.start:part.stop + 64], weights)
    whole = dl.das_beam(window, weights)
    t_excess = _excess(beam, own, (2e-4, 1e-10))
    t_rel = float((beam - whole[:, part]).abs().max() / whole.abs().max())
    t_whole = _excess(beam, whole[:, part], (2e-4, 1e-10))
    if not (t_excess <= 1.0 and t_rel <= 1e-5):
        raise AssertionError(f"15c time-sharded beam: excess {t_excess:.3g} over "
                             f"the rank's own span, {t_rel:.3g} of the peak off "
                             f"the whole block's beam")

    def host_ms(fn, n=20):
        fn()
        torch.cuda.synchronize()
        h0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - h0) * 1e3 / n

    t_ms = host_ms(lambda: f(chunk, tail, weights))
    halo_ms = host_ms(lambda: halo_exchange_time(chunk, tail, 64, tmesh))
    one_t_ms = host_ms(lambda: dl.das_beam(window, weights))
    return dict(excess=excess, off=off, ms=ms, one_ms=one_ms, t_excess=t_excess,
                t_rel=t_rel, t_whole=t_whole, t_ms=t_ms, halo_ms=halo_ms,
                one_t_ms=one_t_ms, t_index=tmesh.get_local_rank(pm.TIME_AXIS))


def _mesh_estimators() -> dict:
    """15d on this rank: the bin-sharded MVDR and MUSIC (subspace) over
    dir = 2 at 64 mics on the realtime 64x64 grid (11 bins padded to 12),
    6 blocks, against the single-device estimator on the card (9e's
    bounds: MVDR 2e-3 relative, MUSIC by its invariants)."""
    from beamforming_lk_tpu_torch.models import music as mu
    from beamforming_lk_tpu_torch.models import mvdr as mv
    from beamforming_lk_tpu_torch.models.mimo import make_mimo_grid
    from beamforming_lk_tpu_torch.parallel import make_mesh

    mesh = make_mesh((1, 2))
    lines = {}
    for name, solver in (("mvdr", ""), ("music subspace", "subspace")):
        one, cfg, array = _estimator(64, "cuda", solver)
        theta, phi = make_mimo_grid(cfg.mimo)
        if solver:
            sharded, state = mu.make_sharded_music_step(
                array.points, theta, phi, mesh, array_cfg=cfg.array,
                solver=solver, device="cuda")
        else:
            sharded, state = mv.make_sharded_mvdr_step(
                array.points, theta, phi, mesh, array_cfg=cfg.array,
                device="cuda")
        blocks = _plane_wave_blocks(array, cfg, 64, "cuda", ADAPTIVE_BLOCKS)
        one_state = one.init()
        for blk in blocks:
            state, got = sharded(state, blk)
            one_state, want = one(one_state, blk)
        lines[name] = (f"{sharded.n_bins} bins a rank, "
                       + _hold_estimates(f"15d {name}", got, want, bool(solver)))
    return lines


def mesh_rank_main(rank: int, tmp: str) -> None:
    """One of 15b-15d's two ranks: both share the card through gloo (NCCL
    refuses two ranks of one communicator on one GPU), named here; the
    results go to ``tmp/rank{rank}.json`` for the parent."""
    import torch
    import torch.distributed as dist

    from beamforming_lk_tpu_torch.parallel.multihost import initialize

    initialize(f"file://{os.path.join(tmp, 'rendezvous')}", 2, rank, backend="gloo")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"device": torch.cuda.current_device()}
    for shape in ((2, 1), (1, 2)):
        out[f"{shape[0]}x{shape[1]}"] = _mesh_awpu(shape)
    out["power"] = _mesh_power()
    out["estimators"] = _mesh_estimators()
    dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def run_mesh_two_ranks(tmp: str) -> dict:
    """15b-15d: two ranks of this script on the one card (gloo on CUDA
    tensors); a rank that fails fails the phase.  Returns the kernels'
    launches of 15b's free runs, summed over the ranks."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--mesh-rank", str(r), tmp],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
              for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode]
    if failed:
        raise AssertionError("15b-15d: " + "\n".join(failed))
    ranks = []
    for r in range(2):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    launches = dict.fromkeys(_wrappers(), 0)
    for shape in ("2x1", "1x2"):
        res = [rk[shape] for rk in ranks]
        for rk in res:
            for k, v in rk["launches"].items():
                launches[k] += v
        r0 = res[0]
        per = {k: v / MESH_BLOCKS for k, v in r0["launches"].items() if v}
        das = "; ".join(
            f"{d} rows x {c} channels {compute} (last block {tail_rows} rows): "
            f"max abs {err:.3g}, {rel:.3g} of the peak, that block {tail:.3g}"
            for d, (c, compute, tail_rows, err, rel, tail) in sorted(
                r0["das"].items(), key=lambda kv: int(kv[0])))
        das = (f"K4 on the first block's own operands vs twin (tol 1e-5 of the "
               f"peak), rank 0: {das}; " if das else "")
        print(f"15b mesh (ch, dir) = ({shape[0]}, {shape[2]}), 2 ranks on one card "
              f"(gloo), realtime, 256 mics, {MESH_BLOCKS} blocks: launches a block "
              f"a rank {per}, all-reduces a block a rank "
              f"{r0['collectives']['all_reduce'] / MESH_BLOCKS:.4g} "
              f"({r0['reduce_ms']:.4f} ms each for a sub-step's [108, 254] "
              f"partial beams, host clock, where ch > 1); "
              f"{max(rk['ms'] for rk in res):.4f} ms/block device, "
              f"{max(rk['host_ms'] for rk in res):.4f} host (slowest rank); "
              f"{r0['lock']}; {das}lockstep vs one rank, worst excess over the sharded "
              f"bounds " + ", ".join(f"{k} {v:.3g}" for k, v in r0["worst"].items()),
              flush=True)
    p0 = ranks[0]["power"]
    pw = [rk["power"] for rk in ranks]
    if sorted(p["t_index"] for p in pw) != [0, 1]:
        raise AssertionError(f"15c: t indices {[p['t_index'] for p in pw]}")
    print(f"15c make_sharded_das_power, ch = 2, 1024 mics, shift_range 192: "
          f"excess over rtol 3e-4 {p0['excess']:.3g}, peak {math.degrees(p0['off']):.2f} "
          f"deg off the source; {p0['ms']:.4f} ms sharded (a rank), "
          f"{p0['one_ms']:.4f} ms one rank", flush=True)
    print(f"15c time-sharded beam, (dir, t) = (1, 2), 64 mics, span 64, a 256-sample "
          f"block in two chunks of 128 (the halo through host memory on gloo): "
          f"vs the one-rank beam of each rank's span, worst excess over rtol 2e-4 / "
          f"atol 1e-10 {max(p['t_excess'] for p in pw):.3g}; vs the whole block's "
          f"one-rank beam {max(p['t_rel'] for p in pw):.3g} of its peak (tol 1e-5; "
          f"excess over rtol 2e-4 / atol 1e-10 {max(p['t_whole'] for p in pw):.3g}, "
          f"not gated); {max(p['t_ms'] for p in pw):.4f} ms a call sharded, "
          f"{max(p['halo_ms'] for p in pw):.4f} ms one halo exchange alone (slowest "
          f"rank, host clock, 20 calls), {p0['one_t_ms']:.4f} ms the whole block's "
          f"beam on one rank; {_card_line()}", flush=True)
    for name, line in ranks[0]["estimators"].items():
        print(f"15d bin-sharded {name}, dir = 2, 64 mics, {ADAPTIVE_BLOCKS} blocks "
              f"vs one device: {line}", flush=True)
    return launches

def main() -> int:
    import tempfile

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on the card")
    print(_card_line(), flush=True)
    import beamforming_lk_tpu_torch  # noqa: F401  (fails outside the repo)
    from beamforming_lk_tpu_torch.ops import cuda_das as cd
    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk
    from beamforming_lk_tpu_torch.ops import fft_das as fd
    from beamforming_lk_tpu_torch.ops import nvcc

    if "jax" in sys.modules:
        raise AssertionError("the port loaded jax")
    # f32 products in full precision on every phase (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    libs = nvcc.build_all([("swarm_chain", [ctk._SOURCE]),
                           ("power_matmul", [fd._SOURCE]),
                           ("das_beam", [cd._SOURCE])])
    ctk._library()
    fd._library()
    cd._library()
    print(f"built swarm_chain, power_matmul and das_beam in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc each, in parallel)",
          flush=True)
    for lib in libs:
        for line in open(lib + ".log"):
            if "registers" in line or "smem" in line:
                print("  ptxas:", line.strip())
    print(f"K1 and K2 launch one thread block cluster of {ctk.cluster_size()} "
          "CTAs (512 threads each)", flush=True)

    k1 = {}
    for ch in (64, 256):
        for compute in ("bfloat16", "float32"):
            k1[ch, compute] = compare_kernel(ch, compute, "cuda", timing=True)
    for ch, compute in ((64, "float32"), (256, "bfloat16")):
        compare_kernel(ch, compute, "cuda", timing=False, interp="fir")
    k2 = {}
    for ch in (64, 256):
        for compute in ("bfloat16", "float32"):
            k2[ch, compute] = compare_chunk(ch, compute, "cuda")
    k3 = {}
    for rows in POWER_ROWS:
        for compute in ("bfloat16", "float32"):
            k3[rows, compute] = compare_power(rows, compute, "cuda")
    end_to_end_check("cuda")
    launches = dict.fromkeys(_wrappers(), 0)
    for name, n in run_default_built().items():
        launches[name] += n
    for ch in (64, 256):
        launches["swarm_chain"] += run_slice(ch, "cuda")[0]
    for ch in (64, 256):
        launches["swarm_chunk"] += run_replay(ch, "cuda")[0]
    launches["power_matmul"] += run_chunked_heatmap("cuda")[0]
    launches["power_matmul"] += run_phat_lattice("cuda")[0]
    n_k1, n_k4, _ = run_calibration("cuda")
    launches["swarm_chain"] += n_k1
    launches["das_beam"] += n_k4
    n_k1, n_k2 = run_save_restore("cuda")
    launches["swarm_chain"] += n_k1
    launches["swarm_chunk"] += n_k2
    launches["swarm_chain"] += run_fusion("cuda")[0]
    adaptive_card_vs_cpu("cuda")
    mvdr_live = None
    for ch in (64, 256):
        n_k1, mvdr_live = run_adaptive(ch, "cuda")
        launches["swarm_chain"] += n_k1
        run_eigh(ch, "cuda")
    launches["swarm_chunk"] += run_adaptive_replay("cuda", mvdr_live)
    k4, k0 = {}, {}
    for ch in (64, 256):
        for compute in ("float32", "bfloat16"):
            k4[ch, compute] = compare_das(ch, compute, "cuda")
            k0[ch, compute] = compare_monopulse(ch, compute, "cuda")
    for ch, compute in ((64, "float32"), (256, "bfloat16")):
        compare_das(ch, compute, "cuda", interp="fir", timing=False)
        compare_monopulse(ch, compute, "cuda", interp="fir", timing=False)
    end_to_end_default("cuda")
    for ch in (64, 256):
        n_k0, n_k4, _, _ = run_default(ch, "cuda")
        launches["monopulse_chain"] += n_k0
        launches["das_beam"] += n_k4
    launches["das_beam"] += run_fallback("cuda")[0]
    with tempfile.TemporaryDirectory() as tmp:
        launches["swarm_chunk"] += run_cli_replay(tmp)
        launches["swarm_chain"] += run_cli_live()
        n_k0, n_k4 = run_cli_default(tmp)
        launches["monopulse_chain"] += n_k0
        launches["das_beam"] += n_k4
        launches["swarm_chain"] += run_cli_fusion(tmp)
        launches["swarm_chunk"] += run_cli_adaptive(tmp)
        launches["monopulse_chain"] += run_mesh_one_rank()[0]
        for name, n in run_mesh_two_ranks(tmp).items():
            launches[name] += n

    def row(name, source, replaces, results, key):
        r = results[key]
        return {
            "name": name, "route": "cuda",
            "source": f"beamforming_lk_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(v["err"] for v in results.values()),
            **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
        }

    print(json.dumps({"kernels": [
        row("swarm_chain", "swarm_chain.cu",
            "beamforming_lk_tpu/ops/pallas_tracker.py:1011", k1, (64, "bfloat16")),
        row("swarm_chunk", "swarm_chain.cu",
            "beamforming_lk_tpu/ops/pallas_tracker.py:1160", k2, (64, "bfloat16")),
        row("power_matmul", "power_matmul.cu",
            "beamforming_lk_tpu/ops/fft_das.py:412", k3, (16384, "bfloat16")),
        row("monopulse_chain", "swarm_chain.cu",
            "beamforming_lk_tpu/ops/pallas_tracker.py:411", k0, (64, "float32")),
        row("das_beam", "das_beam.cu",
            "beamforming_lk_tpu/ops/pallas_das.py:185", k4, (64, "float32")),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_rank_main(int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    sys.exit(main())
