#!/usr/bin/env python3
"""Drive the PyTorch port's live per-block step on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failed check raises, so the exit code is non-zero):

1. require a CUDA device; print the card's name and power limit;
2. build the swarm-chain kernel from ``beamforming_lk_tpu_torch/csrc``;
3. kernel against its plain twin at the deployment shapes (64 and 256 mics,
   27 particle rows, bf16 and f32 windows), with times from CUDA events;
4. a small end-to-end check: 9 blocks through the f32 profile on the card
   and on the CPU (the twin), outputs compared;
5. the slice: ``AwpuPipeline(realtime(Config()), channels=64|256)`` on 96
   plane-wave blocks through ``process_block``, locked on the source, with
   the kernel launched once per block and the ms per block;
6. one JSON line of kernel results, then the final status line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np

SOURCE = (0.5, 1.2, 5000.0)          # theta, phi [rad], frequency [Hz]
BUDGET_MS = 256 / 48828.0 * 1e3      # one block of audio: 5.24 ms
N_BLOCKS = 96
N_TRACKERS, N_SEEKERS = 10, 16       # TrackerConfig defaults: P = 27 rows


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, n: int) -> float:
    """Mean device time of ``fn()`` over ``n`` calls, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def _angle(theta1, phi1, theta2, phi2) -> float:
    """Largest great-circle angle [rad] between paired directions."""
    def unit(t, p):
        t, p = np.asarray(t, np.float64), np.asarray(p, np.float64)
        return np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p), np.cos(t)])

    chord = np.linalg.norm(unit(theta1, phi1) - unit(theta2, phi2), axis=0)
    return float((2.0 * np.arcsin(np.minimum(chord / 2.0, 1.0))).max())


def chain_operands(channels: int, compute: str, device, seed: int = 0):
    """Operands of one swarm-chain call at the deployment shapes, seeded so
    merge, jump and promote all fire: two coincident tracking trackers, a
    published target on a seeker, free trackers, a plane-wave source."""
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
    span = dl.probe_span(pts, cfg.array.samples_per_meter, 2, dsp.shift_range)
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
              refine=3, n_trackers=nt, span=span, taps=2,
              theta_limit=tc.theta_limit, divisor=float(dsp.block_size),
              closeness=tc.tracker_closeness,
              error_threshold=tc.error_threshold,
              min_power_fraction=tc.min_power_fraction)
    return ops, kw


def compare_kernel(channels: int, compute: str, device, timing: bool):
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

    Both settings: tracking flags and start stamps equal.  Returns
    (full-chain tracker/listener direction error, kernel ms, twin ms)."""
    import torch

    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk

    ops, kw = chain_operands(channels, compute, device)
    bf16 = compute == "bfloat16"
    pub = slice(0, N_TRACKERS + 1)                  # trackers | listener
    seek = slice(N_TRACKERS + 1, None)
    settings = (
        ("1 sub-step", dict(kw, n_iter=1, n_sub=1, refine=1),
         dict(pub=1e-5, seek=1e-5, grad=1e-4, beam=1e-5, mean=1e-5)),
        ("full chain", kw,
         dict(pub=1e-3, seek=5e-2, grad=1e-2, beam=1e-3, mean=1e-2) if bf16
         else dict(pub=1e-4, seek=5e-2, grad=1e-3, beam=1e-4, mean=1e-2)),
    )
    for label, kws, tol in settings:
        jumps = ops[4][:, :kws["n_iter"]].contiguous()
        args = ops[:4] + (jumps,) + ops[5:]
        got = ctk.swarm_chain(*args, **kws)
        want = ctk.swarm_chain_reference(*args, **kws)
        if device != "cpu":
            torch.cuda.synchronize()
        gs, gm, gb = (x.cpu().numpy() for x in got)
        ws, wm, wb = (x.cpu().numpy() for x in want)
        for name, x, y in (("tracking", gs[6], ws[6]), ("start", gs[7], ws[7])):
            if not np.array_equal(x, y):
                raise AssertionError(f"{name} differs at {channels} mics "
                                     f"{compute} {label}: {x} vs {y}")
        scale = lambda v: max(float(np.abs(v).max()), 1e-30)  # noqa: E731
        grad_rows = slice(None) if label == "1 sub-step" else pub
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
                                     f"{tol[name]} at {channels} mics "
                                     f"{compute} {label}")
        print(f"kernel vs twin {channels:3d} mics {compute:8s} {label:10s}: "
              + "  ".join(f"{k} {e:.3g} (tol {tol[k]:g})"
                          for k, e in errs.items()), flush=True)
    ms = plain_ms = float("nan")
    if timing:
        ms = _cuda_ms(lambda: ctk.swarm_chain(*ops, **kw), 50)
        plain_ms = _cuda_ms(lambda: ctk.swarm_chain_reference(*ops, **kw), 5)
        print(f"  time per call, full chain: kernel {ms:.4f} ms, twin "
              f"{plain_ms:.4f} ms", flush=True)
    return errs["pub"], ms, plain_ms


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


def run_slice(channels: int, device):
    """96 plane-wave blocks through the realtime profile; returns
    (kernel launches, ms per block on the device clock, host ms/block)."""
    import torch

    from beamforming_lk_tpu_torch import Config, realtime
    from beamforming_lk_tpu_torch.app import AwpuPipeline
    from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block
    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk

    cfg = realtime(Config())
    pipe = AwpuPipeline(cfg, channels=channels, seed=0, device=device)
    rng = np.random.default_rng(channels)
    blocks = torch.as_tensor(np.stack([
        plane_wave_block(pipe.points, [SOURCE], i * 256, 256, cfg.array,
                         noise_std=0.02, rng=rng)
        for i in range(N_BLOCKS)
    ]), device=device)
    warm = 16
    on_card = device != "cpu"
    ctk.swarm_chain.launches = 0
    last_map = None
    for i in range(N_BLOCKS):
        if i == warm and on_card:
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e0.record()
            h0 = time.perf_counter()
        out = pipe.process_block(blocks[i])
        if i % cfg.mimo.heatmap_every == 0:
            last_map = out.powers
    ms = host_ms = float("nan")
    if on_card:
        e1 = torch.cuda.Event(enable_timing=True)
        e1.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - h0) * 1e3 / (N_BLOCKS - warm)
        ms = e0.elapsed_time(e1) / (N_BLOCKS - warm)
    launches = ctk.swarm_chain.launches

    expect = N_BLOCKS if on_card else 0
    if launches != expect:
        raise AssertionError(f"{channels} mics: {launches} kernel launches "
                             f"for {N_BLOCKS} blocks")
    beam = out.miso_beam.cpu().numpy()
    if not (np.isfinite(beam).all() and np.abs(beam).max() > 0):
        raise AssertionError(f"{channels} mics: MISO beam not finite/non-zero")
    tgts = pipe.targets()
    src_xyz = np.array([math.sin(SOURCE[0]) * math.cos(SOURCE[1]),
                        math.sin(SOURCE[0]) * math.sin(SOURCE[1]),
                        math.cos(SOURCE[0])])
    off = [math.degrees(math.acos(min(1.0, float(np.dot(src_xyz, [
        math.sin(t["theta"]) * math.cos(t["phi"]),
        math.sin(t["theta"]) * math.sin(t["phi"]), math.cos(t["theta"])])))))
        for t in tgts]
    if not off or min(off) > 5.0:
        raise AssertionError(f"{channels} mics: no target within 5 deg: {tgts}")
    powers = last_map.cpu().numpy()
    if not np.isfinite(powers).all():
        raise AssertionError(f"{channels} mics: heatmap not finite")
    rows, cols = cfg.mimo.rows, cfg.mimo.columns
    sep = math.sin(math.radians(cfg.mimo.fov_degrees / 2)) / (rows / 2)
    want_c = round((src_xyz[0] + (cols - 1) * sep / 2) / sep)
    want_r = round((src_xyz[1] + (rows - 1) * sep / 2) / sep)
    peak_r, peak_c = divmod(int(np.argmax(powers)), cols)
    if max(abs(peak_r - want_r), abs(peak_c - want_c)) > 1:
        raise AssertionError(f"{channels} mics: heatmap peak at ({peak_r}, "
                             f"{peak_c}), source at ({want_r}, {want_c})")
    print(f"slice {channels:3d} mics: {launches} launches / {N_BLOCKS} blocks, "
          f"target {min(off):.2f} deg off, heatmap peak ({peak_r}, {peak_c}) vs "
          f"source ({want_r}, {want_c}), beam peak {np.abs(beam).max():.4g}; "
          f"{ms:.4f} ms/block device, {host_ms:.4f} ms/block host "
          f"(budget {BUDGET_MS:.2f} ms)", flush=True)
    return launches, ms, host_ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this check runs on the card")
    print(_card_line(), flush=True)
    import beamforming_lk_tpu_torch  # noqa: F401  (fails outside the repo)
    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk
    from beamforming_lk_tpu_torch.ops import nvcc

    if "jax" in sys.modules:
        raise AssertionError("the port loaded jax")
    t0 = time.perf_counter()
    ctk._library()
    print(f"built swarm_chain in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in open(nvcc.build("swarm_chain", [ctk._SOURCE]) + ".log"):
        if "registers" in line or "smem" in line:
            print("  ptxas:", line.strip())

    results = {}
    for ch in (64, 256):
        for compute in ("bfloat16", "float32"):
            results[ch, compute] = compare_kernel(ch, compute, "cuda", timing=True)
    end_to_end_check("cuda")
    launches = 0
    for ch in (64, 256):
        launches += run_slice(ch, "cuda")[0]

    err = max(r[0] for r in results.values())
    _, ms, plain_ms = results[64, "bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "swarm_chain", "route": "cuda",
        "source": "beamforming_lk_tpu_torch/csrc/swarm_chain.cu",
        "replaces": "beamforming_lk_tpu/ops/pallas_tracker.py:1011",
        "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
