#!/usr/bin/env python3
"""Measure the port's swarm kernels and realtime profile on one CUDA card.

    python3 perf_swarm.py clusters   # K1 and K2 at cluster sizes 16 and 8, K0
    python3 perf_swarm.py numerics   # the card-vs-CPU checks per rounding path
    python3 perf_swarm.py phases     # K1 with fewer iterations and sub-steps
    python3 perf_swarm.py profile    # live and replay at 64 and 256 mics

``clusters`` builds ``csrc/swarm_chain.cu`` as it is and a copy with the
cluster size set to 8, holds each against the plain twins (as
``chip_smoke.py`` does), then times K1 and K2 at 64 and 256 mics in bf16
and f32 with the two builds in turns (16, 8, 8, 16), and K0 with its
twin.  ``numerics`` builds copies whose monopulse chain splits a probe's
channels over warps as K1 does, or whose beam sums use a multiply and an
add for each fused multiply-add, and runs ``chip_smoke.py``'s two
end-to-end card-vs-CPU checks on each.  ``phases`` times K1 on
``chip_smoke.py``'s operands cut to (iterations, sub-steps) of (0, 1),
(1, 1), (1, 3), (1, 5) and (2, 5), which splits a block's time into the
fixed part (launch, window staging, prune, MISO beam), sub-step 0, the
later sub-steps and an iteration boundary.  ``profile`` runs ``AwpuPipeline(realtime(Config()))`` on plane-wave
blocks: wall and host-enqueue ms per block, ``torch.profiler``'s device
busy time, kernels and idle share per block over 48 blocks, and the
per-block latency (``process_block`` + synchronize) over 1200 blocks.
Both print the card's name and power limit first and a JSON summary last.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

import chip_smoke as cs

SHAPES = [(ch, compute) for ch in (64, 256) for compute in ("bfloat16", "float32")]


FMA = "acc[i] = __fmaf_rn(w, load_f(rp + off[i] + j), acc[i]);"
NO_FMA = "acc[i] = acc[i] + w * load_f(rp + off[i] + j);"


def _variant(name: str, edits) -> tuple:
    """(name, [path]) of a copy of the swarm-chain source with each
    (line, replacement) of ``edits`` applied, for ``nvcc.build_all``."""
    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk
    from beamforming_lk_tpu_torch.ops import nvcc

    src = open(ctk._SOURCE).read()
    for line, repl in edits:
        if line not in src:
            raise AssertionError(f"{ctk._SOURCE} has no line {line!r}")
        src = src.replace(line, repl)
    os.makedirs(nvcc.BUILD_DIR, exist_ok=True)
    path = os.path.join(nvcc.BUILD_DIR, f"{name}.cu")
    with open(path, "w") as f:
        f.write(src)
    return name, [path]


def _build(variants: dict) -> dict:
    """The loaded library of each variant {label: edits}."""
    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk
    from beamforming_lk_tpu_torch.ops import nvcc

    t0 = time.perf_counter()
    paths = nvcc.build_all([_variant(f"swarm_chain_v{i}", edits)
                            for i, edits in enumerate(variants.values())])
    print(f"built {len(paths)} variants in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in open(paths[0] + ".log"):
        if "registers" in line or "smem" in line:
            print("  ptxas:", line.strip())
    return {label: ctk.load_library(path) for label, path in zip(variants, paths)}


def clusters() -> dict:
    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk

    built = _build({16: [], 8: [("constexpr int kClusterMax = 16;",
                                 "constexpr int kClusterMax = 8;")]})
    libs = {}
    for want, lib in built.items():
        got = lib.swarm_cluster_size()
        print(f"build for {want}: cluster size {got}", flush=True)
        libs[got] = lib
    out = {"cluster": {}, "k0": {}}
    for n, lib in libs.items():
        ctk._library = lambda lib=lib: lib
        for ch, compute in SHAPES:
            print(f"-- cluster {n}", flush=True)
            cs.compare_kernel(ch, compute, "cuda", timing=False)
            cs.compare_chunk(ch, compute, "cuda")
    times = {n: {} for n in libs}
    for n in sorted(libs, reverse=True) + sorted(libs):
        ctk._library = lambda lib=libs[n]: lib
        for ch, compute in SHAPES:
            ops, kw = cs.chain_operands(ch, compute, "cuda")
            cops, ckw = cs.chunk_operands(ch, compute, "cuda")
            k1 = cs._cuda_ms(lambda: ctk.swarm_chain(*ops, **kw), 50)
            k2 = cs._cuda_ms(lambda: ctk.swarm_chunk(*cops, **ckw), 20)
            times[n].setdefault(f"{ch} {compute}", []).append((k1, k2))
    for n, per in times.items():
        out["cluster"][n] = {}
        for shape, runs in per.items():
            k1 = statistics.mean(r[0] for r in runs)
            k2 = statistics.mean(r[1] for r in runs)
            out["cluster"][n][shape] = {"k1_ms": k1, "k2_ms": k2,
                                        "runs": runs}
            print(f"cluster {n:2d} {shape:13s}: K1 {k1:.4f} ms, K2 {k2:.4f} ms "
                  f"per 12 blocks (runs {runs})", flush=True)
    ctk._library = lambda lib=libs[max(libs)]: lib
    for ch, compute in SHAPES:
        r = cs.compare_monopulse(ch, compute, "cuda")
        out["k0"][f"{ch} {compute}"] = {k: r[k] for k in ("ms", "plain_ms",
                                                          "bound_ms")}
    return out


def numerics() -> dict:
    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk

    split = ("constexpr bool kChainSplit = false;",
             "constexpr bool kChainSplit = true;")
    libs = _build({"as built": [], "K0 split": [split],
                   "K0 split, no FMA": [split, (FMA, NO_FMA)],
                   "no FMA": [(FMA, NO_FMA)]})
    out = {}
    for label, lib in libs.items():
        ctk._library = lambda lib=lib: lib
        for check in (cs.end_to_end_default, cs.end_to_end_check):
            print(f"-- {label}: {check.__name__}", flush=True)
            try:
                check("cuda")
                out[f"{label}: {check.__name__}"] = "passed"
            except AssertionError as e:
                print(f"   failed: {e}", flush=True)
                out[f"{label}: {check.__name__}"] = f"failed: {e}"
    return out


def phases() -> dict:
    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk

    out = {}
    for ch, compute in SHAPES:
        ops, kw = cs.chain_operands(ch, compute, "cuda")
        row = {}
        for n_iter, n_sub in ((0, 1), (1, 1), (1, 3), (1, 5), (2, 5)):
            args = ops[:4] + (ops[4][:, :n_iter].contiguous(),) + ops[5:]
            kws = dict(kw, n_iter=n_iter, n_sub=n_sub)
            row[f"{n_iter}x{n_sub}"] = cs._cuda_ms(
                lambda: ctk.swarm_chain(*args, **kws), 50)
        out[f"{ch} {compute}"] = row
        print(f"K1 {ch:3d} mics {compute:8s} by (iterations x sub-steps): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in row.items()), flush=True)
    return out


def _device_columns(prof, n_blocks: int) -> dict:
    """Device busy ms, kernels and idle share per block from a profile."""
    from torch.autograd import DeviceType

    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ev:
        return {"device_busy_ms": "not measured"}
    spans = sorted((e.time_range.start, e.time_range.end) for e in ev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = max(e for _, e in spans) - spans[0][0]
    kernels = [e for e in ev if not e.name.startswith(("Memcpy", "Memset"))]
    swarm = sum(e.time_range.elapsed_us() for e in ev
                if "swarm_" in e.name or "monopulse_chain" in e.name)
    return {"device_busy_ms": busy / 1e3 / n_blocks,
            "swarm_kernel_ms": swarm / 1e3 / n_blocks,
            "kernels_per_block": len(kernels) / n_blocks,
            "idle_share": 1.0 - busy / window}


def _run(pipe, blocks, replay: bool):
    if replay:
        return pipe.process_blocks(blocks)
    for b in blocks:
        out = pipe.process_block(b)
    return out


def profile() -> dict:
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from beamforming_lk_tpu_torch import Config, realtime
    from beamforming_lk_tpu_torch.app import AwpuPipeline

    cfg = realtime(Config())
    out = {}
    for ch in (64, 256):
        for mode in ("live", "replay"):
            pipe = AwpuPipeline(cfg, channels=ch, seed=0, device="cuda")
            blocks = cs._plane_wave_blocks(pipe, cfg, ch, "cuda")
            replay = mode == "replay"
            _run(pipe, blocks[:24], replay)
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            _run(pipe, blocks[24:72], replay)
            enqueue = (time.perf_counter() - h0) * 1e3 / 48
            torch.cuda.synchronize()
            wall = (time.perf_counter() - h0) * 1e3 / 48
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                _run(pipe, blocks[48:96], replay)
                torch.cuda.synchronize()
            row = {"wall_ms": wall, "host_enqueue_ms": enqueue,
                   **_device_columns(prof, 48)}
            out[f"{mode} {ch}"] = row
            print(f"{mode:6s} {ch:3d} mics: " + ", ".join(
                f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in row.items()), flush=True)
    for ch in (64, 256):
        pipe = AwpuPipeline(cfg, channels=ch, seed=0, device="cuda")
        blocks = cs._plane_wave_blocks(pipe, cfg, ch, "cuda")
        lat = []
        for i in range(24 + 1200):
            t = time.perf_counter()
            pipe.process_block(blocks[i % len(blocks)])
            torch.cuda.synchronize()
            if i >= 24:
                lat.append((time.perf_counter() - t) * 1e3)
        med, p99 = float(np.median(lat)), float(np.percentile(lat, 99))
        out[f"latency {ch}"] = {"median_ms": med, "p99_ms": p99, "blocks": 1200}
        print(f"latency {ch:3d} mics over 1200 blocks: median {med:.4f} ms, "
              f"p99 {p99:.4f} ms (budget {cs.BUDGET_MS:.2f} ms)", flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("perf_swarm: no CUDA device; this runs on the card")
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    runs = {"clusters": clusters, "numerics": numerics, "phases": phases,
            "profile": profile}
    if what not in runs:
        raise SystemExit(__doc__)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs._card_line()
    print(card, flush=True)
    out = runs[what]()
    print(json.dumps({"card": card, what: out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
