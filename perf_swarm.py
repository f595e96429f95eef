#!/usr/bin/env python3
"""Measure the port's kernels and profiles on one CUDA card.

    python3 perf_swarm.py clusters   # K1 and K2 at cluster sizes 16 and 8, K0
    python3 perf_swarm.py phases     # K1 with fewer iterations and sub-steps
    python3 perf_swarm.py profile    # realtime live and replay at 64 and 256 mics
    python3 perf_swarm.py default    # the default profile at 64 and 256 mics
    python3 perf_swarm.py adaptive   # realtime live with MVDR, MVDR refresh 3
                                     # and MUSIC at 64 and 256 mics
    python3 perf_swarm.py versus DIR # K3, K0, K4, K1 and K2 of a checkout at DIR
                                     # against this tree's, in turns
    python3 perf_swarm.py ablate     # K4 with parts of its inner step cut out
    python3 perf_swarm.py ablate3    # K3 (bf16) with parts of its work cut out

``clusters`` builds ``csrc/swarm_chain.cu`` as it is and a copy with the
cluster size set to 8, holds each against the plain twins (as
``chip_smoke.py`` does), then times K1 and K2 at 64 and 256 mics in bf16
and f32 with the two builds in turns (16, 8, 8, 16), and K0 with its
twin.  ``phases`` times K1 on ``chip_smoke.py``'s operands cut to
(iterations, sub-steps) of (0, 1), (1, 1), (1, 3), (1, 5) and (2, 5),
which splits a block's time into the fixed part (launch, window staging,
prune, MISO beam), sub-step 0, the later sub-steps and an iteration
boundary.  ``profile`` runs ``AwpuPipeline(realtime(Config()))`` and
``default`` runs ``AwpuPipeline(Config())`` (64 x 64 dense heatmap) on
plane-wave blocks: wall and host-enqueue ms per block over 48 blocks
after 24 warm ones, ``torch.profiler``'s device busy time, kernel times,
kernels and idle share per block over 48 more, and the per-block latency
(``process_block`` + synchronize) over 1200 blocks (``default``: 1008).
``adaptive`` takes the same columns of the realtime profile live, tracker
and MISO on, with each of ``chip_smoke.ADAPTIVE``'s estimators in place of
the DAS heatmap (``heatmap_mode``), latency over 1008 blocks.
``versus`` loads the kernel wrappers of another checkout of the repo (the
parent commit, unpacked with ``git archive``), builds its sources beside
this tree's, and on ``chip_smoke.py``'s operands holds its K3 outputs
against this tree's by their largest difference relative to the largest
power (16 384 and 32 768 rows, bf16 and f32) and each of its K0, K4, K1
and K2 outputs for bitwise equality, then times the two in turns (other,
this, this, other).  ``ablate3`` times K3's bf16 path as built and with
one part of its work cut out (B staging only, launch only, no products,
no repack, no A loads, no exchange, products only), in turns.  ``ablate`` times K4
as built and three copies that each drop one part of a (direction,
channel) step (the residue switch, the window loads, the entry loads;
their beams are wrong on purpose), in turns.  Each mode prints the
card's name and power limit first and a JSON summary last.
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


def _variant(name: str, edits, source: str = "") -> tuple:
    """(name, [path]) of a copy of ``source`` (the swarm-chain source by
    default) with each (line, replacement) of ``edits`` applied, for
    ``nvcc.build_all``."""
    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk
    from beamforming_lk_tpu_torch.ops import nvcc

    source = source or ctk._SOURCE
    src = open(source).read()
    for line, repl in edits:
        if line not in src:
            raise AssertionError(f"{source} has no line {line!r}")
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


KERNEL_NAMES = {"swarm_kernel_ms": ("swarm_", "monopulse_chain"),
                "das_beam_ms": ("das_beam",)}


# Edits of csrc/das_beam.cu that each drop one part of a (direction,
# channel) step; their beams are wrong, and only their times are read.
_LOAD_RUN = """      load_run<kValues>(row + __float_as_int(ew[TAPS]),
                        __float_as_int(ew[TAPS + 1]), v);"""
_ENTRY = """        const float4 e4 = *reinterpret_cast<const float4*>(e + f);"""
ABLATIONS = {
    "as built": [],
    "no residue switch": [(_LOAD_RUN, """      load_run<kValues, 0>(row + __float_as_int(ew[TAPS]), v);""")],
    "no window loads": [(_LOAD_RUN, """#pragma unroll
      for (int k = 0; k < kValues; ++k)
        v[k] = __int_as_float(__float_as_int(ew[TAPS + 1]) + k);""")],
    "no entry loads": [(_ENTRY, """        const float4 e4 = make_float4(
            0.5f, 0.25f, __int_as_float(c), __int_as_float(c & 7));""")],
}


def ablate() -> dict:
    """K4 built as it is and with one part of its (direction, channel) step
    cut out (``ABLATIONS``), timed in turns at 64 and 256 mics f32 on the
    default profile's heatmap: what each part costs."""
    import ctypes

    from beamforming_lk_tpu_torch.ops import cuda_das as cd
    from beamforming_lk_tpu_torch.ops import nvcc

    paths = nvcc.build_all([_variant(f"das_beam_a{i}", edits, cd._SOURCE)
                            for i, edits in enumerate(ABLATIONS.values())])
    real = cd._library()
    libs = {}
    for label, path in zip(ABLATIONS, paths):
        lib = ctypes.CDLL(path)
        lib.das_beam_launch.argtypes = real.das_beam_launch.argtypes
        lib.das_beam_launch.restype = ctypes.c_int
        libs[label] = lib
    ops = {ch: cs.das_operands(ch, "cuda") for ch in (64, 256)}
    times = {label: {ch: [] for ch in ops} for label in libs}
    for label in list(libs) + list(libs)[::-1]:
        cd._library = lambda lib=libs[label]: lib
        for ch, (model, stack) in ops.items():
            times[label][ch].append(cs._cuda_ms(lambda: cd.das_beam(
                stack[0], model.shift, model.tap_weights,
                span=model.shift_range), 50))
    cd._library = lambda: real
    out = {}
    for label, per in times.items():
        out[label] = {f"{ch} float32": statistics.mean(v) for ch, v in per.items()}
        print(f"K4 {label:18s}: " + ", ".join(
            f"{ch} mics {statistics.mean(v):.4f} ms (runs {v})"
            for ch, v in per.items()), flush=True)
    return out


# Edits of csrc/power_matmul.cu that each drop one part of the bf16 path's
# work; their powers are wrong, and only their times are read.
_K3_TILES = "for (int tile = tile0; tile < n_tiles; ++i, tile += n_clusters) {"
_K3_REPACK = [("""        repack_quarter(raw + s * slot_bytes, L, s_a + b * tile_elems, q * kQuarter,
                       max(0, min(kQuarter, R - r0)), F, pw, lane);
""", "")]
_K3_LOADS = [("        if (bulk)\n", "        if (bulk && R < 0)\n"),
             ("        mbar_expect(landed + s, 2 * bulk);", "        mbar_expect(landed + s, 0);")]
_K3_EXCHANGE = [("      if (rank == 0) {\n        mbar_wait", "      if (R < 0) {\n        mbar_wait"),
                ("      } else {\n        if (i >= 2) mbar_wait(empty_h",
                 "      } else if (R < 0) {\n        if (i >= 2) mbar_wait(empty_h")]
K3_ABLATIONS = {
    "as built": [],
    "B staging only": [(_K3_TILES, _K3_TILES.replace("tile < n_tiles", "tile < 0")),
                       ("      for (int u = 0; u < 4 * my_tiles; ++u) {",
                        "      for (int u = 0; u < 0; ++u) {")],
    "launch only": [(_K3_TILES, _K3_TILES.replace("tile < n_tiles", "tile < 0")),
                    ("      for (int u = 0; u < 4 * my_tiles; ++u) {",
                     "      for (int u = 0; u < 0; ++u) {"),
                    ("  for (int j = tid; j < 2 * chunks * kCols; j += kStagers) {",
                     "  for (int j = tid; j < 0; j += kStagers) {")],
    "no products": [("      const int steps = L.k_pad / 16;", "      const int steps = 1;")],
    "no repack": _K3_REPACK,
    "no A loads": _K3_LOADS,
    "no exchange": _K3_EXCHANGE,
    "products only": _K3_REPACK + _K3_LOADS + _K3_EXCHANGE,
}


def ablate3() -> dict:
    """K3's bf16 path built as it is and with one part cut out
    (``K3_ABLATIONS``), timed in turns at 16 384 and 32 768 rows: what
    each part costs."""
    import ctypes

    from beamforming_lk_tpu_torch.ops import fft_das as fd
    from beamforming_lk_tpu_torch.ops import nvcc

    paths = nvcc.build_all([_variant(f"power_matmul_a{i}", edits, fd._SOURCE)
                            for i, edits in enumerate(K3_ABLATIONS.values())])
    real = fd._library()
    libs = {}
    for label, path in zip(K3_ABLATIONS, paths):
        lib = ctypes.CDLL(path)
        lib.power_matmul_launch.argtypes = real.power_matmul_launch.argtypes
        lib.power_matmul_launch.restype = ctypes.c_int
        libs[label] = lib
    ops = {rows: cs.power_operands(rows, "bfloat16", "cuda") for rows in (16384, 32768)}
    times = {label: {rows: [] for rows in ops} for label in libs}
    for label in list(libs) + list(libs)[::-1]:
        fd._library = lambda lib=libs[label]: lib
        for rows, args in ops.items():
            times[label][rows].append(cs._cuda_ms(lambda: fd.power_matmul(*args), 50))
    fd._library = lambda: real
    out = {}
    for label, per in times.items():
        out[label] = {f"{rows} bfloat16": statistics.mean(v) for rows, v in per.items()}
        print(f"K3 {label:15s}: " + ", ".join(
            f"{rows} rows {statistics.mean(v):.4f} ms (runs {v})"
            for rows, v in per.items()), flush=True)
    return out


def _device_columns(prof, n_blocks: int) -> dict:
    """Device busy ms, the swarm kernels' (K0-K2) and the DAS beam's (K4)
    ms, kernels and idle share per block from a profile."""
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
    named = {key: sum(e.time_range.elapsed_us() for e in ev
                      if any(n in e.name for n in names)) / 1e3 / n_blocks
             for key, names in KERNEL_NAMES.items()}
    return {"device_busy_ms": busy / 1e3 / n_blocks, **named,
            "kernels_per_block": len(kernels) / n_blocks,
            "idle_share": 1.0 - busy / window}


def _run(pipe, blocks, replay: bool):
    if replay:
        return pipe.process_blocks(blocks)
    for b in blocks:
        out = pipe.process_block(b)
    return out


def _profile(cfg, modes, n_latency: int, **pipe_kw) -> dict:
    """The profile columns of ``cfg`` at 64 and 256 mics for each mode
    ("live": ``process_block``; "replay": ``process_blocks``), then the
    latency over ``n_latency`` live blocks after 24 warm ones; ``pipe_kw``
    go to each ``AwpuPipeline``."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    from beamforming_lk_tpu_torch.app import AwpuPipeline

    out = {}
    for ch in (64, 256):
        for mode in modes:
            pipe = AwpuPipeline(cfg, channels=ch, seed=0, device="cuda", **pipe_kw)
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
        pipe = AwpuPipeline(cfg, channels=ch, seed=0, device="cuda", **pipe_kw)
        blocks = cs._plane_wave_blocks(pipe, cfg, ch, "cuda")
        lat = []
        for i in range(24 + n_latency):
            t = time.perf_counter()
            pipe.process_block(blocks[i % len(blocks)])
            torch.cuda.synchronize()
            if i >= 24:
                lat.append((time.perf_counter() - t) * 1e3)
        med, p99 = float(np.median(lat)), float(np.percentile(lat, 99))
        out[f"latency {ch}"] = {"median_ms": med, "p99_ms": p99,
                                "blocks": n_latency}
        print(f"latency {ch:3d} mics over {n_latency} blocks: median {med:.4f} "
              f"ms, p99 {p99:.4f} ms (budget {cs.BUDGET_MS:.2f} ms)", flush=True)
    return out


def profile() -> dict:
    from beamforming_lk_tpu_torch import Config, realtime

    return _profile(realtime(Config()), ("live", "replay"), 1200)


def default() -> dict:
    return _profile(cs.default_config(), ("live",), 1008)


def adaptive() -> dict:
    from beamforming_lk_tpu_torch import Config, realtime

    out = {}
    for name, kw in cs.ADAPTIVE.items():
        print(f"-- {name}", flush=True)
        out[name] = _profile(realtime(Config()), ("live",), 1008, **kw)
    return out


def _load_other(root: str, module: str):
    """``beamforming_lk_tpu_torch/ops/<module>.py`` of the checkout at
    ``root``, loaded under another name: its kernel source is that
    checkout's, its imports of the package this tree's."""
    import importlib.util

    path = os.path.join(root, "beamforming_lk_tpu_torch", "ops", f"{module}.py")
    spec = importlib.util.spec_from_file_location(f"other_{module}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def versus(root: str) -> dict:
    import torch

    from beamforming_lk_tpu_torch.ops import cuda_das as cd
    from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk
    from beamforming_lk_tpu_torch.ops import fft_das as fd
    from beamforming_lk_tpu_torch.ops import nvcc

    other = {"ctk": _load_other(root, "cuda_tracker"),
             "cd": _load_other(root, "cuda_das"), "fd": _load_other(root, "fft_das")}
    t0 = time.perf_counter()
    mods = {"other": other, "this": {"ctk": ctk, "cd": cd, "fd": fd}}
    specs = {}  # one build of each distinct source: equal sources share a target
    for name, mod in (("swarm_chain", "ctk"), ("das_beam", "cd"), ("power_matmul", "fd")):
        for tree in mods.values():
            path = tree[mod]._SOURCE
            specs.setdefault(open(path, "rb").read(), (name, [path]))
    nvcc.build_all(list(specs.values()))
    print(f"built both trees' kernels in {time.perf_counter() - t0:.1f} s",
          flush=True)
    out = {}
    # K3 was redesigned with another summation order: held by its largest
    # difference relative to the largest power, not bitwise.
    for rows in (16384, 32768):
        for compute in ("bfloat16", "float32"):
            ops = cs.power_operands(rows, compute, "cuda")
            a, b = (mods[who]["fd"].power_matmul(*ops) for who in ("other", "this"))
            rel = float((a - b).abs().max() / b.abs().max())
            runs = {"other": [], "this": []}
            for who in ("other", "this", "this", "other"):
                runs[who].append(cs._cuda_ms(
                    lambda: mods[who]["fd"].power_matmul(*ops), 50))
            row = {"max_rel_diff": rel, **{
                f"{who}_ms": statistics.mean(v) for who, v in runs.items()},
                "runs": runs}
            out[f"K3 {rows} {compute}"] = row
            print(f"K3 {rows:5d} rows {compute:8s}: max difference {rel:.3g} of the "
                  f"largest; other {row['other_ms']:.4f} ms, this {row['this_ms']:.4f} "
                  f"ms ({row['other_ms'] / row['this_ms']:.2f}x; runs {runs})",
                  flush=True)
    for ch, compute in SHAPES:
        xyz, bp, rows, mask, ckw = cs.monopulse_operands(ch, compute, "cuda")
        act = torch.as_tensor(mask.astype(np.float32), device="cuda")
        one = (rows[:, cs.N_TRACKERS:cs.N_TRACKERS + 1].contiguous(),
               torch.ones((3, 1), device="cuda"))
        model, stack = cs.das_operands(ch, "cuda")
        dkw = dict(span=model.shift_range, compute=compute)
        fir = cs.monopulse_operands(ch, compute, "cuda", "fir")
        fir_act = torch.as_tensor(fir[3].astype(np.float32), device="cuda")
        fir_model, fir_stack = cs.das_operands(ch, "cuda", "fir")
        ops, kw = cs.chain_operands(ch, compute, "cuda")
        cops, ckw2 = cs.chunk_operands(ch, compute, "cuda")
        calls = {
            "K0 26 rows": lambda m: m["ctk"].monopulse_chain(xyz, bp, rows, act, **ckw),
            "K0 listener": lambda m: m["ctk"].monopulse_chain(xyz, bp, *one, **ckw),
            "K4 1 window": lambda m: m["cd"].das_beam(
                stack[0], model.shift, model.tap_weights, **dkw),
            "K4 8 windows": lambda m: m["cd"].das_beam(
                stack, model.shift, model.tap_weights, **dkw),
            "K0 FIR": lambda m: m["ctk"].monopulse_chain(
                *fir[:3], fir_act, **fir[4]),
            "K4 FIR": lambda m: m["cd"].das_beam(
                fir_stack[0], fir_model.shift, fir_model.tap_weights, **dkw),
            "K1": lambda m: m["ctk"].swarm_chain(*ops, **kw),
            "K2": lambda m: m["ctk"].swarm_chunk(*cops, **ckw2),
        }
        for name, call in calls.items():
            a, b = call(mods["other"]), call(mods["this"])
            a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
            equal = all(torch.equal(x, y) for x, y in zip(a, b))
            runs = {"other": [], "this": []}
            for who in ("other", "this", "this", "other"):
                n = 10 if name == "K2" else 50
                runs[who].append(cs._cuda_ms(lambda: call(mods[who]), n))
            row = {"bitwise_equal": equal, **{
                f"{who}_ms": statistics.mean(v) for who, v in runs.items()},
                "runs": runs}
            out[f"{name} {ch} {compute}"] = row
            print(f"{name:12s} {ch:3d} mics {compute:8s}: bitwise equal {equal}; "
                  f"other {row['other_ms']:.4f} ms, this {row['this_ms']:.4f} ms "
                  f"({row['other_ms'] / row['this_ms']:.2f}x; runs {runs})",
                  flush=True)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("perf_swarm: no CUDA device; this runs on the card")
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    runs = {"clusters": clusters, "phases": phases, "profile": profile,
            "default": default, "adaptive": adaptive, "versus": versus,
            "ablate": ablate,
            "ablate3": ablate3}
    if what not in runs or (what == "versus") != (len(sys.argv) == 3):
        raise SystemExit(__doc__)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs._card_line()
    print(card, flush=True)
    out = runs[what](*sys.argv[2:])
    print(json.dumps({"card": card, what: out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
