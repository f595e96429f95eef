"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m portbench.run ...``) from the root of a checkout.  The
cell, its configuration (``portbench/configs/<config>.json``), its traffic
(``portbench/traffic/<traffic>.json``), its limits
(``portbench/limits/<cell>.json``), its metrics
(``portbench/end_to_end/<name>.py``, ``portbench/metrics/<name>.py``) and,
for a configuration whose ``"pipeline"`` names an adaptive estimator, the
estimator's reference (``portbench/reference/estimators/<heatmap_mode>.py``)
are found by the names in ``BENCHMARK.json``.

A run builds ``AwpuPipeline`` from the configuration on the card, makes the
traffic from ``--seed`` (:mod:`portbench.traffic`), warms up the cell's
shapes, then drives the entry for ``--seconds`` as the traffic's loop says:
each call's outputs (targets and listener beam) are copied to the host
after ``torch.cuda.synchronize()``.  With ``--trace 1`` it then drives a
short window more under ``torch.profiler`` and prints the per-layer
metrics instead of the end-to-end ones.  Last, it checks sampled calls
against the plain reference (:mod:`portbench.check`), prints each number
beside its limit on stderr, and prints one JSON line on stdout.

It exits non-zero with no result without CUDA or with fewer cards than the
cell asks for, and when JAX or the JAX package is loaded at the end.
"""

import time

_T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

#: Top-level modules no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "beamforming_lk_tpu")
#: Seconds of the traced window after the untraced one (``--trace 1``).
TRACE_SECONDS = 2.0
#: The latency a failed block counts with: a miss in every tail.
FAILED_LATENCY_S = 1e3
#: A block later than this (s) is reported on stderr as stalled.
STALL_S = 0.02
#: The keys a configuration's optional ``"pipeline"`` object may give,
#: passed to ``AwpuPipeline`` as keyword arguments.
PIPELINE_KEYS = ("heatmap_mode", "music_solver", "music_sources", "mvdr_refresh")


def forbidden_modules(modules=None) -> list:
    """Forbidden top-level names among ``modules`` (``sys.modules``),
    each name compared whole (the part before the first dot)."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_file_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def pipeline_options(cfg: dict) -> dict:
    """The ``AwpuPipeline`` keywords of a configuration's ``"pipeline"``
    object ({} without one).  An unknown key stops the run: a typo must not
    run the DAS map in the estimator's place."""
    options = cfg.get("pipeline", {})
    unknown = sorted(set(options) - set(PIPELINE_KEYS))
    if unknown:
        raise SystemExit(f"configuration {cfg.get('name')!r}: unknown pipeline "
                         f"key(s) {', '.join(map(repr, unknown))}; allowed: "
                         f"{', '.join(PIPELINE_KEYS)}")
    return dict(options)


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """Everything a run of ``workload`` needs, found by name."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    base = root / "portbench"

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    e2e = [m for m in manifest["end_to_end"] if applies(m)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if applies(m) and m["moves"] in reported]
    limits_file = base / "limits" / f"{workload}.json"
    cfg = json.loads((root / config["file"]).read_text())
    mode = pipeline_options(cfg).get("heatmap_mode", "das")
    estimator = None
    if mode != "das":
        estimator = base / "reference" / "estimators" / f"{mode}.py"
        if not estimator.exists():
            raise SystemExit(f"configuration {cfg.get('name')!r} names the estimator "
                             f"{mode!r}, but its reference {estimator} is missing")
    return dict(
        cell=cell,
        config=cfg,
        estimator=estimator,
        traffic=json.loads((base / "traffic" / f"{cell['traffic']}.json").read_text()),
        limits=(json.loads(limits_file.read_text())["limits"]
                if limits_file.exists() else None),
        end_to_end=[(m, base / "end_to_end" / f"{m['name']}.py") for m in e2e],
        per_layer=[(m, base / "metrics" / f"{m['name']}.py") for m in per_layer],
    )


def port_config(cfg: dict):
    """The port's ``Config`` as the configuration file states it."""
    from beamforming_lk_tpu_torch import config as pc

    return pc.Config(array=pc.ArrayConfig(**cfg["array"]),
                     dsp=pc.DspConfig(**cfg["dsp"]),
                     mimo=pc.MimoConfig(**cfg["mimo"]),
                     tracker=pc.TrackerConfig(**cfg["tracker"]))


class Reservoir:
    """A uniform sample of ``k`` of the calls offered, drawn from ``rng``."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.items = k, rng, []

    def offer(self, j: int, item) -> None:
        if j < self.k:
            self.items.append(item)
        else:
            r = int(self.rng.integers(0, j + 1))
            if r < self.k:
                self.items[r] = item


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_outputs(out, m: int):
    """[m, fields] host copy of a call's targets and listener beam."""
    import torch

    t = out.targets
    fields = [t.theta, t.phi, t.power, t.probability, t.start,
              t.valid.to(torch.float32), out.miso_beam]
    return torch.cat([f.reshape(m, -1) for f in fields], dim=1).cpu()


def _call(pipe, feed, k: int, m: int):
    """The entry as users call it: host blocks in, the pipeline's own draws."""
    if m == 1:
        return pipe.process_block(feed.block(k))
    return pipe.process_blocks(feed.batch(k, m))


def _wait_until(t: float) -> None:
    """Spin until ``t``: a sleeping generator wakes late under load, and
    its lateness would be read as the system's."""
    while time.perf_counter() < t:
        pass


def drive(pipe, feed, spec: dict, k: int, seconds: float, device,
          sampler: Reservoir = None, spans: bool = False,
          estimator: bool = False) -> dict:
    """Drive the entry for ``seconds`` from stream block ``k`` as the
    traffic's loop says.  Returns the host-clock record of the window.
    With ``estimator`` (the configuration names one) each sampled call also
    keeps the estimator's state before and after it and its spectrum."""
    import torch

    from portbench import trace as tr

    m, paced = spec["batch"], spec["loop"] == "paced"
    span = (torch.profiler.record_function if spans
            else lambda name: contextlib.nullcontext())
    n_calls = max(1, math.floor(seconds * spec["rate_hz"] / m)) if paced else None
    lat, outs, lateness, enqueue = [], [], [], 0.0
    j, t_done = 0, None
    t0 = time.perf_counter()
    while (j < n_calls) if paced else (j == 0 or time.perf_counter() < t0 + seconds):
        due = t0 + (j + 1) * m / spec["rate_hz"] if paced else None
        if paced:
            with span(tr.WAIT):
                _wait_until(due)
        before = pipe.state
        if estimator:
            est_before = pipe._mvdr_state
        t_call = time.perf_counter()
        with span(tr.CALL):
            with span(tr.ENQUEUE):
                out = _call(pipe, feed, k, m)
            t_enq = time.perf_counter()
            with span(tr.SYNC):
                _sync(device)
            with span(tr.COPY):
                host = _host_outputs(out, m)
        t_done = time.perf_counter()
        enqueue += t_enq - t_call
        lat.extend([t_done - (due if paced else t_call)] * m)
        if paced:
            lateness.append(t_call - due)
        outs.append(host.numpy().copy())     # untracked by the collector
        if sampler is not None:
            item = dict(k0=k, m=m, before=before, out=out, after=pipe.state)
            if estimator:
                # References, not copies: the estimator makes its state and
                # its spectrum anew each call.
                item.update(estimator_before=est_before,
                            estimator_after=pipe._mvdr_state,
                            spectrum=pipe._mvdr_powers)
            sampler.offer(j, item)
        k += m
        j += 1
    host = np.concatenate(outs)
    finite = np.isfinite(host).all(axis=1)
    lat = np.where(finite, np.asarray(lat), FAILED_LATENCY_S)
    quarters = [float(np.median(q)) * 1e3 for q in np.array_split(lat, 4) if len(q)]
    slow = lat > STALL_S
    return dict(latencies_s=lat.tolist(), blocks=int(len(lat)), failed=int((~finite).sum()),
                stalls=(int(slow.sum()), float(lat.max()) * 1e3 if len(lat) else 0.0),
                seconds=t_done - t0, enqueue_s=enqueue, next_block=k,
                lateness_s=max(lateness) if lateness else 0.0, quarters_ms=quarters)


def start_gap(state) -> float:
    """Largest departure of a pipeline's first state from an empty one: a
    zero history, no trackers, the listener at boresight, counters at 0."""
    sw = state.swarm
    vals = [float(state.history.abs().max()), float(sw.tracking.float().max()),
            float(sw.target_valid.float().max()),
            float(state.miso.particle.theta.abs().max()),
            float(state.miso.particle.phi.abs().max()),
            float(state.block_index), float(sw.reset_count)]
    vals += [float(f.abs().max()) for f in sw.trackers]
    return max(vals)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device="cuda",
             pipeline_hook=None, control: bool = False):
    """One run of a cell (:func:`load_cell`'s dict) on ``device``.  Returns
    (the result line as a dict, the numbers compared with their limits).
    ``pipeline_hook(pipe)`` may replace the pipeline's methods (tests plant
    faults through it); ``control`` adds the control's numbers on the same
    sampled calls under ``"control"`` (:mod:`portbench.readings`)."""
    import torch

    from beamforming_lk_tpu_torch.app import AwpuPipeline
    from portbench import check
    from portbench.trace import Trace
    from portbench.traffic import Traffic

    device = torch.device(device)
    cfg, tspec = spec["config"], spec["traffic"]
    marks = [("imports", time.monotonic())]
    pipe = AwpuPipeline(port_config(cfg), channels=cfg["channels"],
                        seed=seed % (2 ** 63), device=device,
                        **pipeline_options(cfg))
    if pipeline_hook is not None:
        pipeline_hook(pipe)
    first_state = pipe.state
    _sync(device)
    marks.append(("pipeline", time.monotonic()))
    feed = Traffic(tspec, cfg, seed, device)
    marks.append(("traffic", time.monotonic()))
    warm = drive(pipe, feed, dict(tspec, loop="closed"), 0, 0.0, device)
    marks.append(("first call", time.monotonic()))
    k = warm["next_block"]
    while k < tspec["warmup_blocks"]:
        k = drive(pipe, feed, dict(tspec, loop="closed"), k, 0.0, device)["next_block"]
    # The window's own loop for a while: the host settles after set-up
    # (a first paced call was seen to stall 125 ms without it).
    k = drive(pipe, feed, tspec, k, tspec["warmup_seconds"], device)["next_block"]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    marks.append(("warm-up", time.monotonic()))
    setup_s = time.monotonic() - _T_START
    split, prev = [], _T_START
    for name, t in marks:
        split.append(f"{name} {t - prev:.3f} s")
        prev = t
    sampler = Reservoir(tspec["verify_calls"],
                        np.random.default_rng(seed % (2 ** 63)))
    window = drive(pipe, feed, tspec, k, seconds, device, sampler=sampler,
                   estimator=spec["estimator"] is not None)
    window["setup_s"] = setup_s
    ctx = dict(window=window, config=cfg, traffic=tspec)
    result = {}
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            traced = drive(pipe, feed, tspec, window["next_block"],
                           min(TRACE_SECONDS, seconds), device, spans=True)
        ctx.update(trace=Trace(prof), traced_blocks=traced["blocks"])
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    del pipe

    metrics = {}
    for m, path in (spec["per_layer"] if trace else spec["end_to_end"]):
        value = _load(path).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    ref = check.Reference(cfg, feed, device, seed, estimator=(
        None if spec["estimator"] is None else _load(spec["estimator"])))
    notes = {}
    numbers = check.compare(ref, sampler.items, notes=notes)
    numbers["history_gap"] = max(numbers["history_gap"], start_gap(first_state))
    correct, shown = check.verdict(numbers, spec["limits"])
    if control:
        result["control"] = check.compare(ref, sampler.items, control=True)
        result["notes"] = notes
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else device.type),
           "count": 1, "memory_peak_bytes": peak}
    if trace:
        tr = ctx["trace"]
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    last = sampler.items[-1]
    shown_last = check.block_outputs(last["out"], 0, last["m"])
    powers = last["spectrum"] if "spectrum" in last else shown_last[0]
    lock = check.lock_report(ref, powers, shown_last[1:4], tspec["sources"])
    result = dict(correct=bool(correct) and window["failed"] == 0,
                  attempted=window["blocks"], failed=window["failed"],
                  metrics=metrics, device=dev, **result,
                  lateness_s=window["lateness_s"], quarters_ms=window["quarters_ms"],
                  stalls=window["stalls"],
                  setup_split="; ".join(split),
                  lock=lock, compared=shown)
    return result, shown


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = load_cell(args.workload)

    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
              "found", file=sys.stderr)
        return 2
    result, shown = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"setup: {result['setup_split']}", file=sys.stderr)
    print("median latency of each quarter of the window, ms: "
          + ", ".join(f"{q:.4f}" for q in result["quarters_ms"]), file=sys.stderr)
    print(f"blocks over {STALL_S * 1e3:g} ms: {result['stalls'][0]}, the longest "
          f"{result['stalls'][1]:.3f} ms", file=sys.stderr)
    print(f"lock: {result['lock']}; generator at most "
          f"{result['lateness_s'] * 1e3:.3f} ms behind", file=sys.stderr)
    for name, v in shown.items():
        print(f"compared {name}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
