"""Readings that several metric files share.  Each metric file under
``portbench/end_to_end/`` and ``portbench/metrics/`` defines
``read(ctx) -> float | None`` (None: nothing to read, the metric is left
out of the line).  ``ctx`` holds:

- ``window``: the untraced window on the host clock: ``latencies_s``
  (every block's due-to-host time; 1000 s for a failed block), ``blocks``,
  ``seconds`` (first call to last outputs on the host), ``enqueue_s``
  (host time inside the entry calls), ``setup_s``;
- ``trace``: a :class:`portbench.trace.Trace` of the traced window (with
  ``--trace 1``) and ``traced_blocks``;
- ``config``, ``traffic``: the cell's files as dicts.
"""

from __future__ import annotations

import numpy as np

from portbench import peaks

#: Kernel names in the device trace (``beamforming_lk_tpu_torch/csrc``).
K0, K1, K2, K4 = ("monopulse_chain_kernel", "swarm_chain_kernel",
                  "swarm_chunk_kernel", "das_beam_kernel")


def latency_ms(ctx, q: float):
    lat = np.asarray(ctx["window"]["latencies_s"], np.float64)
    if not len(lat):
        return None
    return float(np.percentile(lat, q)) * 1e3


def host_enqueue_ms(ctx):
    w = ctx["window"]
    return w["enqueue_s"] / w["blocks"] * 1e3 if w["blocks"] else None


def kernels_per_block(ctx):
    tr, n = ctx.get("trace"), ctx.get("traced_blocks", 0)
    if tr is None or not n or not tr.kernels():
        return None
    return len(tr.kernels()) / n


def kernel_ms_per_block(ctx, name: str):
    tr, n = ctx.get("trace"), ctx.get("traced_blocks", 0)
    if tr is None or not n:
        return None
    ks = tr.kernels(name)
    return sum(e - s for _, s, e in ks) / n * 1e3 if ks else None


def idle_share(ctx):
    """Per cent of the seconds blocks were in flight in which no device
    operation ran."""
    tr = ctx.get("trace")
    if tr is None or not tr.ops:
        return None
    flight = tr.in_flight_s()
    return (1.0 - tr.busy_s() / flight) * 100.0 if flight > 0 else None


def roofline(ctx, name: str, counts):
    """Per cent of the least time ``counts(cfg) -> (operations, bytes,
    peak FLOP/s)`` of one launch, over the traced launches' mean time."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    ks = tr.kernels(name)
    if not ks:
        return None
    flops, nbytes, peak = counts(ctx["config"])
    least = peaks.bound_s(flops, nbytes, peak)
    return least * len(ks) / sum(e - s for _, s, e in ks) * 100.0
