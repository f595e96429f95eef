"""Profiling hooks: ``torch.profiler`` traces around pipeline sections
(counterpart of ``beamforming_lk_tpu.utils.profiling``).

The reference's only runtime metric is a UI FPS counter (SURVEY §5); the
always-on counters live in :mod:`beamforming_lk_tpu_torch.utils.metrics`.
This module adds deep traces (host ops and, on a CUDA host, the device's
kernels) as a Chrome trace viewable in Perfetto, :func:`span` for the
program's own stages in such a trace, and :class:`StageTimer` for the
host-side stages.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

TRACE_FILE = "trace.json"

#: What :func:`span` returns with no profiler running: one shared no-op.
_NO_SPAN = contextlib.nullcontext()

# The span's event: ``record_function``'s host event without its
# annotation on the device's timeline, at a tenth of its cost under a
# profiler (1.0 against 8.8 us a span, H100 host, torch 2.11).
_record = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """``with span("awpu.ring"):`` records ``name`` as a host event of the
    running ``torch.profiler`` (on its clock, beside the device's work),
    and does nothing without one.  The gate, the flag ``torch.profiler``
    sets, keeps spans off the hot path: it costs under 0.5 us a span (H100
    host, torch 2.11), where ``record_function`` costs ~15 us to enter
    even with no profiler (CPU, torch 2.13)."""
    if _autograd_profiler._is_profiler_enabled:
        return _record(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """``with trace("/tmp/prof"):`` records a ``torch.profiler`` trace of
    the enclosed run (CPU activity, and CUDA activity where the host has
    CUDA) and writes it to ``log_dir/trace.json``; ``None`` disables (zero
    overhead)."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class StageTimer:
    """Named wall-clock stage accumulator for host-side pipeline stages
    (ingest / device step / render / fusion); each stage is also the span
    ``control.<name>`` in a profiler's trace."""

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span("control." + name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 6),
                "calls": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / self.counts[name], 3),
            }
            for name in self.totals
        }
