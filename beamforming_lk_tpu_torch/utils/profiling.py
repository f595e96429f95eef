"""Profiling hooks: ``torch.profiler`` traces around pipeline sections
(counterpart of ``beamforming_lk_tpu.utils.profiling``).

The reference's only runtime metric is a UI FPS counter (SURVEY §5); the
always-on counters live in :mod:`beamforming_lk_tpu_torch.utils.metrics`.
This module adds deep traces (host ops and, on a CUDA host, the device's
kernels) as a Chrome trace viewable in Perfetto, and :class:`StageTimer`
for the host-side stages.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """``with trace("/tmp/prof"):`` records a ``torch.profiler`` trace of
    the enclosed run (CPU activity, and CUDA activity where the host has
    CUDA) and writes it to ``log_dir/trace.json``; ``None`` disables (zero
    overhead)."""
    if log_dir is None:
        yield
        return
    import torch
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
    (ingest / device step / render / fusion)."""

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
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
