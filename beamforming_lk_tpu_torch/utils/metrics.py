"""Observability: FPS meter, per-stage block timing, throughput counters.

The reference's only runtime metric is a UI FPS counter
(``computeFps``, ``src/aw_control_unit/aw_control_unit.cpp:52-67``); the
north-star metric here is samples/s and block latency vs the 5.24 ms
real-time deadline (SURVEY §5/§6).  For deep profiles use
``utils.profiling.trace`` (``torch.profiler``) around the run; these
counters are the always-on lightweight layer.

A copy of ``beamforming_lk_tpu.utils.metrics`` (numpy and the standard
library only), kept in the port so that the port loads no module of the
JAX package.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, Optional


class FpsMeter:
    """EMA frame-rate meter (computeFps analog)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.fps = 0.0
        self._last: Optional[float] = None

    def tick(self, now: Optional[float] = None) -> float:
        now = time.perf_counter() if now is None else now
        if self._last is not None:
            dt = max(now - self._last, 1e-9)
            inst = 1.0 / dt
            self.fps = inst if self.fps == 0.0 else (
                self.alpha * inst + (1.0 - self.alpha) * self.fps
            )
        self._last = now
        return self.fps


class BlockMetrics:
    """Streaming pipeline health: block counts, latency percentiles,
    samples/s, real-time margin."""

    def __init__(
        self,
        block_size: int = 256,
        sample_rate: float = 48828.0,
        window: int = 512,
    ):
        self.block_size = block_size
        self.sample_rate = sample_rate
        self.deadline = block_size / sample_rate
        self.blocks = 0
        self.deadline_misses = 0
        self.latencies = collections.deque(maxlen=window)
        self._t0: Optional[float] = None
        self._start = time.perf_counter()

    def start_block(self) -> None:
        self._t0 = time.perf_counter()

    def end_block(self, n: int = 1) -> float:
        """Close the timing window opened by :meth:`start_block`.

        ``n`` > 1 accounts one batched dispatch covering n blocks (the
        chunked replay path): the recorded latency is the amortized
        per-block time, and the deadline check runs against it."""
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        per_block = dt / max(n, 1)
        self.blocks += n
        self.latencies.append(per_block)
        if per_block > self.deadline:
            self.deadline_misses += n
        return dt

    def summary(self) -> Dict[str, float]:
        lat = sorted(self.latencies)
        elapsed = max(time.perf_counter() - self._start, 1e-9)

        def pct(p):
            return lat[min(int(p * len(lat)), len(lat) - 1)] if lat else 0.0

        return {
            "blocks": self.blocks,
            "blocks_per_s": self.blocks / elapsed,
            "samples_per_s": self.blocks * self.block_size / elapsed,
            "realtime_factor": (self.blocks * self.block_size / elapsed)
            / self.sample_rate,
            "latency_p50_ms": pct(0.50) * 1e3,
            "latency_p95_ms": pct(0.95) * 1e3,
            "latency_p99_ms": pct(0.99) * 1e3,
            "latency_max_ms": (lat[-1] if lat else 0.0) * 1e3,
            "deadline_ms": self.deadline * 1e3,
            "deadline_misses": self.deadline_misses,
        }
