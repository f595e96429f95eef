"""The device trace of a window: ``torch.profiler`` with CPU and CUDA
activity, reduced to plain lists the per-layer readers take.

The interval merge is ``perf_swarm.py``'s ``_device_columns``, except that
the window is the benchmark's own: from the first traced call's start to
the last one's end, so host gaps at its ends count as idle.
"""

from __future__ import annotations

from collections import defaultdict

#: The benchmark's own host spans, as ``record_function`` names.
CALL, ENQUEUE, SYNC, COPY, WAIT = ("portbench.call", "portbench.enqueue",
                                   "portbench.sync", "portbench.copy_out",
                                   "portbench.wait")
_OWN = (CALL, ENQUEUE, SYNC, COPY, WAIT)


class Trace:
    """Device operations ``ops`` [(name, start_s, end_s)], host events
    ``host`` [(name, start_s, end_s)], the benchmark's call spans
    ``calls`` [(start_s, end_s)] and the window (start_s, end_s), all on
    the profiler's clock."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        ops, host, calls = [], [], []
        for e in prof.events():
            span = (e.time_range.start * 1e-6, e.time_range.end * 1e-6)
            if e.device_type == DeviceType.CUDA:
                # A host span shows on the device's timeline too, as an
                # annotation over the work it launched: not device work.
                if not (getattr(e, "is_user_annotation", False) or e.name in _OWN):
                    ops.append((e.name, *span))
            elif e.name == CALL:
                calls.append(span)
            else:
                host.append((e.name, *span))
        self.ops = sorted(ops, key=lambda o: o[1])
        self.host = host
        self.calls = sorted(calls)
        self.window = ((self.calls[0][0], self.calls[-1][1]) if self.calls
                       else (0.0, 0.0))

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self):
        """Merged intervals in which a device operation ran, clipped to the
        window."""
        w0, w1 = self.window
        merged = []
        for _, s, e in self.ops:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def in_flight_s(self) -> float:
        """Seconds in which a block was in flight (call to outputs on the
        host)."""
        return sum(e - s for s, e in self.calls)

    def kernels(self, *names):
        """Device kernels (no copies or fills) in the window whose name
        holds any of ``names`` (all kernels without ``names``)."""
        w0, w1 = self.window
        return [o for o in self.ops if w0 <= o[1] < w1
                and not o[0].startswith(("Memcpy", "Memset"))
                and (not names or any(n in o[0] for n in names))]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and idle time by
        what the host was doing (the innermost host event, the
        benchmark's own spans last, at each gap's midpoint)."""
        by_op = defaultdict(float)
        for name, s, e in self.ops:
            if self.window[0] <= s < self.window[1]:
                by_op[name] += e - s
        gaps = defaultdict(float)
        busy = self.busy_intervals()
        edges = [self.window[0]] + [x for iv in busy for x in iv] + [self.window[1]]
        host = sorted(self.host, key=lambda h: h[1])
        nxt, active = 0, []
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            t = (s + e) / 2.0
            while nxt < len(host) and host[nxt][1] <= t:
                active.append(host[nxt])
                nxt += 1
            active = [h for h in active if h[2] >= t]
            gaps[self._doing(active)] += e - s
        rank = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                                key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}

    @staticmethod
    def _doing(active) -> str:
        """The innermost of the host events running at one instant, a
        program event before the benchmark's own spans."""
        ops = [h for h in active if h[0] not in _OWN]
        pool = ops or active
        if not pool:
            return "host idle"
        return min(pool, key=lambda h: h[2] - h[1])[0]
