"""The end-to-end statistics and the trace arithmetic on made-up inputs:
the percentile over every block of a window, the due-time pacing, the
idle share and the breakdown."""

import math
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import readers, run
from portbench import trace as tr


def test_percentiles_cover_every_block_and_failures_count_as_misses():
    lat = [0.001] * 980 + [0.002] * 19 + [run.FAILED_LATENCY_S]
    ctx = {"window": {"latencies_s": lat}}
    assert readers.latency_ms(ctx, 50.0) == pytest.approx(1.0)
    assert readers.latency_ms(ctx, 99.0) == pytest.approx(2.0)
    assert readers.latency_ms(ctx, 100.0) == run.FAILED_LATENCY_S * 1e3
    assert math.isfinite(readers.latency_ms(ctx, 99.95))


class _FakePipe:
    """An entry that takes ``cost`` seconds a block and returns outputs of
    the harness's shape."""

    def __init__(self, cost: float, nt: int = 3, t_len: int = 8):
        self.cost, self.nt, self.t_len, self.calls = cost, nt, t_len, []
        self.state = 0

    def _out(self, lead):
        z = torch.zeros(lead + (self.nt,))
        return SimpleNamespace(
            targets=SimpleNamespace(theta=z, phi=z, power=z, probability=z, start=z,
                                    valid=z > 0),
            miso_beam=torch.zeros(lead + (self.t_len,)), powers=None)

    def process_block(self, block, draws=None):
        self.calls.append(time.perf_counter())
        time.sleep(self.cost)
        self.state += 1
        return self._out(())

    def process_blocks(self, blocks, draws=None):
        self.calls.append(time.perf_counter())
        time.sleep(self.cost * len(blocks))
        self.state += len(blocks)
        return self._out((len(blocks),))


class _Feed:
    def block(self, k):
        return None

    def batch(self, k, m):
        return [None] * m


def test_paced_loop_waits_for_each_due_time_and_counts_the_queue():
    rate = 200.0
    pipe = _FakePipe(cost=0.0005)
    # The loop's own start is no earlier than this; the first call's time
    # less a period is no bound, since a loaded host can start it late.
    t0 = time.perf_counter()
    rec = run.drive(pipe, _Feed(), dict(loop="paced", rate_hz=rate, batch=1),
                    0, 0.25, torch.device("cpu"))
    assert rec["blocks"] == 50 and rec["failed"] == 0
    for j, t in enumerate(pipe.calls):
        assert t >= t0 + (j + 1) / rate - 1e-4
    lat = np.asarray(rec["latencies_s"])
    assert (lat >= 0.0005).all() and np.median(lat) < 0.005
    # An entry slower than the rate: the queue grows and the latency with it.
    slow = run.drive(_FakePipe(cost=0.01), _Feed(),
                     dict(loop="paced", rate_hz=rate, batch=1), 0, 0.1,
                     torch.device("cpu"))
    lat = np.asarray(slow["latencies_s"])
    assert lat[-1] > lat[0] + 0.03 and slow["lateness_s"] > 0.03


def test_closed_loop_counts_blocks_of_every_call():
    rec = run.drive(_FakePipe(cost=0.001), _Feed(), dict(loop="closed", batch=4),
                    0, 0.05, torch.device("cpu"))
    assert rec["blocks"] % 4 == 0 and rec["blocks"] >= 4
    assert rec["blocks"] / rec["seconds"] == pytest.approx(1000.0, rel=0.5)


def _trace(ops, calls, host=()):
    t = tr.Trace.__new__(tr.Trace)
    t.ops, t.calls, t.host = sorted(ops, key=lambda o: o[1]), sorted(calls), list(host)
    t.window = (t.calls[0][0], t.calls[-1][1])
    return t


def test_idle_share_from_made_up_intervals():
    ops = [("k_a", 0.1, 0.3), ("k_b", 0.2, 0.4), ("Memcpy HtoD", 0.5, 0.6),
           ("k_a", 1.5, 1.7)]   # the last one lies outside the window
    t = _trace(ops, [(0.0, 0.5), (0.5, 1.0)])
    assert t.busy_s() == pytest.approx(0.4)
    assert t.window_s == pytest.approx(1.0)
    ctx = {"trace": t, "traced_blocks": 2}
    assert readers.idle_share(ctx) == pytest.approx(60.0)
    assert readers.kernels_per_block(ctx) == pytest.approx(1.0)
    assert readers.kernel_ms_per_block(ctx, "k_b") == pytest.approx(100.0)
    assert readers.kernel_ms_per_block(ctx, "absent") is None


def test_breakdown_labels_gaps_by_the_innermost_host_event():
    ops = [("k_a", 0.1, 0.3), ("k_b", 0.5, 0.6)]
    host = [(tr.ENQUEUE, 0.0, 0.45), ("aten::cat", 0.32, 0.4), (tr.SYNC, 0.45, 1.0)]
    t = _trace(ops, [(0.0, 1.0)], host)
    b = t.breakdown()
    assert b["device_ops"][0] == ["k_a", pytest.approx(0.2)]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    assert gaps["aten::cat"] == pytest.approx(0.2)          # 0.3 .. 0.5
    assert gaps[tr.SYNC] == pytest.approx(0.4)              # 0.6 .. 1.0
    assert gaps[tr.ENQUEUE] == pytest.approx(0.1)           # 0.0 .. 0.1


def test_k4_roofline_counts_do_not_depend_on_the_data():
    k4 = run._load(run.ROOT / "portbench" / "metrics" / "k4_roofline.py")
    cfg = run.load_cell("lk64-default-stream")["config"]
    flops, nbytes, peak = k4.counts(cfg)
    assert flops == 2.0 * 4096 * 64 * 2 * 256
    least = max(flops / peak, nbytes / 3.35e12)
    t = _trace([("das_beam_kernel(DasParams)", 0.0, least * 4)], [(0.0, 1.0)])
    assert k4.read({"trace": t, "config": cfg}) == pytest.approx(25.0)
