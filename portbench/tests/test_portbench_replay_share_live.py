"""The reader of ``swarm_replay_share.live`` on a made-up traced window:
the ``awpu.swarm.replay`` spans that open in the window over the traced
blocks, None where none opened."""

from types import SimpleNamespace

import pytest

from portbench import run


def _read(host, blocks):
    tr = SimpleNamespace(host=list(host), window=(0.0, 1.0))
    path = run.ROOT / "portbench" / "metrics" / "swarm_replay_share.live.py"
    return run._load(path).read({"trace": tr, "traced_blocks": blocks})


def test_every_live_block_replayed_reads_100():
    host = [("awpu.call", 0.1 * i, 0.1 * i + 0.08) for i in range(6)]
    host += [("awpu.heatmap", 0.1 * i + 0.01, 0.1 * i + 0.02) for i in range(0, 6, 3)]
    host += [("awpu.swarm", 0.1 * i + 0.03, 0.1 * i + 0.07) for i in range(6)]
    host += [("awpu.swarm.replay", 0.1 * i + 0.04, 0.1 * i + 0.06) for i in range(6)]
    assert _read(host, 6) == pytest.approx(100.0)


def test_eager_blocks_and_spans_outside_the_window_are_not_counted():
    host = [("awpu.swarm.replay", -0.05, 0.02), ("awpu.swarm.replay", 0.3, 0.32),
            ("awpu.swarm.run", 0.5, 0.6), ("awpu.swarm.replay", 1.0, 1.1)]
    assert _read(host, 4) == pytest.approx(25.0)


@pytest.mark.parametrize("host,blocks", [
    ([("awpu.swarm", 0.1, 0.2), ("awpu.swarm.prep", 0.11, 0.12),
      ("awpu.swarm.run", 0.13, 0.18)], 2),
    ([("awpu.swarm.replay", 0.1, 0.2)], 0),
], ids=["eager_program", "no_blocks"])
def test_nothing_to_read_without_a_replay(host, blocks):
    assert _read(host, blocks) is None
