"""The reader of ``swarm_replay_share.stream`` on a made-up traced window:
the ``awpu.swarm.replay`` spans that open in the window over the traced
blocks, None where none opened."""

from types import SimpleNamespace

import pytest

from portbench import run


def _read(host, blocks):
    tr = SimpleNamespace(host=list(host), window=(0.0, 1.0))
    path = run.ROOT / "portbench" / "metrics" / "swarm_replay_share.stream.py"
    return run._load(path).read({"trace": tr, "traced_blocks": blocks})


def test_every_block_replayed_reads_100():
    host = [("awpu.swarm", 0.1 * i, 0.1 * i + 0.05) for i in range(4)]
    host += [("awpu.swarm.replay", 0.1 * i + 0.01, 0.1 * i + 0.04) for i in range(4)]
    assert _read(host, 4) == pytest.approx(100.0)


def test_spans_opened_outside_the_window_are_not_counted():
    host = [("awpu.swarm.replay", -0.05, 0.02), ("awpu.swarm.replay", 0.5, 0.6),
            ("awpu.swarm.replay", 1.0, 1.1)]
    assert _read(host, 4) == pytest.approx(25.0)


@pytest.mark.parametrize("host,blocks", [
    ([("awpu.swarm", 0.1, 0.2), ("awpu.swarm.run", 0.12, 0.18)], 2),
    ([("awpu.swarm.replay", 0.1, 0.2)], 0),
], ids=["eager_program", "no_blocks"])
def test_nothing_to_read_without_a_replay(host, blocks):
    assert _read(host, blocks) is None
