"""The readers of the program's spans (``portbench/spans.py`` and the nine
``*_ms.<mix>`` metric files) on a made-up traced window: spans clipped to
the window, a nested span counted once, None where a span is absent."""

from types import SimpleNamespace

import pytest

from portbench import run, spans

#: Host events of a made-up 1 s window [0, 1], two traced blocks.
HOST = [
    ("portbench.enqueue", 0.0, 0.9),
    ("awpu.call", 0.0, 0.9),
    ("awpu.intake", -0.05, 0.05),       # crosses the window's start: 0.05 s
    ("awpu.intake", 0.5, 0.52),
    ("awpu.heatmap", 0.1, 0.2),
    ("awpu.swarm", 0.3, 0.4),
    ("awpu.swarm.run", 0.35, 0.38),     # a child: not read by itself
    ("awpu.miso", 0.38, 0.45),          # nested in the swarm to 0.4: 0.05 s more
    ("awpu.swarm", 0.95, 1.1),          # crosses the window's end: 0.05 s
    ("aten::cat", 0.6, 0.7),
]


def _ctx(host=HOST, blocks=2):
    tr = SimpleNamespace(host=list(host), window=(0.0, 1.0))
    return {"trace": tr, "traced_blocks": blocks}


def _metric(name):
    return run._load(run.ROOT / "portbench" / "metrics" / f"{name}.py").read


@pytest.mark.parametrize("mix", ["live", "replay", "stream"])
@pytest.mark.parametrize("metric,expect_ms", [
    ("intake_ms", (0.05 + 0.02) / 2 * 1e3),
    ("heatmap_host_ms", 0.1 / 2 * 1e3),
    ("swarm_host_ms", (0.1 + 0.05 + 0.05) / 2 * 1e3),
])
def test_each_reader_gives_ms_a_block(metric, expect_ms, mix):
    read = _metric(f"{metric}.{mix}")
    assert read(_ctx()) == pytest.approx(expect_ms)


@pytest.mark.parametrize("metric,absent", [
    ("intake_ms", "awpu.intake"), ("heatmap_host_ms", "awpu.heatmap"),
    ("swarm_host_ms", ("awpu.swarm", "awpu.miso")),
])
def test_a_reader_reads_nothing_where_its_span_is_absent(metric, absent):
    host = [h for h in HOST if h[0] not in absent]
    for mix in ("live", "replay", "stream"):
        assert _metric(f"{metric}.{mix}")(_ctx(host)) is None


def test_nothing_to_read_without_a_trace_or_outside_the_window():
    assert spans.intake_ms({}) is None
    assert spans.intake_ms(_ctx(blocks=0)) is None
    outside = [("awpu.intake", 1.2, 1.3), ("awpu.intake", -0.3, -0.1)]
    assert spans.intake_ms(_ctx(outside)) is None


def test_a_stretch_two_spans_cover_counts_once():
    host = [("awpu.swarm", 0.0, 0.5), ("awpu.miso", 0.1, 0.2),
            ("awpu.miso", 0.4, 0.6)]
    assert spans.swarm_host_ms(_ctx(host, blocks=1)) == pytest.approx(600.0)
