"""The cell ``lk256-mvdr-live``: Capon (MVDR) at 256 mics in the realtime
profile, live at the wire rate.  Its files are found by name
(configuration, traffic, limits, the float64 complex reference
``reference/estimators/mvdr.py`` and the three per-layer readers of the
metrics that move ``latency_p50_ms``, the one latency the cell reports);
``mvdr_roofline.live`` counts a block's least work at 256 mics and reads
the device's time outside the swarm kernels, and nothing without a trace;
on the CPU at 64 mics a sound run is correct against the reference, and
the control and three planted faults are not."""

import ast
from types import SimpleNamespace

import pytest

from portbench import check, run
from portbench.tests.portbench_cells import small_cell

CELL = "lk256-mvdr-live"
SECONDS = 0.05
PER_LAYER = {"swarm_replay_share.live", "estimator_host_ms.live", "mvdr_roofline.live"}


def _reader(name):
    return run._load(run.ROOT / "portbench" / "metrics" / f"{name}.py")


def test_the_mvdr_cell_finds_its_files():
    spec = run.load_cell(CELL)
    assert spec["cell"]["config"] == "lk256-mvdr" and spec["cell"]["chips"] == 1
    assert spec["traffic"]["loop"] == "paced" and spec["traffic"]["batch"] == 1
    assert run.pipeline_options(spec["config"]) == {"heatmap_mode": "mvdr",
                                                    "mvdr_refresh": 1}
    assert spec["config"]["channels"] == 256 and spec["config"]["reduced"] == []
    assert spec["estimator"] == (run.ROOT / "portbench" / "reference" / "estimators" /
                                 "mvdr.py")
    assert set(spec["limits"]) == {check.SPECTRUM, check.ESTIMATOR_STATE, "history_gap",
                                   "target_gap_rad", "beam_gap", "state_gap_rad"}
    assert {m["name"] for m, _ in spec["end_to_end"]} == {"latency_p50_ms", "setup_s"}
    assert {m["name"] for m, _ in spec["per_layer"]} == PER_LAYER
    for _, path in spec["end_to_end"] + spec["per_layer"]:
        assert callable(run._load(path).read), path


def test_the_reference_imports_nothing_of_the_port():
    tree = ast.parse((run.ROOT / "portbench" / "reference" / "estimators" /
                      "mvdr.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    tops = {name.split(".")[0] for name in names}
    assert tops <= {"__future__", "math", "numpy", "torch", "portbench"}, tops


def test_the_roofline_counts_a_block_at_256_mics():
    """F = 11 bins, 2C = 512, D = 4096, M = 7 frames of 64 samples."""
    cfg = run.load_cell(CELL)["config"]
    flops, nbytes, peak = _reader("mvdr_roofline.live").counts(cfg)
    f, c2, d, m = 11, 512, 4096, 7
    assert flops == pytest.approx(f * d * c2 ** 2 + f * c2 ** 3 / 3 + 2 * f * c2 ** 2 * m
                                  + 2 * c2 * m * 64 * f + 2 * f * d * c2)
    assert flops == pytest.approx(1.2396e10, rel=1e-4)
    assert nbytes == 4 * (3 * f * d * c2 + 3 * f * c2 ** 2)
    assert peak == 67e12
    # The operations bind: ~0.185 ms at the f32 peak, ~0.093 ms of bytes.
    assert flops / peak == pytest.approx(1.85e-4, rel=1e-2)


def test_the_roofline_reads_the_time_outside_the_swarm_kernels():
    cfg = run.load_cell(CELL)["config"]
    reader = _reader("mvdr_roofline.live")
    least = max(reader.counts(cfg)[0] / 67e12, reader.counts(cfg)[1] / 3.35e12)
    ops = [("void trsm_kernel", 0.0, 0.004), ("swarm_chain_kernel<bf16>", 0.004, 0.005),
           ("potrf", 0.005, 0.006)]
    trace = SimpleNamespace(ops=ops, busy_s=lambda: 0.006,
                            kernels=lambda *names: [o for o in ops
                                                    if any(n in o[0] for n in names)])
    got = reader.read({"trace": trace, "traced_blocks": 2, "config": cfg})
    assert got == pytest.approx(least / 0.0025 * 100.0)
    assert reader.read({"config": cfg}) is None
    assert reader.read({"trace": SimpleNamespace(ops=[]), "traced_blocks": 2,
                        "config": cfg}) is None


def test_the_live_estimator_reader_gives_ms_a_block():
    host = [("awpu.estimator", -0.1, 0.3), ("awpu.estimator.factor", 0.0, 0.1),
            ("awpu.estimator", 0.5, 0.7), ("awpu.swarm", 0.7, 0.9)]
    read = _reader("estimator_host_ms.live").read
    ctx = {"trace": SimpleNamespace(host=host, window=(0.0, 1.0)), "traced_blocks": 2}
    assert read(ctx) == pytest.approx((0.3 + 0.2) / 2 * 1e3)
    bare = [h for h in host if not h[0].startswith("awpu.estimator")]
    assert read({"trace": SimpleNamespace(host=bare, window=(0.0, 1.0)),
                 "traced_blocks": 2}) is None


def test_a_sound_mvdr_run_is_correct_at_the_test_size():
    result, shown = run.run_cell(small_cell(CELL), 2 ** 31 + 21, SECONDS, False,
                                 device="cpu")
    assert result["correct"], shown
    assert check.SPECTRUM in shown and "map_gap" not in shown


def test_the_mvdr_control_fails_the_limits():
    spec = small_cell(CELL)
    result, _ = run.run_cell(spec, 2 ** 31 + 23, SECONDS, False, device="cpu",
                             control=True)
    ok, shown = check.verdict(result["control"], spec["limits"])
    assert not ok, shown


def _unchanged_state(pipe):
    """The estimator's covariance and count never advance."""
    entry = pipe.process_block

    def frozen(block, draws=None):
        held = pipe._mvdr_state
        out = entry(block, draws=draws)
        pipe._mvdr_state = held
        return out

    pipe.process_block = frozen


def _loading_doubled(pipe):
    pipe._mvdr_step.diagonal_loading *= 2.0


def _bin_dropped(pipe):
    """Bin 7 of the 64-point DFT (5341 Hz, nearest the 5 kHz source) left
    out of the sum.  A bin that holds noise alone moves the spectrum by at
    most ~1e-3 of its peak here, under the cell's limit."""
    pipe._mvdr_step.binw[6] = 0.0


@pytest.mark.parametrize("fault", [_unchanged_state, _loading_doubled, _bin_dropped],
                         ids=["state-unchanged", "loading-doubled", "bin-dropped"])
def test_a_planted_mvdr_fault_is_not_correct(fault):
    result, shown = run.run_cell(small_cell(CELL), 2 ** 31 + 21, SECONDS, False,
                                 device="cpu", pipeline_hook=fault)
    assert not result["correct"], shown


@pytest.mark.card
def test_the_mvdr_control_fails_on_the_card_at_the_cells_size(card):
    spec = run.load_cell(CELL)
    for seed in (2 ** 31 + 111, 2 ** 31 + 112):
        result, shown = run.run_cell(spec, seed, 2.0, False, device=card, control=True)
        assert result["correct"], shown
        assert not check.verdict(result["control"], spec["limits"])[0], result["control"]
