"""The cell ``lk256-music-stream``: wideband MUSIC at 256 mics in the
realtime profile under the backlog loop.  Its files are found by name
(configuration, traffic, limits, the float64 reference
``reference/estimators/music.py`` and seven per-layer readers); the two
readers of the estimator's spans read ms a block, and nothing from a
program without them; on the CPU at 64 mics a sound run is correct
against the reference, the control is not, and a planted fault is not."""

import ast
from types import SimpleNamespace

import pytest

from portbench import check, run
from portbench.tests.portbench_cells import small_cell

CELL = "lk256-music-stream"
SECONDS = 0.1
PER_LAYER = {"host_enqueue_ms.stream", "kernels_per_block.stream",
             "device_idle_share.stream", "intake_ms.stream", "swarm_host_ms.stream",
             "estimator_host_ms.stream", "music_subspace_host_ms.stream"}


def test_the_music_cell_finds_its_files():
    spec = run.load_cell(CELL)
    assert spec["cell"]["config"] == "lk256-music" and spec["cell"]["chips"] == 1
    assert run.pipeline_options(spec["config"]) == {
        "heatmap_mode": "music", "music_solver": "subspace", "music_sources": 3}
    assert spec["config"]["channels"] == 256 and spec["config"]["reduced"] == []
    assert spec["estimator"] == (run.ROOT / "portbench" / "reference" / "estimators" /
                                 "music.py")
    assert set(spec["limits"]) == {check.SPECTRUM, check.ESTIMATOR_STATE, "history_gap",
                                   "target_gap_rad", "beam_gap", "state_gap_rad"}
    assert {m["name"] for m, _ in spec["end_to_end"]} == {"blocks_per_s.stream",
                                                          "setup_s"}
    assert {m["name"] for m, _ in spec["per_layer"]} == PER_LAYER
    for _, path in spec["end_to_end"] + spec["per_layer"]:
        assert callable(run._load(path).read), path


def test_the_reference_imports_nothing_of_the_port():
    tree = ast.parse((run.ROOT / "portbench" / "reference" / "estimators" /
                      "music.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    tops = {name.split(".")[0] for name in names}
    assert tops <= {"__future__", "math", "numpy", "torch", "portbench"}, tops


#: Host events of a made-up 1 s window [0, 1], two traced blocks.
HOST = [
    ("awpu.estimator", -0.1, 0.3),            # crosses the window's start: 0.3 s
    ("awpu.estimator.covariance", 0.0, 0.05),
    ("awpu.estimator.subspace", 0.05, 0.2),
    ("awpu.estimator.spectrum", 0.2, 0.3),
    ("awpu.estimator", 0.5, 0.7),
    ("awpu.estimator.subspace", 0.55, 0.65),
    ("awpu.swarm", 0.7, 0.9),
]


def _reader(name):
    return run._load(run.ROOT / "portbench" / "metrics" / f"{name}.py").read


@pytest.mark.parametrize("name, expect_ms", [
    ("estimator_host_ms.stream", (0.3 + 0.2) / 2 * 1e3),
    ("music_subspace_host_ms.stream", (0.15 + 0.1) / 2 * 1e3)])
def test_the_estimator_readers_give_ms_a_block(name, expect_ms):
    ctx = {"trace": SimpleNamespace(host=HOST, window=(0.0, 1.0)), "traced_blocks": 2}
    assert _reader(name)(ctx) == pytest.approx(expect_ms)
    # A program without the spans (the DAS path, or a port before them).
    bare = [h for h in HOST if not h[0].startswith("awpu.estimator")]
    assert _reader(name)({"trace": SimpleNamespace(host=bare, window=(0.0, 1.0)),
                          "traced_blocks": 2}) is None


def test_a_sound_music_run_is_correct_at_the_test_size():
    result, shown = run.run_cell(small_cell(CELL), 2 ** 31 + 21, SECONDS, False,
                                 device="cpu")
    assert result["correct"], shown
    assert check.SPECTRUM in shown and "map_gap" not in shown


def test_the_music_control_fails_the_limits():
    spec = small_cell(CELL)
    result, _ = run.run_cell(spec, 2 ** 31 + 23, SECONDS, False, device="cpu",
                             control=True)
    ok, shown = check.verdict(result["control"], spec["limits"])
    assert not ok, shown


def _frozen_covariance(pipe):
    """The covariance never advances; the counter and basis do."""
    entry = pipe.process_block

    def frozen(block, draws=None):
        held = pipe._mvdr_state
        out = entry(block, draws=draws)
        pipe._mvdr_state = pipe._mvdr_state._replace(cov_re=held.cov_re,
                                                     cov_im=held.cov_im)
        return out

    pipe.process_block = frozen


def _scaled_spectrum(pipe):
    entry = pipe.process_block

    def scaled(block, draws=None):
        out = entry(block, draws=draws)
        pipe._mvdr_powers = pipe._mvdr_powers * 1.1
        return out

    pipe.process_block = scaled


@pytest.mark.parametrize("fault", [_frozen_covariance, _scaled_spectrum],
                         ids=["covariance-unchanged", "spectrum-scaled"])
def test_a_planted_music_fault_is_not_correct(fault):
    result, shown = run.run_cell(small_cell(CELL), 2 ** 31 + 21, SECONDS, False,
                                 device="cpu", pipeline_hook=fault)
    assert not result["correct"], shown


@pytest.mark.card
def test_the_music_control_fails_on_the_card_at_the_cells_size(card):
    spec = run.load_cell(CELL)
    for seed in (2 ** 31 + 111, 2 ** 31 + 112):
        result, shown = run.run_cell(spec, seed, 2.0, False, device=card, control=True)
        assert result["correct"], shown
        assert not check.verdict(result["control"], spec["limits"])[0], result["control"]
