"""A configuration that names an adaptive estimator, added as files alone:
a configuration with a ``"pipeline"`` object, a reference module under
``reference/estimators/``, a limits file and appended entries of
``BENCHMARK.json``, in a copy of the benchmark under ``tmp_path``.  Its
run compares the estimator's spectrum (``spectrum_gap``) and the state it
hands on (``estimator_state_gap``), and no DAS map; a spectrum altered
where it is produced, or a state left unchanged, reads not correct."""

import json
import shutil

import pytest
import torch

from portbench import check, run
from portbench.tests.portbench_cells import small_cell

CELL = "lk64-mvdr-live"
SECONDS = 0.05

#: The planted reference of either estimator: a test fixture, so it may
#: wrap the port's CPU step (the reference a benchmark ships may not).
FIXTURE = '''
import numpy as np
import torch


def _step(points, cfg):
    from beamforming_lk_tpu_torch import config as pc
    from beamforming_lk_tpu_torch.models import music as mu, mvdr as mv
    from beamforming_lk_tpu_torch.models.mimo import make_mimo_grid

    theta, phi = make_mimo_grid(pc.MimoConfig(**cfg["mimo"]))
    args = (np.asarray(points, np.float32), theta, phi, pc.ArrayConfig(**cfg["array"]))
    p = cfg["pipeline"]
    if p["heatmap_mode"] == "mvdr":
        step, _ = mv.make_mvdr_step(*args, weight_refresh=p.get("mvdr_refresh", 1),
                                    device="cpu")
        return step, mv.MvdrState
    step, _ = mu.make_music_step(*args, solver=p.get("music_solver", "subspace"),
                                 n_sources=p.get("music_sources", 3), device="cpu")
    return step, mu.MusicState


def follow(state, blocks, points, cfg, precision):
    from portbench.reference.precision import round_to

    step, kind = _step(points, cfg)
    st = kind(**{k: v.clone() if torch.is_tensor(v) else v for k, v in state.items()})
    for block in round_to(blocks, precision).float():
        st, powers = step(st, block)
    return powers.double(), st._asdict()


def comparable(state):
    out = dict(state)
    if out.get("basis") is not None:
        out["basis"] = out["basis"] @ out["basis"].transpose(-1, -2)
    return out
'''
MVDR = {"heatmap_mode": "mvdr"}


def _estimator_root(tmp_path, pipeline, module=FIXTURE, spectrum_limit=1e-5):
    """A copy of the benchmark with the cell :data:`CELL` added as files
    alone: 64 mics in the realtime profile, a 16 x 16 grid, ``pipeline``."""
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(run.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    base = tmp_path / "portbench"
    cfg = json.loads((base / "configs" / "lk64-rt.json").read_text())
    cfg = dict(cfg, name="lk64-mvdr", pipeline=pipeline,
               mimo=dict(cfg["mimo"], rows=16, columns=16))
    (base / "configs" / "lk64-mvdr.json").write_text(json.dumps(cfg))
    if module is not None:
        (base / "reference" / "estimators" /
         f"{pipeline['heatmap_mode']}.py").write_text(module)
    limits = json.loads((base / "limits" / "lk64-rt-live.json").read_text())["limits"]
    limits.pop("map_gap")
    limits[check.SPECTRUM], limits[check.ESTIMATOR_STATE] = spectrum_limit, 1e-5
    (base / "limits" / f"{CELL}.json").write_text(json.dumps({"limits": limits}))
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())
    manifest["configs"].append(dict(name="lk64-mvdr", source=cfg["source"],
                                    file="portbench/configs/lk64-mvdr.json",
                                    reduced=[], why="test"))
    manifest["workloads"].append(dict(name=CELL, config="lk64-mvdr", traffic="wire",
                                      chips=1, why="test"))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "lk64-rt-live" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp_path


def _scaled_spectrum(pipe):
    """The estimator's spectrum is scaled by 1.05 where it is produced."""
    entry = pipe.process_block

    def scaled(block, draws=None):
        out = entry(block, draws=draws)
        pipe._mvdr_powers = pipe._mvdr_powers * 1.05
        return out

    pipe.process_block = scaled


def _frozen_state(pipe):
    """The estimator hands on the state it was given: the covariance never
    advances (the spectrum of each call is still its own)."""
    entry = pipe.process_block

    def frozen(block, draws=None):
        held = pipe._mvdr_state
        out = entry(block, draws=draws)
        pipe._mvdr_state = held
        return out

    pipe.process_block = frozen


def _frozen_covariance(pipe):
    """As :func:`_frozen_state`, with the counter advancing."""
    entry = pipe.process_block

    def frozen(block, draws=None):
        held = pipe._mvdr_state
        out = entry(block, draws=draws)
        pipe._mvdr_state = pipe._mvdr_state._replace(cov_re=held.cov_re,
                                                     cov_im=held.cov_im)
        return out

    pipe.process_block = frozen


@pytest.mark.parametrize("pipeline, spectrum_limit", [
    (MVDR, 1e-5), (dict(heatmap_mode="mvdr", mvdr_refresh=3), 1e-5),
    # The pseudo-spectrum's complement subtraction cancels near a peak, so
    # the fixture's steering table, from the reference's float64 points (a
    # float32 ulp off the port's), moves it by ~2e-4 on the CPU.
    (dict(heatmap_mode="music", music_solver="subspace", music_sources=3), 1e-3)],
    ids=["mvdr", "mvdr-refresh3", "music-subspace"])
def test_an_estimator_cell_runs_correct_on_its_spectrum(tmp_path, pipeline,
                                                        spectrum_limit):
    root = _estimator_root(tmp_path, pipeline, spectrum_limit=spectrum_limit)
    spec = small_cell(CELL, root=root)
    assert spec["estimator"] == (root / "portbench" / "reference" / "estimators" /
                                 f"{pipeline['heatmap_mode']}.py")
    result, shown = run.run_cell(spec, 2 ** 31 + 7, SECONDS, False, device="cpu")
    assert result["correct"], shown
    assert check.SPECTRUM in shown and "map_gap" not in shown
    assert shown[check.ESTIMATOR_STATE]["value"] <= 1e-5
    assert "map peak at pixel" in result["lock"]


def test_an_altered_spectrum_is_not_correct(tmp_path):
    spec = small_cell(CELL, root=_estimator_root(tmp_path, MVDR))
    result, shown = run.run_cell(spec, 2 ** 31 + 7, SECONDS, False, device="cpu",
                                 pipeline_hook=_scaled_spectrum)
    assert not result["correct"], shown
    assert shown[check.SPECTRUM]["value"] > 0.04


@pytest.mark.parametrize("fault", [_frozen_state, _frozen_covariance],
                         ids=["state-unchanged", "covariance-unchanged"])
def test_an_estimator_state_left_unchanged_is_not_correct(tmp_path, fault):
    """The reference starts from the program's state, so a frozen state
    reads no spectrum gap: the state after the call is what catches it."""
    spec = small_cell(CELL, root=_estimator_root(tmp_path, MVDR))
    result, shown = run.run_cell(spec, 2 ** 31 + 7, SECONDS, False, device="cpu",
                                 pipeline_hook=fault)
    assert not result["correct"], shown
    assert shown[check.SPECTRUM]["value"] <= 1e-5
    assert shown[check.ESTIMATOR_STATE]["value"] > 0.04


def test_the_estimators_control_reads_its_spectrum_one_precision_lower(tmp_path):
    spec = small_cell(CELL, root=_estimator_root(tmp_path, MVDR))
    result, _ = run.run_cell(spec, 2 ** 31 + 9, SECONDS, False, device="cpu",
                             control=True)
    control = result["control"]
    assert "map_gap" not in control and check.ESTIMATOR_STATE in control
    assert control[check.SPECTRUM] > spec["limits"][check.SPECTRUM]


def test_a_missing_estimator_reference_stops_the_cell(tmp_path):
    root = _estimator_root(tmp_path, MVDR, module=None)
    with pytest.raises(SystemExit, match=r"reference/estimators/mvdr\.py"):
        run.load_cell(CELL, root=root)


def test_an_unknown_pipeline_key_is_refused(tmp_path):
    root = _estimator_root(tmp_path, {"heatmap_mode": "mvdr", "mvdr_refesh": 3})
    with pytest.raises(SystemExit, match="mvdr_refesh"):
        run.load_cell(CELL, root=root)


def test_a_configuration_without_pipeline_builds_todays_pipeline():
    spec = run.load_cell("lk64-rt-live")
    assert spec["estimator"] is None and run.pipeline_options(spec["config"]) == {}


@pytest.mark.parametrize("options", [
    dict(heatmap_mode="mvdr"), dict(heatmap_mode="mvdr", mvdr_refresh=3),
    dict(heatmap_mode="music", music_solver="subspace", music_sources=3),
    dict(heatmap_mode="music", music_solver="eigh", music_sources=3)],
    ids=["mvdr", "mvdr-refresh3", "music-subspace", "music-eigh"])
def test_the_estimator_state_held_before_a_call_is_unchanged_after_it(options):
    spec = small_cell("lk64-rt-live")
    cfg = dict(spec["config"], pipeline=options,
               mimo=dict(spec["config"]["mimo"], rows=8, columns=8))
    from beamforming_lk_tpu_torch.app import AwpuPipeline

    pipe = AwpuPipeline(run.port_config(cfg), channels=64, device="cpu",
                        **run.pipeline_options(cfg))
    gen = torch.Generator().manual_seed(5)
    blocks = torch.randn((3, 64, 256), generator=gen) * 1e-2
    feed = type("Feed", (), {"block": lambda self, k: blocks[k % 3]})()
    spectra = []
    for k in range(3):
        held = pipe._mvdr_state
        copy = [v.clone() if torch.is_tensor(v) else v for v in held]
        sampler = run.Reservoir(1, None)
        run.drive(pipe, feed, dict(loop="closed", batch=1), k, 0.0,
                  torch.device("cpu"), sampler=sampler, estimator=True)
        item = sampler.items[0]
        assert item["estimator_before"] is held and held is not pipe._mvdr_state
        assert item["estimator_after"] is pipe._mvdr_state
        for a, b in zip(held, copy):
            assert torch.equal(a, b) if torch.is_tensor(a) else a == b
        assert item["spectrum"] is pipe._mvdr_powers
        spectra.append((item["spectrum"], item["spectrum"].clone()))
    for got, copy in spectra:
        assert torch.equal(got, copy)
