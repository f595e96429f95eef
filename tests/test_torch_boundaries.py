"""Boundaries of the port: it loads no JAX, dispatches its kernels on the
device of their tensors, runs every configuration of the ported slices (a
world-size-1 CPU mesh included) and raises for a mesh that is not a
``DeviceMesh``."""

import dataclasses
import functools
import importlib
import inspect
import os
import pkgutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import beamforming_lk_tpu_torch  # noqa: E402
from beamforming_lk_tpu_torch import config as tcfg  # noqa: E402
from beamforming_lk_tpu_torch import convert  # noqa: E402
from beamforming_lk_tpu_torch.app import AwpuPipeline  # noqa: E402
from beamforming_lk_tpu_torch.app import awpu  # noqa: E402
from beamforming_lk_tpu_torch.app import control  # noqa: E402
from beamforming_lk_tpu_torch.io import checkpoint as ckpt  # noqa: E402
from beamforming_lk_tpu_torch.io import ring as rg  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.models import fusion, kalman  # noqa: E402
from beamforming_lk_tpu_torch.models import miso as ms  # noqa: E402
from beamforming_lk_tpu_torch.models import music as mu  # noqa: E402
from beamforming_lk_tpu_torch.models import mvdr as mv  # noqa: E402
from beamforming_lk_tpu_torch.models import tracker as tk  # noqa: E402
from beamforming_lk_tpu_torch.models.mimo import (  # noqa: E402
    MimoModel, make_mimo_grid, make_mimo_model,
)
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402
from beamforming_lk_tpu_torch.ops import cuda_das as cd  # noqa: E402
from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk  # noqa: E402
from beamforming_lk_tpu_torch.ops import fft_das as fd  # noqa: E402
from beamforming_lk_tpu_torch.tools import track_replay  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = tcfg.realtime(tcfg.Config(
    mimo=tcfg.MimoConfig(rows=16, columns=16),
    tracker=tcfg.TrackerConfig(n_seekers=8, n_trackers=4),
))

_NO_JAX = """
import os, sys, tempfile
import numpy as np
import beamforming_lk_tpu_torch.parallel.multihost
from beamforming_lk_tpu_torch import Config, MimoConfig, realtime
from beamforming_lk_tpu_torch.app import AwpuPipeline
from beamforming_lk_tpu_torch.io import checkpoint
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block
from beamforming_lk_tpu_torch.models import calibration, fusion, kalman
cfg = realtime(Config(mimo=MimoConfig(rows=16, columns=16, phat=True)))
pipes = [AwpuPipeline(cfg, device="cpu", seed=s) for s in (0, 1)]
blocks = [plane_wave_block(pipes[0].points, [(0.5, 1.2, 5e3)], i * 256, 256)
          for i in range(4)]
result = pipes[0].calibrate(blocks)
assert isinstance(result, calibration.CalibrationResult)
with tempfile.TemporaryDirectory() as d:
    pipes[0].save(os.path.join(d, "s.npz"))
    pipes[1].restore(os.path.join(d, "s.npz"))
    checkpoint.load_state(os.path.join(d, "s.npz"), pipes[1].state)
rays = tempfile.TemporaryDirectory()
fuse = fusion.TargetFusion(cfg.triangulation, log_path=os.path.join(rays.name, "t.txt"),
                           device="cpu")
for p, x in zip(pipes, (-1.0, 1.0)):
    fuse.add_array(p, [x, 0.0, 0.0])
for i in range(2):
    for p in pipes:
        out = p.process_block(blocks[i])
    fuse.step(i * 0.005)
fuse.close()
from beamforming_lk_tpu_torch.tools import track_replay
track_replay.replay(os.path.join(rays.name, "t.txt"), device="cpu")
rays.cleanup()
kf = kalman.KalmanFilter3D(0.005, device="cpu")
kf.update(kf.init(), [0.4, 0.6, 6.0])
assert np.isfinite(out.powers.numpy()).all() and out.miso_beam.shape == (256,)
from beamforming_lk_tpu_torch.models import music, mvdr
for mode in ("mvdr", "music"):
    pipe = AwpuPipeline(cfg, device="cpu", heatmap_mode=mode)
    pipe.process_blocks(np.stack(blocks[:2]))
    assert pipe.heatmap().max() == 255
from beamforming_lk_tpu_torch.app import cli, control, waraps
from beamforming_lk_tpu_torch.io import audio_out, gps, native, packets, pcap, udp, wav
from beamforming_lk_tpu_torch.ops import filters
from beamforming_lk_tpu_torch.utils import (
    colormap, metrics, overlay, png, profiling, video)
with tempfile.TemporaryDirectory() as d:
    assert cli.main(["--device", "cpu", "--blocks", "2", "--mimo-res", "16",
                     "--tracking", "--miso", "--realtime", "--output-dir", d,
                     "--render-every", "1", "--miso-wav", os.path.join(d, "b.wav"),
                     "--arrays", "2", "--wara-ps", "--telemetry-file",
                     os.path.join(d, "t.ndjson")]) == 0
loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
          or m == "beamforming_lk_tpu" or m.startswith("beamforming_lk_tpu.")]
assert not loaded, loaded
print("no jax")
"""


def test_port_runs_two_blocks_without_loading_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "no jax" in proc.stdout


def _restore_jax_checkpoint(**kw):
    """``awpu_state_from_jax_checkpoint`` of a file with the JAX package's
    keys (the port writes the same ones)."""
    template = awpu.awpu_init(SMALL, 64, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        ckpt.save_state(path, template)
        return convert.awpu_state_from_jax_checkpoint(path, template, **kw)


def _replay_ray_log(**kw):
    """``tools.track_replay.replay`` of a one-line ray log."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "Targets.txt")
        with open(path, "w") as f:
            f.write("-1 0 0,0.1 0 1;1 0 0,-0.1 0 1;0.0\n")
        return track_replay.replay(path, **kw)


def _numpy_tree(tree):
    """A port state with numpy leaves, the form ``convert`` reads."""
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    if isinstance(tree, tuple):
        return type(tree)(*(_numpy_tree(v) for v in tree))
    return tree


@functools.lru_cache(maxsize=None)
def _jax_models():
    """The JAX package's fft and dense heatmap models of ``SMALL`` at 64
    mics, the inputs of ``convert``'s model converters."""
    from beamforming_lk_tpu import config as jcfg
    from beamforming_lk_tpu.models import mimo as jmm
    from beamforming_lk_tpu.ops import fft_das as jfd

    args = (ant.create_antenna_grid(), jcfg.MimoConfig(rows=16, columns=16),
            jcfg.DspConfig(), jcfg.ArrayConfig())
    return jfd.make_fft_heatmap_model(*args), jmm.make_mimo_model(*args)


_PTS = ant.create_antenna_grid()
_STEP_ARGS = (SMALL.tracker, SMALL.dsp, SMALL.array, _PTS)
_ONE = np.zeros((1, 1), np.float32)

# Each entry point that places work on a device: (function, a call of it).
_ENTRY_POINTS = {
    "AwpuPipeline": (awpu.AwpuPipeline, lambda **kw: awpu.AwpuPipeline(SMALL, **kw)),
    "make_awpu_step": (awpu.make_awpu_step, lambda **kw: awpu.make_awpu_step(
        ant.create_antenna_grid(), SMALL, **kw)),
    "awpu_init": (awpu.awpu_init, lambda **kw: awpu.awpu_init(SMALL, 64, **kw)),
    "TargetFusion": (fusion.TargetFusion, lambda **kw: fusion.TargetFusion(**kw)),
    "KalmanFilter3D": (kalman.KalmanFilter3D,
                       lambda **kw: kalman.KalmanFilter3D(0.005, **kw)),
    "awpu_state_from_jax_checkpoint": (convert.awpu_state_from_jax_checkpoint,
                                       _restore_jax_checkpoint),
    "ControlUnit": (control.ControlUnit,
                    lambda **kw: control.ControlUnit(SMALL, n_arrays=2, **kw)),
    "make_mvdr_step": (mv.make_mvdr_step, lambda **kw: mv.make_mvdr_step(
        ant.create_antenna_grid(), *make_mimo_grid(SMALL.mimo), **kw)),
    "mvdr_init": (mv.mvdr_init, lambda **kw: mv.mvdr_init(11, 64, 256, **kw)),
    "make_music_step": (mu.make_music_step, lambda **kw: mu.make_music_step(
        ant.create_antenna_grid(), *make_mimo_grid(SMALL.mimo), **kw)),
    "music_init": (mu.music_init, lambda **kw: mu.music_init(11, 64, **kw)),
    "track_replay": (track_replay.replay, _replay_ray_log),
    # The builders below it, each exported as the JAX package's is.
    "ring_init": (rg.ring_init, lambda **kw: rg.ring_init(64, 1024, **kw)),
    "pack_geometry": (ctk.pack_geometry,
                      lambda **kw: ctk.pack_geometry(_PTS, 1.0, **kw)),
    "make_fft_heatmap_model": (fd.make_fft_heatmap_model,
                               lambda **kw: fd.make_fft_heatmap_model(
                                   _PTS, SMALL.mimo, SMALL.dsp, SMALL.array, **kw)),
    "FftHeatmapModel": (fd.FftHeatmapModel, lambda **kw: fd.FftHeatmapModel(
        ex_s=_ONE, ey_s=_ONE, dft=_ONE, idft=_ONE, pow_ri=_ONE, rows=1,
        columns=1, block_size=1, fft_len=2, n_active=1.0, **kw)),
    "make_mimo_model": (make_mimo_model, lambda **kw: make_mimo_model(
        _PTS, SMALL.mimo, SMALL.dsp, SMALL.array, **kw)),
    "MimoModel": (MimoModel, lambda **kw: MimoModel(
        np.zeros((1, 64), np.int32), np.zeros((1, 64, 2), np.float32),
        *make_mimo_grid(tcfg.MimoConfig(rows=1, columns=1)), 1, 1, 64, **kw)),
    "miso_init": (ms.miso_init, lambda **kw: ms.miso_init(**kw)),
    "make_miso_step_impl": (ms.make_miso_step_impl,
                            lambda **kw: ms.make_miso_step_impl(*_STEP_ARGS, **kw)),
    "MisoStep": (ms.MisoStep, lambda **kw: ms.MisoStep(*_STEP_ARGS, **kw)),
    "UnfusedSwarmStep": (ms.UnfusedSwarmStep,
                         lambda **kw: ms.UnfusedSwarmStep(*_STEP_ARGS, **kw)),
    "swarm_init": (tk.swarm_init, lambda **kw: tk.swarm_init(
        SMALL.tracker, torch.Generator(), **kw)),
    "make_swarm_step_impl": (tk.make_swarm_step_impl,
                             lambda **kw: tk.make_swarm_step_impl(*_STEP_ARGS, **kw)),
    "make_fused_step_impl": (tk.make_fused_step_impl,
                             lambda **kw: tk.make_fused_step_impl(*_STEP_ARGS, **kw)),
    "make_fused_chunk_impl": (tk.make_fused_chunk_impl,
                              lambda **kw: tk.make_fused_chunk_impl(*_STEP_ARGS, **kw)),
    "ProbeChain": (tk.ProbeChain, lambda **kw: tk.ProbeChain(
        *_STEP_ARGS, None, 32, **kw)),
    "SwarmStep": (tk.SwarmStep, lambda **kw: tk.SwarmStep(*_STEP_ARGS, **kw)),
    "FusedSwarmStep": (tk.FusedSwarmStep,
                       lambda **kw: tk.FusedSwarmStep(*_STEP_ARGS, **kw)),
    "MisoBeam": (tk.MisoBeam, lambda **kw: tk.MisoBeam(
        SMALL.dsp, SMALL.array, _PTS, None, 32, **kw)),
    "AwpuStep": (awpu.AwpuStep, lambda **kw: awpu.AwpuStep(_PTS, SMALL, **kw)),
    "CovarianceStep": (mv.CovarianceStep, lambda **kw: mv.CovarianceStep(
        _PTS, *make_mimo_grid(SMALL.mimo), SMALL.array, 64, 32, 500.0, 4000.0,
        0.1, None, **kw)),
    "swarm_state_from_jax": (convert.swarm_state_from_jax,
                             lambda **kw: convert.swarm_state_from_jax(_numpy_tree(
                                 tk.swarm_init(SMALL.tracker, torch.Generator(),
                                               device="cpu")), **kw)),
    "miso_state_from_jax": (convert.miso_state_from_jax,
                            lambda **kw: convert.miso_state_from_jax(
                                _numpy_tree(ms.miso_init(device="cpu")), **kw)),
    "awpu_state_from_jax": (convert.awpu_state_from_jax,
                            lambda **kw: convert.awpu_state_from_jax(_numpy_tree(
                                awpu.awpu_init(SMALL, 64, device="cpu")), **kw)),
    "mvdr_state_from_jax": (convert.mvdr_state_from_jax,
                            lambda **kw: convert.mvdr_state_from_jax(_numpy_tree(
                                mv.mvdr_init(11, 64, 256, device="cpu")), **kw)),
    "music_state_from_jax": (convert.music_state_from_jax,
                             lambda **kw: convert.music_state_from_jax(_numpy_tree(
                                 mu.music_init(11, 64, device="cpu")), **kw)),
    "fft_model_from_jax": (convert.fft_model_from_jax,
                           lambda **kw: convert.fft_model_from_jax(
                               _jax_models()[0], **kw)),
    "mimo_model_from_jax": (convert.mimo_model_from_jax,
                            lambda **kw: convert.mimo_model_from_jax(
                                _jax_models()[1], **kw)),
}


def _device_parameters():
    """``device`` parameter of every public function and public class
    constructor of the port, keyed by module (below the package) and name."""
    found = {}
    prefix = beamforming_lk_tpu_torch.__name__ + "."
    for info in pkgutil.walk_packages(beamforming_lk_tpu_torch.__path__, prefix):
        module = importlib.import_module(info.name)
        for name, obj in vars(module).items():
            if name.startswith("_") or getattr(obj, "__module__", None) != info.name:
                continue
            if not (inspect.isfunction(obj) or inspect.isclass(obj)):
                continue
            params = inspect.signature(obj).parameters
            if "device" in params:
                found[f"{info.name[len(prefix):]}.{name}"] = params["device"]
    return found


_DEVICE_PARAMETERS = _device_parameters()

# Checks whose ``device`` is the one an operand must lie on: they place
# nothing, and every caller names it.
_DEVICE_CHECKS = {"ops.cuda_tracker.check_operand", "ops.cuda_tracker.require_cuda"}


def test_device_parameters_are_found():
    """The scan reaches every module: it finds each listed entry point and
    each check."""
    names = {n.rsplit(".", 1)[1] for n in _DEVICE_PARAMETERS}
    assert set(_ENTRY_POINTS) - {"track_replay"} <= names
    assert "tools.track_replay.replay" in _DEVICE_PARAMETERS
    assert _DEVICE_CHECKS <= set(_DEVICE_PARAMETERS)


@pytest.mark.parametrize("name", sorted(_DEVICE_PARAMETERS))
def test_every_device_parameter_defaults_to_cuda(name):
    """Every public function and class constructor of the port that takes
    ``device`` defaults to the card, found without a hand list (a check
    takes the operand's device without a default)."""
    param = _DEVICE_PARAMETERS[name]
    if name in _DEVICE_CHECKS:
        assert param.default is inspect.Parameter.empty
    else:
        assert param.default == "cuda"


def test_swarm_init_refuses_a_generator_on_another_device(monkeypatch):
    """A CPU generator for a draw on the card raises, naming both devices,
    and never moves the draw to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match=r"cuda.*cpu"):
        tk.swarm_init(SMALL.tracker, torch.Generator())


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_points_default_to_cuda(entry):
    param = inspect.signature(_ENTRY_POINTS[entry][0]).parameters["device"]
    assert param.default == "cuda"


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_default_device_raises_without_cuda(monkeypatch, entry):
    """On a host without CUDA the default device raises and never carries
    on on the CPU; asking for the CPU runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _ENTRY_POINTS[entry][1]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    assert call(device="cpu") is not None


def test_swarm_chain_rejects_devices_other_than_cuda_and_cpu():
    meta = torch.device("meta")
    p = 13
    with pytest.raises(RuntimeError, match="CUDA"):
        ctk.swarm_chain(
            torch.empty((4, 64), device=meta), torch.empty((64, 286), device=meta),
            torch.empty((64, 288), device=meta),
            torch.empty((16, p), device=meta), torch.empty((2, 1, p), device=meta),
            torch.empty((), device=meta), block_index=0, n_iter=1, n_sub=1,
            refine=1, n_trackers=4, span=32, theta_limit=1.5, divisor=256.0,
            closeness=0.08, error_threshold=1.0,
        )


def test_swarm_chunk_rejects_devices_other_than_cuda_and_cpu():
    meta = torch.device("meta")
    p, k = 13, 3
    with pytest.raises(RuntimeError, match="CUDA"):
        ctk.swarm_chunk(
            torch.empty((4, 64), device=meta),
            torch.empty((k, 64, 286), device=meta),
            torch.empty((k, 64, 288), device=meta),
            torch.empty((16, p), device=meta),
            torch.empty((k, 2, 1, p), device=meta),
            torch.empty((k, 3, p), device=meta), torch.empty((k,), device=meta),
            block_index0=0, n_iter=1, n_sub=1, refine=1, n_trackers=4,
            span=32, theta_limit=1.5, divisor=256.0, closeness=0.08,
            error_threshold=1.0,
        )


def test_power_matmul_rejects_devices_other_than_cuda_and_cpu():
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        fd.power_matmul(
            torch.empty((100, 161), device=meta),
            torch.empty((100, 161), device=meta),
            torch.empty((161, 256), device=meta),
            torch.empty((161, 256), device=meta),
        )


def test_monopulse_chain_rejects_devices_other_than_cuda_and_cpu():
    meta = torch.device("meta")
    p = 13
    with pytest.raises(RuntimeError, match="CUDA"):
        ctk.monopulse_chain(
            torch.empty((4, 64), device=meta), torch.empty((64, 286), device=meta),
            torch.empty((8, p), device=meta), torch.empty((5, p), device=meta),
            span=32, theta_limit=1.5, divisor=256.0,
        )


def test_das_beam_rejects_devices_other_than_cuda_and_cpu():
    meta = torch.device("meta")
    with pytest.raises(RuntimeError, match="CUDA"):
        cd.das_beam(
            torch.empty((64, 320), device=meta),
            torch.empty((100, 64), dtype=torch.int32, device=meta),
            torch.empty((100, 64, 2), device=meta), span=64,
        )


def _replace(cfg, part, **kw):
    return dataclasses.replace(cfg, **{part: dataclasses.replace(
        getattr(cfg, part), **kw)})


_OUTSIDE = {
    "mesh": dict(kwargs=dict(mesh=object()), raises=TypeError),
}

# Configurations of the default-profile slice (the unfused tracker and
# MISO steps, the XLA-chain backend, the dense heatmap and the fft
# backend's fallback to it), SRP-PHAT, and the adaptive heatmaps.
_INSIDE = {
    "mvdr": dict(kwargs=dict(heatmap_mode="mvdr")),
    "music": dict(kwargs=dict(heatmap_mode="music")),
    "phat": dict(cfg=_replace(SMALL, "mimo", phat=True)),
    "tracker_off": dict(kwargs=dict(enable_tracker=False)),
    "miso_off": dict(kwargs=dict(enable_miso=False)),
    "iterations_10": dict(cfg=_replace(SMALL, "tracker", iterations=10)),
    "probe_kernel_xla": dict(cfg=_replace(SMALL, "tracker", probe_kernel="xla")),
    "dense_heatmap": dict(cfg=_replace(SMALL, "mimo", backend="dense")),
    "gain_mask": dict(kwargs=dict(channel_mask=np.full(64, 0.5, np.float32))),
    "non_lattice": dict(kwargs=dict(points=ant.create_antenna_grid() * np.array(
        [[1.0], [1.0], [0.0]], np.float32) + np.linspace(0, 0.01, 64)[None])),
    "mesh": dict(mesh=True),
}


@pytest.fixture
def world1_mesh(tmp_path):
    """A (ch, dir) = (1, 1) CPU mesh of a one-process gloo group, torn down
    after the test."""
    import torch.distributed as dist

    from beamforming_lk_tpu_torch.parallel import make_mesh

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", sorted(_OUTSIDE))
def test_outside_the_slice_raises(case):
    spec = _OUTSIDE[case]
    with pytest.raises(spec["raises"]):
        AwpuPipeline(spec.get("cfg", SMALL), device="cpu",
                     **spec.get("kwargs", {}))


@pytest.mark.parametrize("case", sorted(_INSIDE))
def test_inside_the_slice_runs_two_blocks(case, request):
    """Each configuration builds on the CPU and runs 2 blocks of a plane
    wave: finite heatmap powers (the estimator's in the adaptive modes,
    where the DAS heatmap is off), a beam of one block, targets of every
    tracker (zero beam or zero targets where MISO or the tracker is off).
    The mesh case runs the sharded step on a world-size-1 mesh."""
    spec = _INSIDE[case]
    kwargs = dict(spec.get("kwargs", {}))
    if spec.get("mesh"):
        kwargs["mesh"] = request.getfixturevalue("world1_mesh")
    pipe = AwpuPipeline(spec.get("cfg", SMALL), device="cpu", **kwargs)
    for i in range(2):
        out = pipe.process_block(plane_wave_block(
            pipe.points, [(0.5, 1.2, 5e3)], i * 256, 256,
            rng=np.random.default_rng(i)))
    powers = out.powers
    if "heatmap_mode" in kwargs:
        assert not out.powers.any()
        powers = pipe._mvdr_powers
    assert powers.shape == (256,) and torch.isfinite(powers).all()
    assert powers.max() > 0
    assert out.miso_beam.shape == (256,) and out.targets.valid.shape == (4,)
    assert out.miso_beam.any() == kwargs.get("enable_miso", True)
    if not kwargs.get("enable_tracker", True):
        assert not out.targets.valid.any() and not out.targets.power.any()
    assert pipe.state.block_index == 2


@pytest.mark.parametrize("method", ["calibrate", "save", "restore"])
def test_state_io_and_calibration_run(tmp_path, method):
    """Each method runs on a pipeline with the heatmap off: ``calibrate``
    masks a dead mic and rebuilds the step, ``save`` writes the state's
    leaves and the generator, ``restore`` brings them back."""
    pipe = AwpuPipeline(SMALL, enable_mimo=False, device="cpu")
    path = str(tmp_path / "state.npz")
    blocks = np.stack([plane_wave_block(pipe.points, [(0.5, 1.2, 5e3)], i * 256,
                                        256) for i in range(4)])
    blocks[:, 3] = 0.0
    if method == "calibrate":
        step = pipe.step
        result = pipe.calibrate(blocks)
        assert result.mask[3] == 0.0 and int(result.usable) == 63
        assert pipe.step is not step and pipe.step.swarm_step is not None
        assert pipe.state.block_index == 4
        return
    pipe.process_blocks(blocks)
    pipe.save(path)
    with np.load(path) as data:
        assert {".history", ".block_index", ".swarm/.reset_count",
                AwpuPipeline.GENERATOR_KEY} <= set(data.files)
    if method == "restore":
        other = AwpuPipeline(SMALL, enable_mimo=False, seed=5, device="cpu")
        other.restore(path)
        assert other.state.block_index == 4
        assert torch.equal(other.state.history, pipe.state.history)
        assert torch.equal(other.generator.get_state(), pipe.generator.get_state())


def test_pipeline_scopes_tf32_to_its_own_calls(monkeypatch):
    """The pipeline's calls run without TF32 and give the caller's TF32
    settings back afterwards, also when a call raises."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    from beamforming_lk_tpu_torch.device import _tf32_switches

    pipe = AwpuPipeline(SMALL, device="cpu")
    seen = []
    real = pipe.step.forward

    def forward(*args, **kwargs):
        # Read through the switches the port sets: torch refuses to read
        # allow_tf32 while the newer fp32_precision disagrees with it.
        seen.append([getattr(h, n) == v for h, n, v in _tf32_switches()])
        return real(*args, **kwargs)

    pipe.step.forward = forward
    pipe.process_block(np.zeros((64, 256), np.float32))
    pipe.process_blocks(np.zeros((2, 64, 256), np.float32))
    pipe.calibrate()
    assert seen == [[True, True]] * 3
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    with pytest.raises(RuntimeError):
        pipe.process_block(np.zeros((63, 256), np.float32))
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32


def test_fused_chunk_configuration_runs(monkeypatch):
    """The realtime profile's fused_chunk=12 builds, and process_blocks of
    12 blocks makes one call of the chunk kernel's wrapper."""
    calls = []
    real = ctk.swarm_chunk

    def counting(*args, **kwargs):
        calls.append(args[1].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(ctk, "swarm_chunk", counting)
    assert SMALL.dsp.fused_chunk == 12
    pipe = AwpuPipeline(SMALL, device="cpu")
    out = pipe.process_blocks(np.zeros((12, 64, 256), np.float32))
    assert calls == [12]
    assert out.powers.shape == (12, 256) and out.miso_beam.shape == (12, 256)
    assert out.targets.valid.shape == (12, 4)
    assert pipe.state.block_index == 12


def test_heatmap_can_be_disabled():
    pipe = AwpuPipeline(SMALL, enable_mimo=False, device="cpu")
    out = pipe.process_block(np.zeros((64, 256), np.float32))
    assert not out.powers.any() and out.miso_beam.shape == (256,)
