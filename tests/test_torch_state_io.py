"""Checkpoint/resume and auto-calibration of the port's pipeline against the
JAX package's (``io/checkpoint.py``, ``models/calibration.py``,
``AwpuPipeline.calibrate/save/restore``), on the CPU."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import beamforming_lk_tpu.config as jcfg  # noqa: E402
from beamforming_lk_tpu.app import AwpuPipeline as JaxPipeline  # noqa: E402
from beamforming_lk_tpu.models import calibration as jcal  # noqa: E402
from beamforming_lk_tpu_torch import config as tcfg  # noqa: E402
from beamforming_lk_tpu_torch.app import AwpuPipeline  # noqa: E402
from beamforming_lk_tpu_torch.convert import (  # noqa: E402
    awpu_state_from_jax, awpu_state_from_jax_checkpoint,
)
from beamforming_lk_tpu_torch.io.checkpoint import load_state, save_state  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.models import calibration as tcal  # noqa: E402
from beamforming_lk_tpu_torch.models.mimo import make_mimo_grid  # noqa: E402
from beamforming_lk_tpu_torch.ops.geometry import spherical_angle  # noqa: E402

SRC = (0.5, 1.5, 5000.0)
# The JAX package's checkpoint test's configuration (the fused step on the
# XLA chain), and the realtime profile at a small size (the chunk kernel's
# twin on process_blocks).
CFGS = {
    "fused_xla": tcfg.Config(mimo=tcfg.MimoConfig(rows=16, columns=16),
                             tracker=tcfg.TrackerConfig(iterations=2)),
    "realtime": tcfg.realtime(tcfg.Config(
        mimo=tcfg.MimoConfig(rows=16, columns=16),
        tracker=tcfg.TrackerConfig(n_seekers=8, n_trackers=4))),
}


def _blocks(points, n, start=0):
    return np.stack([
        plane_wave_block(points, [SRC], (start + b) * 256, 256, noise_std=0.02,
                         rng=np.random.default_rng(start + b))
        for b in range(n)
    ])


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _assert_equal_trees(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("name", sorted(CFGS))
def test_pipeline_save_restore_continues_identically(tmp_path, name):
    """A pipeline restored into one built with another seed loads the saved
    state leaf for leaf and continues bit for bit as the uninterrupted one
    does, live (``process_block``) and replayed (``process_blocks``: one
    chunk on the realtime profile)."""
    cfg = CFGS[name]
    n = 12 if name == "realtime" else 4
    path = str(tmp_path / "state.npz")
    for replay in (False, True):
        pipe = AwpuPipeline(cfg, seed=1, device="cpu")
        pipe.process_blocks(_blocks(pipe.points, n))
        pipe.save(path)
        cont = _blocks(pipe.points, n, start=n)
        restored = AwpuPipeline(cfg, seed=99, device="cpu")
        restored.restore(path)
        assert restored.state.block_index == n
        _assert_equal_trees(restored.state, pipe.state)
        for p in (pipe, restored):
            p.outs = (p.process_blocks(cont) if replay
                      else [p.process_block(b) for b in cont])
        _assert_equal_trees(restored.outs, pipe.outs)
        _assert_equal_trees(restored.state, pipe.state)


def test_checkpoint_rejects_shape_mismatch(tmp_path):
    path = str(tmp_path / "s.npz")
    save_state(path, {"a": np.zeros((3,))})
    with pytest.raises(ValueError):
        load_state(path, {"a": np.zeros((4,))})
    with pytest.raises(KeyError):
        load_state(path, {"b": np.zeros((3,))})
    with pytest.raises(ValueError):
        load_state(path, {"a": torch.zeros((1, 3))})
    np.testing.assert_array_equal(load_state(path, {"a": np.ones(3)})["a"], 0.0)


def _jax_pipeline(n_blocks, path):
    """The JAX package's pipeline on the checkpoint test's configuration,
    fed ``n_blocks`` blocks and saved to ``path``; returns its state."""
    cfg = jcfg.Config(mimo=jcfg.MimoConfig(rows=16, columns=16),
                      tracker=jcfg.TrackerConfig(iterations=2))
    pipe = JaxPipeline(cfg, seed=1)
    for b in _blocks(pipe.points, n_blocks):
        pipe.process_block(b)
    pipe.save(path)
    return jax.tree.map(np.asarray, pipe.state)


def test_jax_checkpoint_loads_through_convert(tmp_path):
    """A file the JAX package's ``AwpuPipeline.save`` wrote gives, through
    ``awpu_state_from_jax_checkpoint`` and through ``restore``, leaves
    equal to the JAX state; the file's keys are the port's own plus the
    JAX PRNG key, which is not read."""
    path = str(tmp_path / "jax.npz")
    jstate = _jax_pipeline(4, path)
    pipe = AwpuPipeline(CFGS["fused_xla"], seed=5, device="cpu")
    want = awpu_state_from_jax(jstate, device="cpu")
    got = awpu_state_from_jax_checkpoint(path, pipe.state, device="cpu")
    _assert_equal_trees(got, want)
    assert got.block_index == 4 and isinstance(got.swarm.reset_count, int)
    generator = pipe.generator.get_state()
    pipe.restore(path)
    _assert_equal_trees(pipe.state, want)
    assert torch.equal(pipe.generator.get_state(), generator)

    ours = str(tmp_path / "port.npz")
    pipe.save(ours)
    with np.load(path) as a, np.load(ours) as b:
        assert set(a.files) - {".swarm/.key"} == set(b.files) - {"generator"}


def test_port_checkpoint_round_trips_generator(tmp_path):
    """``save`` writes the generator's state under its own key; ``restore``
    sets it, so the next draws are the saved pipeline's."""
    path = str(tmp_path / "state.npz")
    pipe = AwpuPipeline(CFGS["realtime"], seed=7, device="cpu")
    pipe.process_block(_blocks(pipe.points, 1)[0])
    pipe.save(path)
    with np.load(path) as data:
        np.testing.assert_array_equal(data[AwpuPipeline.GENERATOR_KEY],
                                      pipe.generator.get_state().numpy())
    other = AwpuPipeline(CFGS["realtime"], seed=8, device="cpu")
    other.restore(path)
    assert torch.equal(other.generator.get_state(), pipe.generator.get_state())
    assert torch.equal(torch.rand(5, generator=other.generator),
                       torch.rand(5, generator=pipe.generator))


def _history(dead=21, hot=70, seed=0):
    """A full ring [256, 1024] of a noisy plane wave on four 8x8 arrays,
    with one dead channel and one hot one."""
    from beamforming_lk_tpu_torch.ops import antenna as ant

    pts = ant.multi_array_cluster(256)
    h = plane_wave_block(pts, [SRC], 0, 1024, noise_std=0.3,
                         rng=np.random.default_rng(seed))
    h[dead] = 0.0
    h[hot] *= 200.0
    return h


def test_calibrate_matches_jax_leaf_for_leaf():
    """The port's ``calibrate`` on a given history equals the JAX package's
    leaf for leaf (rtol 1e-6), the off-by-one median included, and masks
    the dead and hot channels."""
    hist = _history()
    got = tcal.calibrate(torch.as_tensor(hist))
    want = jcal.calibrate(hist)
    for field in dataclasses.fields(want):
        np.testing.assert_allclose(getattr(got, field.name).numpy(),
                                   np.asarray(getattr(want, field.name)),
                                   rtol=1e-6, atol=0, err_msg=field.name)
    assert int(got.usable) == int(want.usable) == 254
    assert got.mask[21] == 0.0 and got.mask[70] == 0.0
    with pytest.raises(ValueError, match="divisible"):
        tcal.calibrate(torch.zeros((65, 8)))


def test_auto_calibration_masks_dead_channel():
    """Startup auto-calibration: a dead mic is found from the first blocks
    and masked out of the rebuilt step, which keeps the fft heatmap with
    its rank-1 correction; the heatmap peak stays on the source; the result
    equals the JAX package's ``calibrate`` of the same history."""
    cfg = tcfg.Config(mimo=tcfg.MimoConfig(rows=16, columns=16, backend="fft"),
                      tracker=tcfg.TrackerConfig(iterations=1))
    pipe = AwpuPipeline(cfg, seed=2, enable_tracker=False, enable_miso=False,
                        device="cpu")
    blocks = _blocks(pipe.points, 4)
    blocks[:, 21] = 0.0
    result = pipe.calibrate(blocks)
    mask = result.mask.numpy()
    assert mask[21] == 0.0 and mask.sum() >= 60
    want = jcal.calibrate(pipe.state.history.numpy())
    np.testing.assert_allclose(result.power.numpy(), np.asarray(want.power),
                               rtol=1e-6)
    np.testing.assert_array_equal(mask, np.asarray(want.mask))
    np.testing.assert_array_equal(pipe.channel_mask, mask)
    model = pipe.step.fft_model
    assert model is not None and model.dead_chan.tolist() == [21]
    assert pipe.state.block_index == 4
    out = pipe.process_block(_blocks(pipe.points, 1, start=4)[0])
    theta, phi = make_mimo_grid(cfg.mimo)
    d = int(torch.argmax(out.powers))
    assert float(spherical_angle(torch.tensor(float(theta[d])),
                                 torch.tensor(float(phi[d])),
                                 torch.tensor(SRC[0]), torch.tensor(SRC[1]))) < np.radians(10)


def test_calibrate_apply_gains_takes_dense_fallback():
    """``apply_gains`` folds ``sqrt(gains)`` into the mask: a gain mask, so
    the realtime pipeline falls back to the dense heatmap and keeps its
    state and its tracker."""
    pipe = AwpuPipeline(CFGS["realtime"], seed=3, device="cpu")
    assert pipe.step.fft_model is not None
    blocks = _blocks(pipe.points, 4)
    blocks[:, 9] = 0.0
    result = pipe.calibrate(blocks, apply_gains=True)
    np.testing.assert_allclose(
        pipe.channel_mask,
        result.mask.numpy() * np.sqrt(result.gains.numpy()), rtol=1e-6)
    assert pipe.channel_mask[9] == 0.0
    assert pipe.step.fft_model is None and pipe.step.mimo_model is not None
    assert pipe.step.swarm_step is not None and pipe.state.block_index == 4
    out = pipe.process_block(_blocks(pipe.points, 1, start=4)[0])
    assert torch.isfinite(out.powers).all() and out.powers.max() > 0
