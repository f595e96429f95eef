"""The slice as a whole: the port's AwpuPipeline against the JAX package's,
both in the realtime profile (fft heatmap every 3rd block, 2 iterations,
probe_kernel "pallas" — interpret mode on the JAX side, the twin here) at
a small size, with the JAX package's own random draws injected."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

import beamforming_lk_tpu.config as jcfg  # noqa: E402
from beamforming_lk_tpu.app import AwpuPipeline as JaxPipeline  # noqa: E402
from beamforming_lk_tpu.models import tracker as jtk  # noqa: E402
from beamforming_lk_tpu_torch import config as tcfg  # noqa: E402
from beamforming_lk_tpu_torch.app import AwpuPipeline  # noqa: E402
from beamforming_lk_tpu_torch.convert import awpu_state_from_jax  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402

SRC = (0.5, 1.2, 5000.0)
N_BLOCKS = 9
PTS = ant.create_antenna_grid(8, 8, 0.02)


def _configs(compute):
    """(JAX config, port config) with the same fields: the realtime profile
    at 16x16 pixels, 4 trackers and 8 seekers, in ``compute``."""
    made = []
    for m in (jcfg, tcfg):
        made.append(m.Config(
            dsp=m.DspConfig(compute=compute, probe_compute=compute),
            mimo=m.MimoConfig(rows=16, columns=16, backend="fft",
                              heatmap_every=3),
            tracker=m.TrackerConfig(n_seekers=8, n_trackers=4, iterations=2,
                                    probe_kernel="pallas"),
        ))
    for part in ("array", "dsp", "mimo", "tracker"):
        assert (dataclasses.asdict(getattr(made[0], part))
                == dataclasses.asdict(getattr(made[1], part)))
    return made


def _draws(key, tc):
    """The JAX fused step's draws for one block (models/tracker.py:771-786):
    split for the seeker-reset directions, then one batched jump draw."""
    key, sub = jax.random.split(key)
    r_th, r_ph = jtk._random_directions(sub, tc.n_seekers, tc.theta_limit)
    _, jts, jps = jtk._swarm_jumps(key, tc.iterations, tc.n_seekers,
                                   tc.theta_limit / 2.0)
    return tuple(np.asarray(x) for x in (r_th, r_ph, jts, jps))


def _blocks():
    return [plane_wave_block(PTS, [SRC], i * 256, 256, noise_std=0.02,
                             rng=np.random.default_rng(100 + i))
            for i in range(N_BLOCKS)]


def _jax_run(compute):
    jc, _ = _configs(compute)
    pipe = JaxPipeline(jc, points=PTS, seed=3)
    states, draws, outs = [], [], []
    for blk in _blocks():
        states.append(jax.tree.map(np.asarray, pipe.state))
        draws.append(_draws(pipe.state.swarm.key, jc.tracker))
        outs.append(jax.tree.map(np.asarray, pipe.process_block(blk)))
    return states, draws, outs, pipe


@pytest.fixture(scope="module")
def jax_f32():
    return _jax_run("float32")


def _angle(t1, p1, t2, p2):
    u = lambda t, p: np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p),  # noqa: E731
                               np.cos(t)])
    return np.linalg.norm(u(t1, p1) - u(t2, p2), axis=0).max()


def _port_from(jax_run, start, compute="float32"):
    """The port's pipeline started from the JAX state before block
    ``start``, fed the same blocks and draws; per-block outputs."""
    states, draws = jax_run[:2]
    _, tc = _configs(compute)
    pipe = AwpuPipeline(tc, points=PTS, seed=0, device="cpu")
    pipe.state = awpu_state_from_jax(states[start], device="cpu")
    blocks = _blocks()
    outs = [pipe.process_block(blocks[i], draws=draws[i])
            for i in range(start, N_BLOCKS)]
    return pipe, outs


@pytest.mark.parametrize("start", [0, 3])
def test_slice_matches_jax_pipeline(jax_f32, start):
    """Per block: heatmap powers within 1e-4 of the peak, equal target
    flags, tracker directions within 2e-3 rad, MISO beam within 1e-5 of its
    peak.  ``start=3`` begins from the JAX state converted after 3 blocks."""
    jouts = jax_f32[2]
    pipe, outs = _port_from(jax_f32, start)
    for i, out in enumerate(outs, start):
        want = jouts[i]
        got_p = out.powers.numpy()
        assert np.abs(got_p - want.powers).max() <= 1e-4 * np.abs(want.powers).max(), i
        np.testing.assert_array_equal(out.targets.valid.numpy(), want.targets.valid)
        np.testing.assert_array_equal(out.targets.start.numpy(), want.targets.start)
        assert _angle(out.targets.theta.numpy(), out.targets.phi.numpy(),
                      want.targets.theta, want.targets.phi) < 2e-3, i
        beam = out.miso_beam.numpy()
        assert np.abs(beam - want.miso_beam).max() <= 1e-5 * np.abs(want.miso_beam).max(), i
        np.testing.assert_allclose(float(out.prev_max), float(want.prev_max), rtol=1e-4)
    assert want.targets.valid.any(), "the reference never published a target"
    assert pipe.state.block_index == N_BLOCKS
    assert pipe.heatmap().shape == (16, 16)
    tgts = pipe.targets()
    assert tgts and all(set(t) == {"theta", "phi", "power", "probability", "start"}
                        for t in tgts)


def test_bf16_profile_locks_like_jax():
    """bf16 trajectories may drift apart (bf16 weight rounding is
    discontinuous), so the bf16 profile is held functionally: both lock on
    the source, within 0.05 rad of each other."""
    jax_run = _jax_run("bfloat16")
    pipe, _ = _port_from(jax_run, 0, "bfloat16")
    got, want = pipe.targets(), jax_run[3].targets()
    assert got and want
    best = [max(t, key=lambda x: x["power"]) for t in (got, want)]
    assert abs(best[0]["theta"] - best[1]["theta"]) < 0.05
    assert abs(best[0]["phi"] - best[1]["phi"]) < 0.05
    assert abs(best[0]["theta"] - SRC[0]) < 0.05 and abs(best[0]["phi"] - SRC[1]) < 0.05


def test_process_blocks_stacks_per_block_outputs():
    _, tc = _configs("float32")
    a = AwpuPipeline(tc, points=PTS, seed=1, device="cpu")
    b = AwpuPipeline(tc, points=PTS, seed=1, device="cpu")
    blocks = np.stack(_blocks()[:4])
    stacked = a.process_blocks(blocks)
    for i, blk in enumerate(blocks):
        out = b.process_block(blk)
        np.testing.assert_array_equal(stacked.powers[i].numpy(), out.powers.numpy())
        np.testing.assert_array_equal(stacked.miso_beam[i].numpy(),
                                      out.miso_beam.numpy())
        np.testing.assert_array_equal(stacked.targets.valid[i].numpy(),
                                      out.targets.valid.numpy())
