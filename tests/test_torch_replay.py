"""The chunked replay path: ``AwpuPipeline.process_blocks``.

- against the JAX package's ``process_blocks`` (its ``_fused_chunk_scan``,
  Pallas in interpret mode) with the JAX key schedule's draws injected;
- against the port's own per-block processing from the same seed, in the
  chunked case and in the two cases routed block by block;
- the heatmap-only replay against the JAX package's ``_chunk_scan``."""

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
from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk  # noqa: E402

SRC = (0.5, 1.2, 5000.0)
PTS = ant.create_antenna_grid(8, 8, 0.02)


def _configs(fused_chunk=6, heatmap_every=3, heatmap_chunk=0, reset=128):
    """(JAX config, port config) with the same fields: f32, a 12x12 fft
    heatmap, 4 trackers and 8 seekers, 2 iterations of 3 sub-steps."""
    made = []
    for m in (jcfg, tcfg):
        made.append(m.Config(
            dsp=m.DspConfig(fused_chunk=fused_chunk),
            mimo=m.MimoConfig(rows=12, columns=12, backend="fft",
                              heatmap_every=heatmap_every,
                              heatmap_chunk=heatmap_chunk),
            tracker=m.TrackerConfig(n_seekers=8, n_trackers=4, iterations=2,
                                    tracker_steps=3, probe_kernel="pallas",
                                    seeker_reset_interval=reset),
        ))
    for part in ("array", "dsp", "mimo", "tracker"):
        assert (dataclasses.asdict(getattr(made[0], part))
                == dataclasses.asdict(getattr(made[1], part)))
    return made


def _blocks(n, seed=200):
    return np.stack([plane_wave_block(PTS, [SRC], i * 256, 256, noise_std=0.02,
                                      rng=np.random.default_rng(seed + i))
                     for i in range(n)])


def _jax_key_draws(key, tc, n):
    """The draws of n blocks of the JAX fused step's key schedule, stacked
    on a leading block axis (as process_blocks takes them)."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        r_th, r_ph = jtk._random_directions(sub, tc.n_seekers, tc.theta_limit)
        key, jts, jps = jtk._swarm_jumps(key, tc.iterations, tc.n_seekers,
                                         tc.theta_limit / 2.0)
        out.append(tuple(np.asarray(x) for x in (r_th, r_ph, jts, jps)))
    return tuple(np.stack(f) for f in zip(*out))


def _angle(t1, p1, t2, p2):
    u = lambda t, p: np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p),  # noqa: E731
                               np.cos(t)])
    return np.linalg.norm(u(t1, p1) - u(t2, p2), axis=0).max()


def _count_chunks(monkeypatch):
    calls = []
    real = ctk.swarm_chunk

    def counting(*args, **kwargs):
        calls.append(args[1].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(ctk, "swarm_chunk", counting)
    return calls


def _assert_blocks_match(got, want, powers_tol, dir_tol, rtol):
    """Per block: powers within ``powers_tol`` of the peak, prev_max within
    ``rtol``, equal target flags and starts, target directions within
    ``dir_tol`` rad, MISO beams within 1e-5 of their peak."""
    for i in range(want.powers.shape[0]):
        wp = np.asarray(want.powers[i])
        assert np.abs(np.asarray(got.powers[i]) - wp).max() <= powers_tol * np.abs(wp).max(), i
        np.testing.assert_allclose(float(got.prev_max[i]), float(want.prev_max[i]),
                                   rtol=rtol)
        np.testing.assert_array_equal(np.asarray(got.targets.valid[i]),
                                      np.asarray(want.targets.valid[i]))
        np.testing.assert_array_equal(np.asarray(got.targets.start[i]),
                                      np.asarray(want.targets.start[i]))
        assert _angle(np.asarray(got.targets.theta[i]), np.asarray(got.targets.phi[i]),
                      np.asarray(want.targets.theta[i]),
                      np.asarray(want.targets.phi[i])) < dir_tol, i
        wb = np.asarray(want.miso_beam[i])
        assert np.abs(np.asarray(got.miso_beam[i]) - wb).max() <= 1e-5 * np.abs(wb).max(), i


def test_process_blocks_matches_jax_fused_chunk(monkeypatch):
    """12 blocks in chunks of 6 with a heatmap every 3rd block: per block,
    powers within 1e-4 of the peak, prev_max within rtol 1e-4, equal flags,
    directions within 2e-3 rad, beams within 1e-5 of their peak."""
    jc, tc = _configs(reset=4)
    jpipe = JaxPipeline(jc, points=PTS, seed=3)
    draws = _jax_key_draws(jpipe.state.swarm.key, jc.tracker, 12)
    pipe = AwpuPipeline(tc, points=PTS, device="cpu")
    pipe.state = awpu_state_from_jax(jax.tree.map(np.asarray, jpipe.state),
                                     device="cpu")
    blocks = _blocks(12)
    want = jax.tree.map(np.asarray, jpipe.process_blocks(blocks))
    calls = _count_chunks(monkeypatch)
    got = pipe.process_blocks(blocks, draws=draws)
    assert calls == [6, 6]
    _assert_blocks_match(got, want, 1e-4, 2e-3, 1e-4)
    assert want.targets.valid[-1].any(), "the reference never published a target"
    assert pipe.state.block_index == 12
    np.testing.assert_array_equal(pipe.state.swarm.tracking.numpy(),
                                  np.asarray(jpipe.state.swarm.tracking))


@pytest.mark.parametrize("lead,n,chunked", [
    (0, 12, True),      # whole chunks from an aligned start
    (1, 12, False),     # block_index % heatmap_every != 0: block by block
    (0, 9, False),      # M % fused_chunk != 0: block by block
])
def test_chunked_replay_matches_per_block(monkeypatch, lead, n, chunked):
    """process_blocks against process_block from the same seed (resets
    every 4th block, so mid-chunk): equal flags and starts, directions
    within 1e-5 rad, powers within 1e-5 of the peak."""
    _, tc = _configs(reset=4)
    a, b = (AwpuPipeline(tc, points=PTS, seed=2, device="cpu")
            for _ in range(2))
    blocks = _blocks(lead + n)
    for blk in blocks[:lead]:
        a.process_block(blk)
        b.process_block(blk)
    per_block = [b.process_block(blk) for blk in blocks[lead:]]
    want = type(per_block[0])(
        powers=torch.stack([o.powers for o in per_block]),
        targets=type(per_block[0].targets)(*(torch.stack(f) for f in zip(
            *(o.targets for o in per_block)))),
        miso_beam=torch.stack([o.miso_beam for o in per_block]),
        prev_max=torch.stack([o.prev_max for o in per_block]),
    )
    calls = _count_chunks(monkeypatch)
    got = a.process_blocks(blocks[lead:])
    assert calls == ([6] * (n // 6) if chunked else [])
    _assert_blocks_match(got, want, 1e-5, 1e-5, 1e-5)
    assert a.state.block_index == b.state.block_index == lead + n
    np.testing.assert_array_equal(a.state.history.numpy(), b.state.history.numpy())
    np.testing.assert_array_equal(a.last.targets.valid.numpy(),
                                  b.last.targets.valid.numpy())
    assert torch.equal(torch.rand(4, generator=a.generator),
                       torch.rand(4, generator=b.generator))


def test_heatmap_only_replay_matches_jax_chunk_scan():
    """Tracker and MISO off, 8 blocks in chunks of 4 (a map every block, as
    the JAX package's _chunk_scan computes them): powers within 1e-4 of the
    peak, prev_max within rtol 1e-4, zero targets and beams."""
    jc, tc = _configs(fused_chunk=0, heatmap_every=1, heatmap_chunk=4)
    kw = dict(points=PTS, enable_tracker=False, enable_miso=False)
    jpipe = JaxPipeline(jc, seed=3, **kw)
    pipe = AwpuPipeline(tc, device="cpu", **kw)
    pipe.state = awpu_state_from_jax(jax.tree.map(np.asarray, jpipe.state),
                                     device="cpu")
    assert pipe.step.chunk == 4
    blocks = _blocks(8)
    want = jax.tree.map(np.asarray, jpipe.process_blocks(blocks))
    got = pipe.process_blocks(blocks)
    for i in range(8):
        assert np.abs(got.powers[i].numpy() - want.powers[i]).max() <= (
            1e-4 * np.abs(want.powers[i]).max()), i
    np.testing.assert_allclose(got.prev_max.numpy(), want.prev_max, rtol=1e-4)
    assert not got.targets.valid.any() and not got.miso_beam.any()
    assert got.miso_beam.shape == (8, 256) and got.targets.valid.shape == (8, 4)
    assert pipe.state.block_index == 8


def test_heatmap_only_replay_keeps_the_decimation():
    """With a map every 3rd block the heatmap-only replay (chunks of 6)
    gives the per-block outputs: maps carried between decimated blocks."""
    _, tc = _configs(fused_chunk=0, heatmap_every=3, heatmap_chunk=6)
    kw = dict(points=PTS, enable_tracker=False, enable_miso=False,
              device="cpu")
    a, b = AwpuPipeline(tc, **kw), AwpuPipeline(tc, **kw)
    assert a.step.chunk == 6
    blocks = _blocks(12)
    got = a.process_blocks(blocks)
    for i, blk in enumerate(blocks):
        want = b.process_block(blk)
        assert torch.allclose(got.powers[i], want.powers, rtol=0,
                              atol=1e-5 * float(want.powers.abs().max())), i
        np.testing.assert_allclose(float(got.prev_max[i]), float(want.prev_max),
                                   rtol=1e-5)
    assert torch.equal(got.powers[1], got.powers[0])
