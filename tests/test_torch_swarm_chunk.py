"""The chunk kernel's plain twin and the port's chunked fused step.

- ``swarm_chunk_reference`` against the JAX package's Pallas chunk kernel
  (``swarm_chunk_pallas``, interpret mode) on identical numpy operands;
- the port's ``FusedChunkStep`` against K calls of its ``FusedSwarmStep``
  from the same generator seed (the draw order);
- the port's chunk step against the JAX ``make_fused_chunk_impl`` with the
  JAX key schedule's draws injected.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against this twin there."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import beamforming_lk_tpu.config as jcfg  # noqa: E402
from beamforming_lk_tpu.io import ring as jrg  # noqa: E402
from beamforming_lk_tpu.models import miso as jms  # noqa: E402
from beamforming_lk_tpu.models import tracker as jtk  # noqa: E402
from beamforming_lk_tpu.ops import pallas_tracker as ptk  # noqa: E402
from beamforming_lk_tpu_torch import config as tcfg  # noqa: E402
from beamforming_lk_tpu_torch.convert import swarm_state_from_jax  # noqa: E402
from beamforming_lk_tpu_torch.io import ring as rg  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.models import miso as ms  # noqa: E402
from beamforming_lk_tpu_torch.models import tracker as tk  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402
from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk  # noqa: E402
from beamforming_lk_tpu_torch.ops import delay as dl  # noqa: E402

NT, NS = 4, 8
P = NT + 1 + NS          # trackers | listener | seekers
T = 256
K = 4
SRC = (0.5, 1.2, 5000.0)
SPM = 48828.0 / 340.0
PTS = ant.create_antenna_grid(8, 8, 0.02)


def _angle(t1, p1, t2, p2):
    """Largest great-circle chord between paired directions (~ the angle)."""
    u = lambda t, p: np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p),  # noqa: E731
                               np.cos(t)])
    return np.linalg.norm(u(t1, p1) - u(t2, p2), axis=0).max()


def _chunk_operands(interp, n_iter, seed=0):
    """K consecutive compact windows of a plane wave and the chunk's
    operands, seeded so merge, jump and promote fire: two coincident
    tracking trackers, a published target on seeker 0, free trackers; the
    seeker reset fires before block 2 (mid-chunk)."""
    rng = np.random.default_rng(seed)
    taps = dl.LINEAR_TAPS if interp == "linear" else 8
    span = dl.probe_span(PTS, SPM, taps, 64)
    stream = plane_wave_block(PTS, [SRC], 0, span + K * T, noise_std=0.02,
                              rng=rng)
    pw = np.stack([stream[:, k * T:k * T + span + T] for k in range(K)])
    tc = tcfg.TrackerConfig(n_trackers=NT, n_seekers=NS)
    rows = np.zeros((len(ctk.ROW_FIELDS), P), np.float32)
    rows[0] = rng.uniform(0.1, 1.3, P)
    rows[1] = rng.uniform(0.0, 2 * np.pi, P)
    rows[0, :2], rows[1, :2] = (0.52, 0.53), (1.2, 1.21)
    rows[0, NT], rows[1, NT] = 0.45, 1.1
    rows[6, :2] = 1.0
    rows[7, :2] = (1.0, 2.0)
    rate = tc.tracker_step_gain * tc.tracker_spread
    rows[8] = [rate] * NT + [rate / 3] + [tc.seeker_step_gain * tc.seeker_spread] * NS
    rows[9] = [tc.tracker_spread] * (NT + 1) + [tc.seeker_spread] * NS
    rows[10, :NT], rows[11, NT + 1:], rows[12, NT] = 1.0, 1.0, 1.0
    rows[13, 0], rows[14, 0], rows[15, 0] = rows[0, NT + 1], rows[1, NT + 1], 1.0
    jumps = np.zeros((K, 2, n_iter, P), np.float32)
    jumps[..., NT + 1:] = rng.uniform(-1, 1, (K, 2, n_iter, NS)) * tc.theta_limit / 2
    flags = np.array([k == 2 for k in range(K)], np.float32)
    resets = np.zeros((K, 3, P), np.float32)
    resets[:, 0] = flags[:, None]
    resets[:, 1, NT + 1:] = rng.uniform(0, tc.theta_limit, (K, NS))
    resets[:, 2, NT + 1:] = rng.uniform(0, 2 * np.pi, (K, NS))
    raw0 = pw[:, 0, span - taps:span - taps + T].astype(np.float32)
    bp0 = 0.5 * raw0[:, 1:-1] - 0.25 * (raw0[:, 2:] + raw0[:, :-2])
    references = (np.sum(bp0 * bp0, axis=1) / np.float32(T - 2)).astype(np.float32)
    kw = dict(n_trackers=NT, span=span, taps=taps, theta_limit=tc.theta_limit,
              divisor=float(T), closeness=tc.tracker_closeness,
              error_threshold=tc.error_threshold, interp=interp,
              min_power_fraction=tc.min_power_fraction)
    return pw, rows, jumps, resets, references, kw


@pytest.mark.parametrize("probe_layout,interp", [
    ("quadrant", "linear"),
    ("horizontal", "fir"),
])
def test_chunk_twin_matches_pallas_chunk_kernel(probe_layout, interp):
    """Per block: tracking flags and start stamps equal, published rows
    (trackers and listener) within 1e-5 rad, MISO beams within 1e-5 of
    their peak.  Seekers, and the mean seeker power, are held within 1e-3
    (rad, relative): over several blocks a
    seeker at the field-of-view edge, where its probe ring is clipped,
    amplifies f32 rounding (up to 3e-4 rad here; the JAX package's own
    chunk-vs-per-block test holds seeker phi at 1e-4)."""
    n_iter, n_sub = 2, 3
    pw, rows, jumps, resets, refs, kw = _chunk_operands(interp, n_iter)
    kw = dict(kw, n_iter=n_iter, n_sub=n_sub, refine=3, fir_phases=101,
              probe_layout=probe_layout)
    span = kw["span"]
    wins = [jnp.asarray(w) for w in pw]
    jout = ptk.swarm_chunk_pallas(
        ptk.pack_geometry(PTS, SPM),
        jnp.stack([ptk.bandpass_smaj_window(w, span) for w in wins]),
        jnp.stack([ptk.smaj_window(w, span) for w in wins]),
        rows[0], rows[1], rows[8], rows[9], tuple(rows[2:6]), rows[10:13],
        rows[6], rows[7], rows[13:16], jumps[:, 0], jumps[:, 1],
        resets[:, 0, 0], resets[:, 1], resets[:, 2], 5, refs,
        n_blocks=K, interpret=True, **kw,
    )
    jout = [np.asarray(x) for x in jout]
    pw_t = torch.as_tensor(pw)
    state, mean, beams = ctk.swarm_chunk(
        ctk.pack_geometry(PTS, SPM, device="cpu"), ctk.bandpass_window(pw_t), pw_t,
        torch.as_tensor(rows), torch.as_tensor(jumps), torch.as_tensor(resets),
        torch.as_tensor(refs), block_index0=5, **kw,
    )
    state, mean, beams = state.numpy(), mean.numpy(), beams.numpy()
    for k in range(K):
        np.testing.assert_array_equal(state[k, 6], jout[6][k], err_msg=str(k))
        np.testing.assert_array_equal(state[k, 7], jout[7][k], err_msg=str(k))
        pub, seek = slice(0, NT + 1), slice(NT + 1, None)
        assert _angle(state[k, 0, pub], state[k, 1, pub],
                      jout[0][k, pub], jout[1][k, pub]) < 1e-5, k
        assert _angle(state[k, 0, seek], state[k, 1, seek],
                      jout[0][k, seek], jout[1][k, seek]) < 1e-3, k
        want = jout[9][k, :T]
        assert np.abs(beams[k] - want).max() <= 1e-5 * np.abs(want).max(), k
    np.testing.assert_allclose(mean, jout[8], rtol=1e-3)  # follows the seekers
    # The boundary logic fired on the reference side: the younger of the
    # two coincident trackers merged away and a free tracker was promoted.
    assert not (jout[6][0, 0] > 0.5 and jout[6][0, 1] > 0.5)
    assert (jout[7][:, 2:NT] >= 5.0).any(), "promote never fired"


def _tracker_cfg(interp="linear"):
    return tcfg.TrackerConfig(n_seekers=NS, n_trackers=NT, iterations=2,
                              tracker_steps=3, probe_kernel="pallas",
                              seeker_reset_interval=3)


def _windows(n, taps, seed=70):
    """Per-block windows [C, T+S] of n plane-wave blocks through the ring."""
    dsp = tcfg.DspConfig()
    hist = rg.ring_init(64, dsp.history, device="cpu")
    out = []
    for i in range(n):
        blk = plane_wave_block(PTS, [SRC], i * T, T, noise_std=0.01,
                               rng=np.random.default_rng(seed + i))
        hist = rg.ring_push(hist, torch.as_tensor(blk))
        out.append(rg.ring_window(hist, T, dsp.shift_range, taps))
    return out


def _steps(interp):
    dsp = tcfg.DspConfig(interp=interp)
    cfg = _tracker_cfg()
    taps = dl.LINEAR_TAPS if interp == "linear" else dsp.fir_taps
    span = dl.probe_span(PTS, SPM, taps, dsp.shift_range)
    args = (cfg, dsp, tcfg.ArrayConfig(), PTS)
    return (cfg, dsp, taps,
            tk.make_fused_step_impl(*args, probe_span=span, device="cpu"),
            tk.make_fused_chunk_impl(*args, probe_span=span, device="cpu"))


@pytest.mark.parametrize("interp", ["linear", "fir"])
def test_fused_chunk_step_matches_per_block_steps(interp):
    """From the same generator seed, one chunk of 6 blocks (resets before
    blocks 0 and 3) and 6 per-block steps follow the same trajectory: the
    chunk consumes the generator in the per-block order."""
    cfg, _, taps, fused, chunk = _steps(interp)
    wins = _windows(6, taps)
    gens = [torch.Generator().manual_seed(9) for _ in range(2)]
    states = [tk.swarm_init(cfg, g, device="cpu") for g in gens]
    misos = [ms.miso_init(0.4, 1.0, device="cpu").particle for _ in range(2)]
    per_block = []
    for i, w in enumerate(wins):
        states[0], tg, misos[0], beam = fused(states[0], misos[0], w, i,
                                              generator=gens[0])
        per_block.append((tg, beam))
    states[1], tg_k, misos[1], beams = chunk(
        states[1], misos[1], torch.stack(wins), 0, generator=gens[1]
    )
    for i, (tg, beam) in enumerate(per_block):
        for f in tk.Targets._fields:
            np.testing.assert_array_equal(getattr(tg_k, f)[i].numpy(),
                                          getattr(tg, f).numpy(), err_msg=f"{f} {i}")
        np.testing.assert_array_equal(beams[i].numpy(), beam.numpy())
    a, b = states
    for f in tk.Particles._fields:
        np.testing.assert_array_equal(getattr(b.seekers, f).numpy(),
                                      getattr(a.seekers, f).numpy())
    np.testing.assert_array_equal(misos[1].theta.numpy(), misos[0].theta.numpy())
    assert b.reset_count == a.reset_count == 6
    # Both generators are at the same place afterwards.
    assert torch.equal(torch.rand(4, generator=gens[0]),
                       torch.rand(4, generator=gens[1]))
    assert tg_k.valid.any(), "no target was published"


def _jax_key_draws(key, tc, n):
    """The draws of n blocks of the JAX fused step's key schedule
    (make_fused_chunk_impl's keygen): split for the reset directions, then
    one batched jump draw; stacked on a leading block axis."""
    out = []
    for _ in range(n):
        key, sub = jax.random.split(key)
        r_th, r_ph = jtk._random_directions(sub, tc.n_seekers, tc.theta_limit)
        key, jts, jps = jtk._swarm_jumps(key, tc.iterations, tc.n_seekers,
                                         tc.theta_limit / 2.0)
        out.append(tuple(np.asarray(x) for x in (r_th, r_ph, jts, jps)))
    return tuple(np.stack(f) for f in zip(*out))


def test_chunk_step_matches_jax_fused_chunk_impl():
    """The port's chunk step against the JAX chunk step (interpret mode) on
    the same windows and state, with the JAX key schedule's draws: per
    block equal flags and starts, directions within 1e-4 rad, MISO beams
    within 1e-5 of their peak."""
    cfg, dsp, taps, _, chunk = _steps("linear")
    jc = jcfg.TrackerConfig(**{f: getattr(cfg, f) for f in
                               cfg.__dataclass_fields__})
    span = dl.probe_span(PTS, SPM, taps, dsp.shift_range)
    jchunk = jtk.make_fused_chunk_impl(jc, jcfg.DspConfig(), jcfg.ArrayConfig(),
                                       probe_span=span, n_blocks=K)
    jstate = jtk.swarm_init(jc, jax.random.PRNGKey(4))
    jmiso = jms.miso_init(0.4, 1.0).particle
    hist = jrg.ring_init(64, dsp.history)
    wins = []
    for i in range(K):
        blk = plane_wave_block(PTS, [SRC], i * T, T, noise_std=0.01,
                               rng=np.random.default_rng(40 + i))
        hist = jrg.ring_push(hist, jnp.asarray(blk))
        wins.append(np.asarray(jrg.ring_window(hist, T, dsp.shift_range, taps)))
    draws = _jax_key_draws(jstate.key, jc, K)
    state = swarm_state_from_jax(jax.tree.map(np.asarray, jstate), device="cpu")
    _, jtg, _, jbeams = jchunk(jstate, jmiso, jnp.asarray(np.stack(wins)),
                               jnp.int32(0), jnp.asarray(PTS), None)
    miso = ms.miso_init(0.4, 1.0, device="cpu").particle
    _, tg, _, beams = chunk(state, miso, torch.as_tensor(np.stack(wins)), 0,
                            draws=draws)
    jtg = jax.tree.map(np.asarray, jtg)
    jbeams = np.asarray(jbeams)
    np.testing.assert_array_equal(tg.valid.numpy(), jtg.valid)
    np.testing.assert_array_equal(tg.start.numpy(), jtg.start)
    for k in range(K):
        assert _angle(tg.theta[k].numpy(), tg.phi[k].numpy(),
                      jtg.theta[k], jtg.phi[k]) < 1e-4, k
        assert np.abs(beams[k].numpy() - jbeams[k]).max() <= (
            1e-5 * np.abs(jbeams[k]).max()), k
    assert jtg.valid.any(), "the reference never published a target"
