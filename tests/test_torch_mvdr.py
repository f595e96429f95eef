"""The port's MVDR (Capon) estimator (``models/mvdr.py``) against the JAX
package's on the CPU: the helpers bitwise, one and 8 chained steps, a mask,
the decimated solve, ``scan``, the NaN rule; the JAX package's own MVDR
cases on the port; and ``AwpuPipeline(heatmap_mode="mvdr")`` against the
JAX pipeline, live and replayed, with the converters starting both from
one mid-run state.

Tolerances.  The covariance planes are sums of products of the same f32
snapshots in another summation order: 1e-5 relative, 1e-6 of the largest
entry absolute.  The Capon powers go through a Cholesky and a triangular
solve whose conditioning the diagonal loading bounds (1e-3 of the mean
channel power: a condition number up to ~1e3-1e4), so rounding of ~6e-8
grows to ~1e-4: they are held within 2e-3 relative, and the strongest
direction must be the same cell.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from beamforming_lk_tpu import config as jcfg  # noqa: E402
from beamforming_lk_tpu.app import AwpuPipeline as JaxPipeline  # noqa: E402
from beamforming_lk_tpu.models import mvdr as jmv  # noqa: E402
from beamforming_lk_tpu_torch import config as tcfg  # noqa: E402
from beamforming_lk_tpu_torch import convert  # noqa: E402
from beamforming_lk_tpu_torch.app import AwpuPipeline  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.models import mvdr as mv  # noqa: E402
from beamforming_lk_tpu_torch.models.mimo import make_mimo_grid  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402
from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk  # noqa: E402

ACFG = tcfg.ArrayConfig()
SRC = (0.5, 1.2, 4000.0)
PTS = {64: ant.create_antenna_grid(), 16: ant.create_antenna_grid(4, 4, 0.02)}
POWERS_RTOL = 2e-3


def _grid(n):
    return make_mimo_grid(tcfg.MimoConfig(rows=n, columns=n))


def _blocks(points, n, sources=(SRC,), noise=0.05, seed=0):
    rng = np.random.default_rng(seed)
    return [plane_wave_block(points, list(sources), b * 256, 256, ACFG,
                             noise_std=noise, rng=rng) for b in range(n)]


def _steps(points, grid=8, **kw):
    theta, phi = _grid(grid)
    jstep, n = jmv.make_mvdr_step(points, theta, phi, jcfg.ArrayConfig(), **kw)
    step, n2 = mv.make_mvdr_step(points, theta, phi, ACFG, device="cpu", **kw)
    assert n == n2 == step.n_bins
    return jstep, step


def _hold_powers(got, want, what=""):
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=POWERS_RTOL, err_msg=what)
    assert got.argmax() == want.argmax(), what


def _hold_cov(state, jstate):
    for got, want in ((state.cov_re, jstate.cov_re), (state.cov_im, jstate.cov_im)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    assert state.count == int(jstate.count)


def test_helpers_bitwise_equal_to_the_jax_package():
    bins = mv.select_bins(64, ACFG.sample_rate)
    np.testing.assert_array_equal(bins, jmv.select_bins(64, ACFG.sample_rate))
    np.testing.assert_array_equal(mv.select_bins(128, ACFG.sample_rate, 300, 4000),
                                  jmv.select_bins(128, ACFG.sample_rate, 300, 4000))
    np.testing.assert_array_equal(mv.dft_tables(64, bins), jmv.dft_tables(64, bins))
    theta, phi = _grid(8)
    freqs = np.fft.rfftfreq(64, 1.0 / ACFG.sample_rate)[bins]
    np.testing.assert_array_equal(
        mv.steering_matrix(PTS[64], theta, phi, freqs, ACFG),
        jmv.steering_matrix(PTS[64], theta, phi, freqs, jcfg.ArrayConfig()))


def test_hermitian_embed_and_stft_snapshots():
    rng = np.random.default_rng(4)
    re, im = rng.standard_normal((2, 3, 5, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        mv.hermitian_embed(torch.as_tensor(re), torch.as_tensor(im)).numpy(),
        np.asarray(jmv.hermitian_embed(jnp.asarray(re), jnp.asarray(im))))
    block = _blocks(PTS[64], 1)[0]
    mask = np.ones(64, np.float32)
    mask[7] = 0.0
    tab = mv.dft_tables(64, mv.select_bins(64, ACFG.sample_rate))
    for m in (None, mask):
        got = mv._stft_snapshots(torch.as_tensor(block), torch.as_tensor(tab), 64,
                                 32, None if m is None else torch.as_tensor(m))
        want = jmv._stft_snapshots(jnp.asarray(block), jnp.asarray(tab), 64, 32,
                                   None if m is None else jnp.asarray(m))
        assert got[2] == want[2] == 7
        for g, w in zip(got[:2], want[:2]):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max())


def test_real_embedding_matches_complex_capon():
    """``v^H R^-1 v`` through the port's real embedding equals the complex
    value (the JAX package's case, on the port's ``hermitian_embed``)."""
    rng = np.random.default_rng(7)
    c, d = 12, 9
    a = rng.standard_normal((c, c)) + 1j * rng.standard_normal((c, c))
    r = a @ a.conj().T + 0.5 * np.eye(c)
    v = rng.standard_normal((d, c)) + 1j * rng.standard_normal((d, c))
    want = np.einsum("dc,cd->d", v.conj(), np.linalg.solve(r, v.T)).real
    m = mv.hermitian_embed(torch.as_tensor(r.real), torch.as_tensor(r.imag)).numpy()
    v_emb = np.concatenate([v.real, v.imag], axis=-1)
    got = np.einsum("dc,cd->d", v_emb, np.linalg.solve(m, v_emb.T))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_dft_tables_match_rfft():
    rng = np.random.default_rng(3)
    bins = mv.select_bins(64, 48828.0)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    want = np.fft.rfft(x * np.hanning(64), axis=-1)[:, bins]
    tab = mv.dft_tables(64, bins)
    np.testing.assert_allclose((x @ tab[0]) - 1j * (x @ tab[1]), want,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("channels", [64, 16])
def test_chained_steps_match_jax(channels):
    """One step, then 8 chained steps from the same blocks: covariance,
    count and powers held against the JAX package's after every block."""
    jstep, step = _steps(PTS[channels])
    jstate, state = jmv.mvdr_init(step.n_bins, channels), step.init()
    assert state.count == 0 and state.powers is None
    for i, blk in enumerate(_blocks(PTS[channels], 8)):
        jstate, want = jstep(jstate, jnp.asarray(blk))
        state, got = step(state, torch.as_tensor(blk))
        _hold_cov(state, jstate)
        _hold_powers(got, want, f"block {i}")
    assert state.count == 8


def test_channel_mask_matches_jax():
    mask = np.ones(64, np.float32)
    mask[[5, 40]] = 0.0
    jstep, step = _steps(PTS[64], channel_mask=mask)
    jstate, state = jmv.mvdr_init(step.n_bins, 64), step.init()
    for blk in _blocks(PTS[64], 4):
        jstate, want = jstep(jstate, jnp.asarray(blk))
        state, got = step(state, torch.as_tensor(blk))
    _hold_cov(state, jstate)
    _hold_powers(got, want)
    assert not state.cov_re[:, 5].any() and not state.cov_im[:, :, 40].any()


def test_weight_refresh_blocks_equal_the_undecimated_step():
    """``weight_refresh=3``: the covariance equals the undecimated step's on
    every block, the powers on blocks 0, 3, 6 bitwise, and the blocks in
    between carry the last refresh's; against JAX's decimated step too."""
    jdec, dec = _steps(PTS[64], weight_refresh=3)
    _, full = _steps(PTS[64])
    s_dec, s_full, j_dec = dec.init(), full.init(), jdec.init()
    assert s_dec.powers.shape == (64,) and not s_dec.powers.any()
    last = None
    for b, blk in enumerate(_blocks(PTS[64], 7)):
        blk_t = torch.as_tensor(blk)
        s_dec, p_dec = dec(s_dec, blk_t)
        s_full, p_full = full(s_full, blk_t)
        j_dec, want = jdec(j_dec, jnp.asarray(blk))
        assert torch.equal(s_dec.cov_re, s_full.cov_re)
        if b % 3 == 0:
            assert torch.equal(p_dec, p_full)
            last = p_dec
        else:
            assert torch.equal(p_dec, last)
        assert torch.equal(s_dec.powers, p_dec)
        _hold_powers(p_dec, want, f"block {b}")


def test_weight_refresh_needs_a_state_with_powers():
    """The JAX package fails inside tracing on ``mvdr_init`` without
    ``n_directions``; the port raises a ValueError when called."""
    _, dec = _steps(PTS[64], weight_refresh=3)
    blk = torch.as_tensor(_blocks(PTS[64], 1)[0])
    with pytest.raises(ValueError, match="step.init"):
        dec(mv.mvdr_init(dec.n_bins, 64, device="cpu"), blk)
    state, _ = dec(mv.mvdr_init(dec.n_bins, 64, 64, device="cpu"), blk)
    assert state.count == 1


def test_scan_equals_stepwise():
    _, step = _steps(PTS[64], weight_refresh=2)
    blocks = np.stack(_blocks(PTS[64], 4))
    s1 = step.init()
    for blk in blocks:
        s1, p1 = step(s1, torch.as_tensor(blk))
    s2, ps = step.scan(step.init(), blocks)
    assert ps.shape == (4, 64) and torch.equal(ps[-1], p1)
    assert torch.equal(s2.cov_re, s1.cov_re) and s2.count == 4
    # n beyond the blocks cycles them.
    s3, ps3 = step.scan(step.init(), blocks[:2], n=4)
    assert ps3.shape == (4, 64) and s3.count == 4
    assert torch.equal(s3.cov_im, step.scan(step.init(), blocks[[0, 1, 0, 1]])[0].cov_im)


def test_non_definite_covariance_gives_nan_powers_as_jax():
    """A NaN sample, and a finite covariance that is not positive definite
    (negative, so the loading cannot rescue it), both give all-NaN powers
    in both packages; ``cholesky_ex`` alone would give a finite partial
    factor."""
    jstep, step = _steps(PTS[64])
    blk = _blocks(PTS[64], 1)[0]
    blk[3, 17] = np.nan
    _, want = jstep(jmv.mvdr_init(step.n_bins, 64), jnp.asarray(blk))
    _, got = step(step.init(), torch.as_tensor(blk))
    assert np.isnan(np.asarray(want)).all() and torch.isnan(got).all()
    neg = mv.MvdrState(-step.init().cov_re, step.init().cov_im, 1)
    jneg = jmv.MvdrState(jnp.asarray(neg.cov_re.numpy()),
                         jnp.asarray(neg.cov_im.numpy()), jnp.asarray(1, jnp.int32))
    zero = np.zeros((64, 256), np.float32)
    _, want = jstep(jneg, jnp.asarray(zero))
    _, got = step(neg, torch.as_tensor(zero))
    assert np.isnan(np.asarray(want)).all() and torch.isnan(got).all()


# The JAX package's own MVDR cases (tests/test_mvdr.py), on the port and
# on their inputs: every block's noise from a fresh default_rng(0).

def _ref_blocks(n, sources=(SRC,)):
    return [plane_wave_block(PTS[64], list(sources), b * 256, 256, ACFG,
                             noise_std=0.05) for b in range(n)]


def _run(sources, n_blocks=6, grid=16, **kw):
    theta, phi = _grid(grid)
    step, _ = mv.make_mvdr_step(PTS[64], theta, phi, ACFG, device="cpu", **kw)
    state = step.init()
    for blk in _ref_blocks(n_blocks, sources):
        state, powers = step(state, torch.as_tensor(blk))
    return powers.numpy(), theta, phi, state


def _angle(t1, p1, t2, p2):
    return np.arccos(np.clip(np.sin(t1) * np.sin(t2) * np.cos(p1 - p2)
                             + np.cos(t1) * np.cos(t2), -1.0, 1.0))


def test_single_source_peak():
    powers, theta, phi, state = _run([SRC])
    d = int(np.argmax(powers))
    assert _angle(theta[d], phi[d], SRC[0], SRC[1]) < np.radians(12)
    assert np.isfinite(powers).all() and state.count == 6


def test_two_sources_resolved():
    s1, s2 = (0.45, 0.8, 3500.0), (0.45, 0.8 + np.pi, 5200.0)
    powers, theta, phi, _ = _run([s1, s2], n_blocks=8)
    med = np.median(powers)
    for s in (s1, s2):
        assert powers[_angle(theta, phi, s[0], s[1]) < np.radians(10)].max() > 5 * med


def test_mask_zeroes_channels():
    src = (0.4, 1.0, 4000.0)
    mask = np.ones(64, np.float32)
    mask[5] = 0.0
    powers, theta, phi, _ = _run([src], n_blocks=4, grid=12, channel_mask=mask)
    d = int(np.argmax(powers))
    assert np.isfinite(powers).all()
    assert _angle(theta[d], phi[d], src[0], src[1]) < np.radians(15)


def test_weight_refresh_staleness_bound():
    theta, phi = _grid(12)
    full, _ = mv.make_mvdr_step(PTS[64], theta, phi, ACFG, device="cpu")
    dec, _ = mv.make_mvdr_step(PTS[64], theta, phi, ACFG, weight_refresh=4,
                               device="cpu")
    s_full, s_dec = full.init(), dec.init()
    for b, blk in enumerate(_ref_blocks(12)):
        s_full, a = full(s_full, torch.as_tensor(blk))
        s_dec, d = dec(s_dec, torch.as_tensor(blk))
        if b >= 4:
            assert int(a.argmax()) == int(d.argmax())
            assert float(((d - a).abs() / a.abs()).max()) < 0.25


# The pipeline.

CFG = {m: m.Config(mimo=m.MimoConfig(rows=8, columns=8)) for m in (jcfg, tcfg)}


def test_pipeline_matches_jax_block_by_block_and_through_scan():
    """``AwpuPipeline(heatmap_mode="mvdr")`` with the tracker and MISO off
    against the JAX pipeline (``test_awpu.py::
    test_process_blocks_drives_mvdr_through_scan``): the estimator's powers
    and covariance after 6 blocks, ``process_blocks`` bitwise equal to
    ``process_block``, and the rendered heatmaps within one level."""
    kw = dict(points=PTS[64], enable_tracker=False, enable_miso=False,
              heatmap_mode="mvdr")
    blocks = _blocks(PTS[64], 6, noise=0.02)
    jpipe = JaxPipeline(CFG[jcfg], **kw)
    live = AwpuPipeline(CFG[tcfg], device="cpu", **kw)
    replay = AwpuPipeline(CFG[tcfg], device="cpu", **kw)
    assert live.step.fft_model is None and live.step.mimo_model is None
    for blk in blocks:
        jpipe.process_block(blk)
        out = live.process_block(blk)
    assert not out.powers.any()
    replay.process_blocks(np.stack(blocks))
    _hold_cov(live._mvdr_state, jpipe._mvdr_state)
    _hold_powers(live._mvdr_powers, jpipe._mvdr_powers)
    assert torch.equal(replay._mvdr_powers, live._mvdr_powers)
    assert torch.equal(replay._mvdr_state.cov_re, live._mvdr_state.cov_re)
    for _ in range(2):   # each call advances the rendered maxima's EMA
        img, want = live.heatmap(), jpipe.heatmap()
        assert img.shape == (8, 8) and img.max() == 255
        assert np.abs(img.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_allclose(live._mvdr_prev.numpy(), np.asarray(jpipe._mvdr_prev),
                               rtol=POWERS_RTOL)


SMALL = tcfg.realtime(tcfg.Config(
    mimo=tcfg.MimoConfig(rows=16, columns=16),
    tracker=tcfg.TrackerConfig(n_seekers=8, n_trackers=4),
))


@pytest.mark.parametrize("refresh", [1, 3])
def test_realtime_replay_takes_the_chunk_twin_beside_the_estimator(monkeypatch, refresh):
    """The realtime profile with the tracker and MISO on, in MVDR mode: 12
    blocks through ``process_blocks`` make one call of the chunk kernel's
    wrapper (its twin here) and give ``process_block``'s estimator powers
    and swarm outputs."""
    calls = []
    real = ctk.swarm_chunk

    def counting(*args, **kwargs):
        calls.append(args[1].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(ctk, "swarm_chunk", counting)
    kw = dict(heatmap_mode="mvdr", mvdr_refresh=refresh, device="cpu", seed=2)
    live, replay = AwpuPipeline(SMALL, **kw), AwpuPipeline(SMALL, **kw)
    blocks = np.stack(_blocks(live.points, 12, noise=0.02))
    for blk in blocks:
        out = live.process_block(blk)
    stacked = replay.process_blocks(blocks)
    assert calls == [12]
    assert torch.equal(replay._mvdr_powers, live._mvdr_powers)
    assert replay._mvdr_state.count == live._mvdr_state.count == 12
    assert torch.equal(stacked.targets.valid[-1], out.targets.valid)
    np.testing.assert_allclose(stacked.miso_beam[-1].numpy(), out.miso_beam.numpy(),
                               atol=1e-6 * float(out.miso_beam.abs().max()))
    assert replay.heatmap().shape == (16, 16)


def test_converted_mid_run_state_continues_as_jax():
    """``convert.mvdr_state_from_jax`` of a JAX state after 4 blocks (with
    its carried powers, refresh 2) starts the port, and the next two blocks
    agree with the JAX step's."""
    jstep, step = _steps(PTS[64], weight_refresh=2)
    blocks = _blocks(PTS[64], 6)
    jstate = jstep.init()
    for blk in blocks[:4]:
        jstate, _ = jstep(jstate, jnp.asarray(blk))
    state = convert.mvdr_state_from_jax(
        jmv.MvdrState(*(None if x is None else np.asarray(x) for x in jstate)),
        device="cpu")
    assert state.count == 4 and isinstance(state.count, int)
    for blk in blocks[4:]:
        jstate, want = jstep(jstate, jnp.asarray(blk))
        state, got = step(state, torch.as_tensor(blk))
        _hold_cov(state, jstate)
        _hold_powers(got, want)
