"""The port's SRP-PHAT and lattice-ordered heatmap models against the JAX
package's (``ops/fft_das.py``): the numpy-built constants, the powers of
every power path (K3's twin on ``"pallas"``, the JAX Pallas kernel in
interpret mode), single and chunked, in f32 and bf16."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import beamforming_lk_tpu.config as jcfg  # noqa: E402
from beamforming_lk_tpu.ops import fft_das as jfd  # noqa: E402
from beamforming_lk_tpu_torch import config as tcfg  # noqa: E402
from beamforming_lk_tpu_torch.convert import fft_model_from_jax  # noqa: E402
from beamforming_lk_tpu_torch.io import ring as rg  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import (  # noqa: E402
    plane_wave_block, synthetic_blocks,
)
from beamforming_lk_tpu_torch.models.mimo import make_mimo_grid  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402
from beamforming_lk_tpu_torch.ops import fft_das as tfd  # noqa: E402
from beamforming_lk_tpu_torch.ops.geometry import spherical_angle  # noqa: E402

SRC = [(0.5, 1.2, 5000.0), (0.9, 4.0, 3000.0, 0.3)]
# PHAT weights every bin alike, so its sources are broadband: tones from
# one direction (the JAX package's test_srp_phat_peaks_and_is_level_invariant).
TONES = [(0.35, 2.0, f) for f in (1000.0, 2500.0, 4000.0, 5500.0, 7000.0,
                                  8500.0, 10000.0, 12000.0)]
KINDS = {"phat": (True, False), "lattice": (False, True),
         "phat_lattice": (True, True)}
DEAD = [5, 130]


def _models(phat, lattice, compute="float32", power_path="pallas",
            n_mics=256, dead=True, rows=10):
    """(points, port model, JAX model), built from the same numpy points
    and mask."""
    pts = ant.multi_array_cluster(n_mics)
    mask = None
    if dead:
        mask = np.ones(n_mics, np.float32)
        mask[DEAD] = 0.0
    made = []
    for m, build, kw in ((tcfg, tfd.make_fft_heatmap_model, {"device": "cpu"}),
                         (jcfg, jfd.make_fft_heatmap_model, {})):
        made.append(build(
            pts, m.MimoConfig(rows=rows, columns=rows, fov_degrees=120.0,
                              phat=phat),
            m.DspConfig(), m.ArrayConfig(), channel_mask=mask, compute=compute,
            power_path=power_path, assume_lattice_order=lattice, **kw))
    return pts, made[0], made[1]


def _windows(pts, n, sources=SRC, seed=3):
    rng = np.random.default_rng(seed)
    stream = plane_wave_block(pts, sources, 1000, 64 + 256 * n, noise_std=0.05,
                              rng=rng)
    return np.stack([stream[:, i * 256:i * 256 + 320] for i in range(n)])


def _rows(model, wins):
    """The windows as the model takes them: rows reordered by
    ``channel_perm`` under the lattice-order promise."""
    return wins if model.channel_perm is None else wins[..., model.channel_perm, :]


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_numpy_built_constants_match_jax_model(kind):
    _, ours, ref = _models(*KINDS[kind])
    conv = fft_model_from_jax(ref, device="cpu")
    assert ours.phat == conv.phat == KINDS[kind][0]
    for name in ("ex_s", "ey_s", "dft", "pow_ri", "perm_matrix", "band_weight",
                 "dead_xre", "dead_xim", "dead_yre", "dead_yim", "dead_chan"):
        a, b = getattr(ours, name), getattr(conv, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
    if KINDS[kind][1]:
        assert ours.perm_matrix is None
        np.testing.assert_array_equal(ours.channel_perm, ref.channel_perm)
        np.testing.assert_array_equal(conv.channel_perm, ref.channel_perm)
        assert isinstance(ours.channel_perm, np.ndarray)
        assert "channel_perm" not in dict(ours.named_buffers())
        # A dead channel's window row is its lattice site under the promise.
        np.testing.assert_array_equal(ours.channel_perm[ours.dead_chan.numpy()],
                                      DEAD)
    else:
        assert ours.perm_matrix is not None and ours.channel_perm is None
        np.testing.assert_array_equal(ours.dead_chan.numpy(), DEAD)
    if KINDS[kind][0]:
        band = ours.band_weight.numpy()
        hz = np.arange(band.size) * 48828.0 / ours.fft_len
        np.testing.assert_array_equal(band, ((hz >= 550.0) & (hz <= 9000.0)))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_powers_match_jax(kind, compute):
    """K3's twin path on each model, single windows and a chunk of 3, the
    port's own model and the converted JAX one against the JAX package's
    powers (its Pallas kernel in interpret mode).  f32: within 1e-4 of the
    peak.  bf16 rounds at other places in the two frameworks: every pixel
    within 20 dB of the peak within 0.01 dB, the same peak pixel."""
    pts, ours, ref = _models(*KINDS[kind], compute)
    wins = _rows(ours, _windows(pts, 3))
    want = np.asarray(jfd.fft_heatmap_powers_chunked(jnp.asarray(wins), ref))
    singles = np.stack([np.asarray(jfd.fft_heatmap_powers(jnp.asarray(w), ref))
                        for w in wins])
    for model in (ours, fft_model_from_jax(ref, device="cpu")):
        got = tfd.fft_heatmap_powers_chunked(torch.as_tensor(wins), model).numpy()
        one = np.stack([tfd.fft_heatmap_powers(torch.as_tensor(w), model).numpy()
                        for w in wins])
        for mine, theirs in ((got, want), (one, singles)):
            assert mine.shape == theirs.shape == (3, 100)
            if compute == "float32":
                assert np.abs(mine - theirs).max() <= 1e-4 * theirs.max()
            else:
                loud = theirs > theirs.max(axis=1, keepdims=True) * 1e-2
                db = np.abs(10.0 * np.log10(mine[loud] / theirs[loud]))
                assert db.max() < 0.01, db.max()
                assert (mine.argmax(axis=1) == theirs.argmax(axis=1)).all()


def test_srp_phat_peaks_and_is_level_invariant():
    """The PHAT map of a broadband source peaks on it (within 8 degrees on
    a 16 x 16 grid), and a 10x louder source moves its peak power by less
    than 3x (whitening), where plain DAS power would move 100x."""
    mimo = tcfg.MimoConfig(rows=16, columns=16, fov_degrees=120.0, phat=True)
    dsp, arr = tcfg.DspConfig(), tcfg.ArrayConfig()
    pts = ant.create_antenna_grid(8, 8, 0.02)
    model = tfd.make_fft_heatmap_model(pts, mimo, dsp, arr, device="cpu")
    assert model.phat

    def heatmap(amplitude):
        hist = rg.ring_init(64, dsp.history, device="cpu")
        for b in synthetic_blocks(pts, TONES, 6, amplitude=amplitude, seed=4):
            hist = rg.ring_push(hist, torch.as_tensor(b))
        w = rg.ring_window(hist, dsp.block_size, dsp.shift_range, 2)
        return tfd.fft_heatmap_powers(w, model).numpy()

    p1, p2 = heatmap(1e-2), heatmap(1e-1)
    theta, phi = make_mimo_grid(mimo)
    k = int(p1.argmax())
    d = math.degrees(float(spherical_angle(
        torch.tensor(float(theta[k])), torch.tensor(float(phi[k])),
        torch.tensor(0.35), torch.tensor(2.0))))
    assert d < 8.0, d
    assert p2.max() / p1.max() < 3.0


@pytest.mark.parametrize("use_bandpass", [True, False])
@pytest.mark.parametrize("case", ["plain", "dead", "bf16"])
def test_phat_power_paths_agree(case, use_bandpass):
    """Under PHAT the three power paths are one linear map of the whitened
    spectra: "fused" against "beam" and "pallas" (K3's twin) against
    "fused", within 1e-4 relative in f32 and 5e-3 in bf16 (the JAX
    package's test_power_paths_agree bounds)."""
    mimo = tcfg.MimoConfig(rows=12, columns=12, fov_degrees=150.0, phat=True)
    dsp = tcfg.DspConfig(use_bandpass=use_bandpass)
    pts = ant.create_antenna_grid(8, 8, 0.02)
    kw = {}
    if case == "dead":
        mask = np.ones(64, np.float32)
        mask[[5, 40]] = 0.0
        kw["channel_mask"] = mask
    elif case == "bf16":
        kw["compute"] = "bfloat16"
    rng = np.random.default_rng(7)
    window = torch.as_tensor(
        rng.standard_normal((64, dsp.shift_range + dsp.block_size)), dtype=torch.float32)
    got = {path: tfd.fft_heatmap_powers(window, tfd.make_fft_heatmap_model(
        pts, mimo, dsp, tcfg.ArrayConfig(), power_path=path, device="cpu",
        **kw)).numpy()
        for path in tfd.POWER_PATHS}
    tol = 5e-3 if case == "bf16" else 1e-4
    np.testing.assert_allclose(got["fused"], got["beam"], rtol=tol, atol=1e-12)
    np.testing.assert_allclose(got["pallas"], got["fused"], rtol=tol, atol=1e-12)


@pytest.mark.parametrize("phat", [False, True])
def test_lattice_order_model_skips_perm_matmul(phat):
    """With dead channels: the lattice-ordered model on windows reordered by
    ``channel_perm`` gives the plain model's powers on the raw windows
    (rtol 1e-5), with no permutation product; chunked too."""
    _, base, _ = _models(phat, False)
    _, fast, _ = _models(phat, True)
    assert base.perm_matrix is not None and base.channel_perm is None
    assert fast.perm_matrix is None and fast.channel_perm is not None
    rng = np.random.default_rng(7)
    wins = rng.standard_normal((2, 256, 320)).astype(np.float32)
    p_base = tfd.fft_heatmap_powers_chunked(torch.as_tensor(wins), base).numpy()
    p_fast = tfd.fft_heatmap_powers_chunked(
        torch.as_tensor(wins[:, fast.channel_perm]), fast).numpy()
    np.testing.assert_allclose(p_fast, p_base, rtol=1e-5, atol=1e-12)
    one = tfd.fft_heatmap_powers(torch.as_tensor(wins[0, fast.channel_perm]),
                                 fast).numpy()
    np.testing.assert_allclose(one, p_base[0], rtol=1e-5, atol=1e-12)
