"""The power stage of the separable heatmap: the power kernel's plain twin
against the JAX package's Pallas kernel (``power_matmul_pallas``,
interpret mode), and the port's three power paths, single and chunked,
against the JAX functions on the same model.  The CUDA kernel itself runs
only on the card: ``chip_smoke.py`` holds it against this twin there."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import beamforming_lk_tpu.config as jcfg  # noqa: E402
from beamforming_lk_tpu.ops import fft_das as jfd  # noqa: E402
from beamforming_lk_tpu_torch import config as tcfg  # noqa: E402
from beamforming_lk_tpu_torch.convert import fft_model_from_jax  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402
from beamforming_lk_tpu_torch.ops import fft_das as tfd  # noqa: E402

SRC = [(0.5, 1.2, 5000.0), (0.9, 4.0, 3000.0, 0.3)]
F, TP = 161, 256


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-4)])
def test_power_matmul_reference_matches_pallas_kernel(dtype, tol):
    """200 rows (a ragged edge for 64- and 256-row tiles): powers within
    ``tol`` of the largest."""
    rng = np.random.default_rng(0)
    a_re, a_im = (rng.normal(size=(200, F)).astype(np.float32) for _ in range(2))
    pc, ps = (rng.normal(size=(F, TP)).astype(np.float32) * 0.05 for _ in range(2))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jfd.power_matmul_pallas(
        jnp.asarray(a_re).astype(jdt), jnp.asarray(a_im).astype(jdt),
        jnp.asarray(pc), jnp.asarray(ps), interpret=True,
    ))
    tdt = getattr(torch, dtype)
    got = tfd.power_matmul(torch.as_tensor(a_re).to(tdt),
                           torch.as_tensor(a_im).to(tdt),
                           torch.as_tensor(pc), torch.as_tensor(ps)).numpy()
    assert got.shape == want.shape == (200,) and got.dtype == np.float32
    assert np.abs(got - want).max() <= tol * want.max()


def _models(power_path, compute="float32", dead=True):
    pts = ant.multi_array_cluster(64)
    mask = None
    if dead:
        mask = np.ones(64, np.float32)
        mask[[5, 40]] = 0.0
    ref = jfd.make_fft_heatmap_model(
        pts, jcfg.MimoConfig(rows=12, columns=12), jcfg.DspConfig(),
        jcfg.ArrayConfig(), channel_mask=mask, compute=compute,
        power_path=power_path,
    )
    ours = tfd.make_fft_heatmap_model(
        pts, tcfg.MimoConfig(rows=12, columns=12), tcfg.DspConfig(),
        tcfg.ArrayConfig(), channel_mask=mask, compute=compute,
        power_path=power_path,
    )
    return pts, ref, ours


def _windows(pts, n):
    rng = np.random.default_rng(3)
    stream = plane_wave_block(pts, SRC, 1000, 64 + 256 * n, noise_std=0.05,
                              rng=rng)
    return np.stack([stream[:, i * 256:i * 256 + 320] for i in range(n)])


@pytest.mark.parametrize("power_path", tfd.POWER_PATHS)
def test_power_paths_match_jax(power_path):
    """Each power path, on the JAX model converted and on the port's own,
    single and chunked (3 windows), within 1e-4 of the peak in f32."""
    pts, ref, ours = _models(power_path)
    conv = fft_model_from_jax(ref)
    assert conv.power_path == ours.power_path == power_path
    wins = _windows(pts, 3)
    want = np.asarray(jfd.fft_heatmap_powers_chunked(jnp.asarray(wins), ref))
    for model in (conv, ours):
        got = tfd.fft_heatmap_powers_chunked(torch.as_tensor(wins), model).numpy()
        assert got.shape == want.shape == (3, 144)
        assert np.abs(got - want).max() <= 1e-4 * want.max()
        for i, w in enumerate(wins):
            one = np.asarray(jfd.fft_heatmap_powers(jnp.asarray(w), ref))
            mine = tfd.fft_heatmap_powers(torch.as_tensor(w), model).numpy()
            assert np.abs(mine - one).max() <= 1e-4 * one.max(), i


def test_pallas_path_matches_jax_in_bf16_within_db_bound():
    """The bf16 profile through the power kernel's twin, chunked: every
    pixel within 20 dB of the peak agrees within 0.01 dB, same peak pixel."""
    pts, ref, ours = _models("pallas", compute="bfloat16")
    wins = _windows(pts, 2)
    want = np.asarray(jfd.fft_heatmap_powers_chunked(jnp.asarray(wins), ref))
    got = tfd.fft_heatmap_powers_chunked(torch.as_tensor(wins), ours).numpy()
    loud = want > want.max() * 1e-2
    assert np.abs(10.0 * np.log10(got[loud] / want[loud])).max() < 0.01
    assert (got.argmax(axis=1) == want.argmax(axis=1)).all()


def test_numpy_built_idft_matches_jax_model():
    _, ref, ours = _models("beam", dead=False)
    assert ours.idft.shape == (2 * F, 256)
    np.testing.assert_allclose(ours.idft.numpy(), np.asarray(ref.idft),
                               rtol=1e-6, atol=1e-7)
    assert ours.use_bandpass == ref.use_bandpass


def test_unknown_power_path_is_refused():
    with pytest.raises(ValueError, match="power_path"):
        _models("dense")


def test_lattice_order_model_is_not_ported():
    args = (ant.multi_array_cluster(256), tcfg.MimoConfig(rows=12, columns=12),
            tcfg.DspConfig(), tcfg.ArrayConfig())
    with pytest.raises(NotImplementedError):
        tfd.make_fft_heatmap_model(*args, assume_lattice_order=True)
