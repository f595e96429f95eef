"""The port's separable-FFT heatmap (power_path "fused") against the JAX
package's: the numpy-built constants, and the powers in f32 and bf16."""

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
BUFFERS = ("ex_s", "ey_s", "dft", "pow_ri", "perm_matrix", "src_map",
           "dead_xre", "dead_xim", "dead_yre", "dead_yim", "dead_chan")


def _models(n_mics, dead, interp="linear", compute="float32"):
    pts = ant.multi_array_cluster(n_mics)
    mask = None
    if dead:
        mask = np.ones(n_mics, np.float32)
        mask[[5, 40]] = 0.0
    args = [(tcfg.MimoConfig(rows=16, columns=16), tcfg.DspConfig(interp=interp),
             tcfg.ArrayConfig()),
            (jcfg.MimoConfig(rows=16, columns=16), jcfg.DspConfig(interp=interp),
             jcfg.ArrayConfig())]
    ours = tfd.make_fft_heatmap_model(pts, *args[0], channel_mask=mask,
                                      compute=compute, device="cpu")
    ref = jfd.make_fft_heatmap_model(pts, *args[1], channel_mask=mask,
                                     compute=compute)
    return pts, ours, ref


@pytest.mark.parametrize("n_mics,dead,interp", [
    (64, False, "linear"), (64, True, "linear"), (64, False, "fir"),
    (256, True, "linear"),
])
def test_numpy_built_constants_match_jax_model(n_mics, dead, interp):
    _, ours, ref = _models(n_mics, dead, interp)
    conv = fft_model_from_jax(ref, device="cpu")
    for name in BUFFERS:
        a, b = getattr(ours, name), getattr(conv, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7, err_msg=name)
    assert (ours.perm_matrix is not None) == (n_mics == 256)
    assert ours.n_active == conv.n_active and ours.fft_len == conv.fft_len


def _window(pts, seed=0):
    rng = np.random.default_rng(seed)
    return plane_wave_block(pts, SRC, 1000, 64 + 256, noise_std=0.05, rng=rng)


@pytest.mark.parametrize("n_mics,dead", [(64, False), (64, True), (256, True)])
def test_powers_match_jax_in_f32(n_mics, dead):
    pts, ours, ref = _models(n_mics, dead)
    win = _window(pts)
    got = tfd.fft_heatmap_powers(torch.as_tensor(win), ours).numpy()
    want = np.asarray(jfd.fft_heatmap_powers(jnp.asarray(win), ref))
    assert got.shape == want.shape == (256,)
    assert np.abs(got - want).max() <= 1e-4 * want.max()


def test_powers_match_jax_in_bf16_within_db_bound():
    """bf16 inputs round at other places in the two frameworks (XLA may fuse
    the elementwise steps between the products in f32), so the bf16 profile
    is held by a bound in dB: every pixel within 20 dB of the peak agrees
    within 0.01 dB, and the peak pixel is the same."""
    pts, ours, ref = _models(64, True, compute="bfloat16")
    win = _window(pts, 1)
    got = tfd.fft_heatmap_powers(torch.as_tensor(win), ours).numpy()
    want = np.asarray(jfd.fft_heatmap_powers(jnp.asarray(win), ref))
    loud = want > want.max() * 1e-2
    db = np.abs(10.0 * np.log10(got[loud] / want[loud]))
    assert db.max() < 0.01, db.max()
    assert np.argmax(got) == np.argmax(want)


def test_gain_mask_and_non_lattice_do_not_factor():
    pts = ant.create_antenna_grid()
    args = (tcfg.MimoConfig(rows=16, columns=16), tcfg.DspConfig(),
            tcfg.ArrayConfig())
    assert tfd.make_fft_heatmap_model(pts, *args, channel_mask=np.full(64, 0.5),
                                      device="cpu") is None
    bent = pts.copy()
    bent[2, 3] = 0.01
    assert tfd.make_fft_heatmap_model(bent, *args, device="cpu") is None
