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


def _operands(rows, seed=0):
    rng = np.random.default_rng(seed)
    a_re, a_im = (rng.normal(size=(rows, F)).astype(np.float32) for _ in range(2))
    pc, ps = (rng.normal(size=(F, TP)).astype(np.float32) * 0.05 for _ in range(2))
    return a_re, a_im, pc, ps


@pytest.mark.parametrize("rows", [1, 8, 200])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-4)])
def test_power_matmul_reference_matches_pallas_kernel(dtype, tol, rows):
    """1 row, one 8-row span and 200 rows (a ragged edge for 64- and
    256-row tiles): powers within ``tol`` of the largest."""
    a_re, a_im, pc, ps = _operands(rows)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jfd.power_matmul_pallas(
        jnp.asarray(a_re).astype(jdt), jnp.asarray(a_im).astype(jdt),
        jnp.asarray(pc), jnp.asarray(ps), interpret=True,
    ))
    tdt = getattr(torch, dtype)
    got = tfd.power_matmul(torch.as_tensor(a_re).to(tdt),
                           torch.as_tensor(a_im).to(tdt),
                           torch.as_tensor(pc), torch.as_tensor(ps)).numpy()
    assert got.shape == want.shape == (rows,) and got.dtype == np.float32
    assert np.abs(got - want).max() <= tol * want.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 7, 8, 200, 16384, 32768])
def test_power_matmul_launch_plan(rows, dtype):
    """Every row tile's span starts 16-byte aligned (the kernel copies each
    plane's tile as one span), K is padded to a multiple of 16 past both
    planes, and the shared memory fits a Hopper block."""
    tdt = getattr(torch, dtype)
    plan = tfd.power_matmul_plan(rows, F, TP, tdt)
    item = torch.empty((), dtype=tdt).element_size()
    assert plan["tiles"] == -(-rows // plan["tile_rows"])
    assert plan["span_bytes"] == plan["tile_rows"] * F * item
    for t in range(plan["tiles"]):
        assert (t * plan["span_bytes"]) % 16 == 0
    if dtype == "bfloat16":
        assert (8 * F * item) % 16 == 0       # any run of 8 rows is a span
        assert plan["im_k0"] % 8 == 0 and plan["tile_rows"] % plan["stage_rows"] == 0
        assert (plan["stage_rows"] * F * item) % 16 == 0   # each slot's span too
        assert plan["cluster"] * plan["cta_cols"] == TP
        assert plan["grid"] % plan["cluster"] == 0
        assert 1 <= plan["grid"] // plan["cluster"] <= min(plan["tiles"], 66)
    else:
        assert plan["im_k0"] == F and plan["grid"] == plan["tiles"]
        assert plan["cluster"] == 1 and plan["k_pad"] % plan["k_tile"] == 0
    assert plan["k_pad"] % 16 == 0 and plan["k_pad"] >= plan["im_k0"] + F >= 2 * F
    assert plan["k_pad"] - (plan["im_k0"] + F) < 16    # less than one k-step of zeros
    assert plan["smem_bytes"] <= 232_448


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_power_matmul_decomposition(dtype):
    """The kernel's reading of the twin: the K-padded ``[a_re | a_im | 0]``
    by ``[pc ; ps ; 0]`` product (the im plane from the plan's ``im_k0``)
    equals the two-plane product, and the powers of the column groups the
    kernel sums separately (bf16: the cluster's CTAs; f32: the warps
    along the columns), added in its order, equal the whole; 1e-6 of the
    largest, in f32."""
    tdt = getattr(torch, dtype)
    a_re, a_im, pc, ps = (torch.as_tensor(x) for x in _operands(200, seed=1))
    plan = tfd.power_matmul_plan(200, F, TP, tdt)

    def f(x):
        return x.to(tdt).to(torch.float32)

    k0, kp = plan["im_k0"], plan["k_pad"]
    a = torch.zeros((200, kp))
    a[:, :F], a[:, k0:k0 + F] = f(a_re), f(a_im)
    b = torch.zeros((kp, TP))
    b[:F], b[k0:k0 + F] = f(pc), f(ps)
    beam = a @ b
    two = f(a_re) @ f(pc) + f(a_im) @ f(ps)
    assert (beam - two).abs().max() <= 1e-6 * two.abs().max()
    groups = plan["cluster"] if dtype == "bfloat16" else 4
    width = TP // groups
    total = beam[:, :width].square().sum(-1)
    for q in range(1, groups):
        total = total + beam[:, q * width:(q + 1) * width].square().sum(-1)
    whole = tfd.power_matmul_reference(a_re.to(tdt), a_im.to(tdt), pc, ps)
    assert (total - whole).abs().max() <= 1e-6 * whole.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["offset", "strided"])
def test_power_matmul_rejects_misaligned_rows(case, dtype):
    """``a_re[1:]`` starts one row (322 or 644 bytes) into its storage, off
    the 16-byte alignment the kernel's row spans need; a column slice is
    not contiguous.  Both raise on the CPU as on the card."""
    tdt = getattr(torch, dtype)
    _, _, pc, ps = (torch.as_tensor(x) for x in _operands(1))
    whole = torch.zeros((9, F + 8), dtype=tdt)
    a_im = torch.zeros((8, F), dtype=tdt)
    if case == "offset":
        a_re = torch.zeros((9, F), dtype=tdt)[1:]
        assert a_re.is_contiguous() and a_re.data_ptr() % 16
        match = "16-byte"
    else:
        a_re = whole[1:, :F]
        match = "contiguous"
    with pytest.raises(ValueError, match=match):
        tfd.power_matmul(a_re, a_im, pc, ps)
    with pytest.raises(ValueError, match=match):
        tfd.power_matmul(a_im, a_re, pc, ps)


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
        power_path=power_path, device="cpu",
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
    conv = fft_model_from_jax(ref, device="cpu")
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
    """The lattice-ordered model, once refused, is ported: on the 256-mic
    cluster it has no permutation product, and its channel order is the
    JAX model's (its powers: tests/test_torch_phat_lattice.py)."""
    pts = ant.multi_array_cluster(256)
    ours = tfd.make_fft_heatmap_model(
        pts, tcfg.MimoConfig(rows=12, columns=12), tcfg.DspConfig(),
        tcfg.ArrayConfig(), power_path="pallas", assume_lattice_order=True,
        device="cpu")
    ref = jfd.make_fft_heatmap_model(
        pts, jcfg.MimoConfig(rows=12, columns=12), jcfg.DspConfig(),
        jcfg.ArrayConfig(), power_path="pallas", assume_lattice_order=True)
    assert ours.perm_matrix is None and ref.perm_matrix is None
    np.testing.assert_array_equal(ours.channel_perm, ref.channel_perm)
