"""The DAS-beam kernel's plain twin (beamforming_lk_tpu_torch.ops.cuda_das)
and the dense heatmap model (models/mimo.py) against the JAX package: its
Pallas kernel ``das_beam_pallas`` in interpret mode, its dense ``das_beam``
and its ``MimoModel`` / ``mimo_power``, on identical numpy inputs (64 mics,
an 8x8 grid).  The CUDA kernel itself runs only on the card:
``chip_smoke.py`` holds it against this twin there."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import beamforming_lk_tpu.config as jcfg  # noqa: E402
from beamforming_lk_tpu.models import mimo as jmm  # noqa: E402
from beamforming_lk_tpu.ops import delay as jdl  # noqa: E402
from beamforming_lk_tpu.ops.pallas_das import das_beam_pallas, pad_directions  # noqa: E402
from beamforming_lk_tpu.ops.pallas_das import delay_split_np as jax_delay_split_np  # noqa: E402
from beamforming_lk_tpu_torch import config as tcfg  # noqa: E402
from beamforming_lk_tpu_torch.convert import mimo_model_from_jax  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.models import mimo as mm  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402
from beamforming_lk_tpu_torch.ops import cuda_das as cd  # noqa: E402
from beamforming_lk_tpu_torch.ops import delay as dl  # noqa: E402

S, T = 64, 256
PTS = ant.create_antenna_grid()
SPM = tcfg.ArrayConfig().samples_per_meter


def _inputs(interp, n_windows=1, seed=0):
    """Windows [n, 64, T+S] of a plane wave with noise, the 8x8 grid's
    delays, and the split (shift, tap weights)."""
    theta, phi = mm.make_mimo_grid(tcfg.MimoConfig(rows=8, columns=8))
    delays = ant.steering_delays_np(PTS, theta, phi, SPM)
    stream = plane_wave_block(PTS, [(0.4, 1.0, 5000.0)], 0, S + n_windows * T,
                              noise_std=0.05, rng=np.random.default_rng(seed))
    windows = np.stack([stream[:, i * T:i * T + S + T] for i in range(n_windows)])
    bank = None if interp == "linear" else dl.fractional_delay_fir_bank()
    shift, tapw = cd.delay_split_np(delays, S, interp, bank)
    return windows, delays, bank, shift, tapw


def _twin(window, shift, tapw, compute="float32"):
    return cd.das_beam(torch.as_tensor(window), torch.as_tensor(shift),
                       torch.as_tensor(tapw), span=S, compute=compute).numpy()


def _jax_pallas(window, shift, tapw, compute_dtype=jnp.float32):
    (shift_p, tapw_p), _ = pad_directions([shift, tapw], shift.shape[0], 128)
    beam = das_beam_pallas(jnp.asarray(window), jnp.asarray(shift_p),
                           jnp.asarray(tapw_p), span=S, block_t=T, tile_d=128,
                           tile_c=8, compute_dtype=compute_dtype, interpret=True)
    return np.asarray(beam)[:shift.shape[0]]


@pytest.mark.parametrize("interp", ["linear", "fir"])
def test_twin_matches_pallas_kernel_and_dense_path(interp):
    """f32: within rtol 1e-5 (atol 1e-6) of the Pallas kernel and of the
    dense stencil product, the bounds of test_pallas_das.py."""
    windows, delays, bank, shift, tapw = _inputs(interp)
    got = _twin(windows[0], shift, tapw)
    dense = jdl.das_beam(jnp.asarray(windows[0]),
                         jnp.asarray(jdl.das_weights_np(delays, S, interp, bank)))
    np.testing.assert_allclose(got, np.asarray(dense), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _jax_pallas(windows[0], shift, tapw),
                               rtol=1e-5, atol=1e-6)


def test_twin_bf16_matches_jax_bf16_paths():
    """bf16 inputs with f32 sums: within 2e-2 of the peak of the JAX
    kernel's bf16 beam and of the dense bf16 product (the bound of
    test_pallas_das.py's bf16 test), and within 2e-2 of the f32 beam."""
    windows, delays, _, shift, tapw = _inputs("linear")
    got = _twin(windows[0], shift, tapw, "bfloat16")
    w = jnp.asarray(jdl.das_weights_np(delays, S, "linear"))
    dense = np.asarray(jdl.das_beam(jnp.asarray(windows[0]).astype(jnp.bfloat16),
                                    w.astype(jnp.bfloat16),
                                    precision=jax.lax.Precision.DEFAULT))
    pallas = _jax_pallas(windows[0], shift, tapw, jnp.bfloat16)
    f32 = _twin(windows[0], shift, tapw)
    scale = np.abs(f32).max()
    for want in (dense, pallas, f32):
        assert np.abs(got - want).max() < 2e-2 * scale


def test_masked_channel_and_stack():
    """Tap weights times a mask with two dead channels and a gain equal
    the dense stencil times the mask (rtol 1e-5); a 3-window stack equals
    3 single calls (rtol 1e-6: only the batching differs)."""
    windows, delays, _, shift, tapw = _inputs("linear", n_windows=3)
    mask = np.ones(64, np.float32)
    mask[[5, 40]] = 0.0
    mask[9] = 0.5
    w = jdl.das_weights_np(delays, S, "linear") * mask[:, None]
    want = np.asarray(jdl.das_beam(jnp.asarray(windows[1]), jnp.asarray(w)))
    got_masked = _twin(windows[1], shift, tapw * mask[:, None])
    np.testing.assert_allclose(got_masked, want, rtol=1e-5, atol=1e-6)
    stack = _twin(windows, shift, tapw)
    assert stack.shape == (3, 64, T)
    for i in range(3):
        np.testing.assert_allclose(stack[i], _twin(windows[i], shift, tapw),
                                   rtol=1e-6, atol=1e-7)


def test_twin_takes_the_ring_views():
    """A chunk's windows as the pipeline hands them over, one strided view
    of the history (``ring_windows``' unfold), give the beams of a
    contiguous copy."""
    windows, _, _, shift, tapw = _inputs("linear", n_windows=2)
    hist = torch.as_tensor(np.concatenate([windows[0][:, :T], windows[1]], axis=1))
    views = hist.unfold(-1, S + T, T).movedim(-2, 0)        # [2, C, S+T]
    assert not views.is_contiguous()
    got = cd.das_beam(views, torch.as_tensor(shift), torch.as_tensor(tapw), span=S)
    want = _twin(np.ascontiguousarray(views.numpy()), shift, tapw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("interp", ["linear", "fir"])
def test_mimo_power_and_converted_model_match_jax(interp):
    """The port's model holds the JAX package's split (``delay_split_np``)
    bit for bit, the mask folded into the tap weights; it and the model
    converted from the JAX ``MimoModel`` give the JAX ``mimo_power``
    (rtol 1e-5), with two dead channels and their n_active."""
    mask = np.ones(64, np.float32)
    mask[[3, 17]] = 0.0
    windows, delays, bank, _, _ = _inputs(interp)
    grids = [m.MimoConfig(rows=8, columns=8) for m in (jcfg, tcfg)]
    dsps = [m.DspConfig(interp=interp) for m in (jcfg, tcfg)]
    jmodel = jmm.make_mimo_model(PTS, grids[0], dsps[0], jcfg.ArrayConfig(),
                                 channel_mask=mask)
    want = np.asarray(jmm.mimo_power(jnp.asarray(windows[0]), jmodel,
                                     n_active=62.0))
    model = mm.make_mimo_model(PTS, grids[1], dsps[1], tcfg.ArrayConfig(),
                               channel_mask=mask, device="cpu")
    j_shift, j_tapw = jax_delay_split_np(delays, S, interp, bank)
    np.testing.assert_array_equal(model.shift.numpy(), j_shift)
    np.testing.assert_array_equal(model.tap_weights.numpy(),
                                  j_tapw * mask[:, None])
    for m in (model, mimo_model_from_jax(jmodel, device="cpu")):
        got = mm.mimo_power(torch.as_tensor(windows[0]), m, n_active=62.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    assert mm.mimo_power(torch.as_tensor(windows), model).shape == (1, 64)


def _beam_runs(window, shift, tapw, n):
    """beam[d, t] for t < n from a window whose column 0 is sample 0,
    channel by channel then tap by tap: each sample depends only on its
    own columns."""
    beam = torch.zeros((shift.shape[0], n), dtype=torch.float32)
    cols = torch.arange(n)
    sh = shift.to(torch.long)
    for c in range(window.shape[0]):
        for j in range(tapw.shape[-1]):
            beam = beam + tapw[:, c, j, None] * window[c][sh[:, c, None] + j + cols]
    return beam


@pytest.mark.parametrize("interp", ["linear", "fir"])
def test_beam_over_direction_tiles_and_sample_runs(interp):
    """The DAS-beam kernel splits the beam into tiles of 32 directions and,
    inside a tile, runs of 8 consecutive samples per lane, each run read
    from the 8 + S - 1 window columns that start at its first sample.  On a
    chunk's strided ring view, the tiles x runs, each computed from its own
    columns alone, assemble to the whole beam bit for bit (so the column
    offsets shift + j + t are right at the edge of every run), and the
    whole beam is the twin's (within 1e-5 of the peak: other order)."""
    windows, _, _, shift, tapw = _inputs(interp, n_windows=2)
    hist = torch.as_tensor(np.concatenate([windows[0][:, :T], windows[1]], axis=1))
    view = hist.unfold(-1, S + T, T).movedim(-2, 0)[1]       # [C, S+T], strided
    assert not view.is_contiguous()
    shift_t, tapw_t = torch.as_tensor(shift), torch.as_tensor(tapw)
    plan = cd.das_beam_plan(1, shift.shape[0], 64, T, S, tapw.shape[-1])
    dirs, run = plan["dirs_per_block"], plan["run"]
    whole = _beam_runs(view, shift_t, tapw_t, T)
    tiles = []
    for d0 in range(0, shift.shape[0], dirs):
        sh, w = shift_t[d0:d0 + dirs], tapw_t[d0:d0 + dirs]
        tiles.append(torch.cat([_beam_runs(view[:, t0:t0 + run + S - 1], sh, w, run)
                                for t0 in range(0, T, run)], dim=1))
    assert torch.equal(torch.cat(tiles), whole)
    want = cd.das_beam(view, shift_t, tapw_t, span=S)
    torch.testing.assert_close(whole, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("interp", ["linear", "fir"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [64, 256])
def test_das_beam_launch_plan(channels, compute, interp):
    """The DAS-beam kernel's launch plan for the default profile's 64 x 64
    grid (D = 4096), one window and a stack of 8: blocks of 1024 threads
    over 128 tiles of 32 directions, one direction a warp, lanes of 8
    consecutive samples covering T = 256; channel tiles of 32 rows of
    T + S padded columns, double-buffered, and the tile's (direction,
    channel) entries, one a thread; within the 227 KB a block can use
    (at every tap count up to 16).  The window is staged in
    f32 whatever the product's type, so the plan depends on neither the
    channel count nor the compute type."""
    taps = dl.LINEAR_TAPS if interp == "linear" else tcfg.DspConfig().fir_taps
    for k in (1, 8):
        plan = cd.das_beam_plan(k, 4096, channels, T, S, taps)
        assert plan["grid"] == (128, k, 1) and plan["threads"] == 1024
        assert plan["dirs_per_block"] == 32 == plan["threads"] // 32
        assert plan["run"] * 32 == plan["sample_tile"] == T
        assert plan["row_floats"] == (T + S) * 9 // 8
        assert plan["entry_floats"] >= taps + 2 and plan["entry_floats"] % 4 == 0
        assert 32 * plan["channel_tile"] == plan["threads"]
        assert plan["smem_bytes"] == (
            2 * plan["channel_tile"] * plan["row_floats"] * 4
            + 32 * plan["channel_tile"] * plan["entry_floats"] * 4)
        assert plan["smem_bytes"] <= 232448
    assert cd.das_beam_plan(1, 4096, channels, T, S, 16)["smem_bytes"] <= 232448
    assert cd.das_beam_plan(1, 4096, channels, T, S, taps) == cd.das_beam_plan(
        1, 4096, 64 if channels == 256 else 256, T, S, taps)
