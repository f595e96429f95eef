"""The swarm-chain kernel's plain twin (beamforming_lk_tpu_torch.ops.cuda_tracker)
against the JAX package's Pallas kernel (swarm_chain_pallas, interpret mode)
on identical numpy operands.  The CUDA kernel itself runs only on the card:
``chip_smoke.py`` holds it against this twin there."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from beamforming_lk_tpu.ops import pallas_tracker as ptk  # noqa: E402
from beamforming_lk_tpu_torch.config import TrackerConfig  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402
from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk  # noqa: E402
from beamforming_lk_tpu_torch.ops import delay as dl  # noqa: E402

NT, NS = 4, 8
P = NT + 1 + NS          # trackers | listener | seekers
T = 256
SRC = (0.5, 1.2, 5000.0)
SPM = 48828.0 / 340.0


def _operands(interp, n_iter, seed=0):
    """Seeded so merge, jump and promote all fire: two coincident tracking
    trackers, a published target on seeker 0, free trackers, a source."""
    rng = np.random.default_rng(seed)
    pts = ant.create_antenna_grid(8, 8, 0.02)
    taps = dl.LINEAR_TAPS if interp == "linear" else 8
    span = dl.probe_span(pts, SPM, taps, 64)
    pw = plane_wave_block(pts, [SRC], 0, span + T, noise_std=0.02, rng=rng)
    tc = TrackerConfig(n_trackers=NT, n_seekers=NS)
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
    jumps = np.zeros((2, n_iter, P), np.float32)
    jumps[:, :, NT + 1:] = rng.uniform(-1, 1, (2, n_iter, NS)) * tc.theta_limit / 2
    raw0 = pw[0, span - taps:span - taps + T].astype(np.float32)
    bp0 = 0.5 * raw0[1:-1] - 0.25 * (raw0[2:] + raw0[:-2])
    reference = np.float32(np.sum(bp0 * bp0) / np.float32(T - 2))
    kw = dict(n_trackers=NT, span=span, taps=taps, theta_limit=tc.theta_limit,
              divisor=float(T), closeness=tc.tracker_closeness,
              error_threshold=tc.error_threshold, interp=interp,
              min_power_fraction=tc.min_power_fraction)
    return pts, pw, rows, jumps, reference, kw


def _run_both(interp, probe_layout, n_iter, n_sub, prefix_rows=0, seed=0,
              mask=None):
    pts, pw, rows, jumps, reference, kw = _operands(interp, n_iter, seed)
    kw = dict(kw, n_iter=n_iter, n_sub=n_sub, refine=3, fir_phases=101,
              probe_layout=probe_layout)
    span = kw["span"]
    jout = ptk.swarm_chain_pallas(
        ptk.pack_geometry(pts, SPM, channel_mask=mask),
        ptk.bandpass_smaj_window(jnp.asarray(pw), span),
        rows[0], rows[1], rows[8], rows[9], tuple(rows[2:6]), rows[10:13],
        rows[6], rows[7], rows[13:16], jumps[0], jumps[1], 3.0, reference,
        window_raw=ptk.smaj_window(jnp.asarray(pw), span),
        interpret=True, prefix_rows=prefix_rows, **kw,
    )
    jout = [np.asarray(x) for x in jout]
    pw_t = torch.as_tensor(pw)
    state, mean, beam = ctk.swarm_chain(
        ctk.pack_geometry(pts, SPM, channel_mask=mask, device="cpu"),
        ctk.bandpass_window(pw_t), pw_t, torch.as_tensor(rows),
        torch.as_tensor(jumps), torch.tensor(reference), block_index=3.0,
        **kw,
    )
    return rows, jout, state.numpy(), float(mean), beam.numpy()


def _assert_matches(rows, jout, state, mean, beam):
    np.testing.assert_array_equal(state[6], jout[6])       # tracking flags
    np.testing.assert_array_equal(state[7], jout[7])       # start stamps
    for i in range(6):                                     # continuous state
        np.testing.assert_allclose(state[i], jout[i], rtol=0, atol=1e-5)
    np.testing.assert_allclose(mean, jout[8], rtol=1e-5)
    want = jout[9][:T]
    np.testing.assert_allclose(beam, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("probe_layout,interp", [
    ("quadrant", "linear"),
    ("horizontal", "linear"),
    ("quadrant", "fir"),
    ("horizontal", "fir"),
])
def test_twin_matches_pallas_kernel(probe_layout, interp):
    rows, jout, state, mean, beam = _run_both(interp, probe_layout, 2, 3)
    _assert_matches(rows, jout, state, mean, beam)
    # Coverage of the boundary logic on the reference side: the younger of
    # the two coincident trackers merged away, and a free tracker promoted.
    trk = jout[6]
    assert not (trk[0] > 0.5 and trk[1] > 0.5)
    assert (jout[7][2:NT] == 3.0).any(), "promote never fired"


def test_twin_matches_pallas_kernel_prefix_rows_and_mask():
    """The deployment cadence (2 iterations x 5 sub-steps) with the TPU
    kernel's prefix-rows schedule and a dead channel: the twin, which
    computes every row and masks, gives the same state."""
    mask = np.ones(64, np.float32)
    mask[13] = 0.0
    _assert_matches(*_run_both("linear", "quadrant", 2, 5, prefix_rows=8,
                               seed=1, mask=mask))
