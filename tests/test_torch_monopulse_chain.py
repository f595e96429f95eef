"""The monopulse-chain kernel's plain twin (ops/cuda_tracker.py
``monopulse_chain``) against the JAX package: its Pallas kernel
``monopulse_chain_pallas`` in interpret mode and the chain of its XLA
``_monopulse_step``, on identical numpy inputs (64 mics, 27 rows, random
per-sub-step masks, dead channels, rows at the field-of-view edge).  The
CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against this twin there."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from beamforming_lk_tpu.models import tracker as jtk  # noqa: E402
from beamforming_lk_tpu.ops import delay as jdl  # noqa: E402
from beamforming_lk_tpu.ops import pallas_tracker as ptk  # noqa: E402
from beamforming_lk_tpu_torch.config import ArrayConfig, DspConfig, TrackerConfig  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402
from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk  # noqa: E402
from beamforming_lk_tpu_torch.ops import delay as dl  # noqa: E402

SPM = ArrayConfig().samples_per_meter
PTS = ant.create_antenna_grid(8, 8, 0.02)
P = 27


def _setup(seed, interp="linear"):
    """A random window [64, S+T], the probe span, rows at random directions
    (four near the edges of the field of view) with random dynamics, and a
    mask with two dead channels."""
    dsp, tc = DspConfig(), TrackerConfig()
    taps = dl.LINEAR_TAPS if interp == "linear" else dsp.fir_taps
    span = dl.probe_span(PTS, SPM, taps, dsp.shift_range)
    rng = np.random.default_rng(seed)
    window = rng.standard_normal((64, dsp.shift_range + dsp.block_size)).astype(np.float32)
    pw = window[:, dsp.shift_range - span:]
    theta = np.concatenate([rng.uniform(0.05, 1.4, P - 4), [1.5, 1.55, 1.48, 0.01]])
    rows = np.zeros((8, P), np.float32)
    rows[0], rows[1] = theta, rng.uniform(0.0, 6.28, P)
    rows[6] = rng.uniform(1e-4, 5e-4, P)
    rows[7] = rng.uniform(0.02, 0.13, P)
    mask = np.ones(64, np.float32)
    mask[[7, 30]] = 0.0
    kw = dict(span=span, taps=taps, theta_limit=tc.theta_limit,
              divisor=float(dsp.block_size), interp=interp)
    return pw, rows, mask, kw, rng


def _twin(pw, rows, act, mask, kw, probe_layout="quadrant"):
    pw_t = torch.as_tensor(np.ascontiguousarray(pw))
    return ctk.monopulse_chain(
        ctk.pack_geometry(PTS, SPM, channel_mask=mask, device="cpu"),
        ctk.bandpass_window(pw_t),
        torch.as_tensor(rows), torch.as_tensor(act.astype(np.float32)),
        probe_layout=probe_layout, **kw,
    ).numpy()


@pytest.mark.parametrize("probe_layout,interp", [
    ("quadrant", "linear"), ("horizontal", "linear"), ("quadrant", "fir"),
])
def test_twin_matches_pallas_chain_kernel(probe_layout, interp):
    """5 sub-steps with a random mask and a nonzero state0: every field
    within 1e-5 (the twin and the TPU kernel share the Cartesian probe
    math; only the f32 summation order differs)."""
    pw, rows, mask, kw, rng = _setup(0, interp)
    rows[2:6] = rng.uniform(-0.5, 0.5, (4, P))
    act = rng.random((5, P)) > 0.3
    got = _twin(pw, rows, act, mask, kw, probe_layout)
    out = ptk.monopulse_chain_pallas(
        ptk.pack_geometry(PTS, SPM, channel_mask=mask),
        ptk.bandpass_smaj_window(jnp.asarray(pw), kw["span"]),
        rows[0], rows[1], rows[6], rows[7], jnp.asarray(act),
        state0=tuple(rows[2:6]), probe_layout=probe_layout, interpret=True, **kw,
    )
    np.testing.assert_allclose(got, np.stack([np.asarray(o) for o in out]),
                               rtol=0, atol=1e-5)


def test_twin_matches_xla_monopulse_chain():
    """Against the chain of the JAX package's XLA ``_monopulse_step`` (the
    bounds of test_pallas_tracker.py): one sub-step, positions within 1e-6
    (phi 1e-5) and gradients, radius and error within 1e-5 of their scale;
    5 sub-steps, positions within 1e-4 (phi 1e-3)."""
    pw, rows, mask, kw, rng = _setup(0)
    unf = jdl.unfold_window(jnp.asarray(pw), kw["span"], pw.shape[-1] - kw["span"])
    mono = functools.partial(
        jtk._monopulse_step, window=None, points=jnp.asarray(PTS),
        channel_mask=jnp.asarray(mask), theta_limit=kw["theta_limit"],
        shift_range=64, mode="linear", fir_bank=None, samples_per_meter=SPM,
        unfolded=unf)
    for n_sub, atol_pos, atol_grad in ((1, 1e-6, 1e-5), (5, 1e-4, None)):
        act = rng.random((n_sub, P)) > 0.3
        z = jnp.zeros(P, jnp.float32)
        pr = jtk.Particles(jnp.asarray(rows[0]), jnp.asarray(rows[1]), z, z, z, z)
        for i in range(n_sub):
            pr = mono(pr, jnp.asarray(act[i]), rate=jnp.asarray(rows[6]),
                      spread=jnp.asarray(rows[7]))
        got = _twin(pw, rows, act, mask, kw)
        np.testing.assert_allclose(got[0], np.asarray(pr.theta), atol=atol_pos)
        np.testing.assert_allclose(got[1], np.asarray(pr.phi), atol=atol_pos * 10)
        if atol_grad is not None:
            for g, want in zip(got[2:], pr[2:]):
                want = np.asarray(want)
                np.testing.assert_allclose(
                    g, want, atol=atol_grad * max(1.0, float(np.abs(want).max())))


def test_twin_passes_state0_through_never_active_rows():
    pw, rows, mask, kw, _ = _setup(1)
    rows[2:6] = np.array([0.1, 0.2, 0.3, 0.4], np.float32)[:, None]
    act = np.zeros((3, P), bool)
    act[:, :4] = True                               # rows 4.. never active
    got = _twin(pw, rows, act, mask, kw)
    np.testing.assert_array_equal(got[:, 4:], rows[:6, 4:])
    assert not np.array_equal(got[:, :4], rows[:6, :4])


def _split(split):
    """Row groups of P = 27 rows laid out trackers (10) | listener | seekers
    (16): trackers | listener and seekers, the rows the swarm kernels'
    cluster deals to each CTA, r mod N, or the monopulse-chain kernel's
    one row a CTA (r mod P)."""
    if split == "trackers|seekers":
        return [np.arange(10), np.arange(10, P)]
    n = P if split == "one row a CTA" else int(split.split()[-1])
    return [np.arange(cta, P, n) for cta in range(n)]


@pytest.mark.parametrize("interp", ["linear", "fir"])
@pytest.mark.parametrize("split", ["trackers|seekers", "r mod 8", "r mod 16",
                                   "one row a CTA"])
def test_rows_are_independent(split, interp):
    """A row's sub-step reads only its own state and the window, so any
    split of the rows gives the same numbers.  Three splits rest on it: the
    unfused swarm step runs the seekers' step in sub-step 0 of the
    trackers' chain (the JAX package steps them after it), the swarm
    kernels' cluster runs row r's sub-steps of an iteration on CTA r mod N
    with no barrier between CTAs, and the monopulse-chain kernel runs each
    row's whole chain on a CTA of its own.  Trackers step in all 5
    sub-steps, the listener in the first 3 (its refine budget), seekers in
    sub-step 0; each group of rows run alone gives exactly those rows of
    the run on all of them."""
    pw, rows, mask, kw, _ = _setup(2, interp)
    act = np.zeros((5, P), bool)
    act[:, :10] = True
    act[:3, 10] = True
    act[0, 11:] = True
    together = _twin(pw, rows, act, mask, kw)
    for idx in _split(split):
        alone = _twin(pw, np.ascontiguousarray(rows[:, idx]),
                      np.ascontiguousarray(act[:, idx]), mask, kw)
        np.testing.assert_array_equal(alone, together[:, idx])


def test_listener_refine_chain():
    """P = 1 with 3 sub-steps (the MISO step's launch) against the JAX
    kernel, within 1e-5."""
    pw, rows, mask, kw, _ = _setup(3)
    one = np.ascontiguousarray(rows[:, :1])
    act = np.ones((3, 1), bool)
    got = _twin(pw, one, act, mask, kw)
    out = ptk.monopulse_chain_pallas(
        ptk.pack_geometry(PTS, SPM, channel_mask=mask),
        ptk.bandpass_smaj_window(jnp.asarray(pw), kw["span"]),
        one[0], one[1], one[6], one[7], jnp.asarray(act), interpret=True, **kw)
    np.testing.assert_allclose(got, np.stack([np.asarray(o) for o in out]),
                               rtol=0, atol=1e-5)


def _probe_stencils(pw, rows, mask, kw):
    """The bandpassed window [C, span+n_out] and the stencils (shift
    [4R, C], weights [4R, C, taps]) of the 4 probes around every row, as
    the twin builds them."""
    k = ctk._consts("quadrant", kw["taps"], kw["theta_limit"])
    rt = torch.as_tensor(rows)
    ux, uy, uz = ctk._probe_dirs(rt[0], rt[1], rt[7], k)
    shift, w = ctk._stencil(
        ux.reshape(-1), uy.reshape(-1), uz.reshape(-1),
        ctk.pack_geometry(PTS, SPM, channel_mask=mask, device="cpu"),
        kw["span"], kw["taps"],
        kw["interp"], DspConfig().fir_phases, k["blackman"])
    return ctk.bandpass_window(torch.as_tensor(np.ascontiguousarray(pw))), shift, w


def _beam_samples(win, shift, w, n):
    """beam[r, t] for t < n from a window whose column 0 is sample 0,
    summed channel by channel then tap by tap (the kernel's order, one
    sample at a time): each sample depends only on its own columns."""
    beam = torch.zeros((shift.shape[0], n), dtype=torch.float32)
    cols = torch.arange(n)
    for c in range(win.shape[0]):
        for j in range(w.shape[-1]):
            x = win[c][shift[:, c, None] + j + cols]
            beam = beam + w[:, c, j, None] * x
    return beam


@pytest.mark.parametrize("interp", ["linear", "fir"])
def test_probe_beam_over_sample_segments(interp):
    """The chain kernel splits a probe beam's n_out = T - 2 samples over
    the probe's warps by time: 64-sample segments, each read from the
    n + span - 1 window columns that start at its first sample.  The
    segments, each computed from its own columns alone, concatenate to the
    whole beam bit for bit (so the column offsets shift + j + t are right
    at every segment edge), and the whole beam is the twin's gather
    (within 1e-5 of the peak: the two sum in other orders).  The
    power reduced in the kernel's lane order (lane l sums samples l + 32 i
    in i order, then the xor butterfly of warp_sum) agrees with the twin's
    power to within f32 rounding of n_out terms."""
    pw, rows, mask, kw, _ = _setup(4, interp)
    win, shift, w = _probe_stencils(pw, rows[:, :6], mask, kw)
    span, n_out = kw["span"], win.shape[1] - kw["span"]
    whole = _beam_samples(win, shift, w, n_out)
    seg = ctk.CHAIN_SEGMENT
    parts = [_beam_samples(win[:, t0:min(t0 + seg, n_out) + span - 1], shift, w,
                           min(seg, n_out - t0))
             for t0 in range(0, n_out, seg)]
    assert torch.equal(torch.cat(parts, dim=1), whole)
    torch.testing.assert_close(whole, ctk._gather_beams(win, shift, w, n_out),
                               rtol=1e-5, atol=1e-5 * float(whole.abs().max()))
    b = whole.numpy().astype(np.float32)
    lanes = np.zeros((b.shape[0], 32), np.float32)
    for t in range(n_out):
        lanes[:, t % 32] = lanes[:, t % 32] + b[:, t] * b[:, t]
    for o in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[:, np.arange(32) ^ o]
    assert np.all(lanes == lanes[:, :1])            # every lane holds the sum
    twin = (whole * whole).sum(dim=1).numpy()
    np.testing.assert_allclose(lanes[:, 0], twin,
                               rtol=n_out * np.finfo(np.float32).eps)


@pytest.mark.parametrize("interp", ["linear", "fir"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("channels", [64, 256])
def test_chain_launch_plan(channels, compute, interp):
    """The chain kernel's launch plan at the deployment shapes: one CTA of
    512 threads per row (26 rows of the tracker's call, 1 of the MISO
    step), 4 warps a probe, the window staged whole in each CTA's shared
    memory except the f32 window at 256 mics (325 KB), read from L2; every
    plan within the 227 KB a block can use."""
    dsp = DspConfig()
    pts = ant.multi_array_cluster(channels)
    taps = dl.LINEAR_TAPS if interp == "linear" else dsp.fir_taps
    span = dl.probe_span(pts, SPM, taps, dsp.shift_range)
    elem = 4 if compute == "float32" else 2
    for rows in (26, 1):
        plan = ctk.monopulse_chain_plan(channels, rows, dsp.block_size, span,
                                        taps, elem)
        assert plan["grid"] == rows and plan["threads"] == 512
        assert plan["warps_per_probe"] == 4
        assert plan["window_bytes"] >= channels * (span + dsp.block_size - 2) * elem
        assert plan["staged"] == (channels == 64 or compute == "bfloat16")
        assert plan["smem_bytes"] <= ctk.MAX_SMEM == 232448
        assert plan["smem_bytes"] - plan["staged"] * plan["window_bytes"] >= (
            4 * channels * (taps + 1) * 4 + 4 * (dsp.block_size - 2) * 4)
