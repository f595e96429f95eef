"""The port's wideband MUSIC (``models/music.py``) against the JAX
package's on the CPU, for both solvers: one and 10 chained steps, the
model-order and solver errors, the carried basis; the JAX package's own
MUSIC cases on the port; and ``AwpuPipeline(heatmap_mode="music")``
against the JAX pipeline, with the converter starting both from one
mid-run state.

What is held, and why.  A basis is defined up to a rotation inside its
subspace (QR and eigenvector signs), and with K above the true source
count the eigh split falls inside the noise floor, where the subspaces are
not defined at all; the subspace solver's denominator ``||v||^2 -
||Es^T v||^2`` also cancels at the peaks down to its 2C eps floor.  So
MUSIC is held by what is invariant: the covariance planes (1e-5 relative,
1e-6 of the largest entry absolute: another summation order); the
eigenvalues or Rayleigh quotients (1e-4 of the bin's largest); the signal
projector ``Q Q^T`` of each bin whose split is clear (a 10x eigenvalue
gap: 1e-3 absolute on a projector of norm 1); the argmax cell; the
spectra's correlation (> 0.9999); and their log10 away from the 4 top
cells (within 1e-3 decades).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from beamforming_lk_tpu import config as jcfg  # noqa: E402
from beamforming_lk_tpu.app import AwpuPipeline as JaxPipeline  # noqa: E402
from beamforming_lk_tpu.models import music as jmu  # noqa: E402
from beamforming_lk_tpu.models import mvdr as jmv  # noqa: E402
from beamforming_lk_tpu_torch import config as tcfg  # noqa: E402
from beamforming_lk_tpu_torch import convert  # noqa: E402
from beamforming_lk_tpu_torch.app import AwpuPipeline  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.models import music as mu  # noqa: E402
from beamforming_lk_tpu_torch.models import mvdr as mv  # noqa: E402
from beamforming_lk_tpu_torch.models.mimo import make_mimo_grid  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402

ACFG = tcfg.ArrayConfig()
PTS = ant.create_antenna_grid(8, 8, 0.02)
TWO = [(math.radians(20.0), math.radians(45.0), 4000.0),
       (math.radians(35.0), math.radians(200.0), 6500.0)]
SOLVERS = ["subspace", "eigh"]


def _grid(n, fov=120.0):
    return make_mimo_grid(tcfg.MimoConfig(rows=n, columns=n, fov_degrees=fov))


def _blocks(n, sources=TWO, noise=0.02, seed=0, points=PTS):
    rng = np.random.default_rng(seed)
    return [plane_wave_block(points, list(sources), b * 256, 256, ACFG,
                             noise_std=noise, rng=rng) for b in range(n)]


def _steps(solver, grid=16, **kw):
    theta, phi = _grid(grid)
    kw = dict(n_sources=2, solver=solver, **kw)
    jstep, n = jmu.make_music_step(PTS, theta, phi, jcfg.ArrayConfig(), **kw)
    step, n2 = mu.make_music_step(PTS, theta, phi, ACFG, device="cpu", **kw)
    assert n == n2 == step.n_bins
    return jstep, step


def _hold_spectrum(got, want, what=""):
    got, want = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all() and got.argmax() == want.argmax(), what
    assert np.corrcoef(got, want)[0, 1] > 0.9999, what
    rest = np.argsort(want)[:-4]
    assert np.abs(np.log10(got[rest]) - np.log10(want[rest])).max() < 1e-3, what


def _embedding(state):
    return (mv.hermitian_embed(state.cov_re, state.cov_im).numpy()
            if isinstance(state.cov_re, torch.Tensor) else
            np.asarray(jmv.hermitian_embed(state.cov_re, state.cov_im)))


def _per_bin_close(got, want, rel=1e-4):
    err = np.abs(got - want).max(-1) / np.abs(want).max(-1)
    assert (err <= rel).all(), err


def _hold_subspaces(state, jstate, step):
    """The covariance, the sorted eigenvalues (eigh) or the Rayleigh
    quotients (subspace) and the signal projector of each clearly split
    bin."""
    for got, want in ((state.cov_re, jstate.cov_re), (state.cov_im, jstate.cov_im)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    assert state.count == int(jstate.count)
    m, jm = _embedding(state), _embedding(jstate)
    n_noise = step.n_noise
    vals = np.linalg.eigvalsh(jm.astype(np.float64))
    clear = vals[:, n_noise] > 10.0 * vals[:, n_noise - 1]
    if step.solver == "eigh":
        # Each package's own call on its own covariance.
        got_vals, got_vecs = torch.linalg.eigh(torch.as_tensor(m))
        want_vals, want_vecs = (np.asarray(x) for x in jnp.linalg.eigh(jnp.asarray(jm)))
        _per_bin_close(got_vals.numpy(), want_vals)
        q, jq = got_vecs[..., n_noise:].numpy(), want_vecs[..., n_noise:]
    else:
        q, jq = state.basis.numpy(), np.asarray(jstate.basis)
        rq = np.einsum("fak,fab,fbk->fk", q, m, q)
        jrq = np.einsum("fak,fab,fbk->fk", jq, jm, jq)
        _per_bin_close(np.sort(rq), np.sort(jrq))
    assert clear.sum() >= 2
    proj = np.einsum("fak,fbk->fab", q, q)[clear]
    jproj = np.einsum("fak,fbk->fab", jq, jq)[clear]
    np.testing.assert_allclose(proj, jproj, atol=1e-3)


@pytest.mark.parametrize("solver", SOLVERS)
def test_chained_steps_match_jax(solver):
    """One step (the subspace solver's 8 cold rounds), then 10 chained
    steps, held by the invariants after the first and the last block, the
    spectra after every block."""
    jstep, step = _steps(solver)
    jstate, state = jstep.init(), step.init()
    for i, blk in enumerate(_blocks(10)):
        jstate, want = jstep(jstate, jnp.asarray(blk))
        state, got = step(state, torch.as_tensor(blk))
        _hold_spectrum(got, want, f"{solver} block {i}")
        if i in (0, 9):
            _hold_subspaces(state, jstate, step)
    assert state.count == 10


def test_rejects_bad_model_order_and_solver():
    theta, phi = _grid(8)
    for k in (0, 64, -1):
        with pytest.raises(ValueError, match="n_sources"):
            mu.make_music_step(PTS, theta, phi, ACFG, n_sources=k, device="cpu")
    with pytest.raises(ValueError, match="solver"):
        mu.make_music_step(PTS, theta, phi, ACFG, solver="qr", device="cpu")


@pytest.mark.parametrize("solver", SOLVERS)
def test_carried_basis(solver):
    """The subspace solver carries an orthonormal [F, 2C, 2K] basis; eigh
    carries the initial one untouched."""
    _, step = _steps(solver)
    state = step.init()
    init = state.basis.clone()
    for blk in _blocks(3):
        state, _ = step(state, torch.as_tensor(blk))
    q = state.basis
    assert q.shape == (step.n_bins, 128, 4)
    if solver == "eigh":
        assert torch.equal(q, init)
    gram = (q.mT @ q).numpy()
    np.testing.assert_allclose(gram, np.broadcast_to(np.eye(4), gram.shape), atol=1e-5)


def test_scan_equals_stepwise():
    _, step = _steps("subspace", grid=8)
    blocks = np.stack(_blocks(4))
    s1 = step.init()
    for blk in blocks:
        s1, p1 = step(s1, torch.as_tensor(blk))
    s2, ps = step.scan(step.init(), blocks)
    assert torch.equal(ps[-1], p1) and torch.equal(s2.basis, s1.basis)


# The JAX package's own MUSIC cases (tests/test_music.py), on the port and
# on their inputs: every block's noise from a fresh default_rng(0).

def _run_music(sources, n_blocks=12, n_sources=3, grid=24, solver="subspace"):
    theta, phi = _grid(grid)
    step, _ = mu.make_music_step(PTS, theta, phi, ACFG, n_sources=n_sources,
                                 solver=solver, device="cpu")
    state = step.init()
    for b in range(n_blocks):
        blk = plane_wave_block(PTS, sources, b * 256, 256, ACFG, noise_std=0.02)
        state, pseudo = step(state, torch.as_tensor(blk))
    return pseudo.numpy(), theta, phi, state


def _deg(theta, phi, t, p):
    return math.degrees(math.acos(min(1.0, math.sin(theta) * math.sin(t)
                                      * math.cos(phi - p)
                                      + math.cos(theta) * math.cos(t))))


def test_music_resolves_two_sources():
    pseudo, theta, phi, _ = _run_music(TWO)
    assert np.isfinite(pseudo).all() and pseudo.max() > 0
    top = np.argsort(pseudo)[::-1][:24]
    errs = [min(_deg(theta[k], phi[k], s[0], s[1]) for k in top) for s in TWO]
    assert max(errs) < 8.0, errs


def test_music_pseudo_spectrum_is_peaky():
    src = (math.radians(25.0), math.radians(90.0), 5000.0)
    pseudo, theta, phi, _ = _run_music([src], n_sources=2)
    k = pseudo.argmax()
    assert _deg(theta[k], phi[k], src[0], src[1]) < 6.0
    assert pseudo.max() / np.median(pseudo) > 15.0


def test_music_subspace_solver_matches_eigh():
    p_sub, _, _, s_sub = _run_music(TWO, n_blocks=10, n_sources=2, grid=16)
    p_eig, _, _, s_eig = _run_music(TWO, n_blocks=10, n_sources=2, grid=16,
                                    solver="eigh")
    assert torch.allclose(s_sub.cov_re, s_eig.cov_re, rtol=1e-5, atol=1e-8)
    assert p_sub.argmax() == p_eig.argmax()
    assert np.corrcoef(p_sub, p_eig)[0, 1] > 0.99


def test_subspace_solver_tracks_moving_source():
    theta, phi = _grid(24)
    steps = {s: mu.make_music_step(PTS, theta, phi, ACFG, n_sources=2, solver=s,
                                   device="cpu")[0] for s in SOLVERS}
    states = {s: st.init() for s, st in steps.items()}
    errs = {s: [] for s in SOLVERS}
    for b in range(24):
        src = (0.42, 1.0 + 0.015 * b)
        blk = torch.as_tensor(plane_wave_block(PTS, [(*src, 5000.0)], b * 256, 256,
                                               ACFG, noise_std=0.03))
        for s, st in steps.items():
            states[s], p = st(states[s], blk)
            k = int(p.argmax())
            errs[s].append(_deg(theta[k], phi[k], *src))
    deltas = [abs(a - b) for a, b in zip(errs["subspace"], errs["eigh"])]
    assert max(deltas) < 0.5, deltas
    assert max(errs["subspace"][12:]) < 6.0


# The pipeline.

@pytest.mark.parametrize("solver", SOLVERS)
def test_pipeline_matches_jax(solver):
    """``AwpuPipeline(heatmap_mode="music")`` with the tracker and MISO off
    against the JAX pipeline (``test_music.py::test_music_pipeline_mode``
    and ``test_awpu.py::test_process_blocks_drives_mvdr_through_scan``):
    the spectra after 6 blocks, ``process_blocks`` bitwise equal to
    ``process_block``, and the rendered heatmaps.  K is the one source's
    count: a larger K puts the eigh split inside the noise floor, whose
    eigenvectors the two LAPACK calls pick differently (0.2% of the
    spectrum here)."""
    kw = dict(points=PTS, enable_tracker=False, enable_miso=False,
              heatmap_mode="music", music_solver=solver, music_sources=1)
    cfg = {m: m.Config(mimo=m.MimoConfig(rows=8, columns=8)) for m in (jcfg, tcfg)}
    blocks = _blocks(6, [(0.4, 1.0, 5000.0)])
    jpipe = JaxPipeline(cfg[jcfg], **kw)
    live = AwpuPipeline(cfg[tcfg], device="cpu", **kw)
    replay = AwpuPipeline(cfg[tcfg], device="cpu", **kw)
    assert live.heatmap().shape == (8, 8) and not live.heatmap().any()
    for blk in blocks:
        jpipe.process_block(blk)
        live.process_block(blk)
    replay.process_blocks(np.stack(blocks))
    _hold_spectrum(live._mvdr_powers, jpipe._mvdr_powers)
    assert torch.equal(replay._mvdr_powers, live._mvdr_powers)
    assert replay._mvdr_state.count == 6
    img, want = live.heatmap(), jpipe.heatmap()
    assert img.shape == (8, 8) and img.max() == 255
    assert np.unravel_index(img.argmax(), img.shape) == np.unravel_index(
        want.argmax(), want.shape)


@pytest.mark.parametrize("solver", SOLVERS)
def test_converted_mid_run_state_continues_as_jax(solver):
    """``convert.music_state_from_jax`` of a JAX state after 5 blocks starts
    the port (the carried basis included), and the next block agrees."""
    jstep, step = _steps(solver)
    blocks = _blocks(6)
    jstate = jstep.init()
    for blk in blocks[:5]:
        jstate, _ = jstep(jstate, jnp.asarray(blk))
    state = convert.music_state_from_jax(
        jmu.MusicState(*(np.asarray(x) for x in jstate)), device="cpu")
    assert state.count == 5 and isinstance(state.count, int)
    jstate, want = jstep(jstate, jnp.asarray(blocks[5]))
    state, got = step(state, torch.as_tensor(blocks[5]))
    _hold_spectrum(got, want)
    _hold_subspaces(state, jstate, step)
