"""The port's wideband MUSIC (``models/music.py``, the subspace solver)
against the benchmark's plain float64 reference
(``portbench/reference/estimators/music.py``) on the CPU: 16 mics, a 16 x
16 grid, K = 2 and 3, one plane wave in seeded noise, 6 chained blocks,
each followed by the reference from the port's own state before it, as the
benchmark's ``correct`` does.

The tolerances, and why:

- the spectrum, the largest gap over the reference's peak: 1e-4.  The
  port's float32 steering table (from float32 positions) puts it at ~2e-6
  here; the complement ``||v||^2 - ||Es^T v||^2``, which cancels near a
  peak, read ~3e-4 with the source this near a grid pixel; computing one
  precision lower (TF32) reads ~8e-3;
- the covariance planes, over their peak: 1e-5.  The EMA of 7 frames'
  products differs from float64 by a few float32 ulps (~2e-7); TF32
  operands read ~3e-4;
- the basis through its projector ``Q Q^T`` (a basis is free up to a
  rotation of its columns), over its peak: 1e-3.  Two rounds of multiply
  and QR in float32 read ~1e-5 at this noise; the rounding of the weak
  columns grows with a bin's signal-to-noise ratio (float32 eps times the
  ratio of its strongest eigenvalue to the noise's), so the noise is 0.3 of
  the amplitude, where that ratio is ~1e3; TF32 reads 0.03-0.13;
- the block count: equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from beamforming_lk_tpu_torch.config import ArrayConfig, MimoConfig  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.models import music as mu  # noqa: E402
from beamforming_lk_tpu_torch.models.mimo import make_mimo_grid  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402
from portbench.reference.estimators import music as ref  # noqa: E402
from portbench.reference.geometry import grid_directions  # noqa: E402

ACFG = ArrayConfig()
POINTS = np.asarray(ant.create_antenna_grid(4, 4, 0.02), np.float64)
GRID = dict(rows=16, columns=16, fov_degrees=180.0)
PIXEL = 150
#: 0.01 rad from grid pixel :data:`PIXEL`, where the spectrum's denominator
#: is small.
SOURCE = tuple(float(x[PIXEL]) for x in grid_directions(**GRID))
SOURCE = (SOURCE[0] + 0.01, SOURCE[1], 5000.0)
NOISE = 0.3                        # of the amplitude
N_BLOCKS = 6
TOLERANCE = {"spectrum": 1e-4, "cov_re": 1e-5, "cov_im": 1e-5, "basis": 1e-3}


def _cfg(k: int) -> dict:
    return {"array": {"sample_rate": ACFG.sample_rate,
                      "propagation_speed": ACFG.propagation_speed},
            "mimo": GRID, "pipeline": {"heatmap_mode": "music",
                                       "music_solver": "subspace",
                                       "music_sources": k}}


def _blocks(seed: int = 0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(plane_wave_block(POINTS, [SOURCE], b * 256, 256, ACFG,
                                             noise_std=NOISE, rng=rng))
            for b in range(N_BLOCKS)]


def _step(k: int, solver: str = "subspace", subspace_iters: int = 2):
    theta, phi = make_mimo_grid(MimoConfig(**GRID))
    return mu.MusicStep(POINTS.astype(np.float32), theta, phi, ACFG, n_sources=k,
                        solver=solver, subspace_iters=subspace_iters, device="cpu")


def _rel(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def _gaps(k: int, precision: str = "float64", subspace_iters: int = 2,
          freeze_covariance: bool = False) -> dict:
    """The largest gap of each compared quantity over the chained blocks:
    the port (or, below float64, the reference at that precision) against
    the float64 reference, each block followed from the port's state."""
    step, cfg = _step(k, subspace_iters=subspace_iters), _cfg(k)
    state, worst = step.init(), dict.fromkeys(TOLERANCE, 0.0)
    worst["count"] = 0
    for block in _blocks():
        before = state
        state, spectrum = step(state, block)
        if freeze_covariance:
            state = state._replace(cov_re=before.cov_re, cov_im=before.cov_im)
        got = ref.comparable(state._asdict())
        if precision != "float64":
            spectrum, after = ref.follow(before._asdict(), block.double()[None],
                                         POINTS, cfg, precision)
            got = ref.comparable(after)
        want_spectrum, want = ref.follow(before._asdict(), block.double()[None],
                                         POINTS, cfg, "float64")
        want = ref.comparable(want)
        worst["spectrum"] = max(worst["spectrum"], _rel(spectrum, want_spectrum))
        for key in ("cov_re", "cov_im", "basis"):
            worst[key] = max(worst[key], _rel(got[key], want[key]))
        worst["count"] = max(worst["count"], abs(got["count"] - want["count"]))
    return worst


def _over(gaps: dict) -> list:
    return [key for key, tol in TOLERANCE.items() if gaps[key] > tol] + (
        ["count"] if gaps["count"] else [])


@pytest.mark.parametrize("k", [2, 3])
def test_the_port_follows_the_reference(k):
    gaps = _gaps(k)
    assert not _over(gaps), gaps


@pytest.mark.parametrize("k", [2, 3])
def test_the_reference_one_precision_lower_fails(k):
    gaps = _gaps(k, precision="tf32")
    assert _over(gaps), gaps


@pytest.mark.parametrize("fault", ["one_round", "covariance_unchanged"])
def test_a_planted_fault_fails(fault):
    gaps = _gaps(3, subspace_iters=1 if fault == "one_round" else 2,
                 freeze_covariance=fault == "covariance_unchanged")
    assert _over(gaps), gaps


def test_the_reference_peaks_at_the_source():
    """The reference works its tables out itself: its spectrum peaks on the
    grid pixel nearest the source."""
    step, cfg = _step(3), _cfg(3)
    state = step.init()
    for block in _blocks()[:-1]:
        state, _ = step(state, block)
    spectrum, _ = ref.follow(state._asdict(), _blocks()[-1].double()[None], POINTS,
                             cfg, "float64")
    assert int(torch.argmax(spectrum)) == PIXEL


@pytest.mark.parametrize("solver", ["subspace", "eigh"])
def test_qr_rounds_counts_the_orthogonal_iteration(solver):
    step = _step(3, solver=solver)
    state = step.init()
    want = []
    for block in _blocks()[:4]:
        state, _ = step(state, block)
        want.append(step.qr_rounds)
    assert want == ([8, 10, 12, 14] if solver == "subspace" else [0, 0, 0, 0])


def test_the_reference_follows_the_subspace_solver_only():
    state = _step(3).init()
    cfg = _cfg(3)
    cfg["pipeline"]["music_solver"] = "eigh"
    with pytest.raises(ValueError, match="subspace solver only"):
        ref.follow(state._asdict(), _blocks()[0].double()[None], POINTS, cfg, "float64")
