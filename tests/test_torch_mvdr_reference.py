"""The port's Capon / MVDR step (``models/mvdr.py``) against the benchmark's
plain float64 complex reference (``portbench/reference/estimators/mvdr.py``)
on the CPU: 16 mics, a 16 x 16 grid, one plane wave in seeded noise, 6
chained blocks at ``weight_refresh`` 1 and 4, each block followed by the
reference from the port's own state before it, as the benchmark's
``correct`` does.

The tolerances, and why:

- the spectrum, the largest gap over the reference's peak: 1e-3.  The
  port solves the loaded covariance's real embedding in float32, whose
  rounding the loading's condition number (~1e3 here) carries into ``v^H
  R^-1 v``: it reads up to ~1e-4; the reference one precision lower
  (TF32 operands) reads 3e-3 to 2 block by block;
- the covariance planes, over their peak: 1e-5.  The EMA of 7 frames'
  products differs from float64 by a few float32 ulps (~3e-7); TF32
  operands read ~2e-5 to 3e-4;
- the carried spectrum at refresh 4, over its peak: 1e-3, the spectrum's
  tolerance (a refresh block carries what it computed);
- the block count: equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from beamforming_lk_tpu_torch.config import ArrayConfig, MimoConfig  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.models import mvdr as mv  # noqa: E402
from beamforming_lk_tpu_torch.models.mimo import make_mimo_grid  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402
from portbench.reference.estimators import mvdr as ref  # noqa: E402
from portbench.reference.geometry import grid_directions  # noqa: E402

ACFG = ArrayConfig()
POINTS = np.asarray(ant.create_antenna_grid(4, 4, 0.02), np.float64)
GRID = dict(rows=16, columns=16, fov_degrees=180.0)
PIXEL = 150
#: 0.01 rad from grid pixel :data:`PIXEL`.
SOURCE = tuple(float(x[PIXEL]) for x in grid_directions(**GRID))
SOURCE = (SOURCE[0] + 0.01, SOURCE[1], 5000.0)
NOISE = 0.3                        # of the amplitude
N_BLOCKS = 6
TOLERANCE = {"spectrum": 1e-3, "cov_re": 1e-5, "cov_im": 1e-5, "powers": 1e-3}


def _cfg(refresh: int) -> dict:
    return {"array": {"sample_rate": ACFG.sample_rate,
                      "propagation_speed": ACFG.propagation_speed},
            "mimo": GRID, "pipeline": {"heatmap_mode": "mvdr",
                                       "mvdr_refresh": refresh}}


def _blocks(seed: int = 0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(plane_wave_block(POINTS, [SOURCE], b * 256, 256, ACFG,
                                             noise_std=NOISE, rng=rng))
            for b in range(N_BLOCKS)]


def _step(refresh: int, loading: float = 1e-3):
    theta, phi = make_mimo_grid(MimoConfig(**GRID))
    return mv.MvdrStep(POINTS.astype(np.float32), theta, phi, ACFG,
                       diagonal_loading=loading, weight_refresh=refresh, device="cpu")


def _rel(got, want) -> float:
    return float((got.double() - want).abs().max() / want.abs().max())


def _gaps(refresh: int, precision: str = "float64", loading: float = 1e-3,
          freeze_covariance: bool = False) -> dict:
    """The largest gap of each compared quantity over the chained blocks:
    the port (or, below float64, the reference at that precision) against
    the float64 reference, each block followed from the port's state."""
    step, cfg = _step(refresh, loading), _cfg(refresh)
    state, worst = step.init(), dict.fromkeys(TOLERANCE, 0.0)
    worst["count"] = 0
    for block in _blocks():
        before = state
        state, spectrum = step(state, block)
        if freeze_covariance:
            state = state._replace(cov_re=before.cov_re, cov_im=before.cov_im)
        got = state._asdict()
        if precision != "float64":
            spectrum, got = ref.follow(before._asdict(), block.double()[None],
                                       POINTS, cfg, precision)
        want_spectrum, want = ref.follow(before._asdict(), block.double()[None],
                                         POINTS, cfg, "float64")
        worst["spectrum"] = max(worst["spectrum"], _rel(spectrum, want_spectrum))
        for key in ("cov_re", "cov_im"):
            worst[key] = max(worst[key], _rel(got[key], want[key]))
        assert (got["powers"] is None) == (want["powers"] is None) == (refresh == 1)
        if refresh > 1:
            worst["powers"] = max(worst["powers"], _rel(got["powers"], want["powers"]))
        worst["count"] = max(worst["count"], abs(got["count"] - want["count"]))
    return worst


def _over(gaps: dict) -> list:
    return [key for key, tol in TOLERANCE.items() if gaps[key] > tol] + (
        ["count"] if gaps["count"] else [])


@pytest.mark.parametrize("refresh", [1, 4])
def test_the_port_follows_the_reference(refresh):
    gaps = _gaps(refresh)
    assert not _over(gaps), gaps


@pytest.mark.parametrize("refresh", [1, 4])
def test_the_reference_one_precision_lower_fails(refresh):
    gaps = _gaps(refresh, precision="tf32")
    assert _over(gaps), gaps


@pytest.mark.parametrize("fault", ["loading_doubled", "covariance_unchanged"])
def test_a_planted_fault_fails(fault):
    gaps = _gaps(1, loading=2e-3 if fault == "loading_doubled" else 1e-3,
                 freeze_covariance=fault == "covariance_unchanged")
    assert _over(gaps), gaps


def test_the_reference_peaks_at_the_source():
    """The reference works its tables out itself: its spectrum peaks on the
    grid pixel nearest the source."""
    step, cfg = _step(1), _cfg(1)
    state = step.init()
    for block in _blocks()[:-1]:
        state, _ = step(state, block)
    spectrum, _ = ref.follow(state._asdict(), _blocks()[-1].double()[None], POINTS,
                             cfg, "float64")
    assert int(torch.argmax(spectrum)) == PIXEL


def test_the_reference_carries_its_powers_between_refreshes():
    """At refresh 4 a block whose count is not a multiple of 4 hands on the
    state's powers untouched, and a refresh block computes them anew."""
    step, cfg = _step(4), _cfg(4)
    state = step.init()
    state, _ = step(state, _blocks()[0])
    spectrum, after = ref.follow(state._asdict(), _blocks()[1].double()[None], POINTS,
                                 cfg, "float64")
    assert spectrum is state.powers and after["powers"] is state.powers
    assert after["count"] == 2
    state = state._replace(count=4)
    spectrum, after = ref.follow(state._asdict(), _blocks()[1].double()[None], POINTS,
                                 cfg, "float64")
    assert spectrum.dtype == torch.float64 and after["powers"] is spectrum
