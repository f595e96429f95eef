"""Filter design: fractional-delay + bandpass FIR banks.

SciPy port of the reference's offline MATLAB designer
(``math_toolbox/filter_produce.m``): per frequency band, a hamming-window
``fir1`` bandpass prototype is convolved with a blackman-windowed-sinc
fractional delay and normalized to unit peak gain — giving one
``[phases, taps]`` polyphase bank per band whose rows both delay by a
fraction of a sample AND band-limit.  The shipped C++ coefficients
(``src/dsp/filter.h``) came from that script; here the designer is part of
the framework, so banks regenerate for any sample rate / band / tap budget
and feed straight into the DAS kernels (``fir_bank`` argument).

A copy of ``beamforming_lk_tpu.ops.filters`` (numpy, SciPy and the
standard library), kept in the port so that the port loads no module of
the JAX package.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
from scipy import signal

#: The reference's seven bands of interest in Hz
#: (filter_produce.m lines 13-21).
REFERENCE_BANDS: Tuple[Tuple[float, float], ...] = (
    (6375.0, 9000.0),
    (3541.0, 6375.0),
    (1950.0, 3541.0),
    (956.0, 1950.0),
    (779.0, 956.0),
    (657.0, 779.0),
    (550.0, 657.0),
)

#: Normalized band-edge tweaks the reference applies per band
#: (filter_produce.m lines 24-80, "bands_optimized").
_BAND_TWEAKS = (
    (+0.068, 0.0),
    (-0.059, 0.0),
    (-0.001, +0.0075),
    (0.0, -0.01),
    (0.0, 0.0),
    (0.0, 0.0),
    (0.0, 0.0),
)

#: Per-band (bandpass_order, sinc_half_width) — getCoeffsMode1..57
#: (filter_produce.m lines 104-199).
_BAND_MODES = ((20, 18), (28, 14), (36, 10), (44, 6), (44, 6), (44, 6), (44, 6))

SAMPLE_RATE = 48828.125  # filter_produce.m line 6


def windowed_sinc_delay(half_width: int, delay: float, cutoff: float = 1.0):
    """Blackman-windowed sinc fractional-delay filter, ``2*half_width + 1``
    taps delaying by ``half_width + delay`` samples (getCoeffs,
    filter_produce.m lines 88-100).  ``cutoff`` is normalized to Nyquist."""
    n = np.arange(-half_width, half_width + 1, dtype=np.float64)
    w = np.blackman(2 * half_width + 1)
    # sin(wc (n - d)) / (pi (n - d)) with wc = pi * cutoff
    x = n - delay
    h = w * cutoff * np.sinc(cutoff * x)
    return h


def bandpass_fractional_bank(
    band: Tuple[float, float],
    phases: int = 101,
    bandpass_order: int = 20,
    sinc_half_width: int = 18,
    sample_rate: float = SAMPLE_RATE,
    tweak: Tuple[float, float] = (0.0, 0.0),
) -> np.ndarray:
    """[phases, taps] bank: rows delay by p/(phases-1) of a sample AND
    band-limit to ``band`` (getCoeffsMode*, filter_produce.m).

    taps = bandpass_order + 2*sinc_half_width + 1.  Peak-gain normalized so
    in-band signals pass at unit gain.
    """
    nyq = sample_rate / 2.0
    lo = band[0] / nyq + tweak[0]
    hi = band[1] / nyq + tweak[1]
    # MATLAB fir1(N, ...) returns N+1 taps with hamming window.
    bp = signal.firwin(
        bandpass_order + 1, [lo, hi], pass_zero=False, window="hamming"
    )
    rows = []
    for p in range(phases):
        frac = p / (phases - 1)
        sd = windowed_sinc_delay(sinc_half_width, frac)
        h = np.convolve(bp, sd)
        _, resp = signal.freqz(h, 1, worN=4096)
        h = h / np.abs(resp).max()
        rows.append(h)
    return np.asarray(rows, np.float32)


@functools.lru_cache(maxsize=None)
def reference_band_banks(phases: int = 101) -> Dict[int, np.ndarray]:
    """All seven reference bands -> their polyphase banks
    (the full filter_produce.m output)."""
    out = {}
    for i, (band, tweak, (order, half)) in enumerate(
        zip(REFERENCE_BANDS, _BAND_TWEAKS, _BAND_MODES)
    ):
        out[i] = bandpass_fractional_bank(
            band, phases, order, half, tweak=tweak
        )
    return out


def bank_group_delay(bank: np.ndarray, sample_rate: float = SAMPLE_RATE):
    """Mean in-band group delay per phase [phases] — for verifying that
    phase p delays ~(constant + p/(phases-1)) samples."""
    phases, taps = bank.shape
    out = np.zeros(phases)
    for p in range(phases):
        w, gd = signal.group_delay((bank[p], 1), w=512)
        mid = slice(len(gd) // 4, len(gd) // 2)
        out[p] = float(np.mean(gd[mid]))
    return out
