"""Fractional-delay delay-and-sum on tensors
(counterpart of ``beamforming_lk_tpu.ops.delay``).

    beam[d, t] = sum_c sum_k  W[d, c, k] * x[c, t + k]

``W`` is a per-direction stencil that is zero except for ``taps`` entries
per channel: linear interpolation puts ``[frac, 1-frac]`` at
``shift = (S - taps) - floor(tau)`` (the reference's backwards-interp
quirk, delay.cpp:16-26); the FIR mode puts a row of a windowed-sinc bank
there.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LINEAR_TAPS = 2

#: Integer sample delay of the polyphase FIR bank's centre tap.
FIR_DEFAULT_CENTER = 4.0


def probe_span(
    points,
    samples_per_meter: float,
    taps: int = LINEAR_TAPS,
    shift_range: int | None = None,
    multiple: int = 8,
) -> int:
    """Tightest stencil span covering every steering delay of the aperture:
    ``ceil(diameter * fs/c) + taps`` rounded up to ``multiple``, capped at
    ``shift_range`` (32 for one 8x8 array at 2 cm pitch, 64 for four)."""
    pts = np.asarray(points, np.float64)
    diameter = float(np.linalg.norm(pts.max(axis=1) - pts.min(axis=1)))
    span = int(math.ceil(diameter * samples_per_meter)) + taps
    span = ((span + multiple - 1) // multiple) * multiple
    if shift_range is not None:
        span = min(span, shift_range)
    return span


def fractional_delay_fir_bank(
    phases: int = 101, taps: int = 8, center: float = FIR_DEFAULT_CENTER
) -> np.ndarray:
    """Blackman-windowed sinc fractional-delay bank [phases, taps]; phase p
    reconstructs ``x(n + center - p/(phases-1))``, unit DC gain."""
    fracs = np.arange(phases, dtype=np.float64) / (phases - 1)
    j = np.arange(taps, dtype=np.float64)[None, :]
    d = (center - fracs)[:, None]
    h = np.sinc(j - d) * np.blackman(taps)[None, :]
    h /= h.sum(axis=1, keepdims=True)
    return h.astype(np.float32)


def delay_lut(delays, shift_range: int, taps: int):
    """Delays in samples -> (integer shift, fraction), with
    ``shift = (S - taps) - floor(tau)`` after clamping tau to [0, S - taps]."""
    delays = torch.clamp(
        torch.as_tensor(delays, dtype=torch.float32), 0.0,
        float(shift_range - taps),
    )
    whole = torch.floor(delays)
    frac = delays - whole
    shift = (shift_range - taps) - whole.to(torch.int32)
    return shift, frac


def interp_weights(fractions, mode: str = "linear", fir_bank=None):
    """Per-delay stencil [..., taps]: ``[f, 1-f]`` or the FIR bank row at
    the quantized fraction (round half to even, as ``jnp.round``)."""
    f = torch.as_tensor(fractions, dtype=torch.float32)
    if mode == "linear":
        return torch.stack([f, 1.0 - f], dim=-1)
    if mode == "fir":
        bank = torch.as_tensor(fir_bank, dtype=torch.float32, device=f.device)
        idx = torch.round(f * (bank.shape[0] - 1)).to(torch.long)
        return bank[idx]
    raise ValueError(f"unknown interp mode: {mode}")


def das_weights(delays, shift_range: int, mode: str = "linear", fir_bank=None):
    """Dense DAS stencil W[..., C, S] from delays [..., C]."""
    if mode == "linear":
        shift, frac = delay_lut(delays, shift_range, LINEAR_TAPS)
        k = torch.arange(shift_range, dtype=torch.float32, device=frac.device)
        # delta is an exact small float; subtracting (1 - f) there keeps the
        # taps bit-equal to [f, 1-f] (the unit triangle hat at shift+1-f).
        delta = k - shift.to(torch.float32)[..., None]
        return torch.clamp(
            1.0 - torch.abs(delta - (1.0 - frac[..., None])), min=0.0
        )
    taps = int(np.shape(fir_bank)[-1])
    shift, frac = delay_lut(delays, shift_range, taps)
    w = interp_weights(frac, mode, fir_bank)                 # [..., C, taps]
    k = torch.arange(shift_range, device=frac.device)
    j = torch.arange(taps, device=frac.device)[:, None]
    onehot = (k == shift[..., None, None] + j).to(w.dtype)   # [..., C, taps, S]
    return torch.einsum("...ct,...cts->...cs", w, onehot)


def das_weights_np(delays, shift_range: int, mode: str = "linear", fir_bank=None):
    """Host (numpy) builder of the same stencil as :func:`das_weights`."""
    taps = LINEAR_TAPS if mode == "linear" else int(np.shape(fir_bank)[-1])
    delays = np.clip(np.asarray(delays, np.float64), 0.0, float(shift_range - taps))
    whole = np.floor(delays)
    frac = (delays - whole).astype(np.float32)
    shift = (shift_range - taps) - whole.astype(np.int64)
    if mode == "linear":
        w = np.stack([frac, 1.0 - frac], axis=-1)
    elif mode == "fir":
        bank = np.asarray(fir_bank, np.float32)
        idx = np.round(frac * (bank.shape[0] - 1)).astype(np.int64)
        w = bank[idx]
    else:
        raise ValueError(f"unknown interp mode: {mode}")
    out = np.zeros(delays.shape + (shift_range,), np.float32)
    np.put_along_axis(out, shift[..., None] + np.arange(taps), w, axis=-1)
    return out


def unfold_window(window, shift_range: int, block_size: int):
    """x[C, T + S] -> X[C, S, T] with X[c, k, t] = x[c, t + k] (a strided
    view; no copy)."""
    return window.unfold(-1, block_size, 1)[..., :shift_range, :]


def das_beam_unfolded(unf, weights):
    """beam[..., D, T] = W[..., D, C, S] contracted with ``unf[C, S, T]``,
    accumulated in float32."""
    return torch.einsum(
        "...dcs,cst->...dt", weights.to(torch.float32), unf.to(torch.float32)
    )


def das_beam(window, weights):
    """beam[..., D, T] of a window [C, T + S] through a dense stencil
    ``weights`` [..., D, C, S]: one [D, C*S] by [C*S, T] product of the
    unfolded window, in float32 (the JAX package's dense ``das_beam``; the
    heatmap's hand-written kernel is ``ops.cuda_das.das_beam``)."""
    s = weights.shape[-1]
    return das_beam_unfolded(
        unfold_window(window, s, window.shape[-1] - s), weights
    )


def bandpass_ma(beam):
    """3-tap bandpass ``0.5*y[t] - 0.25*(y[t-1] + y[t+1])`` on interior
    samples: [..., T] -> [..., T-2] (mimo.cpp:131-137)."""
    return 0.5 * beam[..., 1:-1] - 0.25 * (beam[..., 2:] + beam[..., :-2])


def das_power(beam, *, use_bandpass: bool = True, divisor=None):
    """Mean beam power over the time axis, optionally band-passed first."""
    if divisor is None:
        divisor = beam.shape[-1]
    y = bandpass_ma(beam) if use_bandpass else beam
    return torch.sum(y * y, dim=-1) / float(divisor)


def das_power_from_delays(window, delays, *, shift_range: int,
                          mode: str = "linear", fir_bank=None,
                          channel_mask=None, use_bandpass: bool = True):
    """Delays [..., D, C] -> powers [..., D] through the dense stencil,
    normalized by ``T * n_active`` as in the MIMO worker; ``channel_mask``
    [C] zeroes dead or hot channels (the reference compacts an index list,
    aw_processing_unit.cpp:193-199)."""
    w = das_weights(delays, shift_range, mode, fir_bank)
    if channel_mask is not None:
        mask = torch.as_tensor(channel_mask, dtype=w.dtype, device=w.device)
        w = w * mask[..., :, None]
        count = float(mask.sum())
    else:
        count = float(w.shape[-2])
    beam = das_beam(window, w)
    return das_power(beam, use_bandpass=use_bandpass,
                     divisor=beam.shape[-1] * count)
