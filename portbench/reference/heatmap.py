"""Heatmap powers of one window, in plain PyTorch float64.

Both heatmaps are delay-and-sum power maps over the 64x64 grid
(beamforming-lk ``src/dsp/mimo.cpp:97-151``): for each direction the
channels are delayed by their steering delay and summed, the beam is
band-passed with ``0.5 y[t] - 0.25 (y[t-1] + y[t+1])`` on its interior and
its power divided by ``T * channels``.  They differ in how a channel is
delayed:

- ``"dense"``: linear interpolation on the window, ``frac * x[t + s] +
  (1 - frac) * x[t + s + 1]`` with ``s = (S - 2) - floor(tau)`` (the
  upstream backwards-interpolation convention, delay.cpp:16-26);
- ``"fft"``: the band-limited circular delay of the whole window,
  ``x(t + (S - 2) + 1 - tau)`` taken through its DFT, and the grid's corner
  pixels showing the nearest pixel on the unit disc.

Operands are rounded to ``precision`` (:mod:`.precision`) before each
product, and the fft path's spectra and beams after each, as a product in
that precision writes them; sums run in float64.
"""

from __future__ import annotations

import torch

from portbench.reference import geometry as geo
from portbench.reference.precision import round_to

TAPS = 2           # linear interpolation's taps
_CHUNK = 128       # directions per product


def _power(beam, divisor: float):
    bp = 0.5 * beam[..., 1:-1] - 0.25 * (beam[..., 2:] + beam[..., :-2])
    return (bp * bp).sum(-1) / divisor


def dense_powers(window, points, cfg: dict, precision: str = "float64"):
    """Powers [D] of a window [C, T+S] through linear-interpolation DAS."""
    a, d, m = cfg["array"], cfg["dsp"], cfg["mimo"]
    s = d["shift_range"]
    c, t = window.shape[0], window.shape[1] - s
    dev = window.device
    theta, phi = geo.grid_directions(m["rows"], m["columns"], m["fov_degrees"])
    tau = geo.steering_delays(points, theta, phi,
                              a["sample_rate"] / a["propagation_speed"])
    tau = torch.as_tensor(tau, device=dev).clamp(0.0, float(s - TAPS))
    whole = torch.floor(tau)
    frac = round_to(tau - whole, precision)
    shift = (s - TAPS) - whole.to(torch.long)
    x = round_to(window.to(torch.float64), precision)
    unf = x.unfold(-1, t, 1)                              # [C, S+1, T]
    ch = torch.arange(c, device=dev)
    out = []
    for i in range(0, shift.shape[0], _CHUNK):
        sh, fr = shift[i:i + _CHUNK], frac[i:i + _CHUNK, :, None]
        beam = (fr * unf[ch, sh] + (1.0 - fr) * unf[ch, sh + 1]).sum(1)
        out.append(_power(beam, t * c))
    return torch.cat(out)


def _rounded(z, precision: str):
    return torch.complex(round_to(z.real, precision), round_to(z.imag, precision))


def fft_powers(window, points, cfg: dict, precision: str = "float64"):
    """Powers [D] of a window [C, L] (L = T+S) through the band-limited
    circular delay."""
    a, d, m = cfg["array"], cfg["dsp"], cfg["mimo"]
    s = d["shift_range"]
    c, n = window.shape
    t = n - s
    dev = window.device
    spm = a["sample_rate"] / a["propagation_speed"]
    ux, uy = geo.grid_axes(m["rows"], m["columns"], m["fov_degrees"])
    p = torch.as_tensor(points, dtype=torch.float64, device=dev)
    uxd = torch.as_tensor(ux, device=dev).repeat(len(uy))          # [D]
    uyd = torch.as_tensor(uy, device=dev).repeat_interleave(len(ux))
    raw = spm * (uxd[:, None] * p[0] - uyd[:, None] * p[1])       # [D, C]
    shift = (s - TAPS) + 1.0 - (raw - raw.amin(dim=1, keepdim=True))
    x = round_to(window.to(torch.float64), precision)
    spec = _rounded(torch.fft.rfft(x, dim=-1), precision)            # [C, F]
    f = torch.arange(spec.shape[-1], dtype=torch.float64, device=dev)
    out = []
    for i in range(0, shift.shape[0], _CHUNK):
        ang = 2.0 * torch.pi * shift[i:i + _CHUNK, :, None] * f / n
        steer = torch.complex(round_to(torch.cos(ang), precision),
                              round_to(torch.sin(ang), precision))
        spectra = (steer * spec).sum(1)                             # [d, F]
        beam = torch.fft.irfft(_rounded(spectra, precision), n=n, dim=-1)[:, :t]
        out.append(_power(round_to(beam, precision), t * c))
    powers = torch.cat(out)
    src = geo.off_disc_source(m["rows"], m["columns"], m["fov_degrees"])
    return powers[torch.as_tensor(src, device=dev)]


def powers(window, points, cfg: dict, precision: str = "float64"):
    """The configuration's heatmap (``mimo.backend``) of one window."""
    if cfg["mimo"]["backend"] == "fft":
        return fft_powers(window, points, cfg, precision)
    return dense_powers(window, points, cfg, precision)
