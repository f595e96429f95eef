"""Heatmap grid, the dense heatmap and rendering
(counterpart of ``beamforming_lk_tpu.models.mimo``).

The dense heatmap beamforms every grid direction of a block window through
the DAS-beam kernel (``ops/cuda_das.py``).  Its model holds the compact
delay split of the grid (shift [D, C] int32 and tap weights
[D, C, taps]) as buffers, never the [D, C, S] one-hot stencil the JAX
package materializes: 3 MB instead of 67 MB at 64 mics and 4096
directions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from beamforming_lk_tpu_torch.device import resolve_device
from beamforming_lk_tpu_torch.ops import antenna as ant
from beamforming_lk_tpu_torch.ops import cuda_das as cd
from beamforming_lk_tpu_torch.ops import delay as dl


def make_mimo_grid(cfg):
    """Heatmap directions ([R*C] theta, [R*C] phi): pixel (r, c) on the
    sin-projected field-of-view disc, clamped onto it outside
    (mimo.cpp:20-59)."""
    fov = np.radians(cfg.fov_degrees)
    rows, cols = cfg.rows, cfg.columns
    sep_r = np.sin(fov / 2.0) / (rows / 2.0)
    sep_c = np.sin(fov / 2.0) / (cols / 2.0)
    y = np.arange(rows, dtype=np.float64) * sep_r - rows * sep_r / 2.0 + sep_r / 2.0
    x = np.arange(cols, dtype=np.float64) * sep_c - cols * sep_c / 2.0 + sep_c / 2.0
    yy, xx = np.meshgrid(y, x, indexing="ij")
    norm = np.hypot(xx, yy)
    theta = np.arcsin(np.minimum(norm, 1.0))
    safe = np.maximum(norm, 1e-30)
    phi = np.where(norm > 0.0, np.arctan2(yy / safe, xx / safe), 0.0)
    return theta.reshape(-1).astype(np.float32), phi.reshape(-1).astype(np.float32)


class MimoModel(nn.Module):
    """The dense heatmap's delay split (the delay-LUT analog): ``shift``
    [D, C] int32 and ``tap_weights`` [D, C, taps] f32 (the channel mask
    folded in) as buffers, the grid, and the product's ``compute`` dtype."""

    def __init__(self, shift, tap_weights, theta, phi, rows: int, columns: int,
                 shift_range: int, use_bandpass: bool = True,
                 compute: str = "float32", device="cuda"):
        super().__init__()
        device = resolve_device(device)
        self.register_buffer("shift", torch.as_tensor(
            np.ascontiguousarray(shift, np.int32), device=device))
        self.register_buffer("tap_weights", torch.as_tensor(
            np.ascontiguousarray(tap_weights, np.float32), device=device))
        self.theta, self.phi = np.asarray(theta), np.asarray(phi)
        self.rows, self.columns = rows, columns
        self.shift_range = shift_range
        self.taps = self.tap_weights.shape[-1]
        self.use_bandpass = use_bandpass
        self.compute = compute

    def forward(self, window, n_active: Optional[float] = None):
        return mimo_power(window, self, n_active)


def make_mimo_model(points, mimo_cfg, dsp_cfg, array_cfg, channel_mask=None,
                    fir_bank=None, compute: str = "float32",
                    device="cuda", layout=None) -> MimoModel:
    """Build the split of the heatmap grid on the host from
    ``steering_delays_np`` (shifts equal the JAX package's bit for bit),
    the channel mask multiplying the tap weights (mimo.cpp:20-59).  With a
    mesh ``layout`` (``parallel.mesh.Layout``) the model holds this rank's
    (direction, channel) block of the split, the JAX package's
    ``P(dir, ch, None)``, and the grid stays whole.  The model lies on
    ``device``, the card unless it names the CPU."""
    theta, phi = make_mimo_grid(mimo_cfg)
    delays = ant.steering_delays_np(np.asarray(points), theta, phi,
                                    array_cfg.samples_per_meter)
    mode = dsp_cfg.interp
    if mode == "fir" and fir_bank is None:
        fir_bank = dl.fractional_delay_fir_bank(dsp_cfg.fir_phases,
                                                dsp_cfg.fir_taps)
    shift, w = cd.delay_split_np(delays, dsp_cfg.shift_range, mode, fir_bank)
    if channel_mask is not None:
        w = w * np.asarray(channel_mask, np.float32)[:, None]
    if layout is not None:
        d, c = layout.dir.part(shift.shape[0]), layout.ch.part(shift.shape[1])
        shift, w = shift[d, c], w[d, c]
    return MimoModel(shift, w, theta, phi, mimo_cfg.rows, mimo_cfg.columns,
                     dsp_cfg.shift_range, dsp_cfg.use_bandpass, compute, device)


def mimo_power(window, model: MimoModel, n_active: Optional[float] = None,
               reduce=None):
    """Heatmap powers [D] of a window [C, T+S], or [K, D] of a stack
    [K, C, T+S] (one kernel launch), normalized by ``T * n_active``
    (mimo.cpp:137; ``n_active`` defaults to the channel count, as in the
    JAX package).  ``reduce`` (the all-reduce over a mesh's ``ch`` axis)
    turns a channel block's partial beams into the full array's before
    they are squared."""
    beam = cd.das_beam(window, model.shift, model.tap_weights,
                       span=model.shift_range, compute=model.compute)
    if reduce is not None:
        beam = reduce(beam)
    t = beam.shape[-1]
    if n_active is None:
        n_active = model.shift.shape[-1]
    return dl.das_power(beam, use_bandpass=model.use_bandpass,
                        divisor=t * n_active)


def render_heatmap(power, rows: int, columns: int, prev_power, ema_alpha=0.2,
                   use_db: bool = False):
    """Powers [D] -> (uint8 image [rows, cols], updated EMA of the frame
    max), normalized by the frame max (mimo.cpp:61-95)."""
    max_v = torch.max(power)
    min_v = torch.min(power)
    new_prev = max_v * ema_alpha + (1.0 - ema_alpha) * prev_power
    if use_db:
        norm = (power - min_v) / torch.clamp(max_v - min_v, min=1e-30)
        db = 20.0 * torch.log10(torch.clamp(norm, min=1e-30))
        scaled = (db + 60.0) / 60.0 * 255.0
    else:
        scaled = power / torch.clamp(max_v, min=1e-30) * 255.0
    img = torch.clamp(scaled, 0.0, 255.0).to(torch.uint8).reshape(rows, columns)
    return img, new_prev
