"""Heatmap grid and rendering (counterpart of ``beamforming_lk_tpu.models.mimo``)."""

from __future__ import annotations

import numpy as np
import torch


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
