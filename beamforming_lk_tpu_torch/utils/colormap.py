"""Heatmap rendering: colormap LUTs, upscaling, blur — numpy only.

The reference renders with OpenCV: ``cv::resize`` + ``cv::GaussianBlur`` +
``cv::applyColorMap(COLORMAP_JET | COLORMAP_OCEAN)``
(``src/aw_control_unit/aw_control_unit.cpp:300-334``).  These are small
pure functions here so the frame path has no native UI dependency; cv2 can
still consume the frames when present.

A copy of ``beamforming_lk_tpu.utils.colormap`` (numpy and the standard
library only), kept in the port so that the port loads no module of the
JAX package.
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def jet_lut() -> np.ndarray:
    """[256, 3] RGB uint8 approximating OpenCV's COLORMAP_JET."""
    x = np.linspace(0.0, 1.0, 256)

    def ramp(v):
        return np.clip(1.5 - np.abs(v), 0.0, 1.0)

    r = ramp(4.0 * (x - 0.75))
    g = ramp(4.0 * (x - 0.5))
    b = ramp(4.0 * (x - 0.25))
    return (np.stack([r, g, b], axis=-1) * 255.0 + 0.5).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def ocean_lut() -> np.ndarray:
    """[256, 3] RGB uint8 approximating OpenCV's COLORMAP_OCEAN
    (dark blue -> green -> white)."""
    x = np.linspace(0.0, 1.0, 256)
    r = np.clip(3.0 * x - 2.0, 0.0, 1.0)
    g = np.clip(1.5 * x - 0.5, 0.0, 1.0)
    b = x
    return (np.stack([r, g, b], axis=-1) * 255.0 + 0.5).astype(np.uint8)


def apply_colormap(img: np.ndarray, lut: np.ndarray | None = None) -> np.ndarray:
    """uint8 [H, W] -> RGB uint8 [H, W, 3]."""
    if lut is None:
        lut = jet_lut()
    return lut[np.asarray(img, np.uint8)]


def upscale(img: np.ndarray, size: tuple, bilinear: bool = True) -> np.ndarray:
    """Resize [H, W] or [H, W, 3] to (out_h, out_w)."""
    img = np.asarray(img)
    out_h, out_w = size
    h, w = img.shape[:2]
    if not bilinear:
        yi = (np.arange(out_h) * h // out_h).clip(0, h - 1)
        xi = (np.arange(out_w) * w // out_w).clip(0, w - 1)
        return img[yi][:, xi]
    y = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    x = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(y).astype(int), 0, h - 1)
    x0 = np.clip(np.floor(x).astype(int), 0, w - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    fy = np.clip(y - y0, 0.0, 1.0)[:, None]
    fx = np.clip(x - x0, 0.0, 1.0)[None, :]
    if img.ndim == 3:
        fy = fy[..., None]
        fx = fx[..., None]
    a = img[y0][:, x0].astype(np.float32)
    b = img[y0][:, x1].astype(np.float32)
    c = img[y1][:, x0].astype(np.float32)
    d = img[y1][:, x1].astype(np.float32)
    top = a + (b - a) * fx
    bot = c + (d - c) * fx
    out = top + (bot - top) * fy
    return np.clip(out + 0.5, 0, 255).astype(np.uint8)


def gaussian_blur(img: np.ndarray, sigma: float = 1.5) -> np.ndarray:
    """Separable Gaussian blur on [H, W] or [H, W, C] uint8/float
    (the reference's BLUR_EFFECT, aw_control_unit.cpp:300-313)."""
    if sigma <= 0:
        return img
    radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    arr = np.asarray(img, np.float32)
    pad = [(radius, radius), (0, 0)] + ([(0, 0)] if arr.ndim == 3 else [])
    tmp = np.pad(arr, pad, mode="edge")
    tmp = np.apply_along_axis(lambda m: np.convolve(m, k, "valid"), 0, tmp)
    pad = [(0, 0), (radius, radius)] + ([(0, 0)] if arr.ndim == 3 else [])
    tmp = np.pad(tmp, pad, mode="edge")
    tmp = np.apply_along_axis(lambda m: np.convolve(m, k, "valid"), 1, tmp)
    if np.issubdtype(np.asarray(img).dtype, np.integer):
        return np.clip(tmp + 0.5, 0, 255).astype(np.uint8)
    return tmp
