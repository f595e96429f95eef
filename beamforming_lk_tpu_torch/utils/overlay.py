"""Target overlays on rendered heatmap frames.

Re-design of the reference tracker's draw path
(``src/dsp/gradient_ascend.cpp:157-293``: tracker squares, a crosshair on
the oldest tracker, a KF-smoothed lead circle) and the MISO direction circle
(``src/dsp/miso.cpp:57-77``) — as pure-numpy drawing on the RGB frame, no
OpenCV required.

A copy of ``beamforming_lk_tpu.utils.overlay`` (numpy and the standard
library only), kept in the port so that the port loads no module of the
JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

TRACKER_COLOR = (255, 255, 255)
OLDEST_COLOR = (255, 0, 0)
LEAD_COLOR = (0, 255, 255)
MISO_COLOR = (255, 255, 0)


def direction_to_pixel(
    theta: float, phi: float, size: int, fov_degrees: float = 180.0
):
    """(theta, phi) -> fractional (row, col) on the sin-projected heatmap
    (inverse of models/mimo.make_mimo_grid's pixel -> direction map)."""
    half = math.sin(math.radians(fov_degrees) / 2.0)
    x = math.sin(theta) * math.cos(phi)
    y = math.sin(theta) * math.sin(phi)
    sep = half / (size / 2.0)
    col = (x + size * sep / 2.0 - sep / 2.0) / sep
    row = (y + size * sep / 2.0 - sep / 2.0) / sep
    return row, col


def pixel_to_direction(
    row: float, col: float, size: int, fov_degrees: float = 180.0
):
    """(row, col) on a rendered heatmap tile -> (theta, phi): the inverse of
    :func:`direction_to_pixel`, used for click-to-steer (the reference's
    ``clickEvent``, aw_control_unit.cpp:30-47).  Clicks outside the FOV disc
    clamp to its rim."""
    half = math.sin(math.radians(fov_degrees) / 2.0)
    sep = half / (size / 2.0)
    x = sep * (col - size / 2.0 + 0.5)
    y = sep * (row - size / 2.0 + 0.5)
    r = math.hypot(x, y)
    theta = math.asin(min(r, half))
    phi = math.atan2(y, x)
    return theta, phi


def _clip(v, lo, hi):
    return max(lo, min(hi, v))


def draw_rect(frame: np.ndarray, row: int, col: int, half: int, color) -> None:
    """Hollow square outline centered at (row, col), in place."""
    h, w = frame.shape[:2]
    r0, r1 = _clip(row - half, 0, h - 1), _clip(row + half, 0, h - 1)
    c0, c1 = _clip(col - half, 0, w - 1), _clip(col + half, 0, w - 1)
    frame[r0, c0 : c1 + 1] = color
    frame[r1, c0 : c1 + 1] = color
    frame[r0 : r1 + 1, c0] = color
    frame[r0 : r1 + 1, c1] = color


def draw_crosshair(frame: np.ndarray, row: int, col: int, arm: int, color) -> None:
    h, w = frame.shape[:2]
    r = _clip(row, 0, h - 1)
    c = _clip(col, 0, w - 1)
    frame[r, _clip(col - arm, 0, w - 1) : _clip(col + arm, 0, w - 1) + 1] = color
    frame[_clip(row - arm, 0, h - 1) : _clip(row + arm, 0, h - 1) + 1, c] = color


def draw_circle(frame: np.ndarray, row: int, col: int, radius: int, color) -> None:
    h, w = frame.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w]
    d2 = (yy - row) ** 2 + (xx - col) ** 2
    ring = (d2 >= (radius - 1) ** 2) & (d2 <= (radius + 1) ** 2)
    frame[ring] = color


# 3x5 bitmap glyphs for the tracker age labels (the reference's
# cv::putText ages, gradient_ascend.cpp:181-233) — pure numpy, no cv2.
_GLYPHS = {
    "0": ["111", "101", "101", "101", "111"],
    "1": ["010", "110", "010", "010", "111"],
    "2": ["111", "001", "111", "100", "111"],
    "3": ["111", "001", "111", "001", "111"],
    "4": ["101", "101", "111", "001", "001"],
    "5": ["111", "100", "111", "001", "111"],
    "6": ["111", "100", "111", "101", "111"],
    "7": ["111", "001", "010", "010", "010"],
    "8": ["111", "101", "111", "101", "111"],
    "9": ["111", "101", "111", "001", "111"],
    "s": ["000", "011", "110", "011", "110"],
}


def draw_text(frame: np.ndarray, row: int, col: int, text: str, color,
              scale: int = 1) -> None:
    """Render digits/'s' at (row, col) with a 3x5 bitmap font, in place."""
    h, w = frame.shape[:2]
    x = col
    for ch in text:
        glyph = _GLYPHS.get(ch)
        if glyph is None:
            x += 2 * scale
            continue
        for gr, line in enumerate(glyph):
            for gc, bit in enumerate(line):
                if bit != "1":
                    continue
                r0 = row + gr * scale
                c0 = x + gc * scale
                if 0 <= r0 and r0 + scale <= h and 0 <= c0 and c0 + scale <= w:
                    frame[r0 : r0 + scale, c0 : c0 + scale] = color
        x += 4 * scale


def nearest_resize(img: np.ndarray, shape) -> np.ndarray:
    """Nearest-neighbor resize of an [H, W, ...] image to (h, w)."""
    img = np.asarray(img)
    h, w = shape
    ih, iw = img.shape[:2]
    if (ih, iw) == (h, w):
        return img
    ri = (np.arange(h) * ih // h).clip(0, ih - 1)
    ci = (np.arange(w) * iw // w).clip(0, iw - 1)
    return img[ri][:, ci]


def blend_underlay(camera_rgb: np.ndarray, heatmap_rgb: np.ndarray,
                   alpha: float = 0.6) -> np.ndarray:
    """Weighted blend of the heatmap over a camera frame
    (the reference's ``--camera`` mode composites the colormapped heatmap
    onto the live camera view, ``src/aw_control_unit/aw_control_unit.cpp``
    camera overlay branch; ``cv::addWeighted`` semantics).

    ``heatmap_rgb`` is nearest-neighbor resized to the camera frame.  Pure
    numpy — no OpenCV required.
    """
    cam = np.asarray(camera_rgb, np.float32)
    hm = nearest_resize(heatmap_rgb, cam.shape[:2])
    out = (1.0 - alpha) * cam + alpha * hm.astype(np.float32)
    return np.clip(out, 0, 255).astype(np.uint8)


def overlay_targets(
    frame: np.ndarray,
    targets: Sequence[dict],
    fov_degrees: float = 180.0,
    miso_direction: Optional[tuple] = None,
    lead_direction: Optional[tuple] = None,
    flip: bool = False,
    now_block: Optional[float] = None,
    block_seconds: float = 256.0 / 48828.0,
) -> np.ndarray:
    """Draw tracker markers onto an RGB frame (in place; also returned).

    - square per published target (gradient_ascend.cpp:181-233)
    - age label in seconds next to each square when ``now_block`` (the
      current block counter) is given — the reference's putText ages
    - crosshair on the oldest target (the reference's 'locked' marker)
    - optional circle at the MISO steer direction (miso.cpp:57-77)
    - optional circle at a KF lead direction (gradient_ascend.cpp:242-246)
    """
    size = frame.shape[0]
    scale = size  # markers scale with frame size

    def to_px(theta, phi):
        row, col = direction_to_pixel(theta, phi, size, fov_degrees)
        if flip:
            col = size - 1 - col
        return int(round(row)), int(round(col))

    oldest = None
    for t in targets:
        row, col = to_px(t["theta"], t["phi"])
        half = max(2, scale // 32)
        draw_rect(frame, row, col, half, TRACKER_COLOR)
        if now_block is not None:
            age_s = max(0.0, (now_block - t["start"]) * block_seconds)
            draw_text(
                frame,
                _clip(row - 2, 0, size - 1),
                _clip(col + half + 2, 0, size - 1),
                f"{int(round(age_s))}s",
                TRACKER_COLOR,
            )
        if oldest is None or t["start"] < oldest["start"]:
            oldest = t
    if oldest is not None:
        row, col = to_px(oldest["theta"], oldest["phi"])
        draw_crosshair(frame, row, col, max(3, scale // 16), OLDEST_COLOR)
    if lead_direction is not None:
        row, col = to_px(*lead_direction)
        draw_circle(frame, row, col, max(3, scale // 24), LEAD_COLOR)
    if miso_direction is not None:
        row, col = to_px(*miso_direction)
        draw_circle(frame, row, col, max(4, scale // 20), MISO_COLOR)
    return frame
