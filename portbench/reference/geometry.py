"""The array and the heatmap grid, worked out from a configuration file.

The element layout and the grid follow the upstream project's definitions
(beamforming-lk ``src/geometry/antenna.cpp:60-107``, ``src/dsp/mimo.cpp:
20-59``); they are written here once more so that the reference takes no
table from the program under test.
"""

from __future__ import annotations

import math

import numpy as np


def array_points(channels: int, columns: int, rows: int, distance: float):
    """Element positions [3, channels] in metres, f64: ``channels // 64``
    planar 8x8 arrays side by side in a near-square cluster at array pitch,
    each centred as antenna.cpp centres one array (element ``r * columns +
    c`` of array ``i``, arrays in row-major order)."""
    per = columns * rows
    if channels % per:
        raise ValueError(f"{channels} channels is not a whole number of "
                         f"{columns}x{rows} arrays")
    half = distance / 2.0
    x = np.arange(columns) * distance - rows * half + half
    y = np.arange(rows) * distance - columns * half + half
    xx, yy = np.meshgrid(x, y)
    one = np.stack([xx.reshape(-1), yy.reshape(-1), np.zeros(per)])
    n = channels // per
    side = int(math.ceil(math.sqrt(n)))
    placed = [one + np.array([[(i % side) * columns * distance],
                              [(i // side) * rows * distance], [0.0]])
              for i in range(n)]
    return np.concatenate(placed, axis=1)


def steering_delays(points, theta, phi, samples_per_meter):
    """Delays in samples [..., C] toward directions (theta, phi) [...]:
    ``u = [sin t cos p, -sin t sin p, cos t]`` against the elements, the
    least delay over all elements subtracted (antenna.cpp:89-107), f64."""
    theta = np.asarray(theta, np.float64)[..., None]
    phi = np.asarray(phi, np.float64)[..., None]
    p = np.asarray(points, np.float64)
    d = (np.sin(theta) * np.cos(phi) * p[0] - np.sin(theta) * np.sin(phi) * p[1]
         + np.cos(theta) * p[2]) * samples_per_meter
    return d - d.min(axis=-1, keepdims=True)


def grid_axes(rows: int, columns: int, fov_degrees: float):
    """(u_x [columns], u_y [rows]): the sin-projected pixel centres."""
    s = math.sin(math.radians(fov_degrees) / 2.0)
    sep_r, sep_c = s / (rows / 2.0), s / (columns / 2.0)
    uy = np.arange(rows) * sep_r - rows * sep_r / 2.0 + sep_r / 2.0
    ux = np.arange(columns) * sep_c - columns * sep_c / 2.0 + sep_c / 2.0
    return ux, uy


def grid_directions(rows: int, columns: int, fov_degrees: float):
    """(theta [D], phi [D]) of pixel (r, c) at index ``r * columns + c``,
    a pixel outside the unit disc steered to its rim at the same azimuth
    (mimo.cpp:20-59; the dense heatmap's grid)."""
    ux, uy = grid_axes(rows, columns, fov_degrees)
    yy, xx = np.meshgrid(uy, ux, indexing="ij")
    norm = np.hypot(xx, yy)
    theta = np.arcsin(np.minimum(norm, 1.0))
    phi = np.arctan2(yy, xx)
    return theta.reshape(-1), phi.reshape(-1)


def off_disc_source(rows: int, columns: int, fov_degrees: float):
    """[D] pixel each pixel shows: itself on the unit disc, the nearest
    on-disc pixel to its rim point outside it (the separable heatmap's
    corners)."""
    ux, uy = grid_axes(rows, columns, fov_degrees)
    yy, xx = np.meshgrid(uy, ux, indexing="ij")
    x, y = xx.reshape(-1), yy.reshape(-1)
    norm = np.hypot(x, y)
    src = np.arange(rows * columns)
    out = norm > 1.0
    inside = np.nonzero(~out)[0]
    px, py = x[out] / norm[out], y[out] / norm[out]
    d2 = (x[inside][None] - px[:, None]) ** 2 + (y[inside][None] - py[:, None]) ** 2
    src[out] = inside[d2.argmin(axis=1)]
    return src


def probe_span(points, samples_per_meter: float, taps: int,
               shift_range: int, multiple: int = 8) -> int:
    """Samples of window the probe stencils reach: the aperture's diameter
    in samples plus the taps, rounded up to ``multiple``, at most
    ``shift_range``."""
    p = np.asarray(points, np.float64)
    diameter = float(np.linalg.norm(p.max(axis=1) - p.min(axis=1)))
    span = int(math.ceil(diameter * samples_per_meter)) + taps
    return min((span + multiple - 1) // multiple * multiple, shift_range)
