"""Array model: element positions and steering delays
(counterpart of ``beamforming_lk_tpu.ops.antenna``).

For direction (theta, phi) the steering row is
``u = [sin t cos p, -sin t sin p, cos t]``, so delays for D directions are
``(U[D, 3] @ points[3, N]) * fs/c``, min-subtracted per direction
(antenna.cpp:89-107).
"""

from __future__ import annotations

import numpy as np
import torch


def create_antenna_grid(
    columns: int = 8, rows: int = 8, distance: float = 0.02
) -> np.ndarray:
    """Planar grid element positions [3, rows*columns], z = 0; element id
    r * columns + c (antenna.cpp:60-87, including its centring convention)."""
    half = distance / 2.0
    c = np.arange(columns, dtype=np.float32)
    r = np.arange(rows, dtype=np.float32)
    x = c * distance - rows * half + half
    y = r * distance - columns * half + half
    xx, yy = np.meshgrid(x, y)
    pts = np.stack(
        [xx.reshape(-1), yy.reshape(-1), np.zeros(rows * columns, np.float32)]
    )
    return pts.astype(np.float32)


def combine_arrays(grids, offsets) -> np.ndarray:
    """Concatenate element grids placed at xyz offsets into one aperture."""
    placed = [
        np.asarray(g) + np.asarray(o, np.float32).reshape(3, 1)
        for g, o in zip(grids, offsets)
    ]
    return np.concatenate(placed, axis=1)


def multi_array_cluster(
    n_mics: int, columns: int = 8, rows: int = 8, distance: float = 0.02
) -> np.ndarray:
    """A near-square cluster of 8x8 arrays side by side at array pitch,
    ``n_mics`` channels in all (256 = one FPGA's four daisy-chained arrays)."""
    g = create_antenna_grid(columns, rows, distance)
    e = columns * rows
    if n_mics % e:
        raise ValueError(f"{n_mics} not a multiple of {e}")
    n_arrays = n_mics // e
    if n_arrays == 1:
        return g
    side = int(np.ceil(np.sqrt(n_arrays)))
    offsets = [
        ((i % side) * columns * distance, (i // side) * rows * distance, 0.0)
        for i in range(n_arrays)
    ]
    return combine_arrays([g] * n_arrays, offsets)


def steering_delays(points, theta, phi, samples_per_meter):
    """Steering delays in samples [..., N] for directions theta/phi [...].

    The min is taken over ALL channels, masked ones included (a mask only
    zeroes stencil weights downstream), as antenna.cpp:89-97 does.
    """
    theta = torch.as_tensor(theta, dtype=torch.float32)
    phi = torch.as_tensor(phi, dtype=torch.float32, device=theta.device)
    st = torch.sin(theta)
    u = torch.stack(
        [st * torch.cos(phi), -st * torch.sin(phi), torch.cos(theta)], dim=-1
    )
    pts = torch.as_tensor(points, dtype=torch.float32, device=theta.device)
    delays = (u @ pts) * float(samples_per_meter)
    return delays - delays.amin(dim=-1, keepdim=True)


def steering_delays_np(points, theta, phi, samples_per_meter) -> np.ndarray:
    """Host (numpy, float64) twin of :func:`steering_delays` for static grids."""
    theta = np.asarray(theta, np.float64)
    phi = np.asarray(phi, np.float64)
    st = np.sin(theta)
    u = np.stack([st * np.cos(phi), -st * np.sin(phi), np.cos(theta)], axis=-1)
    delays = (u @ np.asarray(points, np.float64)) * float(samples_per_meter)
    return (delays - delays.min(axis=-1, keepdims=True)).astype(np.float32)
