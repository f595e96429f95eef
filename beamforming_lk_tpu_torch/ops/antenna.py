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

from beamforming_lk_tpu_torch.ops.geometry import horizontal_to_spherical

# Quadrant sector element indices of an 8x8 array for 4-sector monopulse
# (reference: antenna.h:32-50), kept as boolean masks over the 64 elements.
_SECTOR_LISTS = {
    0: [4, 5, 6, 7, 12, 13, 14, 15, 20, 21, 22, 23, 28, 29, 30, 31],
    1: [0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 19, 24, 25, 26, 27],
    2: [32, 33, 34, 35, 40, 41, 42, 43, 48, 49, 50, 51, 56, 57, 58, 59],
    3: [36, 37, 38, 39, 44, 45, 46, 47, 52, 53, 54, 55, 60, 61, 62, 63],
}


def sector_masks(elements: int = 64) -> np.ndarray:
    """[4, elements] boolean masks of the four quadrant sectors."""
    masks = np.zeros((4, elements), dtype=bool)
    for s, idx in _SECTOR_LISTS.items():
        masks[s, idx] = True
    return masks


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


def steer_points(points, theta, phi):
    """The element cloud rotated into the steered frame,
    ``Ry(-theta) @ Rz(phi) @ points`` (antenna.cpp:99-107): points [3, N],
    theta / phi broadcastable -> [..., 3, N]."""
    theta = torch.as_tensor(theta, dtype=torch.float32)
    phi = torch.as_tensor(phi, dtype=torch.float32, device=theta.device)
    theta, phi = torch.broadcast_tensors(theta, phi)
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    rot = torch.stack([
        torch.stack([ct * cp, -ct * sp, -st], dim=-1),
        torch.stack([sp, cp, torch.zeros_like(st)], dim=-1),
        torch.stack([st * cp, -st * sp, ct], dim=-1),
    ], dim=-2)
    return rot @ torch.as_tensor(points, dtype=torch.float32, device=theta.device)


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


def steering_delays_horizontal(points, azimuth, elevation, samples_per_meter):
    """Steering delays toward (azimuth, elevation) (antenna.cpp:109-117)."""
    theta, phi = horizontal_to_spherical(
        torch.as_tensor(azimuth, dtype=torch.float32),
        torch.as_tensor(elevation, dtype=torch.float32),
    )
    return steering_delays(points, theta, phi, samples_per_meter)


def steering_delays_cartesian(points, xyz, samples_per_meter):
    """Steering delays toward unit-sphere points [..., 3]
    (antenna.cpp:119-124)."""
    xyz = torch.as_tensor(xyz, dtype=torch.float32)
    azimuth = torch.atan2(xyz[..., 1], xyz[..., 0])
    elevation = np.pi / 2.0 - torch.arcsin(torch.clamp(xyz[..., 2], -1.0, 1.0))
    return steering_delays_horizontal(points, azimuth, elevation,
                                      samples_per_meter)


def generate_unit_dome(n: int) -> np.ndarray:
    """Fibonacci-spiral hemisphere of n unit vectors [n, 3]
    (antenna.cpp:136-153)."""
    i = np.arange(n, dtype=np.float64)
    incl = np.arccos(1.0 - i / n)          # the reference calls this "phi"
    azim = i * (2.0 * np.pi / 1.618033988749)
    return np.stack(
        [np.cos(azim) * np.sin(incl), np.sin(azim) * np.sin(incl), np.cos(incl)],
        axis=-1,
    ).astype(np.float32)


def _degree_grid() -> np.ndarray:
    """Unit vectors [90, 360, 3] at integer (inclination, azimuth) degrees."""
    incl = np.deg2rad(np.arange(90, dtype=np.float64))[:, None]
    azim = np.deg2rad(np.arange(360, dtype=np.float64))[None, :]
    x = np.cos(azim) * np.sin(incl)
    y = np.sin(azim) * np.sin(incl)
    z = np.broadcast_to(np.cos(incl), x.shape)
    return np.stack([x, y, z], axis=-1)


def generate_dome_lookup(dome: np.ndarray) -> np.ndarray:
    """[90, 360] int32 table of the nearest dome index to each integer
    (inclination, azimuth) degree (antenna.cpp:155-178, as one argmin over
    a distance matrix)."""
    grid = _degree_grid().reshape(-1, 3)
    d2 = ((grid[:, None, :] - dome[None, :, :].astype(np.float64)) ** 2).sum(-1)
    return np.argmin(d2, axis=1).reshape(90, 360).astype(np.int32)


def dome_lookup_max_error(dome: np.ndarray, table: np.ndarray) -> float:
    """Worst chord distance from a table cell to its dome point (the
    exhaustive form of the reference's random self-test,
    antenna.cpp:180-211, which allows 0.2)."""
    return float(np.sqrt(((_degree_grid() - dome[table]) ** 2).sum(-1)).max())
