"""Spherical geometry on tensors (counterpart of ``beamforming_lk_tpu.ops.geometry``).

Physics convention: theta is the inclination from the +Z boresight, phi
the azimuth from +X.  Every function broadcasts over leading batch
dimensions.
"""

from __future__ import annotations

import math

import torch

PI_HALF = math.pi / 2.0


def wrap_angle(angle):
    """Wrap an angle to [0, 2*pi) (floor-mod: negative angles wrap up)."""
    return torch.remainder(angle, 2.0 * math.pi)


def smallest_angle(target, current):
    """Signed smallest difference between two angles (geometry.cpp:22-24)."""
    d = target - current
    return torch.atan2(torch.sin(d), torch.cos(d))


def spherical_to_cartesian(theta, phi, radius=1.0):
    """Direction -> xyz stacked on a trailing axis of size 3
    (geometry.cpp:29-37)."""
    theta, phi = torch.broadcast_tensors(theta, phi)
    st = torch.sin(theta)
    return torch.stack(
        [radius * st * torch.cos(phi), radius * st * torch.sin(phi),
         radius * torch.cos(theta)], dim=-1
    )


def cartesian_to_spherical(xyz):
    """xyz[..., 3] -> (theta, phi, radius) (geometry.cpp:62-66)."""
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    radius = torch.sqrt(x * x + y * y + z * z)
    theta = torch.arccos(torch.clamp(z / torch.clamp(radius, min=1e-12), -1.0, 1.0))
    return theta, torch.atan2(y, x), radius


def horizontal_to_spherical(azimuth, elevation):
    """(azimuth, elevation) -> (theta, phi) (geometry.cpp:47-60)."""
    phi = torch.atan2(torch.sin(elevation), torch.sin(azimuth))
    z_height = torch.sin(PI_HALF - elevation) * torch.cos(azimuth)
    theta = PI_HALF - torch.arcsin(torch.clamp(z_height, -1.0, 1.0))
    return theta, phi


def spherical_angle(theta1, phi1, theta2, phi2):
    """Geodesic angle between two directions (geometry.cpp:109-118)."""
    s1 = torch.sin(PI_HALF - theta1)
    s2 = torch.sin(PI_HALF - theta2)
    c1 = torch.cos(PI_HALF - theta1)
    c2 = torch.cos(PI_HALF - theta2)
    return torch.arccos(
        torch.clamp(s1 * s2 + c1 * c2 * torch.cos(phi1 - phi2), -1.0, 1.0)
    )


def spherical_chord_distance(theta1, phi1, theta2, phi2):
    """Chord distance between unit directions (geometry.cpp:42-45)."""
    inner = (torch.sin(theta1) * torch.sin(theta2) * torch.cos(phi1 - phi2)
             + torch.cos(theta1) * torch.cos(theta2))
    return torch.sqrt(torch.clamp(2.0 - 2.0 * inner, min=0.0))


def rotation_z(angle):
    """Batched Z-axis rotation matrices [..., 3, 3]."""
    c, s = torch.cos(angle), torch.sin(angle)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([c, -s, zero], dim=-1),
        torch.stack([s, c, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def rotation_y(angle):
    """Batched Y-axis rotation matrices [..., 3, 3]."""
    c, s = torch.cos(angle), torch.sin(angle)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([
        torch.stack([c, zero, s], dim=-1),
        torch.stack([zero, one, zero], dim=-1),
        torch.stack([-s, zero, c], dim=-1),
    ], dim=-2)


def normalize_spherical(theta, phi, theta_limit):
    """Clamp theta to [0, limit], wrap phi to [0, 2*pi) (particle.h:24-27)."""
    return torch.clamp(theta, 0.0, theta_limit), wrap_angle(phi)


def _edge_adjust(theta, spread):
    """FoV-edge back-off shared by the probe generators (geometry.cpp:159-165):
    returns (rotation theta, adjusted particle theta)."""
    near_edge = theta + spread > PI_HALF
    rotate_theta = torch.where(near_edge, theta - spread, theta)
    adjusted_theta = torch.where(near_edge, theta - spread / 2.0, theta)
    return rotate_theta, adjusted_theta


def _rotated_probes(base_phis_deg, theta, phi, spread):
    """Probe ring centred on (theta, phi): 4 points at inclination
    ``spread`` rotated by ``Rz(phi) @ Ry(theta)``.  Returns
    (probe_theta[..., 4], probe_phi[..., 4], adjusted_theta[...])."""
    theta = torch.as_tensor(theta, dtype=torch.float32)
    phi = torch.as_tensor(phi, dtype=torch.float32, device=theta.device)
    spread = torch.as_tensor(spread, dtype=torch.float32, device=theta.device)
    base_phi = torch.deg2rad(
        torch.tensor(base_phis_deg, dtype=torch.float32, device=theta.device)
    )
    base = spherical_to_cartesian(
        spread[..., None] * torch.ones_like(base_phi), base_phi
    )                                                         # [..., 4, 3]
    rotate_theta, adjusted_theta = _edge_adjust(theta, spread)
    rot = rotation_z(phi) @ rotation_y(rotate_theta)          # [..., 3, 3]
    rotated = torch.einsum("...ij,...pj->...pi", rot, base)
    probe_theta = torch.arccos(torch.clamp(rotated[..., 2], -1.0, 1.0))
    probe_phi = torch.atan2(rotated[..., 1], rotated[..., 0])
    return probe_theta, probe_phi, adjusted_theta


def quadrant_probes(theta, phi, spread):
    """4 diagonal monopulse probes at 45/315/225/135 degrees."""
    return _rotated_probes((45.0, 315.0, 225.0, 135.0), theta, phi, spread)


def nearby_probes(theta, phi, spread):
    """N/E/S/W monopulse probes (geometry.cpp:144-179, re-centred)."""
    return _rotated_probes((0.0, 90.0, 180.0, 270.0), theta, phi, spread)


def quadrant_probes_reference(theta, phi, spread):
    """``Spherical::quadrant`` (geometry.cpp:181-217) as the reference
    computes it, azimuth mirror included (the probes centre on (theta,
    -phi)); kept for parity with the reference, the dynamics use
    :func:`quadrant_probes`."""
    theta = torch.as_tensor(theta, dtype=torch.float32)
    phi = torch.as_tensor(phi, dtype=torch.float32, device=theta.device)
    base_phi = torch.deg2rad(torch.tensor((45.0, 315.0, 225.0, 135.0),
                                          dtype=torch.float32,
                                          device=theta.device))
    base = spherical_to_cartesian(torch.full_like(base_phi, spread), base_phi)
    rotate_theta, adjusted_theta = _edge_adjust(theta, spread)
    rot = rotation_y(rotate_theta) @ rotation_z(phi)
    rotated = torch.einsum("pi,...ij->...pj", base, rot)      # row vectors
    probe_theta = torch.arccos(torch.clamp(rotated[..., 2], -1.0, 1.0))
    probe_phi = torch.atan2(rotated[..., 1], rotated[..., 0]) - math.pi
    return probe_theta, probe_phi, adjusted_theta
