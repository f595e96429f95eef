"""MISO steered-listening state (counterpart of ``beamforming_lk_tpu.models.miso``).

The listener is one tracker-like particle that re-centres on the source
with 3 slow monopulse steps per block and emits the delay-and-sum audio
beam at its direction (miso.cpp:25-55).  In the per-block step both ride
the swarm-chain kernel (``models/tracker.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from beamforming_lk_tpu_torch.models.tracker import Particles


class MisoState(NamedTuple):
    particle: Particles      # batch of 1
    tracking: torch.Tensor   # [] bool


def miso_init(theta=0.0, phi=0.0, device=None) -> MisoState:
    z = torch.zeros((1,), dtype=torch.float32, device=device)
    return MisoState(
        particle=Particles(
            theta=torch.full((1,), theta, dtype=torch.float32, device=device),
            phi=torch.full((1,), phi, dtype=torch.float32, device=device),
            grad_theta=z, grad_phi=z, radius=z, error=z,
        ),
        tracking=torch.ones((), dtype=torch.bool, device=device),
    )


def miso_steer(state: MisoState, theta, phi) -> MisoState:
    """Pin the listener to a direction (click-to-steer; miso.cpp:14-19)."""
    dev = state.particle.theta.device
    return MisoState(
        particle=state.particle._replace(
            theta=torch.full((1,), float(theta), dtype=torch.float32, device=dev),
            phi=torch.full((1,), float(phi), dtype=torch.float32, device=dev),
        ),
        tracking=torch.ones((), dtype=torch.bool, device=dev),
    )
