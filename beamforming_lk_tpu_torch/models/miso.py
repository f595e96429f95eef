"""MISO steered listening (counterpart of ``beamforming_lk_tpu.models.miso``).

The listener is one tracker-like particle that re-centres on the source
with 3 slow monopulse steps per block and emits the delay-and-sum audio
beam at its direction (miso.cpp:25-55).  In the fused per-block step both
ride the swarm kernels (``models/tracker.py``); alone, :class:`MisoStep`
runs the refine steps as one launch of the monopulse-chain kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from beamforming_lk_tpu_torch.models.tracker import MisoBeam, Particles, probe_windows
from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk
from beamforming_lk_tpu_torch.ops import delay as dl


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


class MisoStep(nn.Module):
    """The unfused per-block MISO update (the JAX package's
    ``make_miso_step_impl``): ``refine_steps`` monopulse steps at
    ``tracker_step_gain * tracker_spread / 3`` (miso.cpp:39-40) as one
    launch of the monopulse-chain kernel, then the f32 audio beam at the
    refined direction.

    ``forward(state, window [C, T+S]) -> (state, beam [T])``."""

    def __init__(self, cfg, dsp, array_cfg, points, channel_mask=None,
                 refine_steps: int = 3, probe_span=None, device=None):
        super().__init__()
        self.cfg, self.dsp = cfg, dsp
        self.taps = dl.LINEAR_TAPS if dsp.interp == "linear" else dsp.fir_taps
        self.span = (dsp.shift_range if probe_span is None
                     else min(probe_span, dsp.shift_range))
        rate = cfg.tracker_step_gain * cfg.tracker_spread / 3.0
        self.register_buffer("dyn", torch.as_tensor(
            np.array([[rate], [cfg.tracker_spread]], np.float32), device=device))
        self.register_buffer("active", torch.ones(
            (refine_steps, 1), dtype=torch.float32, device=device))
        self.register_buffer("xyz", ctk.pack_geometry(
            points, array_cfg.samples_per_meter, channel_mask, device=device))
        self.beam = MisoBeam(dsp, array_cfg, points, channel_mask, self.span,
                             device)

    def forward(self, state: MisoState, window):
        win_bp, pw = probe_windows(window, self.dsp, self.span)
        rows = torch.cat([torch.cat(state.particle)[:, None], self.dyn])
        out = ctk.monopulse_chain(
            self.xyz, win_bp, rows, self.active, span=self.span,
            taps=self.taps, theta_limit=self.cfg.theta_limit,
            divisor=float(self.dsp.block_size),
            probe_layout=self.cfg.probe_layout, interp=self.dsp.interp,
            fir_phases=self.dsp.fir_phases,
        )
        particle = Particles(*out.unbind(0))
        return state._replace(particle=particle), self.beam(particle, pw)


def make_miso_step_impl(cfg, dsp, array_cfg, points, channel_mask=None,
                        refine_steps: int = 3, probe_span=None,
                        device=None) -> MisoStep:
    """The unfused MISO per-block update (the JAX package's function of the
    same name)."""
    return MisoStep(cfg, dsp, array_cfg, points, channel_mask, refine_steps,
                    probe_span, device)
