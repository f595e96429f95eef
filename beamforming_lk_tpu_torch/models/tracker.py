"""Gradient-ascent source tracker swarm, fused with the MISO listener
(counterpart of ``beamforming_lk_tpu.models.tracker``, the kernel path of
``make_fused_step_impl``).

16 seekers and 10 trackers step by 4-point monopulse (gradient_ascend.cpp);
the MISO listener rides the same chain.  The whole per-block update is one
call of :func:`beamforming_lk_tpu_torch.ops.cuda_tracker.swarm_chain`; this
module prepares its operands (reference power, bandpassed window, seeker
reset, jump draws, packed rows) and unpacks its results.  Every decision
that the JAX package takes on the device with a traced predicate but that
depends only on counters (the seeker reset) is taken here on the host, so
a block never waits for the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk
from beamforming_lk_tpu_torch.ops import delay as dl


class Particles(NamedTuple):
    """A batch of monopulse particles (seekers, trackers or the listener)."""

    theta: torch.Tensor       # [P]
    phi: torch.Tensor         # [P]
    grad_theta: torch.Tensor  # [P]
    grad_phi: torch.Tensor    # [P]
    radius: torch.Tensor      # [P] mean probe power
    error: torch.Tensor       # [P] |grad_theta| + |grad_phi|


class SwarmState(NamedTuple):
    seekers: Particles
    trackers: Particles
    tracking: torch.Tensor      # [Nt] bool
    start: torch.Tensor         # [Nt] f32 block index when tracking began
    jumped: torch.Tensor        # [Ns] bool (carried, unused by the step)
    mean: torch.Tensor          # [] mean valid-seeker power
    reset_count: int            # blocks since start (host counter)
    # Previous block's published targets (seeker avoidance).
    target_theta: torch.Tensor  # [Nt]
    target_phi: torch.Tensor    # [Nt]
    target_valid: torch.Tensor  # [Nt] bool


class Targets(NamedTuple):
    """Published target list (reference: Target struct, worker.h:32-61)."""

    theta: torch.Tensor
    phi: torch.Tensor
    power: torch.Tensor
    probability: torch.Tensor   # 1 / error
    start: torch.Tensor
    valid: torch.Tensor         # bool


def _empty_particles(n: int, device=None) -> Particles:
    z = torch.zeros((n,), dtype=torch.float32, device=device)
    return Particles(z, z, z, z, z, z)


def _random_directions(generator, n: int, theta_limit: float, device=None):
    """Uniform placement in the search domain (particle.cpp:11-14)."""
    u = torch.rand((2, n), generator=generator, device=device)
    return u[0] * theta_limit, u[1] * (2.0 * math.pi)


def _swarm_jumps(generator, n_iter: int, n_seekers: int, jump: float,
                 device=None):
    """All iterations' seeker jump offsets in one draw:
    (jt[n_iter, Ns], jp[n_iter, Ns]) uniform in [-jump, jump)."""
    u = (torch.rand((2, n_iter, n_seekers), generator=generator,
                    device=device) * 2.0 - 1.0) * jump
    return u[0], u[1]


def swarm_init(cfg, generator, device=None) -> SwarmState:
    s_theta, s_phi = _random_directions(
        generator, cfg.n_seekers, cfg.theta_limit, device
    )
    nt = cfg.n_trackers
    zt = torch.zeros((nt,), dtype=torch.float32, device=device)
    return SwarmState(
        seekers=_empty_particles(cfg.n_seekers, device)._replace(
            theta=s_theta, phi=s_phi
        ),
        trackers=_empty_particles(nt, device),
        tracking=torch.zeros((nt,), dtype=torch.bool, device=device),
        start=zt,
        jumped=torch.zeros((cfg.n_seekers,), dtype=torch.bool, device=device),
        mean=torch.zeros((), dtype=torch.float32, device=device),
        reset_count=0,
        target_theta=zt,
        target_phi=zt,
        target_valid=torch.zeros((nt,), dtype=torch.bool, device=device),
    )


class FusedSwarmStep(nn.Module):
    """The fused tracker + MISO per-block update through the swarm-chain
    kernel.  Holds the packed geometry and the per-row constants (rates,
    spreads, family one-hots) as buffers.

    ``forward(state, miso_particle, window, block_index, generator=None,
    draws=None) -> (state, Targets, miso_particle, miso_beam[T])``.
    ``draws = (reset_theta[Ns], reset_phi[Ns], jump_theta[I, Ns],
    jump_phi[I, Ns])`` replaces the generator's draws (tests feed the JAX
    package's own draws through it)."""

    def __init__(self, cfg, dsp, array_cfg, points, channel_mask=None,
                 probe_span=None, miso_refine_steps: int = 3, device=None):
        super().__init__()
        if cfg.iterations * cfg.tracker_steps < miso_refine_steps:
            raise ValueError(
                f"fused step needs iterations*tracker_steps >= "
                f"{miso_refine_steps}; got {cfg.iterations}*{cfg.tracker_steps}"
            )
        self.cfg, self.dsp = cfg, dsp
        self.taps = dl.LINEAR_TAPS if dsp.interp == "linear" else dsp.fir_taps
        self.span = (
            dsp.shift_range if probe_span is None
            else min(probe_span, dsp.shift_range)
        )
        self.refine = miso_refine_steps
        nt, ns = cfg.n_trackers, cfg.n_seekers
        tracker_rate = cfg.tracker_step_gain * cfg.tracker_spread
        # Rows: trackers | miso | seekers.
        consts = np.zeros((5, nt + 1 + ns), np.float32)
        consts[0] = [tracker_rate] * nt + [tracker_rate / 3.0] + [
            cfg.seeker_step_gain * cfg.seeker_spread] * ns   # miso.cpp:39-40
        consts[1] = [cfg.tracker_spread] * (nt + 1) + [cfg.seeker_spread] * ns
        consts[2, :nt] = 1.0
        consts[3, nt + 1:] = 1.0
        consts[4, nt] = 1.0
        self.register_buffer("consts", torch.as_tensor(consts, device=device))
        self.register_buffer("xyz", ctk.pack_geometry(
            points, array_cfg.samples_per_meter, channel_mask, device=device
        ))
        self.register_buffer("zeros_tm", torch.zeros(
            (2, cfg.iterations, nt + 1), dtype=torch.float32, device=device
        ))
        self.register_buffer("zeros_sm", torch.zeros(
            (ns + 1,), dtype=torch.float32, device=device
        ))

    def forward(self, state: SwarmState, miso_particle: Particles, window,
                block_index: int, generator: Optional[torch.Generator] = None,
                draws=None):
        cfg, dsp = self.cfg, self.dsp
        nt, t_len = cfg.n_trackers, dsp.block_size
        device = window.device
        # Reference power: bandpass power of channel 0's block
        # (gradient_ascend.cpp:304-313), at window offset S - taps.
        b0 = dsp.shift_range - self.taps
        reference = dl.das_power(
            window[0, b0:b0 + t_len], use_bandpass=True, divisor=t_len - 2
        )
        pw = window[:, dsp.shift_range - self.span:]
        win_bp = ctk.bandpass_window(pw)
        if dsp.probe_compute == "bfloat16":
            win_bp = win_bp.to(torch.bfloat16)

        # Seeker reset every seeker_reset_interval blocks (host counter).
        seekers = state.seekers
        if draws is None:
            if state.reset_count % cfg.seeker_reset_interval == 0:
                r_th, r_ph = _random_directions(
                    generator, cfg.n_seekers, cfg.theta_limit, device
                )
                seekers = seekers._replace(theta=r_th, phi=r_ph)
            jts, jps = _swarm_jumps(
                generator, cfg.iterations, cfg.n_seekers,
                cfg.theta_limit / 2.0, device,
            )
        else:
            r_th, r_ph, jts, jps = (
                torch.as_tensor(np.array(d, np.float32), device=device)
                for d in draws
            )
            if state.reset_count % cfg.seeker_reset_interval == 0:
                seekers = seekers._replace(theta=r_th, phi=r_ph)
        jumps = torch.cat(
            [self.zeros_tm, torch.stack([jts, jps])], dim=2
        ).contiguous()

        parts = (state.trackers, miso_particle, seekers)
        rows = torch.cat(
            [f for i in range(6) for f in (g[i] for g in parts)]
            + [state.tracking.to(torch.float32), self.zeros_sm,
               state.start, self.zeros_sm, self.consts.reshape(-1),
               state.target_theta, self.zeros_sm,
               state.target_phi, self.zeros_sm,
               state.target_valid.to(torch.float32), self.zeros_sm]
        ).reshape(len(ctk.ROW_FIELDS), -1)
        out, mean, beam = ctk.swarm_chain(
            self.xyz, win_bp, pw.contiguous(), rows, jumps, reference,
            block_index=block_index, n_iter=cfg.iterations,
            n_sub=cfg.tracker_steps, refine=self.refine, n_trackers=nt,
            span=self.span, taps=self.taps, theta_limit=cfg.theta_limit,
            divisor=float(t_len), closeness=cfg.tracker_closeness,
            error_threshold=cfg.error_threshold,
            probe_layout=cfg.probe_layout, interp=dsp.interp,
            fir_phases=dsp.fir_phases,
            min_power_fraction=cfg.min_power_fraction,
        )
        combo = Particles(*out[:6])
        trackers = Particles(*(x[:nt] for x in combo))
        miso_p = Particles(*(x[nt:nt + 1] for x in combo))
        new_seekers = Particles(*(x[nt + 1:] for x in combo))
        tracking = out[6, :nt] > 0.5          # post-prune
        start = out[7, :nt]
        targets = Targets(
            theta=trackers.theta, phi=trackers.phi, power=trackers.radius,
            probability=1.0 / torch.clamp(trackers.error, min=1e-30),
            start=start, valid=tracking,
        )
        new_state = SwarmState(
            seekers=new_seekers, trackers=trackers, tracking=tracking,
            start=start, jumped=state.jumped, mean=mean,
            reset_count=state.reset_count + 1,
            target_theta=trackers.theta, target_phi=trackers.phi,
            target_valid=tracking,
        )
        return new_state, targets, miso_p, beam


def make_fused_step_impl(cfg, dsp, array_cfg, points, channel_mask=None,
                         probe_span=None, miso_refine_steps: int = 3,
                         device=None) -> FusedSwarmStep:
    """The fused swarm + MISO per-block update (the JAX package's kernel
    path of the same name); raises ``NotImplementedError`` outside it."""
    if cfg.probe_kernel != "pallas":
        raise NotImplementedError(
            f"probe_kernel={cfg.probe_kernel!r}: the port carries only the "
            "swarm-chain kernel path (probe_kernel='pallas'); the XLA "
            "monopulse chain is not ported"
        )
    return FusedSwarmStep(
        cfg, dsp, array_cfg, points, channel_mask, probe_span,
        miso_refine_steps, device,
    )
