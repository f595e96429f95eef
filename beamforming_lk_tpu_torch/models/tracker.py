"""Gradient-ascent source tracker swarm, fused with the MISO listener
(counterpart of ``beamforming_lk_tpu.models.tracker``, the kernel paths of
``make_fused_step_impl`` and ``make_fused_chunk_impl``).

16 seekers and 10 trackers step by 4-point monopulse (gradient_ascend.cpp);
the MISO listener rides the same chain.  The whole per-block update is one
call of :func:`beamforming_lk_tpu_torch.ops.cuda_tracker.swarm_chain`, and
K blocks of it one call of ``swarm_chunk`` (the replay path); this module
prepares their operands (reference power, bandpassed window, seeker reset,
jump draws, packed rows) and unpacks their results.  Every decision
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

    def _kernel_kw(self):
        cfg, dsp = self.cfg, self.dsp
        return dict(
            n_iter=cfg.iterations, n_sub=cfg.tracker_steps,
            refine=self.refine, n_trackers=cfg.n_trackers, span=self.span,
            taps=self.taps, theta_limit=cfg.theta_limit,
            divisor=float(dsp.block_size), closeness=cfg.tracker_closeness,
            error_threshold=cfg.error_threshold,
            probe_layout=cfg.probe_layout, interp=dsp.interp,
            fir_phases=dsp.fir_phases,
            min_power_fraction=cfg.min_power_fraction,
        )

    def _prep(self, window):
        """Kernel operands of a window [C, T+S], or of a stack [K, C, T+S]
        batched: the reference power (bandpass power of channel 0's block,
        gradient_ascend.cpp:304-313, at window offset S - taps), the
        bandpassed compact probe window and the raw compact window."""
        dsp, t_len = self.dsp, self.dsp.block_size
        b0 = dsp.shift_range - self.taps
        reference = dl.das_power(
            window[..., 0, b0:b0 + t_len], use_bandpass=True,
            divisor=t_len - 2,
        )
        pw = window[..., dsp.shift_range - self.span:].contiguous()
        win_bp = ctk.bandpass_window(pw)
        if dsp.probe_compute == "bfloat16":
            win_bp = win_bp.to(torch.bfloat16)
        return reference, win_bp, pw

    def _rows(self, state: SwarmState, miso_particle: Particles, seekers):
        parts = (state.trackers, miso_particle, seekers)
        return torch.cat(
            [f for i in range(6) for f in (g[i] for g in parts)]
            + [state.tracking.to(torch.float32), self.zeros_sm,
               state.start, self.zeros_sm, self.consts.reshape(-1),
               state.target_theta, self.zeros_sm,
               state.target_phi, self.zeros_sm,
               state.target_valid.to(torch.float32), self.zeros_sm]
        ).reshape(len(ctk.ROW_FIELDS), -1)

    def _unpack(self, out, state: SwarmState, mean, n_blocks: int):
        """Kernel state rows [..., 8, P] (a leading block axis or none) ->
        (new state after the last block, Targets [..., nt], listener)."""
        nt = self.cfg.n_trackers
        fields = [out[..., i, :] for i in range(6)]
        trackers = Particles(*(x[..., :nt] for x in fields))
        tracking = out[..., 6, :nt] > 0.5          # post-prune
        start = out[..., 7, :nt]
        targets = Targets(
            theta=trackers.theta, phi=trackers.phi, power=trackers.radius,
            probability=1.0 / torch.clamp(trackers.error, min=1e-30),
            start=start, valid=tracking,
        )
        last = (lambda x: x[-1]) if out.dim() == 3 else (lambda x: x)
        last_trackers = Particles(*map(last, trackers))
        new_state = SwarmState(
            seekers=Particles(*(last(x)[nt + 1:] for x in fields)),
            trackers=last_trackers, tracking=last(tracking),
            start=last(start), jumped=state.jumped, mean=last(mean),
            reset_count=state.reset_count + n_blocks,
            target_theta=last_trackers.theta, target_phi=last_trackers.phi,
            target_valid=last(tracking),
        )
        miso_p = Particles(*(last(x)[nt:nt + 1] for x in fields))
        return new_state, targets, miso_p

    def forward(self, state: SwarmState, miso_particle: Particles, window,
                block_index: int, generator: Optional[torch.Generator] = None,
                draws=None):
        cfg = self.cfg
        device = window.device
        reference, win_bp, pw = self._prep(window)

        # Seeker reset every seeker_reset_interval blocks (host counter).
        seekers = state.seekers
        reset = state.reset_count % cfg.seeker_reset_interval == 0
        if draws is None:
            if reset:
                r_th, r_ph = _random_directions(
                    generator, cfg.n_seekers, cfg.theta_limit, device
                )
            jts, jps = _swarm_jumps(
                generator, cfg.iterations, cfg.n_seekers,
                cfg.theta_limit / 2.0, device,
            )
        else:
            r_th, r_ph, jts, jps = (_on(d, device) for d in draws)
        if reset:
            seekers = seekers._replace(theta=r_th, phi=r_ph)
        jumps = torch.cat(
            [self.zeros_tm, torch.stack([jts, jps])], dim=2
        ).contiguous()

        out, mean, beam = ctk.swarm_chain(
            self.xyz, win_bp, pw, self._rows(state, miso_particle, seekers),
            jumps, reference, block_index=block_index, **self._kernel_kw(),
        )
        new_state, targets, miso_p = self._unpack(out, state, mean, 1)
        return new_state, targets, miso_p, beam


class FusedChunkStep(FusedSwarmStep):
    """K consecutive blocks of the fused tracker + MISO update through ONE
    launch of the chunk kernel (the JAX package's ``make_fused_chunk_impl``):
    the per-block operand prep runs batched over the chunk, and the seeker
    resets are a table the kernel applies before each block.

    ``forward(state, miso_particle, windows[K, C, T+S], block_index0,
    generator=None, draws=None) -> (state, Targets [K, nt], miso_particle,
    beams [K, T])``.  With ``draws=None`` the chunk consumes ``generator``
    in exactly the order of K calls of :meth:`FusedSwarmStep.forward` (a
    reset draw on a block whose reset fires, then the jump draw), so both
    follow the same trajectory.  ``draws = (reset_theta[K, Ns],
    reset_phi[K, Ns], jump_theta[K, I, Ns], jump_phi[K, I, Ns])`` replaces
    the generator's draws; a block's reset draw is read only where its reset
    fires."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        ns = self.cfg.n_seekers
        device = self.consts.device
        self.register_buffer("ones_s", torch.ones((ns,), device=device))
        self.register_buffer("zeros_s2", torch.zeros((2, ns), device=device))

    def forward(self, state: SwarmState, miso_particle: Particles, windows,
                block_index0: int, generator: Optional[torch.Generator] = None,
                draws=None):
        cfg = self.cfg
        device = windows.device
        kb, ns, nt = windows.shape[0], cfg.n_seekers, cfg.n_trackers
        references, win_bp, pw = self._prep(windows)

        # Per-block reset flags from the host counter; the draws as raw
        # uniforms in the per-block order, scaled once for the chunk (the
        # same elementwise ops as _random_directions and _swarm_jumps).
        flags = [(state.reset_count + k) % cfg.seeker_reset_interval == 0
                 for k in range(kb)]
        if draws is None:
            r_u, j_u = [], []
            for fires in flags:
                r_u.append(torch.rand((2, ns), generator=generator,
                                      device=device) if fires else self.zeros_s2)
                j_u.append(torch.rand((2, cfg.iterations, ns),
                                      generator=generator, device=device))
            r_u = torch.stack(r_u)
            r_th, r_ph = r_u[:, 0] * cfg.theta_limit, r_u[:, 1] * (2.0 * math.pi)
            j_u = (torch.stack(j_u) * 2.0 - 1.0) * (cfg.theta_limit / 2.0)
            jts, jps = j_u[:, 0], j_u[:, 1]
        else:
            r_th, r_ph, jts, jps = (_on(d, device) for d in draws)
        flag_s = torch.stack(
            [self.ones_s if fires else self.zeros_sm[:ns] for fires in flags]
        )
        resets = torch.cat([
            torch.zeros((kb, 3, nt + 1), dtype=torch.float32, device=device),
            torch.stack([flag_s, r_th, r_ph], dim=1),
        ], dim=2)
        jumps = torch.cat([
            self.zeros_tm[None].expand(kb, -1, -1, -1),
            torch.stack([jts, jps], dim=1),
        ], dim=3)

        out, mean, beams = ctk.swarm_chunk(
            self.xyz, win_bp, pw, self._rows(state, miso_particle, state.seekers),
            jumps, resets, references, block_index0=block_index0,
            **self._kernel_kw(),
        )
        new_state, targets, miso_p = self._unpack(out, state, mean, kb)
        return new_state, targets, miso_p, beams


def _on(draw, device):
    """A draw given as an array, as an f32 tensor on ``device``."""
    return torch.as_tensor(np.array(draw, np.float32), device=device)


def _require_kernel_path(cfg):
    if cfg.probe_kernel != "pallas":
        raise NotImplementedError(
            f"probe_kernel={cfg.probe_kernel!r}: the port carries only the "
            "swarm-chain kernel path (probe_kernel='pallas'); the XLA "
            "monopulse chain is not ported"
        )


def make_fused_step_impl(cfg, dsp, array_cfg, points, channel_mask=None,
                         probe_span=None, miso_refine_steps: int = 3,
                         device=None) -> FusedSwarmStep:
    """The fused swarm + MISO per-block update (the JAX package's kernel
    path of the same name); raises ``NotImplementedError`` outside it."""
    _require_kernel_path(cfg)
    return FusedSwarmStep(
        cfg, dsp, array_cfg, points, channel_mask, probe_span,
        miso_refine_steps, device,
    )


def make_fused_chunk_impl(cfg, dsp, array_cfg, points, channel_mask=None,
                          probe_span=None, miso_refine_steps: int = 3,
                          device=None) -> FusedChunkStep:
    """K blocks of the fused update per launch of the chunk kernel (the JAX
    package's ``make_fused_chunk_impl``; K is the leading axis of the
    windows it is given); raises ``NotImplementedError`` outside the kernel
    path."""
    _require_kernel_path(cfg)
    return FusedChunkStep(
        cfg, dsp, array_cfg, points, channel_mask, probe_span,
        miso_refine_steps, device,
    )
