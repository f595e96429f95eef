"""Gradient-ascent source tracker swarm, alone or fused with the MISO
listener (counterpart of ``beamforming_lk_tpu.models.tracker``:
``make_swarm_step_impl``, ``make_fused_step_impl`` and
``make_fused_chunk_impl``).

16 seekers and 10 trackers step by 4-point monopulse (gradient_ascend.cpp);
in the fused step the MISO listener rides the same chain.  Two backends,
as the JAX package's ``TrackerConfig.probe_kernel``:

- ``"pallas"``: the whole per-block update is one call of
  :func:`beamforming_lk_tpu_torch.ops.cuda_tracker.swarm_chain`, and K
  blocks of it one call of ``swarm_chunk`` (the replay path);
- ``"xla"``: the JAX package's iteration scan, with each iteration's
  sub-step chain as one call of ``monopulse_chain`` and the iteration
  boundary (merge, seeker jump, promote) and the publish prune in PyTorch.

This module prepares the kernels' operands (reference power, bandpassed
window, seeker reset, jump draws, packed rows) and unpacks their results.
Every decision that the JAX package takes on the device with a traced
predicate but that depends only on counters (the seeker reset) is taken
here on the host, so a block never waits for the device.
"""

from __future__ import annotations

import math
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from beamforming_lk_tpu_torch.device import f32_mode, resolve_device
from beamforming_lk_tpu_torch.ops import antenna as ant
from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk
from beamforming_lk_tpu_torch.ops import delay as dl
from beamforming_lk_tpu_torch.ops import geometry as gm
from beamforming_lk_tpu_torch.ops.cuda_tracker import block_stamp
from beamforming_lk_tpu_torch.utils import profiling
from beamforming_lk_tpu_torch.utils.graphs import StepGraphs


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


def swarm_init(cfg, generator, device="cuda") -> SwarmState:
    """A fresh swarm on ``device`` (the card unless it names the CPU): the
    seekers drawn uniform in the search domain from ``generator``, which
    must lie on the same kind of device (a CUDA ``torch.Generator`` on the
    card); no trackers yet."""
    device = resolve_device(device)
    if generator is not None and generator.device.type != device.type:
        raise ValueError(
            f"swarm_init draws on {device} but the generator is on "
            f"{generator.device}; pass a torch.Generator(device="
            f"{device.type!r}) or device={generator.device.type!r}"
        )
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


def probe_windows(window, dsp, span: int):
    """(bandpassed compact probe window [..., C, span+T-2] in the probe
    compute dtype, raw compact window [..., C, span+T] f32) of a DAS window
    [..., C, T+S]: its last span+T samples (the probe span's shift base
    moves by the same constant)."""
    pw = window[..., dsp.shift_range - span:].contiguous()
    win_bp = ctk.bandpass_window(pw)
    if dsp.probe_compute == "bfloat16":
        win_bp = win_bp.to(torch.bfloat16)
    return win_bp, pw


class ProbeChain(nn.Module):
    """Chained 4-probe monopulse sub-steps of packed rows, the XLA chain's
    probe evaluation: one launch of the monopulse-chain kernel (K0), or,
    with the channels sharded over a mesh's ``ch`` axis of more than one
    rank, per sub-step one DAS-beam kernel launch (K4) on this rank's
    channels and an all-reduce of the partial beams
    (:func:`ops.cuda_tracker.monopulse_chain_sharded`).  ``xyz`` holds the
    full array's geometry on every rank, so the stencil's min over the
    channels is the global one with no collective."""

    def __init__(self, cfg, dsp, array_cfg, points, channel_mask, span: int,
                 layout=None, device="cuda"):
        super().__init__()
        self.dsp, self.span = dsp, span
        self.register_buffer("xyz", ctk.pack_geometry(
            points, array_cfg.samples_per_meter, channel_mask, device=device))
        self.kw = dict(
            span=span, taps=dl.LINEAR_TAPS if dsp.interp == "linear" else dsp.fir_taps,
            theta_limit=cfg.theta_limit, divisor=float(dsp.block_size),
            probe_layout=cfg.probe_layout, interp=dsp.interp,
            fir_phases=dsp.fir_phases,
        )
        self.shard = None if layout is None or layout.ch.size == 1 else layout.ch
        self.channels = (None if self.shard is None
                         else self.shard.part(np.shape(points)[1]))

    def windows(self, window):
        """(bandpassed, raw) compact probe windows of this rank's window
        [..., C_loc, T+S] (:func:`probe_windows`); the bandpassed one stays
        f32 for the sharded chain, whose kernel rounds it."""
        if self.shard is None:
            return probe_windows(window, self.dsp, self.span)
        pw = window[..., self.dsp.shift_range - self.span:].contiguous()
        return ctk.bandpass_window(pw), pw

    def forward(self, win_bp, rows, active):
        """Rows [8, P] after ``active.shape[0]`` sub-steps -> [6, P]."""
        if self.shard is None:
            return ctk.monopulse_chain(self.xyz, win_bp, rows, active, **self.kw)
        return ctk.monopulse_chain_sharded(
            self.xyz, win_bp, rows, active, channels=self.channels,
            reduce=self.shard.all_reduce, compute=self.dsp.probe_compute,
            **self.kw)


def _merge_trackers(trackers: Particles, tracking, start, closeness: float):
    """Absorb pairwise-close trackers, oldest wins (gradient_ascend.cpp:
    332-351): tracker m stops if a tracking tracker n lies within
    ``closeness`` (``spherical_angle``, as the JAX package's XLA path) and
    started earlier, or at the same block with a lower index."""
    nt = tracking.shape[0]
    ang = gm.spherical_angle(trackers.theta[:, None], trackers.phi[:, None],
                             trackers.theta[None, :], trackers.phi[None, :])
    idx = torch.arange(nt, device=tracking.device)
    close = ((ang < closeness) & tracking[:, None] & tracking[None, :]
             & (idx[:, None] != idx[None, :]))
    older = (start[:, None] > start[None, :]) | (
        (start[:, None] == start[None, :]) & (idx[:, None] > idx[None, :])
    )
    return tracking & ~(close & older).any(dim=1)


class _SwarmRows(nn.Module):
    """Operand prep shared by the swarm steps: the packed geometry and the
    per-row constants of the row layout ``trackers | miso | seekers`` (the
    listener row only with ``n_miso=1``; rates, spreads, family one-hots)
    as buffers, the seeker reset and jump draws, the kernels' operands and
    the unpacking of their rows."""

    def __init__(self, cfg, dsp, array_cfg, points, channel_mask, probe_span,
                 n_miso: int, refine: int, device, layout=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg, self.dsp = cfg, dsp
        self.taps = dl.LINEAR_TAPS if dsp.interp == "linear" else dsp.fir_taps
        self.span = (
            dsp.shift_range if probe_span is None
            else min(probe_span, dsp.shift_range)
        )
        # A mesh with a ch axis takes the XLA chain (the JAX package's
        # _use_pallas_chain gate), and says so where the kernel was asked.
        sharded = layout is not None and layout.has_ch
        if sharded and cfg.probe_kernel == "pallas":
            print("tracker probe_kernel 'pallas' unavailable (sharded "
                  "channels); using the XLA monopulse chain (see "
                  "docs/performance.md)", file=sys.stderr)
        self.xla = cfg.probe_kernel == "xla" or sharded
        self.probes = ProbeChain(cfg, dsp, array_cfg, points, channel_mask,
                                 self.span, layout if sharded else None, device)
        self.n_miso, self.refine = n_miso, refine
        nt, ns = cfg.n_trackers, cfg.n_seekers
        p = nt + n_miso + ns
        tracker_rate = cfg.tracker_step_gain * cfg.tracker_spread
        consts = np.zeros((5, p), np.float32)
        consts[0] = [tracker_rate] * nt + [tracker_rate / 3.0] * n_miso + [
            cfg.seeker_step_gain * cfg.seeker_spread] * ns   # miso.cpp:39-40
        consts[1] = [cfg.tracker_spread] * (nt + n_miso) + [cfg.seeker_spread] * ns
        consts[2, :nt] = 1.0
        consts[3, nt + n_miso:] = 1.0
        consts[4, nt:nt + n_miso] = 1.0
        # The XLA chain's static activity per iteration and sub-step:
        # seekers ride sub-step 0, the listener its refine budget (the
        # trackers' activity, their tracking flags, is added per iteration).
        act = np.zeros((cfg.iterations, cfg.tracker_steps, p), np.float32)
        act[:, 0, nt + n_miso:] = 1.0
        slots = np.arange(cfg.iterations * cfg.tracker_steps).reshape(
            cfg.iterations, cfg.tracker_steps)
        act[..., nt:nt + n_miso] = (slots < refine)[..., None]
        self.register_buffer("consts", torch.as_tensor(consts, device=device))
        self.register_buffer("act_static", torch.as_tensor(act, device=device))
        self.register_buffer("zeros_tm", torch.zeros(
            (2, cfg.iterations, nt + n_miso), dtype=torch.float32, device=device
        ))
        self.register_buffer("zeros_sm", torch.zeros(
            (p - nt,), dtype=torch.float32, device=device
        ))
        self.register_buffer("false_sm", self.zeros_sm > 0.0)

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
        bandpassed compact probe window and the raw compact window.  With
        the channels sharded, global channel 0 lives on the first ``ch``
        rank, which alone contributes to the all-reduce."""
        dsp, t_len = self.dsp, self.dsp.block_size
        b0 = dsp.shift_range - self.taps
        reference = dl.das_power(
            window[..., 0, b0:b0 + t_len], use_bandpass=True,
            divisor=t_len - 2,
        )
        shard = self.probes.shard
        if shard is not None:
            reference = shard.all_reduce(reference * float(shard.index == 0))
        return (reference,) + self.probes.windows(window)

    def reset_fires(self, reset_count: int) -> bool:
        """Whether the block at host counter ``reset_count`` redraws the seekers."""
        return reset_count % self.cfg.seeker_reset_interval == 0

    def _draw(self, state: SwarmState, device, generator, draws):
        """The seekers after this block's reset (every
        ``seeker_reset_interval`` blocks, host counter) and the jump table
        [2, I, P] (zero on non-seeker rows)."""
        cfg = self.cfg
        seekers = state.seekers
        reset = self.reset_fires(state.reset_count)
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
        return seekers, jumps

    def _parts(self, state: SwarmState, miso_particle, seekers):
        return ((state.trackers,) + ((miso_particle,) if self.n_miso else ())
                + (seekers,))

    def _rows(self, state: SwarmState, miso_particle, seekers):
        """The swarm kernels' packed rows [16, P]."""
        parts = self._parts(state, miso_particle, seekers)
        return torch.cat(
            [f for i in range(6) for f in (g[i] for g in parts)]
            + [state.tracking.to(torch.float32), self.zeros_sm,
               state.start, self.zeros_sm, self.consts.reshape(-1),
               state.target_theta, self.zeros_sm,
               state.target_phi, self.zeros_sm,
               state.target_valid.to(torch.float32), self.zeros_sm]
        ).reshape(len(ctk.ROW_FIELDS), -1)

    def _unpack(self, out, tracking, start, state: SwarmState, mean,
                n_blocks: int):
        """Particle rows [..., 6+, P] (a leading block axis or none), the
        post-prune tracking flags and start stamps [..., nt] -> (new state
        after the last block, Targets [..., nt], listener or None)."""
        nt = self.cfg.n_trackers
        fields = [out[..., i, :] for i in range(6)]
        trackers = Particles(*(x[..., :nt] for x in fields))
        targets = Targets(
            theta=trackers.theta, phi=trackers.phi, power=trackers.radius,
            probability=1.0 / torch.clamp(trackers.error, min=1e-30),
            start=start, valid=tracking,
        )
        last = (lambda x: x[-1]) if out.dim() == 3 else (lambda x: x)
        last_trackers = Particles(*map(last, trackers))
        new_state = SwarmState(
            seekers=Particles(*(last(x)[nt + self.n_miso:] for x in fields)),
            trackers=last_trackers, tracking=last(tracking),
            start=last(start), jumped=state.jumped, mean=last(mean),
            reset_count=state.reset_count + n_blocks,
            target_theta=last_trackers.theta, target_phi=last_trackers.phi,
            target_valid=last(tracking),
        )
        miso_p = (Particles(*(last(x)[nt:nt + 1] for x in fields))
                  if self.n_miso else None)
        return new_state, targets, miso_p

    def _update(self, state: SwarmState, miso_particle, window,
                block_index, generator, draws):
        """One block's swarm update through the configured backend ->
        (new state, Targets, listener or None, the swarm-chain kernel's
        MISO beam or None, raw compact window).  ``block_index`` is the
        host counter or its f32 device scalar (:func:`block_stamp`), which
        both backends read on the device."""
        with profiling.span("awpu.swarm.prep"):
            reference, win_bp, pw = self._prep(window)
        with profiling.span("awpu.swarm.draws"):
            seekers, jumps = self._draw(state, window.device, generator, draws)
        beam = None
        stamp = block_stamp(block_index, window)
        with profiling.span("awpu.swarm.run"):
            if not self.xla:
                out, mean, beam = ctk.swarm_chain(
                    self.probes.xyz, win_bp, pw,
                    self._rows(state, miso_particle, seekers), jumps,
                    reference, block_index=stamp, **self._kernel_kw(),
                )
                nt = self.cfg.n_trackers
                tracking, start = out[6, :nt] > 0.5, out[7, :nt]  # post-prune
            else:
                out, tracking, start, mean = self._chain(
                    state, miso_particle, seekers, win_bp, reference, jumps,
                    stamp,
                )
        new_state, targets, miso_p = self._unpack(out, tracking, start, state,
                                                  mean, 1)
        return new_state, targets, miso_p, beam, pw

    def _chain(self, state: SwarmState, miso_particle, seekers, win_bp,
               reference, jumps, stamp):
        """``probe_kernel="xla"``: the JAX package's XLA iteration scan
        (models/tracker.py:491-580, and 846-950 for the fused step) with
        each iteration's sub-step chain as ONE launch of the monopulse-chain
        kernel on all rows: trackers active in every sub-step while
        tracking, seekers in sub-step 0, the listener within its refine
        budget.  The JAX package steps the seekers after the trackers'
        chain and their merge; riding sub-step 0 instead gives the same
        numbers, because each row's sub-step reads only its own state and
        the window, and the merge reads no seeker.  With the channels
        sharded the chain runs through :class:`ProbeChain`'s K4 launches
        and all-reduces instead.  A promoted tracker's start is ``stamp``,
        the block index as an f32 device scalar, so that a CUDA graph of the
        chain reads it as an operand.  Returns (rows [6, P], post-prune
        tracking [nt], start [nt], mean [])."""
        cfg = self.cfg
        nt = cfg.n_trackers
        parts = self._parts(state, miso_particle, seekers)
        rows = torch.stack([torch.cat([g[i] for g in parts]) for i in range(6)])
        dyn = self.consts[:2]
        is_s = self.consts[3] > 0.5
        tracking, start, mean = state.tracking, state.start, state.mean
        for it in range(cfg.iterations):
            active = self.act_static[it] + torch.cat(
                [tracking.to(torch.float32), self.zeros_sm])
            rows = self.probes(win_bp, torch.cat([rows, dyn]), active)
            th, ph, gt, gp, rad, err = rows.unbind(0)
            n_tracking = tracking.sum()

            # Merge close trackers (oldest wins).
            tracking = _merge_trackers(
                Particles(th[:nt], ph[:nt], gt[:nt], gp[:nt], rad[:nt], err[:nt]),
                tracking, start, cfg.tracker_closeness,
            )

            # Jump seekers near a previously published target
            # (gradient_ascend.cpp:360-371).
            ang = gm.spherical_angle(th[:, None], ph[:, None],
                                     state.target_theta[None, :],
                                     state.target_phi[None, :])
            too_close = ((ang < cfg.tracker_closeness)
                         & state.target_valid[None, :]).any(dim=1) & is_s
            j_th, j_ph = gm.normalize_spherical(
                th + jumps[0, it], ph + jumps[1, it], cfg.theta_limit)
            th = torch.where(too_close, j_th, th)
            ph = torch.where(too_close, j_ph, ph)

            # Promote the best converged seeker (first index of the max) to
            # every free tracker (gradient_ascend.cpp:374-393).
            valid = is_s & ~too_close
            converged = valid & (err < cfg.error_threshold)
            best = torch.argmax(torch.where(converged, rad, -math.inf))
            better = (converged & (rad > 0.0)).any()
            promote_t = better & (n_tracking < nt) & ~tracking
            promote = torch.cat([promote_t, self.false_sm])
            best = best.view(1)   # an index tensor: no host sync
            th = torch.where(promote, th.index_select(0, best), th)
            ph = torch.where(promote, ph.index_select(0, best), ph)
            start = torch.where(promote_t, stamp, start)
            tracking = tracking | promote_t

            mean = (torch.where(valid, rad, 0.0).sum()
                    / torch.clamp(valid.sum(), min=1))
            rows = torch.stack([th, ph, gt, gp, rad, err])

        # Publish: prune weak or diverged trackers, then the sidelobe gate
        # (gradient_ascend.cpp:398-408).
        t_rad = rows[4, :nt]
        weak = (t_rad < mean) | (t_rad < reference) | (
            rows[5, :nt] > cfg.error_threshold)
        tracking = tracking & ~weak
        if cfg.min_power_fraction > 0.0:
            strongest = torch.where(tracking, t_rad, 0.0).max()
            tracking = tracking & (t_rad >= cfg.min_power_fraction * strongest)
        return rows, tracking, start, mean


class SwarmStep(_SwarmRows):
    """The unfused per-block swarm update (the JAX package's
    ``make_swarm_step_impl``): rows ``trackers | seekers``, through one
    swarm-chain launch (``probe_kernel="pallas"``; no listener row, so the
    kernel's beam is dropped) or one monopulse-chain launch per iteration
    (``"xla"``).

    ``forward(state, window, block_index, generator=None, draws=None) ->
    (state, Targets)``; ``draws`` as :class:`FusedSwarmStep`'s;
    ``block_index`` the host counter or its :func:`block_stamp`."""

    def __init__(self, cfg, dsp, array_cfg, points, channel_mask=None,
                 probe_span=None, device="cuda", layout=None):
        super().__init__(cfg, dsp, array_cfg, points, channel_mask,
                         probe_span, 0, 0, device, layout)

    def forward(self, state: SwarmState, window, block_index,
                generator: Optional[torch.Generator] = None, draws=None):
        new_state, targets, _, _, _ = self._update(
            state, None, window, block_index, generator, draws)
        return new_state, targets


class FusedSwarmStep(_SwarmRows):
    """The fused tracker + MISO per-block update: rows ``trackers | miso |
    seekers`` through one swarm-chain launch (``probe_kernel="pallas"``,
    the MISO beam from the kernel) or one monopulse-chain launch per
    iteration (``"xla"``, the MISO beam from the f32 stencil in PyTorch).

    ``forward(state, miso_particle, window, block_index, generator=None,
    draws=None) -> (state, Targets, miso_particle, miso_beam[T])``.
    ``draws = (reset_theta[Ns], reset_phi[Ns], jump_theta[I, Ns],
    jump_phi[I, Ns])`` replaces the generator's draws (tests feed the JAX
    package's own draws through it).

    On the kernel backend (so without a mesh ``ch`` axis, whose all-reduce
    in :meth:`_prep` stays eager) the step reads no host value but the
    seeker reset, K1 taking the block's stamp from the card; so on the
    card it replays as one CUDA graph a key (:attr:`graphs`,
    :meth:`_replay`): a key's first block eager, its second captured,
    every later one replayed.  ``draws`` runs eagerly; ``step.graphs =
    None`` gives the eager path."""

    def __init__(self, cfg, dsp, array_cfg, points, channel_mask=None,
                 probe_span=None, miso_refine_steps: int = 3, device="cuda",
                 layout=None):
        if cfg.iterations * cfg.tracker_steps < miso_refine_steps:
            raise ValueError(
                f"fused step needs iterations*tracker_steps >= "
                f"{miso_refine_steps}; got {cfg.iterations}*{cfg.tracker_steps}"
            )
        super().__init__(cfg, dsp, array_cfg, points, channel_mask,
                         probe_span, 1, miso_refine_steps, device, layout)
        self.beam = MisoBeam(dsp, array_cfg, points, channel_mask, self.span,
                             device, layout)
        # self.xla holds under a mesh ch axis too (_SwarmRows).
        self.graphs = None if self.xla else StepGraphs(
            self._step, counters=(ctk.swarm_chain,), span="awpu.swarm.replay")

    def forward(self, state: SwarmState, miso_particle: Particles, window,
                block_index: int, generator: Optional[torch.Generator] = None,
                draws=None):
        if self.graphs is not None and window.is_cuda and draws is None:
            return self._replay(state, miso_particle, window, block_index,
                                generator)
        return self._step(state, miso_particle, window, block_index,
                          generator, draws)

    def _step(self, state: SwarmState, miso_particle: Particles, window,
              block_index, generator=None, draws=None):
        """The eager step of :meth:`forward`."""
        new_state, targets, miso_p, beam, pw = self._update(
            state, miso_particle, window, block_index, generator, draws)
        if beam is None:
            beam = self.beam(miso_p, pw)
        return new_state, targets, miso_p, beam

    def _replay(self, state: SwarmState, miso_particle: Particles, window,
                block_index, generator):
        """:meth:`_step` through :attr:`graphs`, keyed by the seeker reset
        and the TF32 switches; the host counter counts on."""
        new, targets, miso_p, beam = self.graphs(
            (self.reset_fires(state.reset_count), f32_mode()),
            state, miso_particle, window, block_stamp(block_index, window),
            generator)
        return new._replace(reset_count=state.reset_count + 1), targets, miso_p, beam


class MisoBeam(nn.Module):
    """The f32 MISO audio beam at a listener direction (miso.cpp:41-55):
    steering delays, the dense stencil over the probe span times the
    channel mask, contracted with the unfolded raw compact window in plain
    PyTorch (the JAX package runs this product outside any kernel too).
    With the channels sharded over a mesh (``layout``), the delays come
    from the full array and this rank's channels' partial beam is
    all-reduced over ``ch``."""

    def __init__(self, dsp, array_cfg, points, channel_mask, span: int,
                 device="cuda", layout=None):
        super().__init__()
        device = resolve_device(device)
        self.dsp, self.span = dsp, span
        self.channels = (slice(None) if layout is None
                         else layout.ch.part(np.shape(points)[1]))
        self.reduce = (lambda beam: beam) if layout is None else layout.ch.all_reduce
        self.spm = array_cfg.samples_per_meter
        self.register_buffer("points", torch.as_tensor(
            np.asarray(points, np.float32), device=device))
        self.register_buffer("mask", None if channel_mask is None else
                             torch.as_tensor(np.asarray(channel_mask, np.float32),
                                             device=device))
        self.register_buffer("bank", None if dsp.interp == "linear" else
                             torch.as_tensor(dl.fractional_delay_fir_bank(
                                 dsp.fir_phases, dsp.fir_taps), device=device))

    def forward(self, particle: Particles, pw):
        """Beam [T] at ``particle``'s direction from the raw compact window
        ``pw`` [C, span+T]."""
        delays = ant.steering_delays(self.points, particle.theta, particle.phi,
                                     self.spm)                      # [1, C]
        w = dl.das_weights(delays, self.span, self.dsp.interp, self.bank)
        if self.mask is not None:
            w = w * self.mask[:, None]
        unf = dl.unfold_window(pw, self.span, pw.shape[-1] - self.span)
        return self.reduce(dl.das_beam_unfolded(unf, w[:, self.channels]))[0]


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
        self.graphs = None      # one K2 launch a chunk; never replayed
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
        with profiling.span("awpu.swarm.prep"):
            references, win_bp, pw = self._prep(windows)

        # Per-block reset flags from the host counter; the draws as raw
        # uniforms in the per-block order, scaled once for the chunk (the
        # same elementwise ops as _random_directions and _swarm_jumps).
        with profiling.span("awpu.swarm.draws"):
            flags = [self.reset_fires(state.reset_count + k) for k in range(kb)]
            if draws is None:
                r_u, j_u = [], []
                for fires in flags:
                    r_u.append(torch.rand((2, ns), generator=generator,
                                          device=device)
                               if fires else self.zeros_s2)
                    j_u.append(torch.rand((2, cfg.iterations, ns),
                                          generator=generator, device=device))
                r_u = torch.stack(r_u)
                r_th = r_u[:, 0] * cfg.theta_limit
                r_ph = r_u[:, 1] * (2.0 * math.pi)
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

        with profiling.span("awpu.swarm.run"):
            out, mean, beams = ctk.swarm_chunk(
                self.probes.xyz, win_bp, pw,
                self._rows(state, miso_particle, state.seekers), jumps, resets,
                references, block_index0=block_index0, **self._kernel_kw(),
            )
        new_state, targets, miso_p = self._unpack(
            out, out[:, 6, :nt] > 0.5, out[:, 7, :nt], state, mean, kb)
        return new_state, targets, miso_p, beams


def _on(draw, device):
    """A draw given as an array, as an f32 tensor on ``device``."""
    return torch.as_tensor(np.array(draw, np.float32), device=device)


def _require_probe_kernel(cfg, allowed):
    if cfg.probe_kernel not in allowed:
        raise ValueError(f"probe_kernel={cfg.probe_kernel!r}: expected one "
                         f"of {allowed}")


def make_swarm_step_impl(cfg, dsp, array_cfg, points, channel_mask=None,
                         probe_span=None, device="cuda",
                         layout=None) -> SwarmStep:
    """The unfused swarm per-block update (the JAX package's function of
    the same name); ``layout`` (``parallel.mesh.Layout``) shards it as the
    JAX package's ``axis_name``."""
    _require_probe_kernel(cfg, ("pallas", "xla"))
    return SwarmStep(cfg, dsp, array_cfg, points, channel_mask, probe_span,
                     device, layout)


def make_fused_step_impl(cfg, dsp, array_cfg, points, channel_mask=None,
                         probe_span=None, miso_refine_steps: int = 3,
                         device="cuda", layout=None) -> FusedSwarmStep:
    """The fused swarm + MISO per-block update (the JAX package's function
    of the same name); ``layout`` as :func:`make_swarm_step_impl`'s."""
    _require_probe_kernel(cfg, ("pallas", "xla"))
    return FusedSwarmStep(
        cfg, dsp, array_cfg, points, channel_mask, probe_span,
        miso_refine_steps, device, layout,
    )


def make_fused_chunk_impl(cfg, dsp, array_cfg, points, channel_mask=None,
                          probe_span=None, miso_refine_steps: int = 3,
                          device="cuda") -> FusedChunkStep:
    """K blocks of the fused update per launch of the chunk kernel (the JAX
    package's ``make_fused_chunk_impl``; K is the leading axis of the
    windows it is given).  Like the JAX package's, it needs the kernel
    backend, ``probe_kernel="pallas"``."""
    _require_probe_kernel(cfg, ("pallas",))
    return FusedChunkStep(
        cfg, dsp, array_cfg, points, channel_mask, probe_span,
        miso_refine_steps, device,
    )


def make_swarm_step(points, cfg, dsp, array_cfg, channel_mask=None,
                    device="cuda") -> SwarmStep:
    """The single-device per-block swarm update on ``device`` (the card by
    default), with its probe span sized from the aperture: ``step(state,
    window, block_index) -> (state, Targets)`` for the DAS window of
    ``ring_window``.  The FIR stencil comes from ``dsp`` (the kernels'
    closed form), where the JAX package also takes a ``fir_bank``."""
    taps = dl.LINEAR_TAPS if dsp.interp == "linear" else dsp.fir_taps
    span = dl.probe_span(points, array_cfg.samples_per_meter, taps,
                         dsp.shift_range)
    return make_swarm_step_impl(cfg, dsp, array_cfg, points, channel_mask,
                                probe_span=span, device=device)
