"""MISO steered listening (counterpart of ``beamforming_lk_tpu.models.miso``).

The listener is one tracker-like particle that re-centres on the source
with 3 slow monopulse steps per block and emits the delay-and-sum audio
beam at its direction (miso.cpp:25-55).  In the fused per-block step both
ride the swarm kernels (``models/tracker.py``); alone, :class:`MisoStep`
runs the refine steps as one launch of the monopulse-chain kernel, after
the unfused tracker step in :class:`UnfusedSwarmStep`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from beamforming_lk_tpu_torch.device import f32_mode, resolve_device
from beamforming_lk_tpu_torch.models import tracker as tk
from beamforming_lk_tpu_torch.models.tracker import MisoBeam, Particles, ProbeChain
from beamforming_lk_tpu_torch.ops import cuda_tracker as ctk
from beamforming_lk_tpu_torch.ops import delay as dl
from beamforming_lk_tpu_torch.utils import profiling
from beamforming_lk_tpu_torch.utils.graphs import StepGraphs


class MisoState(NamedTuple):
    particle: Particles      # batch of 1
    tracking: torch.Tensor   # [] bool


def miso_init(theta=0.0, phi=0.0, device="cuda") -> MisoState:
    """The listener at (``theta``, ``phi``), tracking, on ``device`` (the
    card unless it names the CPU)."""
    device = resolve_device(device)
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
    refined direction.  With the channels sharded over a mesh (``layout``)
    the refine steps and the beam reduce their partial beams over ``ch``
    (:class:`models.tracker.ProbeChain`, :class:`models.tracker.MisoBeam`).

    ``forward(state, window [C, T+S]) -> (state, beam [T])``."""

    def __init__(self, cfg, dsp, array_cfg, points, channel_mask=None,
                 refine_steps: int = 3, probe_span=None, device="cuda",
                 layout=None):
        super().__init__()
        device = resolve_device(device)
        span = (dsp.shift_range if probe_span is None
                else min(probe_span, dsp.shift_range))
        rate = cfg.tracker_step_gain * cfg.tracker_spread / 3.0
        self.register_buffer("dyn", torch.as_tensor(
            np.array([[rate], [cfg.tracker_spread]], np.float32), device=device))
        self.register_buffer("active", torch.ones(
            (refine_steps, 1), dtype=torch.float32, device=device))
        self.probes = ProbeChain(cfg, dsp, array_cfg, points, channel_mask,
                                 span, layout, device)
        self.beam = MisoBeam(dsp, array_cfg, points, channel_mask, span,
                             device, layout)

    def forward(self, state: MisoState, window):
        win_bp, pw = self.probes.windows(window)
        rows = torch.cat([torch.cat(state.particle)[:, None], self.dyn])
        particle = Particles(*self.probes(win_bp, rows, self.active).unbind(0))
        return state._replace(particle=particle), self.beam(particle, pw)


def make_miso_step_impl(cfg, dsp, array_cfg, points, channel_mask=None,
                        refine_steps: int = 3, probe_span=None,
                        device="cuda", layout=None) -> MisoStep:
    """The unfused MISO per-block update (the JAX package's function of the
    same name); ``layout`` (``parallel.mesh.Layout``) shards it as the JAX
    package's ``axis_name``."""
    return MisoStep(cfg, dsp, array_cfg, points, channel_mask, refine_steps,
                    probe_span, device, layout)


class UnfusedSwarmStep(nn.Module):
    """The unfused tracker step, then the MISO step, each in its span
    (``awpu.swarm``, ``awpu.miso``): ``forward(swarm, miso, window,
    block_index, generator=None, draws=None) -> (swarm, Targets, miso, beam
    [T])``, zero targets with the tracker off, a zero beam with the MISO
    off (with both off, also of a stack of windows [K, C, T+S]).

    Both on, on the XLA chain, without a mesh ``ch`` axis (its collectives
    stay eager), they read no host value but the seeker reset, so on the
    card they replay as one CUDA graph a key (:attr:`graphs`): a key's
    first block eager, its second captured, every later one replayed.
    ``draws`` runs eagerly; ``step.graphs = None`` gives the eager path."""

    def __init__(self, cfg, dsp, array_cfg, points, channel_mask=None,
                 enable_tracker: bool = True, enable_miso: bool = True,
                 probe_span=None, device="cuda", layout=None):
        super().__init__()
        self.cfg, self.block_size = cfg, dsp.block_size
        args = (cfg, dsp, array_cfg, points, channel_mask)
        kw = dict(probe_span=probe_span, device=device, layout=layout)
        self.tracker = tk.make_swarm_step_impl(*args, **kw) if enable_tracker else None
        self.miso = make_miso_step_impl(*args, **kw) if enable_miso else None
        graphed = (enable_tracker and enable_miso and self.tracker.xla
                   and not (layout is not None and layout.has_ch))
        self.graphs = StepGraphs(self._both, counters=(ctk.monopulse_chain,),
                                 span="awpu.swarm.replay") if graphed else None

    def _both(self, swarm, miso, window, stamp, generator):
        """Both steps of one block, as a graph captures them."""
        swarm, targets = self.tracker(swarm, window, stamp, generator=generator)
        miso, beam = self.miso(miso, window)
        return swarm, targets, miso, beam

    def _replay(self, swarm, miso, window, block_index, generator):
        """:meth:`_both` through :attr:`graphs`, keyed by the seeker reset
        and the TF32 switches; the host counter counts on."""
        new, targets, miso, beam = self.graphs(
            (self.tracker.reset_fires(swarm.reset_count), f32_mode()),
            swarm, miso, window, tk.block_stamp(block_index, window), generator)
        return new._replace(reset_count=swarm.reset_count + 1), targets, miso, beam

    def forward(self, swarm, miso: MisoState, window, block_index,
                generator=None, draws=None):
        if self.graphs is not None and window.is_cuda and draws is None:
            with profiling.span("awpu.swarm"):
                return self._replay(swarm, miso, window, block_index, generator)
        lead = window.shape[:-2]
        if self.tracker is None:
            z = torch.zeros((*lead, self.cfg.n_trackers), dtype=torch.float32,
                            device=window.device)
            targets = tk.Targets(z, z, z, z, z, torch.zeros_like(z, dtype=torch.bool))
        else:
            with profiling.span("awpu.swarm"):
                swarm, targets = self.tracker(swarm, window, block_index,
                                              generator=generator, draws=draws)
        if self.miso is None:
            beam = torch.zeros((*lead, self.block_size), dtype=torch.float32,
                               device=window.device)
        else:
            with profiling.span("awpu.miso"):
                miso, beam = self.miso(miso, window)
        return swarm, targets, miso, beam


def make_miso_step(points, cfg, dsp, array_cfg, channel_mask=None,
                   refine_steps: int = 3, device="cuda") -> MisoStep:
    """The single-device per-block MISO update on ``device`` (the card by
    default), its probe span sized from the aperture: ``step(state,
    window) -> (state, beam [T])``, ``refine_steps`` monopulse steps at a
    third of the tracker rate (miso.cpp:39-40), then the beam."""
    taps = dl.LINEAR_TAPS if dsp.interp == "linear" else dsp.fir_taps
    span = dl.probe_span(points, array_cfg.samples_per_meter, taps,
                         dsp.shift_range)
    return MisoStep(cfg, dsp, array_cfg, points, channel_mask, refine_steps,
                    span, device)
