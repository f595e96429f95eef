"""AWPU: the per-block processing step on one device
(counterpart of ``beamforming_lk_tpu.app.awpu``).

    step(state, block) ->
        heatmap powers [D]   (MIMO worker,    mimo.cpp:97-151)
        target list          (GRADIENT worker, gradient_ascend.cpp:301-409)
        audio beam [T]       (MISO worker,    miso.cpp:25-55)

Stages per 256-sample block: ring push and window; the heatmap on every
``heatmap_every``-th block, separable-FFT (plain matrix products) or dense
(the DAS-beam kernel; also the fft backend's fallback for gain masks and
non-lattice apertures); the tracker swarm, fused with the MISO listener
at a real-time cadence, else the two as separate steps; and the published
outputs.  The block counter and the heatmap decimation are host-side, so
a block issues its device work without waiting on it.  On the card the
separate steps on the XLA chain (the default profile) replay as one CUDA
graph a block (``models/miso.py``): ~1030 launches become one.

Replay (``AwpuPipeline.process_blocks``) runs ``fused_chunk`` blocks per
launch of the chunk kernel, with their heatmaps at the decimated positions
batched into one call of the chunked heatmap (the JAX package's
``_fused_chunk_scan``); a pipeline with the tracker and MISO off replays
``heatmap_chunk`` blocks per batched heatmap (``_chunk_scan``).  Per-block
outputs equal :meth:`AwpuPipeline.process_block`'s: a batch that does not
split into whole chunks, or that starts off the decimation phase, runs
block by block.

``AwpuPipeline`` also calibrates the array from its carried history
(``calibrate``), saves and restores its state (``save``, ``restore``), and
with ``heatmap_mode="mvdr"`` or ``"music"`` renders an adaptive estimator's
spectrum (``models.mvdr``, ``models.music``) in place of the DAS heatmap.

With a mesh (``parallel.make_mesh``; one process a rank) the step is the
JAX package's sharded one: each rank holds its ``ch`` block of the
history and its ``dir`` block of the powers, the swarm and the listener
are replicated, and the collectives make the ranks agree.  The fft
heatmap runs whole on every rank and is sliced to its directions when
``ch`` has size 1; otherwise the dense heatmap runs on the rank's
(direction, channel) block through the DAS-beam kernel and an all-reduce
over ``ch``.  The tracker and MISO take the XLA chain (K0, or with ``ch``
above 1 a K4 launch and an all-reduce per sub-step), and the replay steps
block by block.
"""

from __future__ import annotations

import contextlib
import sys
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

from beamforming_lk_tpu_torch.device import full_f32, resolve_device
from beamforming_lk_tpu_torch.io import checkpoint as ckpt
from beamforming_lk_tpu_torch.io import ring as rg
from beamforming_lk_tpu_torch.models import calibration as cal
from beamforming_lk_tpu_torch.models import miso as ms
from beamforming_lk_tpu_torch.models import music as mu
from beamforming_lk_tpu_torch.models import mvdr as mv
from beamforming_lk_tpu_torch.models import tracker as tk
from beamforming_lk_tpu_torch.models.mimo import (
    make_mimo_grid, make_mimo_model, mimo_power, render_heatmap,
)
from beamforming_lk_tpu_torch.ops import antenna as ant
from beamforming_lk_tpu_torch.ops import delay as dl
from beamforming_lk_tpu_torch.ops import fft_das as fd
from beamforming_lk_tpu_torch.parallel.mesh import Layout
from beamforming_lk_tpu_torch.utils import profiling


class AwpuState(NamedTuple):
    """Carried state of one array's pipeline (under a mesh, the rank's
    shards of ``history`` and ``powers``; the rest replicated)."""

    history: torch.Tensor       # [C, H] ring history
    swarm: tk.SwarmState
    miso: ms.MisoState
    prev_max: torch.Tensor      # [] heatmap running-max EMA
    block_index: int            # host block counter
    powers: torch.Tensor        # [D] last computed heatmap powers


class AwpuOutputs(NamedTuple):
    powers: torch.Tensor        # [D]
    targets: tk.Targets
    miso_beam: torch.Tensor     # [T]
    prev_max: torch.Tensor      # []


def _ema_chain(maxes, prev_max, alpha: float):
    """All n EMA states ``m_j = a*max_j + (1-a)*m_{j-1}`` of a chunk's map
    maxima [n] in closed form (the recurrence is linear)."""
    decay = (1.0 - alpha) ** torch.arange(
        maxes.shape[0] + 1, dtype=maxes.dtype, device=maxes.device
    )
    contrib = torch.cumsum(alpha * maxes / decay[:-1], dim=0) * decay[:-1]
    return contrib + prev_max * decay[1:]


def _join(how, *outs: AwpuOutputs) -> AwpuOutputs:
    """``how`` of each tensor's list across ``outs`` (the targets'
    included): a stack, a cat, or the last block of one stack."""
    return pytree.tree_map(lambda *xs: how(xs), *outs)


class AwpuStep(nn.Module):
    """The per-block step, ``forward(state, block, generator=None,
    draws=None) -> (state, AwpuOutputs)``, and the chunked replay of a
    batch, :meth:`scan_chunks`.  With the tracker off the targets are zero,
    with the MISO off the beam is zero; with both off the pipeline is
    heatmap-only.  With a mesh ``layout`` (``parallel.mesh.Layout``) the
    step takes and keeps this rank's shards (module docstring) and never
    replays in chunks."""

    def __init__(self, points, cfg, channel_mask=None, enable_mimo=True,
                 enable_tracker=True, enable_miso=True, device="cuda",
                 layout: Optional[Layout] = None):
        super().__init__()
        device = resolve_device(device)
        dsp, arr, tc = cfg.dsp, cfg.array, cfg.tracker
        self.cfg = cfg
        self.layout = layout
        self.enable_mimo = enable_mimo
        self.taps = dl.LINEAR_TAPS if dsp.interp == "linear" else dsp.fir_taps
        points = np.asarray(points, np.float32)
        self.fft_model = self.mimo_model = None
        if enable_mimo:
            theta, phi = make_mimo_grid(cfg.mimo)
            delays = ant.steering_delays_np(points, theta, phi,
                                            arr.samples_per_meter)
            span_needed = float(delays.max()) + self.taps
            if span_needed > dsp.shift_range:
                raise ValueError(
                    f"aperture needs a shift span of {span_needed:.0f} samples "
                    f"but DspConfig.shift_range is {dsp.shift_range}"
                )
            if cfg.mimo.backend == "fft":
                # The fft heatmap needs every channel: under a mesh it runs
                # whole on each rank, so only where ch has size 1.
                if layout is None or layout.ch.size == 1:
                    self.fft_model = fd.make_fft_heatmap_model(
                        points, cfg.mimo, dsp, arr, channel_mask=channel_mask,
                        compute=dsp.compute, device=device,
                    )
                if self.fft_model is None:
                    # The JAX package's own fallback to the dense heatmap.
                    print("mimo backend 'fft' unavailable for this "
                          "geometry/mask/mesh; using dense", file=sys.stderr)
            if self.fft_model is None:
                self.mimo_model = make_mimo_model(
                    points, cfg.mimo, dsp, arr, channel_mask=channel_mask,
                    compute=dsp.compute, device=device, layout=layout,
                )
                self.n_active = float(points.shape[1] if channel_mask is None
                                      else np.sum(channel_mask))
            elif layout is not None:
                self.directions = layout.dir.part(cfg.mimo.n_directions)
        span = dl.probe_span(points, arr.samples_per_meter, self.taps,
                             dsp.shift_range)
        # Tracker and MISO both on at a real-time cadence share one swarm
        # update (the JAX package's use_fused gate); otherwise each runs
        # its own step, or with both off neither.
        fused = (enable_tracker and enable_miso and tc.iterations <= 4
                 and tc.iterations * tc.tracker_steps >= 3)
        self.swarm_step = self.unfused_step = self.chunk_step = None
        args = (tc, dsp, arr, points, channel_mask)
        step_kw = dict(probe_span=span, device=device, layout=layout)
        if fused:
            self.swarm_step = tk.make_fused_step_impl(*args, **step_kw)
        else:
            self.unfused_step = ms.UnfusedSwarmStep(
                *args, enable_tracker, enable_miso, **step_kw)
        # Replay chunk: K-block kernel launches with the fused swarm on the
        # kernel backend, batched heatmaps without a swarm; the heatmap
        # decimation stays chunk-aligned.  Other pipelines replay block by
        # block.
        self.every = max(cfg.mimo.heatmap_every, 1) if enable_mimo else 1
        heatmap_only = not (enable_tracker or enable_miso)
        if layout is not None:
            chunk = 0
        elif fused and tc.probe_kernel == "pallas":
            chunk = dsp.fused_chunk
        else:
            chunk = cfg.mimo.heatmap_chunk if heatmap_only and enable_mimo else 0
        self.chunk = chunk if chunk > 1 and chunk % self.every == 0 else 0
        if self.chunk and fused:
            self.chunk_step = tk.make_fused_chunk_impl(*args, probe_span=span,
                                                       device=device)

    def _maps(self, windows):
        """Heatmap powers [D] of a window [C, T+S], or [K, D] of a stack
        [K, C, T+S] in one batched call (one DAS-beam launch on the dense
        path)."""
        if self.fft_model is None:
            return mimo_power(windows, self.mimo_model, self.n_active)
        if windows.dim() == 2:
            return fd.fft_heatmap_powers(windows, self.fft_model)
        return fd.fft_heatmap_powers_chunked(windows, self.fft_model)

    def _heatmap(self, window):
        """(this rank's powers, the whole map's maximum) of a window: the
        whole map without a mesh; under one, the fft map sliced to the
        rank's directions, or the dense map's direction block reduced over
        ``ch`` with its maximum reduced over ``dir``."""
        layout = self.layout
        if layout is None:
            powers = self._maps(window)
            return powers, torch.max(powers)
        if self.fft_model is not None:
            powers = self._maps(window)
            return powers[self.directions], torch.max(powers)
        powers = mimo_power(window, self.mimo_model, self.n_active,
                            reduce=layout.ch.all_reduce)
        return powers, layout.dir.all_reduce(torch.max(powers),
                                             op=dist.ReduceOp.MAX)

    def forward(self, state: AwpuState, block, generator=None, draws=None):
        cfg, dsp = self.cfg, self.cfg.dsp
        with profiling.span("awpu.ring"):
            history = rg.ring_push(state.history, block)
            window = rg.ring_window(history, dsp.block_size, dsp.shift_range,
                                    self.taps)
        powers, prev_max = state.powers, state.prev_max
        if self.enable_mimo and state.block_index % cfg.mimo.heatmap_every == 0:
            with profiling.span("awpu.heatmap"):
                powers, peak = self._heatmap(window)
                a = cfg.mimo.ema_alpha
                prev_max = peak * a + (1.0 - a) * state.prev_max
        if self.swarm_step is not None:
            with profiling.span("awpu.swarm"):
                swarm, targets, miso_p, miso_beam = self.swarm_step(
                    state.swarm, state.miso.particle, window, state.block_index,
                    generator=generator, draws=draws,
                )
            miso = state.miso._replace(particle=miso_p)
        else:
            swarm, targets, miso, miso_beam = self.unfused_step(
                state.swarm, state.miso, window, state.block_index,
                generator=generator, draws=draws,
            )
        new_state = AwpuState(
            history=history,
            swarm=swarm,
            miso=miso,
            prev_max=prev_max,
            block_index=state.block_index + 1,
            powers=powers,
        )
        return new_state, AwpuOutputs(powers, targets, miso_beam, prev_max)

    def takes_chunks(self, state: AwpuState, n_blocks: int) -> bool:
        """Whether :meth:`scan_chunks` may replay ``n_blocks`` blocks from
        ``state``: whole chunks, starting on the decimation phase (the JAX
        package's chunk assumes that phase but does not check it)."""
        return (self.chunk > 0 and n_blocks % self.chunk == 0
                and state.block_index % self.every == 0)

    def scan_chunks(self, state: AwpuState, blocks, generator=None,
                    draws=None):
        """Replay [M, C, T] blocks in chunks of :attr:`chunk` (see
        :meth:`takes_chunks`); returns ``(state, AwpuOutputs)`` with outputs
        stacked per block.  ``draws`` are the per-block draws stacked on a
        leading axis of M (``FusedChunkStep``)."""
        cfg, dsp = self.cfg, self.cfg.dsp
        ck, every, t_len = self.chunk, self.every, dsp.block_size
        m, c = blocks.shape[0], blocks.shape[1]
        h = state.history.shape[-1]
        # The whole replay behind the history; chunk i's windows are a view
        # of its first h + (i+1)*ck*T samples.
        with profiling.span("awpu.ring"):
            big = torch.cat(
                [state.history, blocks.permute(1, 0, 2).reshape(c, m * t_len)],
                dim=1,
            )
        swarm, miso_p, prev_max = state.swarm, state.miso.particle, state.prev_max
        bi, powers_last = state.block_index, state.powers
        outs = []
        for i in range(m // ck):
            with profiling.span("awpu.ring"):
                windows = rg.ring_windows(big[:, :h + (i + 1) * ck * t_len],
                                          t_len, dsp.shift_range, self.taps, ck)
            if self.chunk_step is None:     # heatmap-only: zero outputs
                _, targets_k, _, beams = self.unfused_step(swarm, state.miso,
                                                           windows, bi)
            else:
                d_i = None if draws is None else tuple(
                    d[i * ck:(i + 1) * ck] for d in draws)
                with profiling.span("awpu.swarm"):
                    swarm, targets_k, miso_p, beams = self.chunk_step(
                        swarm, miso_p, windows, bi, generator=generator,
                        draws=d_i,
                    )
            if self.enable_mimo:
                with profiling.span("awpu.heatmap"):
                    maps = self._maps(windows[::every])
                    emas = _ema_chain(maps.amax(dim=-1), prev_max,
                                      cfg.mimo.ema_alpha)
                    powers_k = maps.repeat_interleave(every, dim=0)
                    prev_k = emas.repeat_interleave(every)
                prev_max, powers_last = emas[-1], maps[-1]
            else:
                powers_k = powers_last.expand(ck, -1)
                prev_k = prev_max.expand(ck)
            outs.append(AwpuOutputs(powers_k, targets_k, beams, prev_k))
            bi += ck
        with profiling.span("awpu.outputs"):
            stacked = _join(torch.cat, *outs)
        new_state = AwpuState(
            history=big[:, -h:].contiguous(),
            swarm=swarm,
            miso=state.miso._replace(particle=miso_p),
            prev_max=prev_max,
            block_index=bi,
            powers=powers_last,
        )
        return new_state, stacked


def _placement(mesh, device):
    """(layout or None, torch device) of an entry point's ``mesh`` and
    ``device``: under a CUDA mesh the rank's current card."""
    if mesh is None:
        return None, resolve_device(device)
    layout = Layout(mesh)
    return layout, layout.device(device)


def make_awpu_step(points, cfg, channel_mask=None, mesh=None,
                   enable_mimo: bool = True, enable_tracker: bool = True,
                   enable_miso: bool = True, device="cuda") -> AwpuStep:
    """Build the step on ``device`` (the card unless it names the CPU): the
    fused tracker + MISO step, the unfused tracker and MISO steps (either
    one off, or more than 4 iterations), or with both off the heatmap-only
    step.  ``mesh`` (a ``DeviceMesh`` with axes ``ch`` and / or ``dir``,
    whose device type ``device`` must match) shards it; C must split over
    ``ch`` and D over ``dir``."""
    layout, device = _placement(mesh, device)
    return AwpuStep(points, cfg, channel_mask, enable_mimo, enable_tracker,
                    enable_miso, device, layout)


def awpu_init(cfg, channels: int, mesh=None, seed: int = 0, device="cuda",
              generator: Optional[torch.Generator] = None) -> AwpuState:
    """Fresh state on ``device`` (the card by default): empty ring, swarm
    drawn from ``generator`` (or one seeded with ``seed``, the same on
    every rank), MISO at boresight; under a ``mesh``, this rank's blocks of
    the ring's channels and of the powers."""
    layout, device = _placement(mesh, device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    c, d = channels, cfg.mimo.n_directions
    if layout is not None:
        c, d = layout.ch.count(c), layout.dir.count(d)
    return AwpuState(
        history=rg.ring_init(c, cfg.dsp.history, device=device),
        swarm=tk.swarm_init(cfg.tracker, generator, device),
        miso=ms.miso_init(device=device),
        prev_max=torch.zeros((), dtype=torch.float32, device=device),
        block_index=0,
        powers=torch.zeros((d,), dtype=torch.float32, device=device),
    )


def shard_state(state: AwpuState, layout: Optional[Layout]) -> AwpuState:
    """This rank's shards of a whole state: its channels of the history,
    its directions of the powers (the state itself without a mesh)."""
    if layout is None:
        return state
    return state._replace(
        history=state.history[layout.ch.part(state.history.shape[0])].contiguous(),
        powers=state.powers[layout.dir.part(state.powers.shape[0])].contiguous(),
    )


def gather_state(state: AwpuState, layout: Optional[Layout]) -> AwpuState:
    """The whole state from every rank's shards (collectives over ``ch``
    and ``dir``; the state itself without a mesh)."""
    if layout is None:
        return state
    return state._replace(history=layout.ch.all_gather(state.history),
                          powers=layout.dir.all_gather(state.powers))


class AwpuPipeline:
    """Host-side orchestrator for one array link (the reference's
    ``AWProcessingUnit``): owns the step, its state and its generator, and
    exposes ``process_block``, ``process_blocks``, ``steer``, ``targets``,
    ``heatmap``, ``calibrate``, ``save`` and ``restore``.  It runs on the
    card unless ``device`` names the CPU, where the kernels' plain twins
    run.  Its own calls run f32 products without TF32 and leave the
    caller's TF32 settings as they were (:func:`device.full_f32`).

    ``heatmap_mode`` "mvdr" (Capon, its solve every ``mvdr_refresh``-th
    block) or "music" (``music_solver``, ``music_sources`` = K) turns the
    DAS heatmap off and runs the estimator on every block beside the
    tracker and the MISO listener; ``heatmap()`` renders its spectrum.  As
    in the JAX package, ``calibrate`` rebuilds only the DAS step (the
    estimator keeps the mask it was built with), and ``save`` / ``restore``
    carry the ``AwpuState`` alone, not the estimator's covariance.

    With a ``mesh`` (one pipeline a rank, each built with the same
    arguments and seed) the step is sharded (module docstring): blocks come
    whole or as the ``DTensor`` of ``parallel.multihost.
    global_block_from_local``; ``heatmap()`` gathers the powers over
    ``dir``; ``calibrate`` gathers the history over ``ch``, and every rank
    computes the same mask; ``save`` gathers the state and the mesh's first
    rank writes it, ``restore`` reads the file on every rank, each keeping
    its shards; the estimator of ``heatmap_mode`` runs whole on every rank
    on the block gathered over ``ch``."""

    #: The checkpoint key of the generator's state: the port's draws come
    #: from :attr:`generator`, where the JAX package carries ``.swarm/.key``.
    GENERATOR_KEY = "generator"

    def __init__(self, cfg, points=None, channel_mask=None, mesh=None,
                 seed: int = 0, enable_mimo: bool = True,
                 enable_tracker: bool = True, enable_miso: bool = True,
                 heatmap_mode: str = "das", channels: Optional[int] = None,
                 music_solver: str = "subspace", music_sources: int = 3,
                 mvdr_refresh: int = 1, device="cuda"):
        if heatmap_mode not in ("das", "mvdr", "music"):
            raise ValueError(f"heatmap_mode must be 'das', 'mvdr' or 'music', "
                             f"got {heatmap_mode!r}")
        self.cfg = cfg
        self.mesh = mesh
        self.layout, self.device = _placement(mesh, device)
        if points is None:
            points = ant.multi_array_cluster(
                cfg.array.elements if channels is None else channels,
                cfg.array.columns, cfg.array.rows, cfg.array.distance,
            )
        self.points = np.asarray(points, np.float32)
        self.channel_mask = channel_mask
        self.heatmap_mode = heatmap_mode
        self._enable = dict(enable_mimo=enable_mimo and heatmap_mode == "das",
                            enable_tracker=enable_tracker,
                            enable_miso=enable_miso)
        self.step = self._make_step(channel_mask)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = awpu_init(cfg, self.points.shape[1], mesh=mesh,
                               device=self.device, generator=self.generator)
        self.last: Optional[AwpuOutputs] = None
        # The adaptive estimator, its state, its last spectrum and the EMA
        # of its rendered maxima (the JAX package's names).
        self._mvdr_step = self._mvdr_state = self._mvdr_powers = None
        if heatmap_mode != "das":
            theta, phi = make_mimo_grid(cfg.mimo)
            if heatmap_mode == "mvdr":
                self._mvdr_step, _ = mv.make_mvdr_step(
                    self.points, theta, phi, cfg.array,
                    channel_mask=channel_mask, weight_refresh=mvdr_refresh,
                    device=self.device)
            else:
                self._mvdr_step, _ = mu.make_music_step(
                    self.points, theta, phi, cfg.array,
                    channel_mask=channel_mask, solver=music_solver,
                    n_sources=music_sources, device=self.device)
            self._mvdr_state = self._mvdr_step.init()
            self._mvdr_prev = torch.zeros((), dtype=torch.float32,
                                          device=self.device)

    def _make_step(self, channel_mask) -> AwpuStep:
        return AwpuStep(self.points, self.cfg, channel_mask, device=self.device,
                        layout=self.layout, **self._enable)

    def _blocks(self, blocks, dim: int):
        """(this rank's channels, the whole block or None) of a block
        (``dim`` 0) or a stack (``dim`` 1): numpy, a tensor, or a
        ``DTensor`` sharded over ``ch``, gathered only for an estimator."""
        whole = None
        if isinstance(blocks, DTensor):
            local = blocks.to_local()
            if self._mvdr_step is not None:
                whole = blocks.full_tensor()
        else:
            whole = torch.as_tensor(blocks, dtype=torch.float32,
                                    device=self.device)
            local = whole
            if self.layout is not None:
                part = self.layout.ch.part(whole.shape[dim])
                local = whole.narrow(dim, part.start, part.stop - part.start)
        return local, whole

    @contextlib.contextmanager
    def _call(self, blocks, dim: int):
        """The entries' prologue in ``awpu.call``, without TF32: the intake
        (:meth:`_blocks`), the estimator's step or scan; yields the local part."""
        with profiling.span("awpu.call"):
            with profiling.span("awpu.intake"):
                local, whole = self._blocks(blocks, dim)
            with full_f32():
                if self._mvdr_step is not None:
                    with profiling.span("awpu.estimator"):
                        run = self._mvdr_step.scan if dim else self._mvdr_step
                        self._mvdr_state, powers = run(self._mvdr_state, whole)
                        self._mvdr_powers = powers[-1] if dim else powers
                yield local

    def process_block(self, block, draws=None) -> AwpuOutputs:
        """Feed one [C, T] block (numpy, a tensor, or under a mesh the
        ``DTensor`` of its ``ch`` shards) through the estimator, if any,
        and the step."""
        with self._call(block, 0) as block:
            self.state, self.last = self.step(
                self.state, block, generator=self.generator, draws=draws)
            return self.last

    def process_blocks(self, blocks, draws=None) -> AwpuOutputs:
        """Drive M stacked blocks [M, C, T]; outputs stack on the leading
        axis and equal M calls of :meth:`process_block`.  Whole chunks that
        start on the heatmap decimation phase replay through
        :meth:`AwpuStep.scan_chunks` (one chunk-kernel launch per
        ``fused_chunk`` blocks); any other batch, and every batch under a
        mesh, runs block by block.  ``draws`` are :meth:`process_block`'s
        draws stacked over the M blocks."""
        with self._call(blocks, 1) as blocks:
            if self.step.takes_chunks(self.state, blocks.shape[0]):
                self.state, stacked = self.step.scan_chunks(
                    self.state, blocks, self.generator, draws)
                with profiling.span("awpu.outputs"):
                    self.last = _join(lambda xs: xs[0][-1], stacked)
                return stacked
            outs = []
            for i, b in enumerate(blocks):
                self.state, self.last = self.step(
                    self.state, b, generator=self.generator,
                    draws=None if draws is None else tuple(d[i] for d in draws))
                outs.append(self.last)
            with profiling.span("awpu.outputs"):
                return _join(torch.stack, *outs)

    @property
    def miso_enabled(self) -> bool:
        """Whether the pipeline runs the MISO listener."""
        return self._enable["enable_miso"]

    @property
    def is_root(self) -> bool:
        """Whether this pipeline writes outputs: always without a mesh,
        on the mesh's first rank with one."""
        return self.layout is None or self.layout.is_root

    def steer(self, theta: float, phi: float) -> None:
        """Pin the MISO listener (click-to-steer)."""
        self.state = self.state._replace(
            miso=ms.miso_steer(self.state.miso, theta, phi)
        )

    def targets(self):
        """Last published targets as a list of dicts (one device fetch)."""
        if self.last is None:
            return []
        from beamforming_lk_tpu_torch.models.targets import targets_to_list

        return targets_to_list(self.last.targets)

    def heatmap(self):
        """The last powers rendered to a uint8 [rows, cols] numpy image: the
        estimator's spectrum, normalised by its maximum, when there is one
        (each call advances the EMA of its maxima, as in the JAX package),
        else the DAS heatmap (under a mesh gathered over ``dir``, a
        collective every rank calls)."""
        mimo = self.cfg.mimo
        if self._mvdr_powers is not None:
            img, self._mvdr_prev = render_heatmap(
                self._mvdr_powers, mimo.rows, mimo.columns, self._mvdr_prev,
                ema_alpha=mimo.ema_alpha, use_db=mimo.use_db,
            )
            return img.cpu().numpy()
        if self.last is None:
            return np.zeros((mimo.rows, mimo.columns), np.uint8)
        powers = self.last.powers
        if self.layout is not None:
            powers = self.layout.dir.all_gather(powers)
        img, _ = render_heatmap(
            powers, mimo.rows, mimo.columns, self.state.prev_max,
            ema_alpha=1.0, use_db=mimo.use_db,
        )
        return img.cpu().numpy()

    def calibrate(self, blocks=None, apply_gains: bool = False):
        """Auto-calibrate and rebuild the step with the resulting channel
        mask (``AWProcessingUnit::calibrate``, aw_processing_unit.cpp:
        102-212).  ``blocks``: [C, T] blocks fed first (else the carried
        history is used as it is); the carried history (under a mesh
        gathered over ``ch``) is calibrated on the device and the mask
        fetched to the host once.  ``apply_gains`` folds ``sqrt(gains)``
        into the mask: a gain mask, which the fft heatmap cannot take, so
        the step falls back to the dense heatmap.  The state carries over.
        Returns the ``CalibrationResult``."""
        if blocks is not None:
            for b in blocks:
                self.process_block(b)
        history = gather_state(self.state, self.layout).history
        with full_f32():
            result = cal.calibrate(history)
        mask, gains = torch.stack([result.mask, result.gains]).cpu().numpy()
        if apply_gains:
            mask = mask * np.sqrt(gains)     # power gains; beams scale by sqrt
        self.channel_mask = mask
        self.step = self._make_step(mask)
        return result

    def save(self, path: str) -> None:
        """Checkpoint the carried state (ring history, swarm, MISO, EMA,
        counters) and the generator's state to ``path`` (.npz), keyed as
        the JAX package keys its state.  Under a mesh every rank gathers
        the state, the first writes it, and all wait for the file."""
        state = gather_state(self.state, self.layout)
        if self.is_root:
            ckpt.save_state(path, state, extra={
                self.GENERATOR_KEY: self.generator.get_state().numpy()})
        if self.layout is not None:
            self.layout.barrier()

    def restore(self, path: str) -> None:
        """Load a checkpoint that :meth:`save` wrote, or that the JAX
        package's ``AwpuPipeline.save`` wrote, onto this pipeline's device
        (under a mesh, each rank its shards).
        With the generator's state in the file the pipeline continues bit
        for bit as the saved one would have; a JAX file carries no torch
        generator (its ``.swarm/.key`` is not read), so the state is the
        same and the later draws are this pipeline's own."""
        template = gather_state(self.state, self.layout)
        self.state = shard_state(ckpt.load_state(path, template), self.layout)
        with np.load(path) as data:
            if self.GENERATOR_KEY in data:
                self.generator.set_state(torch.as_tensor(data[self.GENERATOR_KEY]))
