"""AWPU: the fused per-block processing step on one device
(counterpart of ``beamforming_lk_tpu.app.awpu``).

    step(state, block) ->
        heatmap powers [D]   (MIMO worker,    mimo.cpp:97-151)
        target list          (GRADIENT worker, gradient_ascend.cpp:301-409)
        audio beam [T]       (MISO worker,    miso.cpp:25-55)

Stages per 256-sample block: ring push and window, the separable-FFT
heatmap on every ``heatmap_every``-th block (plain matrix products), the
tracker swarm with the MISO listener through the swarm-chain kernel, and
the published outputs.  The block counter and the heatmap decimation are
host-side, so a block issues its device work without waiting on it.

Configurations outside this slice raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from beamforming_lk_tpu_torch.io import ring as rg
from beamforming_lk_tpu_torch.models import miso as ms
from beamforming_lk_tpu_torch.models import tracker as tk
from beamforming_lk_tpu_torch.models.mimo import make_mimo_grid, render_heatmap
from beamforming_lk_tpu_torch.ops import antenna as ant
from beamforming_lk_tpu_torch.ops import delay as dl
from beamforming_lk_tpu_torch.ops import fft_das as fd


class AwpuState(NamedTuple):
    """Carried state of one array's pipeline."""

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


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported to the torch package yet")


class AwpuStep(nn.Module):
    """The per-block step: ``forward(state, block, generator=None,
    draws=None) -> (state, AwpuOutputs)``."""

    def __init__(self, points, cfg, channel_mask=None, enable_mimo=True,
                 device=None):
        super().__init__()
        dsp, arr = cfg.dsp, cfg.array
        self.cfg = cfg
        self.enable_mimo = enable_mimo
        self.taps = dl.LINEAR_TAPS if dsp.interp == "linear" else dsp.fir_taps
        points = np.asarray(points, np.float32)
        self.fft_model = None
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
            if cfg.mimo.backend != "fft":
                raise _not_ported(f"heatmap backend {cfg.mimo.backend!r}")
            self.fft_model = fd.make_fft_heatmap_model(
                points, cfg.mimo, dsp, arr, channel_mask=channel_mask,
                compute=dsp.compute, device=device,
            )
            if self.fft_model is None:
                raise _not_ported(
                    "the dense heatmap (the fft backend's fallback for "
                    "non-lattice apertures and gain masks)"
                )
        span = dl.probe_span(points, arr.samples_per_meter, self.taps,
                             dsp.shift_range)
        self.swarm_step = tk.make_fused_step_impl(
            cfg.tracker, dsp, arr, points, channel_mask, probe_span=span,
            device=device,
        )

    def forward(self, state: AwpuState, block, generator=None, draws=None):
        cfg, dsp = self.cfg, self.cfg.dsp
        history = rg.ring_push(state.history, block)
        window = rg.ring_window(history, dsp.block_size, dsp.shift_range,
                                self.taps)
        powers, prev_max = state.powers, state.prev_max
        if self.enable_mimo and state.block_index % cfg.mimo.heatmap_every == 0:
            powers = fd.fft_heatmap_powers(window, self.fft_model)
            a = cfg.mimo.ema_alpha
            prev_max = torch.max(powers) * a + (1.0 - a) * state.prev_max
        swarm, targets, miso_p, miso_beam = self.swarm_step(
            state.swarm, state.miso.particle, window, state.block_index,
            generator=generator, draws=draws,
        )
        new_state = AwpuState(
            history=history,
            swarm=swarm,
            miso=state.miso._replace(particle=miso_p),
            prev_max=prev_max,
            block_index=state.block_index + 1,
            powers=powers,
        )
        return new_state, AwpuOutputs(powers, targets, miso_beam, prev_max)


def make_awpu_step(points, cfg, channel_mask=None, mesh=None,
                   enable_mimo: bool = True, enable_tracker: bool = True,
                   enable_miso: bool = True, device=None) -> AwpuStep:
    """Build the per-block step for one device.  Raises
    ``NotImplementedError`` for what the slice does not carry: a mesh, the
    unfused tracker/MISO path (either disabled, or more than 4 iterations),
    the K-block replay kernel, and every probe backend but the kernel."""
    if mesh is not None:
        raise _not_ported("multi-device execution (mesh)")
    tc = cfg.tracker
    if not (enable_tracker and enable_miso and tc.iterations <= 4
            and tc.iterations * tc.tracker_steps >= 3):
        raise _not_ported(
            "the unfused tracker/MISO path (tracker or MISO disabled, or "
            "iterations > 4)"
        )
    if cfg.dsp.fused_chunk > 1:
        raise _not_ported("the K-block replay kernel (fused_chunk > 1)")
    return AwpuStep(points, cfg, channel_mask, enable_mimo, device)


def awpu_init(cfg, channels: int, mesh=None, seed: int = 0, device=None,
              generator: Optional[torch.Generator] = None) -> AwpuState:
    """Fresh state: empty ring, swarm drawn from ``generator`` (or one
    seeded with ``seed``), MISO at boresight."""
    if mesh is not None:
        raise _not_ported("multi-device execution (mesh)")
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    return AwpuState(
        history=rg.ring_init(channels, cfg.dsp.history, device=device),
        swarm=tk.swarm_init(cfg.tracker, generator, device),
        miso=ms.miso_init(device=device),
        prev_max=torch.zeros((), dtype=torch.float32, device=device),
        block_index=0,
        powers=torch.zeros((cfg.mimo.n_directions,), dtype=torch.float32,
                           device=device),
    )


class AwpuPipeline:
    """Host-side orchestrator for one array link (the reference's
    ``AWProcessingUnit``): owns the step, its state and its generator, and
    exposes ``process_block``, ``steer``, ``targets`` and ``heatmap``."""

    def __init__(self, cfg, points=None, channel_mask=None, mesh=None,
                 seed: int = 0, enable_mimo: bool = True,
                 enable_tracker: bool = True, enable_miso: bool = True,
                 heatmap_mode: str = "das", channels: Optional[int] = None,
                 device="cpu"):
        if heatmap_mode != "das":
            raise _not_ported(f"heatmap_mode {heatmap_mode!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # f32 products in full precision, as the JAX package's HIGHEST.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if points is None:
            points = ant.multi_array_cluster(
                cfg.array.elements if channels is None else channels,
                cfg.array.columns, cfg.array.rows, cfg.array.distance,
            )
        self.points = np.asarray(points, np.float32)
        self.channel_mask = channel_mask
        self.step = make_awpu_step(
            self.points, cfg, channel_mask=channel_mask, mesh=mesh,
            enable_mimo=enable_mimo, enable_tracker=enable_tracker,
            enable_miso=enable_miso, device=self.device,
        )
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = awpu_init(cfg, self.points.shape[1], device=self.device,
                               generator=self.generator)
        self.last: Optional[AwpuOutputs] = None

    def process_block(self, block, draws=None) -> AwpuOutputs:
        """Feed one [C, T] block (numpy or tensor) through the step."""
        block = torch.as_tensor(block, dtype=torch.float32, device=self.device)
        self.state, self.last = self.step(
            self.state, block, generator=self.generator, draws=draws
        )
        return self.last

    def process_blocks(self, blocks) -> AwpuOutputs:
        """Drive M stacked blocks [M, C, T] one at a time; outputs stack on
        the leading axis (the K-block replay kernel is not ported yet)."""
        outs = [self.process_block(b) for b in blocks]
        return AwpuOutputs(
            powers=torch.stack([o.powers for o in outs]),
            targets=tk.Targets(*(torch.stack(f) for f in
                                 zip(*(o.targets for o in outs)))),
            miso_beam=torch.stack([o.miso_beam for o in outs]),
            prev_max=torch.stack([o.prev_max for o in outs]),
        )

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
        """The last powers rendered to a uint8 [rows, cols] numpy image."""
        mimo = self.cfg.mimo
        if self.last is None:
            return np.zeros((mimo.rows, mimo.columns), np.uint8)
        img, _ = render_heatmap(
            self.last.powers, mimo.rows, mimo.columns, self.state.prev_max,
            ema_alpha=1.0, use_db=mimo.use_db,
        )
        return img.cpu().numpy()

    def calibrate(self, blocks=None, apply_gains: bool = False):
        raise _not_ported("calibration")

    def save(self, path: str) -> None:
        raise _not_ported("checkpoint save")

    def restore(self, path: str) -> None:
        raise _not_ported("checkpoint restore")
