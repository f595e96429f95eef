"""Synthetic plane-wave source in numpy (counterpart of
``beamforming_lk_tpu.io.synthetic``).

Channel c leads the wavefront by its steering delay in samples,
``x_c[n] = sum_k a_k sin(2 pi f_k (n + tau_c) / fs)``, so beamforming at the
true direction coheres exactly.
"""

from __future__ import annotations

import numpy as np

from beamforming_lk_tpu_torch.config import ArrayConfig
from beamforming_lk_tpu_torch.ops.antenna import steering_delays_np


def plane_wave_block(
    points: np.ndarray,
    sources,
    start_sample: int,
    n_samples: int,
    array_cfg: ArrayConfig = ArrayConfig(),
    noise_std: float = 0.0,
    rng: np.random.Generator | None = None,
    amplitude: float = 1e-2,
) -> np.ndarray:
    """One [C, T] float32 block; sources are (theta, phi, frequency_hz) or
    (theta, phi, frequency_hz, relative_amplitude)."""
    c = points.shape[1]
    n = start_sample + np.arange(n_samples, dtype=np.float64)
    fs = array_cfg.sample_rate
    block = np.zeros((c, n_samples), np.float64)
    for src in sources:
        theta, phi, freq = src[0], src[1], src[2]
        amp = src[3] if len(src) > 3 else 1.0
        delays = steering_delays_np(
            points, theta, phi, array_cfg.samples_per_meter
        ).astype(np.float64)
        phase = 2.0 * np.pi * freq * (n[None, :] + delays[:, None]) / fs
        block += amp * np.sin(phase)
    block *= amplitude
    if noise_std > 0.0:
        rng = rng or np.random.default_rng(0)
        block += rng.normal(0.0, noise_std * amplitude, size=block.shape)
    return block.astype(np.float32)


def synthetic_blocks(
    points: np.ndarray,
    sources,
    n_blocks: int,
    block_size: int = 256,
    array_cfg: ArrayConfig = ArrayConfig(),
    noise_std: float = 0.0,
    seed: int = 0,
    amplitude: float = 1e-2,
):
    """Yield consecutive [C, T] blocks."""
    rng = np.random.default_rng(seed)
    for b in range(n_blocks):
        yield plane_wave_block(
            points, sources, b * block_size, block_size, array_cfg,
            noise_std, rng, amplitude,
        )
