"""Microphone auto-calibration: dead/hot channel masking and gain correction
(counterpart of ``beamforming_lk_tpu.models.calibration``).

``AWProcessingUnit::calibrate`` (aw_processing_unit.cpp:102-212): the
per-channel mean power over a full ring of history, a per-antenna median,
outlier rejection and a power-correction gain, computed on the history's
device.  Where the reference compacts the surviving channels into an
index list, this emits a fixed-shape validity mask.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class CalibrationResult:
    mask: torch.Tensor     # [C] float32 validity (1 = usable)
    gains: torch.Tensor    # [C] reference_power / channel_power (0 if masked)
    power: torch.Tensor    # [C] measured mean power
    median: torch.Tensor   # per-antenna median power, broadcast to [C]
    mean: torch.Tensor     # mean power over usable channels, broadcast to [C]

    @property
    def usable(self):
        return torch.sum(self.mask).to(torch.int32)


def calibrate(
    history,
    elements_per_antenna: int = 64,
    reference_power: float = 1.0,
    diff_threshold: float = 1e-4,
    low_ratio: float = 1e-3,
) -> CalibrationResult:
    """history: [C, H] snapshot (a full ring: the reference waits for 4
    barriers before calibrating, aw_processing_unit.cpp:105-107).

    A channel survives iff ``|power - median| <= diff_threshold`` and
    ``power >= median * low_ratio`` (aw_processing_unit.cpp:161-179)."""
    history = torch.as_tensor(history, dtype=torch.float32)
    c = history.shape[0]
    if c % elements_per_antenna != 0:
        raise ValueError(f"{c} channels not divisible by {elements_per_antenna}")
    n_ant, e = c // elements_per_antenna, elements_per_antenna

    power = torch.mean(torch.square(history), dim=-1)     # [C]
    grouped = power.reshape(n_ant, e)                      # [A, E]
    # The reference's median, (sorted[E/2] + sorted[E/2 + 1]) / 2
    # (aw_processing_unit.cpp:149-151), one past the textbook one.
    s = torch.sort(grouped, dim=-1).values
    median = (s[:, e // 2] + s[:, e // 2 + 1]) / 2.0      # [A]
    median_b = torch.repeat_interleave(median, e)         # [C]

    ok = ((torch.abs(power - median_b) <= diff_threshold)
          & (power >= median_b * low_ratio))
    mask = ok.to(torch.float32)
    gains = torch.where(ok, reference_power / torch.clamp(power, min=1e-30),
                        torch.zeros_like(power))
    grouped_mask = mask.reshape(n_ant, e)
    usable = torch.clamp(torch.sum(grouped_mask, dim=-1), min=1.0)
    mean = torch.sum(grouped * grouped_mask, dim=-1) / usable
    return CalibrationResult(mask=mask, gains=gains, power=power,
                             median=median_b, mean=torch.repeat_interleave(mean, e))
