"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, dense rates), and the least time of a kernel under them
(copied from ``chip_smoke.py``: ``PEAK_BYTES``, ``PEAK_FLOPS``, ``bound``).
A card set below 700 W runs slower; the run prints the card's limit."""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}


def bound_s(flops: float, nbytes: float, peak_flops: float) -> float:
    """The least seconds for ``flops`` operations on ``nbytes`` bytes
    moved once: the larger of the two times."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)
