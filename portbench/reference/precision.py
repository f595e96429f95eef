"""Rounding of operands to a named precision, for the reference and its
control (the reference computed one precision below the configuration's).

``round_to(x, name)`` returns ``x`` rounded to ``name`` and widened back to
its own dtype: "float64" and "float32" as the dtypes, "tf32" to 10 mantissa
bits (what a TF32 matrix product reads of an f32 operand), "bfloat16", and
"float8_e4m3" with one scale per tensor that maps its largest magnitude to
the format's largest finite value (448), as an fp8 path would scale it.
"""

from __future__ import annotations

import torch

#: The next precision below each stated one (the control's precision).
BELOW = {"float32": "tf32", "bfloat16": "float8_e4m3"}

_FP8_MAX = 448.0


def _tf32(x):
    """Round f32 to nearest (ties away) on the 10-bit mantissa TF32 keeps."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_to(x, name: str):
    """``x`` rounded to precision ``name``, in ``x``'s dtype."""
    dtype = x.dtype
    if name == "float64":
        return x
    if name == "float32":
        return x.to(torch.float32).to(dtype)
    if name == "tf32":
        return _tf32(x).to(dtype)
    if name == "bfloat16":
        return x.to(torch.bfloat16).to(dtype)
    if name == "float8_e4m3":
        amax = float(x.abs().max())
        if amax == 0.0:
            return x
        scale = _FP8_MAX / amax
        q = (x.to(torch.float32) * scale).to(torch.float8_e4m3fn)
        return (q.to(torch.float32) / scale).to(dtype)
    raise ValueError(f"unknown precision {name!r}")
