"""The delay-and-sum heatmap beam as a CUDA kernel, with its plain twin.

Counterpart of ``beamforming_lk_tpu.ops.pallas_das``: the beam

    beam[d, t] = sum_c sum_j w[d, c, j] * window[c, shift[d, c] + j + t]

of a window [C, T+S] from the compact delay split (``shift`` [D, C] int32
in [0, S - taps], ``tap_weights`` [D, C, taps] f32).  The CUDA source is
``beamforming_lk_tpu_torch/csrc/das_beam.cu``; it gathers the taps from the
window where the TPU kernel rebuilt a dense one-hot stencil.  The TPU
kernel's ``pad_directions`` is a tiling constraint of its grid and has no
counterpart here.

:func:`das_beam` dispatches on the device of its tensors: CPU tensors take
:func:`das_beam_reference`, CUDA tensors launch the kernel (or the call
raises), any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from beamforming_lk_tpu_torch.ops import delay as dl
from beamforming_lk_tpu_torch.ops.cuda_tracker import check_operand, require_cuda

_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc", "das_beam.cu",
)
_MAX_TAPS = 16


def delay_split_np(delays, span: int, mode: str = "linear", fir_bank=None):
    """Host (numpy) delay split (shift [..., C] int32, tap weights
    [..., C, taps] f32) of delays in samples, with the convention of
    :func:`beamforming_lk_tpu_torch.ops.delay.das_weights_np`:
    ``shift = (span - taps) - floor(tau)`` after clamping tau to
    [0, span - taps]; weights ``[frac, 1-frac]`` or the FIR bank row at the
    rounded fraction."""
    taps = dl.LINEAR_TAPS if mode == "linear" else int(np.shape(fir_bank)[-1])
    delays = np.clip(np.asarray(delays, np.float64), 0.0, float(span - taps))
    whole = np.floor(delays)
    frac = (delays - whole).astype(np.float32)
    shift = ((span - taps) - whole).astype(np.int32)
    if mode == "linear":
        w = np.stack([frac, 1.0 - frac], axis=-1)
    else:
        bank = np.asarray(fir_bank, np.float32)
        idx = np.round(frac * (bank.shape[0] - 1)).astype(np.int64)
        w = bank[idx]
    return shift, np.ascontiguousarray(w, np.float32)


def _rounded(x, compute: str):
    return x.to(torch.bfloat16).to(torch.float32) if compute == "bfloat16" else x


def das_beam_reference(window, shift, tap_weights, *, span: int,
                       compute: str = "float32"):
    """Plain twin of the kernel: the one-hot stencil [D, C, span] built from
    the split and contracted with the unfolded window in f32 (the JAX
    package's dense ``das_beam``).  With ``compute="bfloat16"`` the window
    and the tap weights are rounded to bf16 first.  ``window`` is [C, T+S]
    or a stack [K, C, T+S]; returns [D, T] or [K, D, T] f32."""
    d, c = shift.shape
    taps = tap_weights.shape[-1]
    stencil = torch.zeros((d, c, span), dtype=torch.float32, device=shift.device)
    idx = shift.to(torch.long)[..., None] + torch.arange(taps, device=shift.device)
    stencil.scatter_(-1, idx, _rounded(tap_weights, compute))
    t = window.shape[-1] - span
    unf = _rounded(window, compute).unfold(-1, t, 1)[..., :span, :]  # [.., C, S, T]
    return torch.einsum("dcs,...cst->...dt", stencil, unf)


def das_beam_plan(k: int, d: int, c: int, t: int, span: int, taps: int) -> dict:
    """Launch plan of the DAS-beam kernel for ``k`` windows, ``d``
    directions, ``c`` channels, ``t`` samples, a ``span`` and ``taps``:
    blocks of ``threads`` threads over (direction tiles, windows, sample
    tiles) (``grid``), each block ``dirs_per_block`` directions (one a
    warp, ``run`` consecutive samples a lane) by
    ``sample_tile`` samples, channels in tiles of ``channel_tile``: two
    buffers of window rows of ``row_floats`` floats (column a at
    a + a // 8) and one of (direction, channel) entries of
    ``entry_floats`` floats (the tap weights, then the shift's padded
    column and its residue mod 8).  ``smem_bytes`` is the
    kernel's ``das_layout`` total, which the launch checks."""
    run, warps, chan = 8, 32, 32
    dirs, tile = warps, 32 * run
    row = (tile + span) + (tile + span) // 8
    entry = (taps + 5) // 4 * 4
    win = (chan * row * 4 + 15) // 16 * 16
    return {
        "grid": (-(-d // dirs), k, -(-t // tile)), "threads": 32 * warps,
        "dirs_per_block": dirs, "run": run,
        "sample_tile": tile, "channel_tile": chan, "row_floats": row,
        "entry_floats": entry,
        "smem_bytes": 2 * win + dirs * chan * entry * 4,
    }


@functools.cache
def _library():
    from beamforming_lk_tpu_torch.ops import nvcc

    lib = ctypes.CDLL(nvcc.build("das_beam", [_SOURCE]))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.das_beam_launch.argtypes = [ptr, i64, i64, ptr, ptr, ptr] + [i32] * 7 + [ptr, ptr]
    lib.das_beam_launch.restype = i32
    lib.das_beam_error_string.argtypes = [i32]
    lib.das_beam_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(window, shift, tap_weights, span, compute):
    """Raise unless the operands fit the kernel; run on every device.  The
    window may be a strided view (``ring_window``, ``ring_windows``) as
    long as its time axis is unit-stride."""
    device = shift.device
    d, c = shift.shape
    taps = tap_weights.shape[-1]
    if compute not in ("float32", "bfloat16"):
        raise ValueError(f"unknown compute dtype {compute!r}")
    if not 0 < taps <= min(_MAX_TAPS, span):
        raise ValueError(f"{taps} taps do not fit a span of {span}")
    if window.dim() not in (2, 3) or window.shape[-2] != c:
        raise ValueError(f"window has shape {tuple(window.shape)}; expected "
                         f"[C, T+S] or [K, C, T+S] with C = {c}")
    if window.shape[-1] <= span:
        raise ValueError(f"window has {window.shape[-1]} columns; need span + T")
    if window.device != device or window.dtype != torch.float32:
        raise TypeError(f"window must be float32 on {device}, got "
                        f"{window.dtype} on {window.device}")
    if window.stride(-1) != 1 or min(window.stride()) < 0:
        raise ValueError("window must have a unit-stride time axis")
    check_operand("shift", shift, device, (torch.int32,), (d, c))
    check_operand("tap_weights", tap_weights, device, (torch.float32,), (d, c, taps))


def das_beam(window, shift, tap_weights, *, span: int, compute: str = "float32"):
    """The heatmap beam (module docstring): ``window`` [C, T+S] f32 or a
    stack [K, C, T+S] (one launch for the stack), ``shift`` [D, C] int32,
    ``tap_weights`` [D, C, taps] f32; ``compute="bfloat16"`` rounds the
    window and the weights to bf16 before the product.  Returns [D, T] or
    [K, D, T] f32; ``das_beam.launches`` counts kernel launches."""
    _check_operands(window, shift, tap_weights, span, compute)
    device = shift.device
    if device.type == "cpu":
        return das_beam_reference(window, shift, tap_weights, span=span,
                                  compute=compute)
    require_cuda("das_beam", device)
    stack = window if window.dim() == 3 else window[None]
    k, c, width = stack.shape
    d, taps = shift.shape[0], tap_weights.shape[-1]
    t = width - span
    out = torch.empty((k, d, t), dtype=torch.float32, device=device)
    plan = das_beam_plan(k, d, c, t, span, taps)
    lib = _library()
    err = lib.das_beam_launch(
        stack.data_ptr(), stack.stride(0), stack.stride(1), shift.data_ptr(),
        tap_weights.data_ptr(), out.data_ptr(), k, d, c, t, span, taps,
        int(compute == "bfloat16"),
        (ctypes.c_int * 5)(*plan["grid"], plan["threads"], plan["smem_bytes"]),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err:
        raise RuntimeError("das_beam kernel launch failed: "
                           + lib.das_beam_error_string(err).decode())
    das_beam.launches += 1
    return out if window.dim() == 3 else out[0]


das_beam.launches = 0
