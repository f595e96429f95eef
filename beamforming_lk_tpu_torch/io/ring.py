"""Per-channel sample history (counterpart of ``beamforming_lk_tpu.io.ring``).

The history is a ``[channels, history]`` tensor with the newest samples at
the end.  :func:`ring_push` returns a new tensor (one concatenation on the
device); callers may also update a history in place with
``hist.copy_(ring_push(hist, block))`` where they own it exclusively.
"""

from __future__ import annotations

import torch

from beamforming_lk_tpu_torch.device import resolve_device

#: Samples of lookahead kept past the beamformed block so interpolation taps
#: (up to 8 for the FIR bank) never read off the end of history.
LOOKAHEAD_GUARD = 8


def ring_init(channels: int, history: int, device="cuda", dtype=torch.float32):
    """A zero history [channels, history] on ``device`` (the card unless
    it names the CPU)."""
    return torch.zeros((channels, history), dtype=dtype,
                       device=resolve_device(device))


def ring_push(history, block):
    """Append a [C, T] block, dropping the oldest T samples."""
    t = block.shape[-1]
    return torch.cat([history[..., t:], block.to(history.dtype)], dim=-1)


def block_start(history_len: int, block_size: int) -> int:
    """History index where the beamformed block begins."""
    return history_len - block_size - LOOKAHEAD_GUARD


def ring_window(history, block_size: int, shift_range: int, taps: int):
    """The [C, T + S] window the DAS stages consume (a view): it starts at
    ``block_start - (S - taps)`` so stencil index ``t + shift + j`` lands on
    history index ``block_start + t - floor(delay) + j``."""
    h = history.shape[-1]
    w0 = block_start(h, block_size) - (shift_range - taps)
    if w0 < 0:
        raise ValueError(
            f"history {h} too short for block {block_size} + shifts {shift_range}"
        )
    return history[..., w0:w0 + block_size + shift_range]


def ring_windows(history, block_size: int, shift_range: int, taps: int,
                 chunk: int):
    """[chunk, C, T + S] windows of the last ``chunk`` pushed blocks: window
    ``j`` is :func:`ring_window` as it was right after block ``j`` of the
    chunk was pushed.  Returns ONE strided view of ``history`` (``unfold``
    over the time axis; no copy)."""
    h = history.shape[-1]
    win = block_size + shift_range
    w_last = block_start(h, block_size) - (shift_range - taps)
    w0 = w_last - (chunk - 1) * block_size
    if w0 < 0:
        raise ValueError(
            f"history {h} too short for {chunk} blocks of {block_size} "
            f"+ shifts {shift_range}"
        )
    return history[..., w0:w_last + win].unfold(-1, win, block_size).movedim(-2, 0)
