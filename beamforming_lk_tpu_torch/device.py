"""The port's device rules, shared by its entry points: the card by
default, the CPU (the kernels' plain twins) only when asked for, and f32
products in full precision inside the port's own calls."""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device of an entry point's ``device`` argument: raises
    when CUDA is asked for on a host without it (the plain twins run only
    when the caller asks for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the port runs on CUDA by default and this host has no CUDA "
            "device; pass device='cpu' to run the kernels' plain twins"
        )
    return device


def _tf32_switches():
    """(holder, attribute, full-precision value) of each TF32 switch: the
    per-backend ``fp32_precision`` where torch has it (it refuses to read
    the older ``allow_tf32`` flags once they were set through the newer
    API, and reads the newer one either way), else ``allow_tf32``."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    conv = getattr(cudnn, "conv", None)
    if conv is not None and hasattr(conv, "fp32_precision"):
        return [(matmul, "fp32_precision", "ieee"), (conv, "fp32_precision", "ieee")]
    return [(matmul, "allow_tf32", False), (cudnn, "allow_tf32", False)]


def f32_mode() -> tuple:
    """The TF32 switches' current values: what a CUDA graph's f32 products
    keep from the moment they were captured."""
    return tuple(getattr(holder, name) for holder, name, _ in _tf32_switches())


@contextlib.contextmanager
def full_f32():
    """f32 matrix products and convolutions without TF32 inside the block,
    as the JAX package's ``Precision.HIGHEST``; the caller's settings come
    back on exit, also when the block raises."""
    switches = _tf32_switches()
    saved = [getattr(holder, name) for holder, name, _ in switches]
    try:
        for holder, name, value in switches:
            setattr(holder, name, value)
        yield
    finally:
        for (holder, name, _), value in zip(switches, saved):
            setattr(holder, name, value)
