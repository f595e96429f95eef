"""Carry state and constants over from the JAX package.

Every function takes the JAX objects' arrays as numpy (``np.asarray`` of
each leaf, which needs no JAX import here), or a file the JAX package
wrote, and returns the port's tensors on ``device``: the card unless it
names the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from beamforming_lk_tpu_torch.app.awpu import AwpuState, _placement, shard_state
from beamforming_lk_tpu_torch.device import resolve_device
from beamforming_lk_tpu_torch.io.checkpoint import load_state
from beamforming_lk_tpu_torch.models.mimo import MimoModel
from beamforming_lk_tpu_torch.models.miso import MisoState
from beamforming_lk_tpu_torch.models.music import MusicState
from beamforming_lk_tpu_torch.models.mvdr import MvdrState
from beamforming_lk_tpu_torch.models.tracker import Particles, SwarmState
from beamforming_lk_tpu_torch.ops.fft_das import FftHeatmapModel


def _t(a, device, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def _particles(p, device) -> Particles:
    return Particles(*(_t(getattr(p, f), device, torch.float32)
                       for f in Particles._fields))


def swarm_state_from_jax(sw, device="cuda") -> SwarmState:
    """A JAX ``SwarmState`` whose leaves are numpy arrays (its PRNG key is
    not read) -> the port's ``SwarmState``; the counter becomes a host int."""
    device = resolve_device(device)
    return SwarmState(
        seekers=_particles(sw.seekers, device),
        trackers=_particles(sw.trackers, device),
        tracking=_t(sw.tracking, device, torch.bool),
        start=_t(sw.start, device, torch.float32),
        jumped=_t(sw.jumped, device, torch.bool),
        mean=_t(sw.mean, device, torch.float32),
        reset_count=int(np.asarray(sw.reset_count)),
        target_theta=_t(sw.target_theta, device, torch.float32),
        target_phi=_t(sw.target_phi, device, torch.float32),
        target_valid=_t(sw.target_valid, device, torch.bool),
    )


def miso_state_from_jax(ms, device="cuda") -> MisoState:
    """A JAX ``MisoState`` whose leaves are numpy arrays -> the port's."""
    device = resolve_device(device)
    return MisoState(particle=_particles(ms.particle, device),
                     tracking=_t(ms.tracking, device, torch.bool))


def awpu_state_from_jax(state, device="cuda", mesh=None) -> AwpuState:
    """A JAX ``AwpuState`` whose leaves are numpy arrays (its PRNG key is
    not read) -> the port's ``AwpuState``; the counters become host ints.
    With a ``mesh`` the whole state becomes this rank's shards (its
    channels of the history, its directions of the powers), placed as
    ``awpu_init`` places them (on a CUDA mesh, the rank's card), so that
    both packages can start a sharded run from one state."""
    layout, device = _placement(mesh, device)
    whole = AwpuState(
        history=_t(state.history, device, torch.float32),
        swarm=swarm_state_from_jax(state.swarm, device),
        miso=miso_state_from_jax(state.miso, device),
        prev_max=_t(state.prev_max, device, torch.float32),
        block_index=int(np.asarray(state.block_index)),
        powers=_t(state.powers, device, torch.float32),
    )
    return shard_state(whole, layout)


def mvdr_state_from_jax(state, device="cuda") -> MvdrState:
    """A JAX ``MvdrState`` whose leaves are numpy arrays -> the port's; the
    counter becomes a host int."""
    device = resolve_device(device)
    return MvdrState(
        cov_re=_t(state.cov_re, device, torch.float32),
        cov_im=_t(state.cov_im, device, torch.float32),
        count=int(np.asarray(state.count)),
        powers=None if state.powers is None else _t(state.powers, device,
                                                    torch.float32),
    )


def music_state_from_jax(state, device="cuda") -> MusicState:
    """A JAX ``MusicState`` whose leaves are numpy arrays -> the port's; the
    counter becomes a host int."""
    device = resolve_device(device)
    return MusicState(
        cov_re=_t(state.cov_re, device, torch.float32),
        cov_im=_t(state.cov_im, device, torch.float32),
        count=int(np.asarray(state.count)),
        basis=_t(state.basis, device, torch.float32),
    )


def _on(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, tuple):
        return type(tree)(*(_on(v, device) for v in tree))
    return tree


def awpu_state_from_jax_checkpoint(path: str, template: AwpuState,
                                   device="cuda") -> AwpuState:
    """The state in a ``.npz`` that the JAX package's ``AwpuPipeline.save``
    wrote (keys are its tree paths: ``.history``, ``.swarm/.seekers/.theta``,
    ..., ``.block_index``, ``.powers``) -> the port's ``AwpuState`` on
    ``device`` (the card by default), shaped like ``template`` (a state of
    the same configuration and channel count); the counters become host
    ints.  The JAX PRNG key ``.swarm/.key`` is not read: the restored state
    is the same, but the port draws from its own ``torch.Generator``, so
    the later draws are not the JAX pipeline's."""
    return load_state(path, _on(template, resolve_device(device)))


def fft_model_from_jax(model, device="cuda") -> FftHeatmapModel:
    """The JAX ``FftHeatmapModel`` (any ``power_path``, PHAT and the
    lattice-order promise included) -> the port's module with the same
    constants."""
    np_ = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    dead = None if model.dead is None else tuple(np.asarray(a) for a in model.dead)
    return FftHeatmapModel(
        ex_s=np_(model.ex_s), ey_s=np_(model.ey_s), dft=np_(model.dft),
        idft=np_(model.idft), pow_ri=np_(model.pow_ri),
        perm_matrix=np_(model.perm_matrix), src_map=np_(model.src_map),
        dead=dead, rows=model.rows, columns=model.columns,
        block_size=model.block_size, fft_len=model.fft_len,
        n_active=model.n_active, use_bandpass=model.use_bandpass,
        compute=model.compute, phat=model.phat,
        band_weight=np_(model.band_weight), channel_perm=np_(model.channel_perm),
        power_path=model.power_path, device=device,
    )


def mimo_model_from_jax(model, compute: str = "float32",
                        device="cuda") -> MimoModel:
    """The JAX ``MimoModel`` (its dense stencil ``weights`` [D, C, S]) ->
    the port's model of the same beams: for each direction and channel the
    ``taps`` columns from the first weighted one (moved back to fit the
    span), which hold all of its weight."""
    w = np.asarray(model.weights, np.float32)
    s, taps = w.shape[-1], model.taps
    nz = w != 0.0
    shift = np.minimum(np.where(nz.any(-1), nz.argmax(-1), 0), s - taps)
    idx = shift[..., None] + np.arange(taps)
    tap_w = np.take_along_axis(w, idx, axis=-1)
    if not np.array_equal(np.count_nonzero(tap_w, axis=-1), nz.sum(-1)):
        raise ValueError(f"a stencil row has weight outside {taps} neighbouring taps")
    return MimoModel(shift.astype(np.int32), tap_w, model.theta, model.phi,
                     model.rows, model.columns, model.shift_range,
                     model.use_bandpass, compute, device)
