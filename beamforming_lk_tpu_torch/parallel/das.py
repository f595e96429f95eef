"""Sharded delay-and-sum on a mesh of ranks (counterpart of
``beamforming_lk_tpu.parallel.das``).

- **channel sharding** (``ch``): each rank holds ``C / n_ch`` mic channels
  of the window and the matching slice of the dense stencil; the partial
  beams are summed by an all-reduce over the ``ch`` group before they are
  squared (the reference's accumulate-over-mics loop,
  ``src/dsp/delay.cpp:16-26``);
- **direction sharding** (``dir``): the grid splits with no communication;
- **time sharding** (``t``): a block's time axis splits into contiguous
  chunks, and each chunk takes the ``S`` samples before it from its left
  neighbour (``batch_isend_irecv``; through host memory on gloo), the
  first from the history's tail.

Each function takes this rank's shards, as :func:`shard_window` and
:func:`shard_weights` cut them from global tensors, and returns this
rank's shard of the result.  The beam is the dense-stencil product of
:func:`ops.delay.das_beam` (plain torch, as the JAX package's).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from beamforming_lk_tpu_torch.io import ring as rg
from beamforming_lk_tpu_torch.ops import delay as dl
from beamforming_lk_tpu_torch.parallel.mesh import (
    CH_AXIS, DIR_AXIS, TIME_AXIS, Axis, Layout,
)


def shard_window(window, mesh: DeviceMesh):
    """This rank's channels of a global [C, T+S] window (the JAX package
    places it sharded ``P(ch, None)``)."""
    return window[Axis(mesh, CH_AXIS).part(window.shape[-2])]


def shard_weights(weights, mesh: DeviceMesh):
    """This rank's (direction, channel) block of a global [D, C, S]
    stencil (``P(dir, ch, None)``)."""
    d = Axis(mesh, DIR_AXIS).part(weights.shape[0])
    c = Axis(mesh, CH_AXIS).part(weights.shape[1])
    return weights[d, c]


def _full_beam(layout: Layout, window, weights):
    """The full-array beam [D_loc, T] of this rank's directions."""
    return layout.ch.all_reduce(dl.das_beam(window, weights))


def make_sharded_das_power(mesh: DeviceMesh, *, use_bandpass: bool = True,
                           n_active: float | None = None):
    """``power(window, weights) -> powers``: this rank's window channels
    [C_loc, T+S] and stencil block [D_loc, C_loc, S] to its powers [D_loc],
    normalized by ``T * n_active`` (all C channels by default).  The beam
    is reduced over ``ch`` before it is squared: power is nonlinear in the
    full-array beam (``src/dsp/mimo.cpp:124-137``)."""
    layout = Layout(mesh)

    def power(window, weights):
        beam = _full_beam(layout, window, weights)
        count = (weights.shape[-2] * layout.ch.size if n_active is None
                 else n_active)
        return dl.das_power(beam, use_bandpass=use_bandpass,
                            divisor=beam.shape[-1] * count)

    return power


def halo_exchange_time(block, history_tail, halo: int, mesh: DeviceMesh,
                       axis_name: str = TIME_AXIS):
    """[C, halo + T_loc]: this rank's time chunk ``block`` [C, T_loc]
    behind the ``halo`` samples before it, which its left neighbour on
    ``axis_name`` sends (its last ``halo`` samples); the first rank takes
    ``history_tail`` [C, halo], the samples before the global block.
    Needs ``T_loc >= halo``.

    On a gloo group the halo goes through host memory, whatever the
    tensors' device: gloo sends no CUDA tensor point to point (its TCP
    pair writes from the device pointer), so a CPU copy is sent, received
    and then moved to ``block``'s device (no copy for CPU tensors)."""
    if block.shape[-1] < halo:
        raise ValueError(f"a time chunk of {block.shape[-1]} samples is "
                         f"shorter than the halo of {halo}")
    axis = Axis(mesh, axis_name)
    left = history_tail
    if axis.size > 1:
        ranks = dist.get_process_group_ranks(axis.group)
        via = ("cpu" if dist.get_backend(axis.group) == dist.Backend.GLOO
               else block.device)
        ops = []
        if axis.index + 1 < axis.size:
            ops.append(dist.P2POp(dist.isend,
                                  block[..., -halo:].to(via).contiguous(),
                                  ranks[axis.index + 1], group=axis.group))
        if axis.index > 0:
            left = torch.empty(history_tail.shape, dtype=history_tail.dtype,
                               device=via)
            ops.append(dist.P2POp(dist.irecv, left, ranks[axis.index - 1],
                                  group=axis.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        left = left.to(block.device)
    return torch.cat([left, block], dim=-1)


def make_time_sharded_beam(mesh: DeviceMesh):
    """``beam(block, history_tail, weights) -> beam``: this rank's time
    chunk [C, T_loc] of the block (split over ``t``), the replicated
    ``history_tail`` [C, S] and its direction block [D_loc, C, S] of the
    stencil (split over ``dir``) to its beam block [D_loc, T_loc]."""
    has_t = TIME_AXIS in (mesh.mesh_dim_names or ())

    def beam(block, history_tail, weights):
        s = weights.shape[-1]
        if has_t:
            window = halo_exchange_time(block, history_tail, s, mesh)
        else:
            window = torch.cat([history_tail, block], dim=-1)
        return dl.das_beam(window, weights)

    return beam


def make_sharded_mimo_step(mesh: DeviceMesh, *, block_size: int,
                           shift_range: int, taps: int,
                           use_bandpass: bool = True):
    """The streaming heatmap step, ``step(history, block, weights) ->
    (history, powers)``: push this rank's channels of the block [C_loc, T]
    into its history [C_loc, H], window it, beam its stencil block
    [D_loc, C_loc, S], reduce over ``ch`` and return its powers [D_loc]
    (producer -> barrier -> ``MIMOWorker::update``,
    ``src/fpga/pipeline.cpp:243-255`` and ``src/dsp/mimo.cpp:97-151``)."""
    layout = Layout(mesh)

    def step(history, block, weights):
        history = rg.ring_push(history, block)
        window = rg.ring_window(history, block_size, shift_range, taps)
        beam = _full_beam(layout, window, weights)
        count = weights.shape[-2] * layout.ch.size
        return history, dl.das_power(beam, use_bandpass=use_bandpass,
                                     divisor=beam.shape[-1] * count)

    return step
