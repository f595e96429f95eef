"""Mesh construction and this rank's place in a mesh (counterpart of
``beamforming_lk_tpu.parallel.mesh``).

Axis conventions (see the package docstring): ``ch`` (mic channels,
all-reduce of partial beams), ``dir`` (directions, no communication),
``t`` (time, halo exchange).  The JAX package runs one process over all
devices of a ``jax.sharding.Mesh``; here each rank is one process, the
mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
process group, laid out row-major as ``np.array(devices).reshape(shape)``
lays out JAX's devices (rank = ch index * n_dir + dir index), and each
axis is a process group.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from beamforming_lk_tpu_torch.device import resolve_device

CH_AXIS = "ch"
DIR_AXIS = "dir"
TIME_AXIS = "t"


def _factor2(n: int) -> Tuple[int, int]:
    """Split n into the most-square (a, b) with a*b == n."""
    a = int(math.isqrt(n))
    while n % a:
        a -= 1
    return a, n // a


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (CH_AXIS, DIR_AXIS),
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh over every rank of the process group (start it first, for
    example with :func:`parallel.multihost.initialize`).

    With no ``shape`` the ranks split as-square-as-possible over the first
    two axis names (the others get size 1).  ``device_type`` is the card
    unless the caller names ``"cpu"``; a CUDA mesh on a host without CUDA
    raises.  Raises when no process group is up or the shape does not
    match the world size."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost."
                           "initialize() (or torch.distributed."
                           "init_process_group) first")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA device; pass "
                           "device_type='cpu' for a mesh of CPU processes")
    n = dist.get_world_size()
    if shape is None:
        if len(axis_names) == 1:
            shape = (n,)
        else:
            shape = _factor2(n) + (1,) * (len(axis_names) - 2)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} ranks")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))


def single_device_mesh(axis_names: Sequence[str] = (CH_AXIS, DIR_AXIS),
                       device_type: str = "cuda") -> DeviceMesh:
    """A 1x1 mesh of a one-process group: the sharded code paths on one
    device, unchanged."""
    return make_mesh((1,) * len(axis_names), axis_names, device_type)


class Axis:
    """One mesh axis as this rank sees it: its ``size``, this rank's
    ``index`` along it and its process ``group`` (size 1, index 0 and no
    group for an axis the mesh does not have).  The collectives count
    their calls in :data:`collectives` and skip an axis of size 1."""

    def __init__(self, mesh: DeviceMesh, name: str):
        names = mesh.mesh_dim_names or ()
        self.name = name
        if name in names:
            self.size = mesh.size(names.index(name))
            self.index = mesh.get_local_rank(name)
            self.group = mesh.get_group(name)
        else:
            self.size, self.index, self.group = 1, 0, None

    def part(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` items (raises unless the
        axis size divides ``n``)."""
        k = self.count(n)
        return slice(self.index * k, (self.index + 1) * k)

    def count(self, n: int) -> int:
        """The items of ``n`` on each rank (raises unless they split)."""
        if n % self.size:
            raise ValueError(f"{n} does not split over the {self.size} ranks "
                             f"of mesh axis {self.name!r}")
        return n // self.size

    def all_reduce(self, t, op=dist.ReduceOp.SUM):
        """``t`` reduced over the axis, in place."""
        if self.size > 1:
            collectives["all_reduce"] += 1
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_gather(self, t):
        """The ranks' ``t`` concatenated along dim 0 in axis order."""
        if self.size == 1:
            return t
        collectives["all_gather"] += 1
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)


class Layout:
    """This rank's place in a (``ch``, ``dir``) mesh: its channel and
    direction blocks (:class:`Axis` each) and whether it is the mesh's
    first rank, the one that writes outputs.  Raises ``TypeError`` for a
    mesh that is not a ``DeviceMesh``."""

    def __init__(self, mesh: DeviceMesh):
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch DeviceMesh "
                            f"(parallel.make_mesh), got {type(mesh).__name__}")
        self.mesh = mesh
        self.has_ch = CH_AXIS in (mesh.mesh_dim_names or ())
        self.ch = Axis(mesh, CH_AXIS)
        self.dir = Axis(mesh, DIR_AXIS)
        self.is_root = not any(mesh.get_coordinate() or ())

    def device(self, device) -> torch.device:
        """The torch device of an entry point's ``device`` argument under
        this mesh: it must be of the mesh's device type, and on the card
        it is the rank's current one."""
        device = resolve_device(device)
        if device.type != self.mesh.device_type:
            raise ValueError(f"device {device} under a {self.mesh.device_type} "
                             "mesh")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device

    def barrier(self) -> None:
        """Wait for every rank of the mesh (one barrier per mesh axis)."""
        for name in self.mesh.mesh_dim_names or ():
            if self.mesh.size(self.mesh.mesh_dim_names.index(name)) > 1:
                dist.barrier(group=self.mesh.get_group(name))


#: Calls of the collectives that :class:`Axis` made, by name.
collectives = {"all_reduce": 0, "all_gather": 0}
