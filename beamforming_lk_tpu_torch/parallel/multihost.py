"""Process-group bootstrap and the global block from per-host channels
(counterpart of ``beamforming_lk_tpu.parallel.multihost``).

Each host ingests its own FPGA links: the channels whose UDP packets land
on a rank are its ``ch`` shard.  :func:`global_block_from_local` wraps them
as a ``DTensor`` sharded over ``ch`` without moving any sample between
hosts; beam partials meet later through the all-reduce.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from beamforming_lk_tpu_torch.parallel.mesh import CH_AXIS

_LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> int:
    """Start the process group and return this process's rank.

    - ``coordinator_address`` ``"host:port"`` (or an ``init_method`` URL):
      ``num_processes`` ranks rendezvous there, this one as ``process_id``;
    - none, under a launcher (``torchrun``, which sets ``RANK``,
      ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``): the launcher's
      group;
    - none otherwise: a one-process group, so that
      :func:`parallel.mesh.single_device_mesh` runs with no launcher.

    ``backend`` is ``"nccl"`` on a host with CUDA unless the caller names
    another (``"gloo"``: several ranks on one card, or CPU processes), and
    ``"gloo"`` on a host without CUDA.  With CUDA, the rank's device
    becomes its local rank's card (``LOCAL_RANK``, else the rank modulo the
    cards).  A second call returns the rank of the group already up."""
    if dist.is_initialized():
        return dist.get_rank()
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is not None:
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    elif all(v in os.environ for v in _LAUNCHER_VARS):
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0)
    rank = dist.get_rank()
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    return rank


def global_block_from_local(local_block, mesh: DeviceMesh) -> DTensor:
    """The global [C, T] block as a ``DTensor`` sharded over ``ch`` and
    replicated over the other axes, from this host's channels
    ``local_block`` [C / n_ch, T] (numpy or a tensor).  Its ``to_local()``
    is this rank's shard, its ``full_tensor()`` (a gather) the global
    block."""
    names = mesh.mesh_dim_names or ()
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    local = torch.as_tensor(local_block, dtype=torch.float32, device=device)
    placements = [Shard(0) if n == CH_AXIS else Replicate() for n in names]
    return DTensor.from_local(local, mesh, placements)
