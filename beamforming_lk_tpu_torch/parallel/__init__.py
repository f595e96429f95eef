"""Multi-device execution on ``torch.distributed`` (counterpart of
``beamforming_lk_tpu.parallel``): one process a rank, a ``DeviceMesh`` over
the ranks, one process group a mesh axis.

==========  =============================  ==============================
mesh axis   shards                          communication
==========  =============================  ==============================
``ch``      microphone channels             all-reduce of partial beams
``dir``     direction grid / STFT bins      none (an all-gather to render)
``t``       time axis within a block        halo of the DAS shift span to
                                            the right-hand neighbour
==========  =============================  ==============================

Multi-host: each host ingests its own FPGA links (the channel shard lives
where its UDP packets land), ``multihost.global_block_from_local`` wraps
them as a ``DTensor``, and the sharded step runs unchanged.  Start the
process group with ``multihost.initialize`` (``torchrun`` sets its
environment), then build the mesh with :func:`make_mesh`.
"""

from beamforming_lk_tpu_torch.parallel.mesh import (  # noqa: F401
    CH_AXIS,
    DIR_AXIS,
    TIME_AXIS,
    make_mesh,
    single_device_mesh,
)
from beamforming_lk_tpu_torch.parallel.das import (  # noqa: F401
    halo_exchange_time,
    make_sharded_das_power,
    make_sharded_mimo_step,
    make_time_sharded_beam,
    shard_window,
    shard_weights,
)
