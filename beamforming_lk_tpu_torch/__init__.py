"""beamforming_lk_tpu_torch — the PyTorch + CUDA port of beamforming_lk_tpu.

Same layout and names as the JAX package (``ops``, ``io``, ``models``,
``app``), written for PyTorch on an NVIDIA H100.  The port carries the live
per-block step (``app.awpu.AwpuPipeline.process_block`` under
``config.realtime``) and the chunked replay (``process_blocks``).  Its
hand-written kernels are the per-block and K-block swarm updates
(``csrc/swarm_chain.cu``) and the heatmap's power stage
(``csrc/power_matmul.cu``).  The JAX package stays beside it as the
reference; this package imports no JAX.
"""

__version__ = "0.1.0"

from beamforming_lk_tpu_torch.config import (  # noqa: F401
    ArrayConfig,
    Config,
    DspConfig,
    MimoConfig,
    TrackerConfig,
    realtime,
)
