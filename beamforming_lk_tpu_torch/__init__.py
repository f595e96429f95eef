"""beamforming_lk_tpu_torch — the PyTorch + CUDA port of beamforming_lk_tpu.

Same layout and names as the JAX package (``ops``, ``io``, ``models``,
``app``), written for PyTorch on an NVIDIA H100.  The port carries
``app.awpu.AwpuPipeline`` in the realtime profile (``config.realtime``:
the live step ``process_block`` and the chunked replay ``process_blocks``),
in the default profile (``Config()``: the dense heatmap, the unfused
tracker and MISO step) and with the tracker or MISO off, with the
heatmap's SRP-PHAT and lattice-ordered models, with the adaptive
heatmaps in place of DAS (``heatmap_mode="mvdr"``: ``models.mvdr``, MVDR /
Capon; ``"music"``: ``models.music``, wideband MUSIC; both plain torch),
auto-calibration (``calibrate``) and checkpoints (``save``, ``restore``);
the fusion of several arrays into 3D tracks (``models.fusion.TargetFusion``,
with ``models.kalman``); the CLI and control unit (``app.cli``,
``app.control``); and the multi-device path on ``torch.distributed``
(``parallel``: one process a rank, ``mesh=`` on the pipeline, the step,
the control unit and the bin-sharded MVDR and MUSIC).  Its hand-written
CUDA kernels, one per TPU kernel of the JAX package:

- ``csrc/swarm_chain.cu``: the monopulse chain K0, the per-block swarm
  update K1 and the K-block chunk K2;
- ``csrc/power_matmul.cu``: the heatmap's power stage K3
  (``power_path="pallas"``);
- ``csrc/das_beam.cu``: the dense heatmap's beam K4.

The JAX package stays beside it as the reference; this package imports no
JAX.
"""

__version__ = "0.1.0"

from beamforming_lk_tpu_torch.config import (  # noqa: F401
    ArrayConfig,
    Config,
    DspConfig,
    MimoConfig,
    PipelineConfig,
    TrackerConfig,
    TriangulationConfig,
    realtime,
)
