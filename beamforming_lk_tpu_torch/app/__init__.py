"""Per-array orchestration (AWPU)."""

from beamforming_lk_tpu_torch.app.awpu import (  # noqa: F401
    AwpuOutputs,
    AwpuPipeline,
    AwpuState,
    AwpuStep,
    awpu_init,
    make_awpu_step,
)
