"""Typed configuration of the PyTorch port, and its deployment profile.

The dataclasses carry the same fields and defaults as
``beamforming_lk_tpu/config.py`` (``tests/test_torch_ops.py`` pins them
field for field).  They
are defined here rather than imported so that the port, and a program
that drives it, load no module of the JAX package.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ArrayConfig:
    """Physical microphone-array model (reference: src/geometry/antenna.h:16-21)."""

    columns: int = 8
    rows: int = 8
    distance: float = 0.02          # mic pitch [m]
    sample_rate: float = 48828.0    # [Hz]
    propagation_speed: float = 340.0  # [m/s]

    @property
    def elements(self) -> int:
        return self.columns * self.rows

    @property
    def samples_per_meter(self) -> float:
        return self.sample_rate / self.propagation_speed


@dataclasses.dataclass(frozen=True)
class DspConfig:
    """Block/buffer/interp parameters (reference: src/fpga/streams.hpp:28-34)."""

    block_size: int = 256        # samples per processing block
    history: int = 1024          # ring history per channel
    shift_range: int = 64        # integer-shift span of the DAS window
    interp: str = "linear"       # "linear" | "fir" fractional-delay interp
    fir_taps: int = 8
    fir_phases: int = 101
    use_bandpass: bool = True    # 3-tap MA bandpass before power
    normalization: float = float(2 ** 23)
    compute: str = "float32"     # heatmap matmul input dtype
    probe_compute: str = "float32"  # tracker/MISO probe-beam input dtype
    fused_chunk: int = 0         # blocks per launch of the replay chunk kernel

    @property
    def block_seconds(self) -> float:
        return self.block_size / 48828.0


@dataclasses.dataclass(frozen=True)
class MimoConfig:
    """Heatmap grid (reference: src/dsp/mimo.cpp:20-59)."""

    rows: int = 64
    columns: int = 64
    fov_degrees: float = 180.0
    ema_alpha: float = 0.2       # running-max EMA (mimo.cpp:75-76)
    use_db: bool = False
    backend: str = "dense"       # "fft" is the ported backend
    phat: bool = False
    heatmap_every: int = 1       # recompute the heatmap every k-th block
    heatmap_chunk: int = 0

    @property
    def n_directions(self) -> int:
        return self.rows * self.columns


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Gradient-ascent swarm hyperparameters
    (reference: src/dsp/gradient_ascend.h:22-35)."""

    n_seekers: int = 16
    n_trackers: int = 10
    seeker_reset_interval: int = 128
    seeker_spread: float = math.radians(7.0)
    tracker_spread: float = math.radians(2.0)
    tracker_steps: int = 5
    tracker_slowdown: float = 0.1
    tracker_closeness: float = math.radians(5.0)
    error_threshold: float = 1.0
    seeker_step_gain: float = 2.0
    tracker_step_gain: float = 1.0
    probe_layout: str = "quadrant"   # "quadrant" | "horizontal" (N/E/S/W)
    fov_degrees: float = 180.0
    iterations: int = 10
    min_power_fraction: float = 0.1
    # "pallas" selects the hand-written swarm-chain kernel on CUDA (its
    # plain PyTorch twin on the CPU); the port has no other backend.
    probe_kernel: str = "xla"

    @property
    def theta_limit(self) -> float:
        """Half field-of-view in radians (gradient_ascend.cpp:117)."""
        return math.radians(self.fov_degrees / 2.0)


@dataclasses.dataclass(frozen=True)
class TriangulationConfig:
    """Multi-array fusion (reference: src/target_handler/triangulate.cpp:32-36,
    target_handler.cpp:91-128)."""

    distance_threshold: float = 1.0   # max closest-approach between rays [m]
    # Grow the per-track merge box with log(hits) (the reference computes
    # this, CalculateDistanceThreshold, but never calls it; False matches).
    adaptive_merge: bool = False
    max_range: float = 20.0           # targets beyond this are rejected [m]
    min_z: float = 0.0                # targets behind the arrays rejected
    near_z: float = 1.0               # closer than this = static noise
    norm_limit: float = 50.0          # sanity cap on intersection norm
    track_merge_distance: float = 1.0  # per-axis merge box [m]
    track_duplicate_eps: float = 1e-15
    track_timeout: float = 0.5        # seconds without a hit -> invalid
    max_tracks: int = 64


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Ingest configuration (reference: src/fpga/receiver.h, pipeline.cpp)."""

    address: str = "10.0.0.1"
    ports: tuple = (21844,)
    max_sensors_per_fpga: int = 256   # MAX_N_SENSORS (receiver.h:17)
    column_flip: bool = True          # daisy-chain demux (pipeline.cpp:277-291)


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level configuration of the AWPU step and of multi-array fusion."""

    array: ArrayConfig = dataclasses.field(default_factory=ArrayConfig)
    dsp: DspConfig = dataclasses.field(default_factory=DspConfig)
    mimo: MimoConfig = dataclasses.field(default_factory=MimoConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    triangulation: TriangulationConfig = dataclasses.field(
        default_factory=TriangulationConfig
    )
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)


def realtime(cfg: Config) -> Config:
    """The deployment profile: bf16 compute, the separable-FFT heatmap
    recomputed every 3rd block, 2 swarm iterations per block, the
    swarm-chain kernel for live blocks and 12 blocks per launch of the
    chunk kernel for replay (``process_blocks``).  Same values as the JAX
    package's ``Config.realtime()`` on its accelerator: ``probe_kernel`` is
    ``"pallas"`` and ``fused_chunk`` 12 on every device."""
    return dataclasses.replace(
        cfg,
        dsp=dataclasses.replace(
            cfg.dsp, compute="bfloat16", probe_compute="bfloat16",
            fused_chunk=12,
        ),
        mimo=dataclasses.replace(cfg.mimo, backend="fft", heatmap_every=3),
        tracker=dataclasses.replace(
            cfg.tracker, iterations=2, probe_kernel="pallas"
        ),
    )
