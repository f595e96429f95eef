"""Processing models: the MIMO heatmap, the tracker swarm, the MISO
listener, calibration, the Kalman filter, triangulation and fusion, and the
adaptive heatmaps MVDR (Capon, ``mvdr``) and wideband MUSIC (``music``)
(the counterparts of ``beamforming_lk_tpu.models``'s exports)."""

from beamforming_lk_tpu_torch.models.mimo import (  # noqa: F401
    MimoModel,
    make_mimo_grid,
    make_mimo_model,
    mimo_power,
    render_heatmap,
)
from beamforming_lk_tpu_torch.models.calibration import (  # noqa: F401
    CalibrationResult,
    calibrate,
)
from beamforming_lk_tpu_torch.models.kalman import (  # noqa: F401
    KalmanFilter3D,
    KalmanState,
)
from beamforming_lk_tpu_torch.models.miso import (  # noqa: F401
    MisoState,
    make_miso_step,
    miso_init,
    miso_steer,
)
from beamforming_lk_tpu_torch.models.targets import targets_to_list  # noqa: F401
from beamforming_lk_tpu_torch.models.tracker import (  # noqa: F401
    Particles,
    SwarmState,
    Targets,
    make_swarm_step,
    swarm_init,
)
from beamforming_lk_tpu_torch.models.fusion import (  # noqa: F401
    TargetFusion,
    Track,
    TrackStore,
    position_to_gps,
    target_rays,
    triangulate_rays,
)
from beamforming_lk_tpu_torch.models.mvdr import (  # noqa: F401
    MvdrState,
    make_mvdr_step,
    mvdr_init,
    steering_matrix,
)
