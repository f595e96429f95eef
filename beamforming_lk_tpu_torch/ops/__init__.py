"""Tensor ops: geometry, steering, DAS, the FFT heatmap and the hand-written
kernels (the counterparts of ``beamforming_lk_tpu.ops``'s exports).

The JAX package's Pallas entry points map to the port's kernels:
``das_beam_pallas`` to :func:`das_beam_cuda` (``ops.cuda_das.das_beam``,
K4), ``monopulse_chain_pallas`` to :func:`monopulse_chain` (K0), and
``fold_bandpass_window`` to :func:`bandpass_window` (the kernels take the
compact window, not an unfolded one).  ``pad_directions`` has no
counterpart: K4 takes a ragged direction count.
"""

from beamforming_lk_tpu_torch.ops.geometry import (  # noqa: F401
    cartesian_to_spherical,
    horizontal_to_spherical,
    nearby_probes,
    normalize_spherical,
    quadrant_probes,
    quadrant_probes_reference,
    rotation_y,
    rotation_z,
    smallest_angle,
    spherical_angle,
    spherical_chord_distance,
    spherical_to_cartesian,
    wrap_angle,
)
from beamforming_lk_tpu_torch.ops.antenna import (  # noqa: F401
    create_antenna_grid,
    dome_lookup_max_error,
    generate_dome_lookup,
    generate_unit_dome,
    multi_array_cluster,
    sector_masks,
    steer_points,
    steering_delays,
    steering_delays_cartesian,
    steering_delays_horizontal,
    steering_delays_np,
)
from beamforming_lk_tpu_torch.ops.delay import (  # noqa: F401
    bandpass_ma,
    das_beam,
    das_power,
    das_power_from_delays,
    das_weights,
    das_weights_np,
    delay_lut,
    fractional_delay_fir_bank,
    probe_span,
    unfold_window,
)
from beamforming_lk_tpu_torch.ops.fft_das import (  # noqa: F401
    fft_heatmap_powers,
    lattice_factorization,
    make_fft_heatmap_model,
)
from beamforming_lk_tpu_torch.ops.filters import (  # noqa: F401
    REFERENCE_BANDS,
    bandpass_fractional_bank,
    reference_band_banks,
    windowed_sinc_delay,
)
from beamforming_lk_tpu_torch.ops.cuda_das import (  # noqa: F401
    das_beam as das_beam_cuda,
    delay_split_np,
)
from beamforming_lk_tpu_torch.ops.cuda_tracker import (  # noqa: F401
    bandpass_window,
    monopulse_chain,
    pack_geometry,
)
