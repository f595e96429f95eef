"""Target-list utilities (counterpart of ``beamforming_lk_tpu.models.targets``)."""

from __future__ import annotations

import torch


def targets_to_list(targets):
    """Targets of tensors -> list of dicts for host-side consumers.

    The fields are stacked on their device and fetched with ONE ``.cpu()``
    (one device-to-host copy, one wait) rather than one per field."""
    data = torch.stack([
        targets.theta, targets.phi, targets.power, targets.probability,
        targets.start, targets.valid.to(torch.float32),
    ]).cpu().numpy()
    theta, phi, power, prob, start, valid = data
    return [
        {
            "theta": float(theta[i]),
            "phi": float(phi[i]),
            "power": float(power[i]),
            "probability": float(prob[i]),
            "start": float(start[i]),
        }
        for i in range(len(valid)) if valid[i] > 0.5
    ]
