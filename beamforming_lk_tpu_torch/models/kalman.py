"""9-state constant-acceleration Kalman filter (pos/vel/acc x xyz)
(counterpart of ``beamforming_lk_tpu.models.kalman``).

The reference's header-only ``KalmanFilter3D`` (``src/geometry/kf.h:22-154``),
used to smooth and lead the best track.  The state is an explicit
NamedTuple of f32 tensors on the filter's device (the card by default).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from beamforming_lk_tpu_torch.device import full_f32, resolve_device


class KalmanState(NamedTuple):
    x: torch.Tensor  # [9] state (pos, vel, acc interleaved by axis groups)
    p: torch.Tensor  # [9, 9] covariance


def _model_matrices(dt: float):
    """A, Q, H, R exactly as kf.h:34-83 (sj = rp = 1)."""
    dt2, dt3, dt4, dt5, dt6 = dt**2, dt**3, dt**4, dt**5, dt**6
    a = np.eye(9, dtype=np.float32)
    for i in range(3):
        a[i, i + 3] = dt
        a[i, i + 6] = dt2 / 2.0
        a[i + 3, i + 6] = dt
    q = np.zeros((9, 9), np.float32)
    for i in range(3):
        q[i, i] = dt6 / 36
        q[i, i + 3] = q[i + 3, i] = dt5 / 12
        q[i, i + 6] = q[i + 6, i] = dt4 / 6
        q[i + 3, i + 3] = dt4 / 4
        q[i + 3, i + 6] = q[i + 6, i + 3] = dt3 / 2
        q[i + 6, i + 6] = dt2
    h = np.zeros((3, 9), np.float32)
    h[:3, :3] = np.eye(3)
    r = np.eye(3, dtype=np.float32)
    return a, q, h, r


class KalmanFilter3D:
    """The model matrices on ``device`` (the card unless the CPU is asked
    for), and the filter's steps on a :class:`KalmanState`; f32 products
    without TF32."""

    def __init__(self, dt: float, device="cuda"):
        self.device = resolve_device(device)
        self.a, self.q, self.h, self.r = (
            torch.as_tensor(m, device=self.device) for m in _model_matrices(dt))

    def init(self) -> KalmanState:
        return KalmanState(
            x=torch.zeros(9, dtype=torch.float32, device=self.device),
            p=torch.eye(9, dtype=torch.float32, device=self.device))

    def update(self, state: KalmanState, measurement) -> KalmanState:
        """Predict + correct (kf.h:85-98)."""
        a, q, h, r = self.a, self.q, self.h, self.r
        z = torch.as_tensor(measurement, dtype=torch.float32, device=self.device)
        with full_f32():
            x = a @ state.x
            p = a @ state.p @ a.T + q
            s = h @ p @ h.T + r
            k = p @ h.T @ torch.linalg.inv(s)
            x = x + k @ (z - h @ x)
            p = (torch.eye(9, dtype=torch.float32, device=self.device) - k @ h) @ p
        return KalmanState(x=x, p=p)

    def position(self, state: KalmanState):
        return state.x[:3]

    def velocity(self, state: KalmanState):
        return state.x[3:6]

    def _extrapolate(self, state: KalmanState, steps: int):
        """``steps`` applications of the reference's accumulating transition
        (kf.h:107-118: ``xn = An xn; An = An A``, so the applied powers of
        A grow triangularly)."""
        xn, an = state.x, self.a
        with full_f32():
            for _ in range(steps):
                xn = an @ xn
                an = an @ self.a
        return xn[:3]

    def predict(self, state: KalmanState, steps: int):
        """Forward-extrapolate ``steps`` accumulating steps."""
        return self._extrapolate(state, int(steps))

    def predict_time(self, state: KalmanState, t: float):
        """Fractional-step extrapolation (kf.h:120-153).  In the reference
        ``xp`` equals ``xn`` after the loop, so the trailing interpolation
        is a no-op; the effective behaviour, ``floor(t) + 1`` accumulating
        steps, is what this does.  Beyond ``t = 10`` it is the position."""
        if t > 10:
            return self.position(state)
        return self._extrapolate(state, int(t) + 1)
