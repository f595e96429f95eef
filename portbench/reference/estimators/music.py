"""Wideband MUSIC in plain PyTorch float64: the reference of a configuration
whose ``"pipeline"`` names ``heatmap_mode`` ``"music"`` (the contract is
:mod:`portbench.reference.estimators`).

The method is MUSIC (Schmidt, IEEE Trans. Antennas Propag. 34(3), 1986) in
each frequency bin, the bins' pseudo-spectra summed incoherently (Wang and
Kaveh, 1985), with the signal subspace tracked block to block by
orthogonal iteration.  Everything but the estimator's carried state is
worked out again here from ``points`` and ``cfg``:

1. the bins: every bin of a :data:`FRAME`-point DFT at the array's sample
   rate inside :data:`BAND` (the upstream band envelope,
   ``filter_produce.m``), DC and Nyquist excluded;
2. the snapshots: frames of :data:`FRAME` samples :data:`HOP` apart, under
   a symmetric Hann window, ``X_f = sum_n w_n x_n exp(-2 pi i k n / N)``;
3. the covariance ``R_f = X_f X_f^H / M`` (M frames), folded in as
   ``R <- (1 - a) R + a R_f``, ``a`` = :data:`ALPHA`; the first block
   (``count`` 0) replaces the initial identity;
4. the real embedding ``E = [[Re R, -Im R], [Im R, Re R]]`` (2C), and the
   orthogonal iteration ``Q <- qr(E Q)`` from the carried basis
   [F, 2C, 2K], :data:`ROUNDS_COLD` rounds on the first block and
   :data:`ROUNDS` after it;
5. the Rayleigh quotients ``s = diag(Q^T E Q)``, the noise floor
   ``n = (tr E - sum s) / (2(C - K))``, and the bin weights ``max(sum s -
   2K n, 0)`` over their sum;
6. ``P[d] = sum_f w_f / ||(I - Q Q^T) v_f(d)||^2``, ``v = [cos | sin]`` of
   the phase ``2 pi f tau_d / fs``, ``tau_d`` the steering delays in
   samples toward grid direction d (:mod:`portbench.reference.geometry`).

K is the configuration's ``music_sources`` (3 without it); the constants
below are the port's documented defaults, which the configuration's
``assumed`` states.

The noise projection ``||(I - Q Q^T) v||^2`` is computed as the residual's
norm, as the program does: ``||v||^2 - ||Q^T v||^2`` is equal for any
orthonormal ``Q``, but cancels near a peak (``||v||^2 = C``), where in
float32 at 256 mics it missed this value by up to a tenth of the peak.

Departures from the program (``beamforming_lk_tpu_torch/models/music.py``):

- the steering phases come from the float64 element positions and grid;
  the program's come from float32 ones (a float32 ulp apart), which is the
  program's stated precision and so lands in its gap;
- the denominator keeps the program's floor ``2 C eps_f32``: the floor
  caps each bin's share of the spectrum, which is part of what the
  operator sees, not a rounding.  It binds only where a grid direction
  lies within the noise of a source's own steering vector;
- only the subspace solver is followed (the configuration names it);
  another solver stops the check.

At a precision below float64 (the control) every product's operands are
rounded to it (:func:`portbench.reference.precision.round_to`), and sums
and element-wise steps stay in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import geometry as geo
from portbench.reference.precision import round_to

FRAME, HOP = 64, 32
BAND = (550.0, 9000.0)
ALPHA = 0.1
ROUNDS, ROUNDS_COLD = 2, 8
#: float32's machine epsilon: the program's floor is 2 C of it.
_EPS_F32 = 2.0 ** -23


def _tables(points, cfg: dict, device):
    """(the windowed DFT [N, F] complex, the steering planes [F, D, 2C]) of
    the bins in :data:`BAND`."""
    a, m = cfg["array"], cfg["mimo"]
    fs = a["sample_rate"]
    k = np.arange(1, FRAME // 2)
    k = k[(k * fs / FRAME >= BAND[0]) & (k * fs / FRAME <= BAND[1])]
    freqs = torch.as_tensor(k * fs / FRAME, dtype=torch.float64, device=device)
    n = torch.arange(FRAME, dtype=torch.float64, device=device)
    window = torch.hann_window(FRAME, periodic=False, dtype=torch.float64,
                               device=device)
    kk = torch.as_tensor(k, dtype=torch.float64, device=device)
    dft = window[:, None] * torch.exp(-2j * math.pi * n[:, None] * kk[None] / FRAME)
    theta, phi = geo.grid_directions(m["rows"], m["columns"], m["fov_degrees"])
    tau = torch.as_tensor(geo.steering_delays(
        points, theta, phi, a["sample_rate"] / a["propagation_speed"]),
        device=device)                                            # [D, C]
    phase = 2.0 * math.pi * freqs[:, None, None] * tau[None] / fs
    return dft, torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def _round_complex(z, precision: str):
    return torch.complex(round_to(z.real, precision), round_to(z.imag, precision))


def follow(state, blocks, points, cfg: dict, precision: str):
    """(spectrum [D], state after the blocks) of the MUSIC step followed
    over ``blocks`` [m, C, T] from the program's ``state``."""
    options = cfg.get("pipeline", {})
    if options.get("music_solver", "subspace") != "subspace":
        raise ValueError("the MUSIC reference follows the subspace solver only, "
                         f"not {options['music_solver']!r}")
    k_src = options.get("music_sources", 3)
    dev = blocks.device
    dft, v_emb = _tables(points, cfg, dev)
    v_emb = round_to(v_emb, precision)
    dft = _round_complex(dft, precision)
    cov_re, cov_im = (state[n].to(torch.float64) for n in ("cov_re", "cov_im"))
    basis, count = state["basis"].to(torch.float64), state["count"]
    c = blocks.shape[1]
    for block in blocks:
        frames = round_to(block, precision).unfold(-1, FRAME, HOP)   # [C, M, N]
        x = torch.einsum("cmn,nf->fcm", frames.to(dft.dtype), dft)   # [F, C, M]
        x = _round_complex(x, precision)
        r = x @ x.conj().mT / x.shape[-1]
        alpha = ALPHA if count > 0 else 1.0
        cov_re = (1.0 - alpha) * cov_re + alpha * r.real
        cov_im = (1.0 - alpha) * cov_im + alpha * r.imag
        emb = round_to(torch.cat([torch.cat([cov_re, -cov_im], dim=-1),
                                  torch.cat([cov_im, cov_re], dim=-1)], dim=-2),
                       precision)
        for _ in range(ROUNDS if count > 0 else ROUNDS_COLD):
            basis, _ = torch.linalg.qr(emb @ round_to(basis, precision))
        count += 1
    q = round_to(basis, precision)
    sig = (q * (emb @ q)).sum(1).sum(-1)                             # [F]
    noise = (torch.diagonal(emb, dim1=-2, dim2=-1).sum(-1) - sig) / (2 * (c - k_src))
    weight = torch.clamp(sig - 2 * k_src * noise, min=0.0)
    weight = weight / torch.clamp(weight.sum(), min=1e-30)
    resid = v_emb - round_to(v_emb @ q, precision) @ q.mT            # [F, D, 2C]
    denom = torch.clamp((resid * resid).sum(-1), min=2.0 * c * _EPS_F32)
    spectrum = (weight[:, None] / denom).sum(0)
    return spectrum, dict(cov_re=cov_re, cov_im=cov_im, count=count, basis=basis)


def comparable(state):
    """The covariance planes and the count as they are, the basis through
    its projector ``Q Q^T`` (free up to a rotation of its columns)."""
    q = state["basis"].to(torch.float64)
    return dict(cov_re=state["cov_re"], cov_im=state["cov_im"], count=state["count"],
                basis=q @ q.mT)
