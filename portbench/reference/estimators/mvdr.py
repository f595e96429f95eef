"""Wideband Capon (MVDR) in plain PyTorch float64 complex arithmetic: the
reference of a configuration whose ``"pipeline"`` names ``heatmap_mode``
``"mvdr"`` (the contract is :mod:`portbench.reference.estimators`).

The method is Capon's minimum-variance spectrum (Capon, "High-resolution
frequency-wavenumber spectrum analysis", Proc. IEEE 57(8), 1969),
``P(d) = 1 / (v_d^H R^-1 v_d)``.  Everything but the estimator's carried
state is worked out again here from ``points`` and ``cfg``, with the
tables of :mod:`.music` (the same bins, windowed DFT and steering phases):

1. the snapshots: frames of :data:`FRAME` samples :data:`HOP` apart under
   a symmetric Hann window, ``X_f = sum_n w_n x_n exp(-2 pi i k n / N)``,
   in the bins of :data:`.music.BAND`;
2. the complex covariance ``R_f = X_f X_f^H / M`` (M frames), folded in as
   ``R <- (1 - a) R + a R_f``, ``a`` = :data:`ALPHA`;
3. the loaded ``R_f + l_f I``, ``l_f`` = :data:`LOADING` times the bin's
   mean channel power ``tr R_f / C``, and ``v^H (R_f + l_f I)^-1 v``
   through a complex solve (LU) against every steering vector ``v_fd =
   exp(2 pi i f tau_d / fs)``, ``tau_d`` the steering delays in samples
   toward grid direction d (:mod:`portbench.reference.geometry`);
4. ``P[d] = sum_f 1 / (v_fd^H (R_f + l_f I)^-1 v_fd)``.

Departures from Capon 1969, each the port's documented choice, which the
configuration's ``assumed`` states:

- the bins' spectra are summed incoherently (Capon's is one frequency);
- the covariance is diagonally loaded (Carlson, "Covariance matrix
  estimation errors and diagonal loading in adaptive arrays", IEEE Trans.
  AES 24(4), 1988), plus the program's floor 1e-12, which keeps a silent
  bin definite and binds nowhere else;
- the covariance is an exponential average over blocks, not one
  estimate: the first block (``count`` 0) replaces the initial identity;
- with ``mvdr_refresh`` k > 1 the spectrum is worked out again only on
  blocks whose count before them is a multiple of k; the blocks between
  carry the state's ``powers`` as they were.

Departures from the program (``beamforming_lk_tpu_torch/models/mvdr.py``):
it solves the complex system, not the Cholesky factor of the real block
embedding; the steering phases come from float64 element positions and
grid (the program's from float32 ones); the program's floor of the
denominator (1e-20) is left out: a loaded covariance keeps it far above.

At a precision below float64 (the control) every product's operands are
rounded to it (:func:`portbench.reference.precision.round_to`): the
samples and the DFT table, the snapshots, the loaded covariance and the
steering vectors that the solve reads, and the solution in ``v^H y``;
sums and element-wise steps stay in float64.
"""

from __future__ import annotations

import torch

from portbench.reference.estimators.music import (ALPHA, FRAME, HOP,
                                                  _round_complex, _tables)
from portbench.reference.precision import round_to

#: The diagonal loading, a share of each bin's mean channel power.
LOADING = 1e-3


def _capon(cov, steer, precision: str):
    """``sum_f 1 / (v^H (R_f + l_f I)^-1 v)`` [D] of the covariance [F, C, C]
    and the steering vectors [F, D, C]."""
    c = cov.shape[-1]
    load = LOADING * torch.diagonal(cov, dim1=-2, dim2=-1).real.sum(-1) / c + 1e-12
    eye = torch.eye(c, dtype=cov.dtype, device=cov.device)
    loaded = _round_complex(cov + load[:, None, None] * eye, precision)
    y = _round_complex(torch.linalg.solve(loaded, steer.mT), precision)  # [F, C, D]
    quad = (steer.conj().mT * y).sum(-2).real                             # [F, D]
    return (1.0 / quad).sum(0)


def follow(state, blocks, points, cfg: dict, precision: str):
    """(spectrum [D], state after the blocks) of the MVDR step followed over
    ``blocks`` [m, C, T] from the program's ``state``."""
    refresh = int(cfg.get("pipeline", {}).get("mvdr_refresh", 1))
    c = blocks.shape[1]
    dft, v_emb = _tables(points, cfg, blocks.device)
    dft = _round_complex(dft, precision)
    v_emb = round_to(v_emb, precision)
    steer = torch.complex(v_emb[..., :c], v_emb[..., c:])              # [F, D, C]
    cov = torch.complex(state["cov_re"].to(torch.float64),
                        state["cov_im"].to(torch.float64))
    count, powers = state["count"], state["powers"]
    for block in blocks:
        frames = round_to(block, precision).unfold(-1, FRAME, HOP)   # [C, M, N]
        x = torch.einsum("cmn,nf->fcm", frames.to(dft.dtype), dft)   # [F, C, M]
        x = _round_complex(x, precision)
        alpha = ALPHA if count > 0 else 1.0
        cov = (1.0 - alpha) * cov + alpha * (x @ x.conj().mT / x.shape[-1])
        if count % refresh == 0:
            powers = _capon(cov, steer, precision)
        count += 1
    return powers, dict(cov_re=cov.real, cov_im=cov.imag, count=count,
                        powers=powers if refresh > 1 else None)
