"""Wideband (incoherent) MUSIC direction-of-arrival estimation without
complex dtypes (counterpart of ``beamforming_lk_tpu.models.music``).

Per frequency bin, the EMA spatial covariance (the same planes as
:mod:`models.mvdr`) is split into a signal subspace of K sources and the
noise subspace orthogonal to them, and

    P[d] = sum_f  w_f / || En[f]^H v[f, d] ||^2

peaks at the source directions.  The Hermitian ``R`` is embedded as the
real symmetric ``M = [[Re, -Im], [Im, Re]]``, whose eigenvalues are R's,
each doubled, so the 2(C-K) weakest eigenvectors of ``M`` give the complex
noise-projection norm, ``||En^H v||^2 = ||En_emb^T v_emb||^2``.  The bin
weights ``w_f`` are each bin's signal eigenvalue mass above its noise
floor, normalised over the bins.

Two solvers:

- ``solver="subspace"`` (default): warm-started orthogonal iteration on the
  carried 2K-column signal basis, ``subspace_iters`` multiply + QR rounds a
  block (8 on the first block), with the noise-projection norm taken as
  the residual ``||En^T a||^2 = ||a - Es Es^T a||^2``;
- ``solver="eigh"``: the full ``torch.linalg.eigh`` of the embedding and the
  direct noise-projection norm (exact; it waits for the device once a call,
  as torch checks its result on the host).

Plain torch on every device (the JAX package has no Pallas kernel here),
without TF32 (:func:`device.full_f32`).  The cold-start rounds are chosen
on the host's block count, so the subspace step waits on nothing, and on
the card the whole step (covariance EMA, rounds, spectrum) replays as one
CUDA graph a block (:meth:`MusicStep.forward`, ``utils/graphs.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from beamforming_lk_tpu_torch.config import ArrayConfig
from beamforming_lk_tpu_torch.device import full_f32, resolve_device
from beamforming_lk_tpu_torch.parallel.mesh import Axis, Layout
from beamforming_lk_tpu_torch.models.mvdr import CovarianceStep, hermitian_embed
from beamforming_lk_tpu_torch.utils.graphs import StepGraphs
from beamforming_lk_tpu_torch.utils.profiling import span

_EPS_F32 = float(np.finfo(np.float32).eps)


class MusicState(NamedTuple):
    cov_re: torch.Tensor    # [F, C, C] symmetric plane of R
    cov_im: torch.Tensor    # [F, C, C] antisymmetric plane of R
    count: int              # host count of the blocks folded in
    basis: torch.Tensor     # [F, 2C, 2K] warm-started signal basis
    #                         (carried untouched by the eigh solver)


def music_init(n_bins: int, channels: int, n_sources: int = 3,
               device="cuda") -> MusicState:
    """Identity covariance and the first 2K unit vectors as the basis, on
    ``device`` (the card by default); ``n_sources`` is the step's K."""
    device = resolve_device(device)
    eye = torch.eye(channels, dtype=torch.float32, device=device)
    basis = torch.eye(2 * channels, dtype=torch.float32,
                      device=device)[:, :2 * n_sources]
    return MusicState(
        cov_re=eye.expand(n_bins, channels, channels).clone(),
        cov_im=torch.zeros((n_bins, channels, channels), dtype=torch.float32,
                           device=device),
        count=0,
        basis=basis.expand(n_bins, 2 * channels, 2 * n_sources).clone(),
    )


class MusicStep(CovarianceStep):
    """The per-block MUSIC update, ``forward(state, block [C, T]) ->
    (state, pseudo [D])``; K = ``n_sources`` is the assumed model order
    (the noise subspace spans the 2(C-K) weakest eigenvectors of the
    embedding).

    The subspace solver's step on one device reads no host value but
    whether the block is cold, so on the card it replays as one CUDA graph
    a key (:attr:`graphs`, :meth:`_replay`): the cold block and the first
    warm one run eagerly, the second warm one captures, and every later
    one replays.  ``eigh`` (torch checks its result on the host) and a
    bin-sharded step (its all-reduces) stay eager; set ``step.graphs =
    None`` for the eager path on the card."""

    def __init__(self, points, theta, phi, array_cfg=ArrayConfig(),
                 n_sources: int = 3, frame_size: int = 64, hop: int = 32,
                 f_low: float = 550.0, f_high: float = 9000.0,
                 ema_alpha: float = 0.1, channel_mask=None,
                 solver: str = "subspace", subspace_iters: int = 2,
                 device="cuda", shard=None):
        c, k = int(np.asarray(points).shape[1]), int(n_sources)
        if not 0 < k < c:
            raise ValueError(f"n_sources must be in (0, {c}), got {k}")
        if solver not in ("subspace", "eigh"):
            raise ValueError(f"solver must be 'subspace' or 'eigh', got {solver!r}")
        super().__init__(points, theta, phi, array_cfg, frame_size, hop, f_low,
                         f_high, ema_alpha, channel_mask, device, shard)
        self.n_sources, self.solver = k, solver
        self.subspace_iters = int(subspace_iters)
        self.n_noise = 2 * (c - k)
        #: Orthogonal-iteration rounds run since the step was built (a
        #: host int: 8 a cold block, ``subspace_iters`` a warm one, 0 under
        #: eigh), replays included.
        self.qr_rounds = 0
        self.graphs = None
        if solver == "subspace" and shard is None:
            self.graphs = StepGraphs(self._step, counters=(),
                                     span="awpu.estimator.replay")

    def init(self) -> MusicState:
        return music_init(self.n_bins, self.channels, self.n_sources,
                          device=self.v_emb.device)

    def subspaces(self, m, state: MusicState):
        """``(basis, signal eigenvalues [F, 2K], noise floor [F], carried
        basis)`` of the embedding ``m`` [F, 2C, 2C]: the noise basis En
        [F, 2C, 2(C-K)] for eigh, the tracked signal basis Es [F, 2C, 2K]
        with its Rayleigh quotients for subspace; the span
        ``awpu.estimator.subspace``."""
        with span("awpu.estimator.subspace"):
            if self.solver == "eigh":
                vals, vecs = torch.linalg.eigh(m)             # ascending
                return (vecs[..., :self.n_noise], vals[..., self.n_noise:],
                        vals[..., :self.n_noise].mean(-1), state.basis)
            q = state.basis
            rounds = self._rounds(state.count == 0)
            for _ in range(rounds):
                q, _ = torch.linalg.qr(m @ q)
            self.qr_rounds += rounds
            sig_vals = (q * (m @ q)).sum(1)                   # Rayleigh quotients
            trace = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)
            return q, sig_vals, (trace - sig_vals.sum(-1)) / self.n_noise, q

    def spectrum(self, basis, sig_vals, noise_mean):
        """The pseudo-spectrum [D] from a bin's basis and eigenvalues; the
        span ``awpu.estimator.spectrum``."""
        with span("awpu.estimator.spectrum"):
            y = self.v_emb @ basis                        # [F, D, 2(C-K) | 2K]
            if self.solver == "eigh":
                denom, floor = (y * y).sum(-1), 1e-12
            else:
                # The residual itself: the complement ||v||^2 - ||Es^T v||^2
                # cancels near a peak (||v||^2 = C), where at 256 mics it
                # missed the float64 value by up to a tenth of the peak.
                resid = torch.baddbmm(self.v_emb, y, basis.mT, alpha=-1.0)
                denom = torch.linalg.vector_norm(resid, dim=-1).square()
                floor = 2.0 * self.channels * _EPS_F32
            sig = torch.clamp(sig_vals.sum(-1) - 2 * self.n_sources * noise_mean,
                              min=0.0) * self.binw
            w = sig / torch.clamp(self.reduce(sig.sum()), min=1e-30)
            return self.reduce((w[:, None] / torch.clamp(denom, min=floor)).sum(0))

    def _rounds(self, cold: bool) -> int:
        """Orthogonal-iteration rounds of a cold or a warm block."""
        return max(self.subspace_iters, 8) if cold else self.subspace_iters

    def _replay(self, state: MusicState, block):
        """:meth:`_step` through :attr:`graphs`, one graph a value of
        whether the block is cold; the host count and :attr:`qr_rounds`
        count on."""
        cold = state.count == 0
        rounds = self.qr_rounds
        new, pseudo = self.graphs(cold, state, block)
        self.qr_rounds = rounds + self._rounds(cold)
        return new._replace(count=state.count + 1), pseudo

    def forward(self, state: MusicState, block):
        if self.graphs is not None and block.is_cuda:
            return self._replay(state, block)
        return self._step(state, block)

    def _step(self, state: MusicState, block):
        """The eager step of :meth:`forward`."""
        with full_f32():
            cov_re, cov_im = self.covariance(state, block)
            basis, sig_vals, noise_mean, carried = self.subspaces(
                hermitian_embed(cov_re, cov_im), state)
            pseudo = self.spectrum(basis, sig_vals, noise_mean)
        return MusicState(cov_re, cov_im, state.count + 1, carried), pseudo


def make_music_step(points, theta, phi, array_cfg: ArrayConfig = ArrayConfig(),
                    n_sources: int = 3, frame_size: int = 64, hop: int = 32,
                    f_low: float = 550.0, f_high: float = 9000.0,
                    ema_alpha: float = 0.1, channel_mask=None,
                    solver: str = "subspace", subspace_iters: int = 2,
                    device="cuda"):
    """``(step, n_bins)``: the :class:`MusicStep` on ``device`` (the card by
    default), with ``step.init()`` and ``step.scan``; raises ``ValueError``
    for ``n_sources`` outside (0, C) and for an unknown solver."""
    step = MusicStep(points, theta, phi, array_cfg, n_sources, frame_size, hop,
                     f_low, f_high, ema_alpha, channel_mask, solver,
                     subspace_iters, device)
    return step, step.n_bins


def make_sharded_music_step(points, theta, phi, mesh, axis_name: str = "dir",
                            array_cfg: ArrayConfig = ArrayConfig(),
                            n_sources: int = 3, frame_size: int = 64,
                            hop: int = 32, f_low: float = 550.0,
                            f_high: float = 9000.0, ema_alpha: float = 0.1,
                            channel_mask=None, solver: str = "subspace",
                            subspace_iters: int = 2, device="cuda"):
    """Bin-sharded wideband MUSIC over the ranks of ``mesh``'s
    ``axis_name`` (the estimator twin of
    :func:`models.mvdr.make_sharded_mvdr_step`): ``(step, state)``.  Each
    rank keeps its bins' covariance and signal basis; the SNR normaliser
    and the [D] pseudo-spectrum are all-reduced (padding bins carry zero
    weight)."""
    step = MusicStep(points, theta, phi, array_cfg, n_sources, frame_size, hop,
                     f_low, f_high, ema_alpha, channel_mask, solver,
                     subspace_iters, Layout(mesh).device(device),
                     Axis(mesh, axis_name))
    return step, step.init()
