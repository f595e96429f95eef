"""Wideband frequency-domain MVDR (Capon) beamforming without complex
dtypes (counterpart of ``beamforming_lk_tpu.models.mvdr``).

For each selected STFT bin of a [C, T] block:

  1. re/im snapshot planes of the block's overlapping frames, from two
     windowed-DFT tables (no rfft, no gather);
  2. the spatial covariance's EMA, kept as the (re, im) planes of the
     Hermitian ``R``: ``re`` symmetric, ``im`` antisymmetric;
  3. the Capon power ``P[d] = sum_f 1 / (v^H R^-1 v)`` through the real
     block embedding ``M = [[Re, -Im], [Im, Re]]`` (size 2C) of the
     diagonally loaded ``R``, with ``v^H R^-1 v = ||L^-1 v_emb||^2`` for
     ``M = L L^T`` and ``v_emb = [vr | vi]``: one batched Cholesky and one
     triangular solve against all D directions.

Plain torch on every device (the JAX package has no Pallas kernel here):
``torch.linalg.cholesky_ex`` and ``solve_triangular`` stand where it calls
``jax.lax.linalg``.  The step waits on nothing: the block counter that
picks the EMA's first weight and the solve's decimation is a host int, and
the Cholesky's ``info`` stays on the device, where it turns a factor that
failed (a covariance that is not positive definite, only from non-finite
input: the loading keeps a silent block definite) into NaN, as the JAX
package's Cholesky does.  Each call runs without TF32
(:func:`device.full_f32`).  Under a profiler the stages open the spans
``awpu.estimator.covariance``, ``.factor`` and ``.directions``;
:attr:`MvdrStep.solves` counts the direction stages run.  On the card the
whole step (covariance EMA, factor, directions) replays as one CUDA graph
a block (:meth:`MvdrStep.forward`, ``utils/graphs.py``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from beamforming_lk_tpu_torch.config import ArrayConfig
from beamforming_lk_tpu_torch.device import full_f32, resolve_device
from beamforming_lk_tpu_torch.parallel.mesh import Axis, Layout
from beamforming_lk_tpu_torch.ops import antenna as ant
from beamforming_lk_tpu_torch.utils.graphs import StepGraphs
from beamforming_lk_tpu_torch.utils.profiling import span


class MvdrState(NamedTuple):
    cov_re: torch.Tensor              # [F, C, C] symmetric plane of R
    cov_im: torch.Tensor              # [F, C, C] antisymmetric plane of R
    count: int                        # host count of the blocks folded in
    # [D] the last refreshed powers, carried between refreshes when the
    # step decimates its solve (``weight_refresh > 1``); None otherwise.
    powers: Optional[torch.Tensor] = None


def mvdr_init(n_bins: int, channels: int, n_directions: Optional[int] = None,
              device="cuda") -> MvdrState:
    """Identity covariance on ``device`` (the card by default).
    ``n_directions`` sizes the carried spectrum, which a step built with
    ``weight_refresh > 1`` needs (``step.init()`` gives it)."""
    device = resolve_device(device)
    eye = torch.eye(channels, dtype=torch.float32, device=device)
    return MvdrState(
        cov_re=eye.expand(n_bins, channels, channels).clone(),
        cov_im=torch.zeros((n_bins, channels, channels), dtype=torch.float32,
                           device=device),
        count=0,
        powers=(None if n_directions is None else
                torch.zeros((n_directions,), dtype=torch.float32, device=device)),
    )


def select_bins(frame_size: int, sample_rate: float, f_low: float = 550.0,
                f_high: float = 9000.0) -> np.ndarray:
    """rfft bin indices inside the band of interest (the reference's band
    envelope, filter_produce.m: 550-9000 Hz)."""
    freqs = np.fft.rfftfreq(frame_size, 1.0 / sample_rate)
    idx = np.where((freqs >= f_low) & (freqs <= f_high))[0]
    # Skip DC/nyquist edges even for wide bands.
    return idx[(idx > 0) & (idx < frame_size // 2)]


def dft_tables(frame_size: int, bins, window=None) -> np.ndarray:
    """Windowed-DFT analysis tables, stacked [2, frame, F] (cos, sin):
    ``X_k = sum_n w_n x_n e^{-2 pi i k n / N}`` is ``re = x @ tab[0]``,
    ``im = -(x @ tab[1])``."""
    if window is None:
        window = np.hanning(frame_size)
    n = np.arange(frame_size, dtype=np.float64)[:, None]
    k = np.asarray(bins, np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / frame_size
    w = np.asarray(window, np.float64)[:, None]
    return np.stack([np.cos(ang) * w, np.sin(ang) * w]).astype(np.float32)


def steering_matrix(points, theta, phi, freqs_hz,
                    array_cfg: ArrayConfig = ArrayConfig()) -> np.ndarray:
    """Re/im planes, stacked [2, F, D, C], of ``v = exp(+2 pi i f tau /
    fs)`` from the DAS delay model (the matched phasor of a plane wave that
    reaches channel c ``tau_c`` samples early, as ``io.synthetic`` makes
    it)."""
    delays = ant.steering_delays_np(
        np.asarray(points), np.asarray(theta), np.asarray(phi),
        array_cfg.samples_per_meter,
    )  # [D, C] in samples
    phase = (2.0 * np.pi * np.asarray(freqs_hz)[:, None, None]
             * delays[None, :, :] / array_cfg.sample_rate)
    return np.stack([np.cos(phase), np.sin(phase)]).astype(np.float32)


def hermitian_embed(re, im):
    """[..., C, C] (re, im) planes of a Hermitian matrix -> the real
    symmetric block embedding ``[[re, -im], [im, re]]`` [..., 2C, 2C]; HPD
    maps to SPD, and products commute with ``z -> [z_re | z_im]``."""
    return torch.cat([torch.cat([re, -im], dim=-1),
                      torch.cat([im, re], dim=-1)], dim=-2)


def _stft_snapshots(block, dft_t, frame_size: int, hop: int, mask=None):
    """block [C, T] -> (re, im) snapshot planes [F, C, M] and M, the frames
    ``hop`` apart."""
    if mask is not None:
        block = block * mask[:, None]
    frames = block.unfold(-1, frame_size, hop)        # [C, M, frame]
    re = torch.einsum("cmn,nf->fcm", frames, dft_t[0])
    im = -torch.einsum("cmn,nf->fcm", frames, dft_t[1])
    return re, im, frames.shape[1]


class CovarianceStep(nn.Module):
    """What the adaptive estimators share: the analysis tables, the steering
    planes ``v_emb`` [F, D, 2C] (``[vr | vi]``, built once), the bin
    weights ``binw`` [F], the channel mask, and the covariance EMA.

    ``shard`` (a ``parallel.mesh.Axis``) shards the bins over its ranks:
    the bins pad up to a multiple of its size (repeats of the last bin,
    with ``binw`` 0), each rank keeps its block of them, and
    :meth:`reduce` sums a per-bin total over the ranks."""

    def __init__(self, points, theta, phi, array_cfg, frame_size, hop, f_low,
                 f_high, ema_alpha, channel_mask, device="cuda", shard=None):
        super().__init__()
        device = resolve_device(device)
        bins = select_bins(frame_size, array_cfg.sample_rate, f_low, f_high)
        binw = np.ones(len(bins), np.float32)
        self.shard = shard
        if shard is not None:
            pad = (-len(bins)) % shard.size
            bins = np.concatenate([bins, np.repeat(bins[-1:], pad)])
            binw = np.concatenate([binw, np.zeros(pad, np.float32)])
            part = shard.part(len(bins))
            bins, binw = bins[part], binw[part]
        freqs = np.fft.rfftfreq(frame_size, 1.0 / array_cfg.sample_rate)[bins]
        v = steering_matrix(points, theta, phi, freqs, array_cfg)
        self.register_buffer("v_emb", torch.as_tensor(
            np.concatenate([v[0], v[1]], axis=-1), device=device))
        self.register_buffer("dft", torch.as_tensor(
            dft_tables(frame_size, bins), device=device))
        self.register_buffer("binw", torch.as_tensor(binw, device=device))
        self.register_buffer("mask", None if channel_mask is None else
                             torch.as_tensor(channel_mask, dtype=torch.float32,
                                             device=device))
        self.frame_size, self.hop = frame_size, hop
        self.alpha = float(np.float32(ema_alpha))
        self.n_bins = len(bins)
        self.channels = int(np.asarray(points).shape[1])
        self.n_directions = int(np.asarray(theta).size)

    def reduce(self, total):
        """A sum over the bins completed over the ranks of a bin-sharded
        step (an all-reduce; the total itself on one device)."""
        return total if self.shard is None else self.shard.all_reduce(total)

    def covariance(self, state, block):
        """The EMA covariance planes after ``block`` [C, T]; the first block
        (``state.count == 0``) replaces the initial identity; the span
        ``awpu.estimator.covariance`` in a profiler's trace."""
        with span("awpu.estimator.covariance"):
            xr, xi, n_frames = _stft_snapshots(block, self.dft, self.frame_size,
                                               self.hop, self.mask)
            # All four plane products as one batched product of [xr; xi].
            c = xr.shape[1]
            z = torch.cat([xr, xi], dim=1)                 # [F, 2C, M]
            g = z @ z.mT
            r_re = (g[:, :c, :c] + g[:, c:, c:]) / n_frames
            r_im = (g[:, c:, :c] - g[:, :c, c:]) / n_frames
            # The weights as the JAX package rounds them: f32 alpha, 1 - alpha
            # in f32.
            alpha = self.alpha if state.count > 0 else 1.0
            keep = float(np.float32(1.0) - np.float32(alpha))
            return (keep * state.cov_re + alpha * r_re,
                    keep * state.cov_im + alpha * r_im)

    def scan(self, state, blocks, n: Optional[int] = None):
        """``(state, powers [n, D])`` of ``n`` consecutive blocks of
        ``blocks`` [M, C, T] (all M by default; ``n`` beyond M cycles
        them), equal to ``n`` calls of the step."""
        blocks = torch.as_tensor(blocks, dtype=torch.float32,
                                 device=self.v_emb.device)
        k = blocks.shape[0]
        n = k if n is None else n
        out = []
        for i in range(n):
            state, p = self(state, blocks[i % k])
            out.append(p)
        return state, torch.stack(out)


class MvdrStep(CovarianceStep):
    """The per-block MVDR update, ``forward(state, block [C, T]) -> (state,
    powers [D])``.  With ``weight_refresh`` k > 1 the covariance EMA folds
    in every block, and the Cholesky and the direction stage (the block's
    dominant cost) run on blocks with ``count % k == 0``; the blocks in
    between carry ``state.powers``.  Refresh blocks equal the undecimated
    step's.

    On one device the step reads no host value but whether the block is
    cold and whether it solves, so on the card it replays as one CUDA graph
    a key (:attr:`graphs`, :meth:`_replay`): a key's first block runs
    eagerly, its second captures, and every later one replays.  A
    bin-sharded step (its all-reduces) stays eager; set ``step.graphs =
    None`` for the eager path on the card."""

    def __init__(self, points, theta, phi, array_cfg=ArrayConfig(),
                 frame_size: int = 64, hop: int = 32, f_low: float = 550.0,
                 f_high: float = 9000.0, ema_alpha: float = 0.1,
                 diagonal_loading: float = 1e-3, channel_mask=None,
                 weight_refresh: int = 1, device="cuda", shard=None):
        super().__init__(points, theta, phi, array_cfg, frame_size, hop, f_low,
                         f_high, ema_alpha, channel_mask, device, shard)
        self.diagonal_loading = diagonal_loading
        self.weight_refresh = int(weight_refresh)
        #: Direction stages run since the step was built (a host int: one
        #: a block at ``weight_refresh`` 1, one in k at k), replays included.
        self.solves = 0
        self.graphs = None
        if shard is None:
            self.graphs = StepGraphs(self._step, counters=(),
                                     span="awpu.estimator.replay")

    def init(self) -> MvdrState:
        return mvdr_init(self.n_bins, self.channels,
                         self.n_directions if self.weight_refresh > 1 else None,
                         device=self.v_emb.device)

    def factor(self, cov_re, cov_im):
        """The lower Cholesky factor [F, 2C, 2C] of the loaded covariance's
        embedding: the loading is ``diagonal_loading`` times each bin's mean
        channel power.  A bin whose factorisation fails is all NaN.  The
        span ``awpu.estimator.factor``."""
        with span("awpu.estimator.factor"):
            c = cov_re.shape[-1]
            tr = torch.diagonal(cov_re, dim1=-2, dim2=-1).sum(-1)   # [F]
            load = self.diagonal_loading * tr / c + 1e-12
            eye = torch.eye(c, dtype=cov_re.dtype, device=cov_re.device)
            m = hermitian_embed(cov_re + load[:, None, None] * eye, cov_im)
            chol, info = torch.linalg.cholesky_ex(m)
            return torch.where((info > 0)[:, None, None], torch.nan, chol)

    def directions(self, chol):
        """Capon powers [D] from the factor: ``sum_f binw_f / ||L_f^-1
        v_emb[f, d]||^2``; counted in :attr:`solves`.  The span
        ``awpu.estimator.directions``."""
        with span("awpu.estimator.directions"):
            self.solves += 1
            y = torch.linalg.solve_triangular(chol, self.v_emb.mT, upper=False)
            denom = (y * y).sum(dim=1)                              # [F, D]
            return self.reduce(
                (self.binw[:, None] / torch.clamp(denom, min=1e-20)).sum(0))

    def _solves(self, count: int) -> bool:
        """Whether the block after ``count`` folded ones runs the factor and
        the direction stage."""
        return count % self.weight_refresh == 0

    def _replay(self, state: MvdrState, block):
        """:meth:`_step` through :attr:`graphs`, one graph a value of
        whether the block is cold and whether it solves; the host count and
        :attr:`solves` count on."""
        solves = self._solves(state.count)
        before = self.solves
        new, powers = self.graphs((state.count == 0, solves), state, block)
        self.solves = before + solves
        return new._replace(count=state.count + 1), powers

    def forward(self, state: MvdrState, block):
        if self.weight_refresh > 1 and state.powers is None:
            raise ValueError(
                "a step with weight_refresh > 1 carries its spectrum in "
                "state.powers: start from step.init() (or mvdr_init with "
                "n_directions)")
        if self.graphs is not None and block.is_cuda:
            return self._replay(state, block)
        return self._step(state, block)

    def _step(self, state: MvdrState, block):
        """The eager step of :meth:`forward`."""
        refresh = self.weight_refresh > 1
        with full_f32():
            cov_re, cov_im = self.covariance(state, block)
            if self._solves(state.count):
                powers = self.directions(self.factor(cov_re, cov_im))
            else:
                powers = state.powers
        return MvdrState(cov_re, cov_im, state.count + 1,
                         powers if refresh else None), powers


def make_mvdr_step(points, theta, phi, array_cfg: ArrayConfig = ArrayConfig(),
                   frame_size: int = 64, hop: int = 32, f_low: float = 550.0,
                   f_high: float = 9000.0, ema_alpha: float = 0.1,
                   diagonal_loading: float = 1e-3, channel_mask=None,
                   weight_refresh: int = 1, device="cuda"):
    """``(step, n_bins)``: the :class:`MvdrStep` on ``device`` (the card by
    default), with ``step.init()`` and ``step.scan``."""
    step = MvdrStep(points, theta, phi, array_cfg, frame_size, hop, f_low,
                    f_high, ema_alpha, diagonal_loading, channel_mask,
                    weight_refresh, device)
    return step, step.n_bins


def make_sharded_mvdr_step(points, theta, phi, mesh, axis_name: str = "dir",
                           array_cfg: ArrayConfig = ArrayConfig(),
                           frame_size: int = 64, hop: int = 32,
                           f_low: float = 550.0, f_high: float = 9000.0,
                           ema_alpha: float = 0.1,
                           diagonal_loading: float = 1e-3, channel_mask=None,
                           weight_refresh: int = 1, device="cuda"):
    """Bin-sharded MVDR over the ranks of ``mesh``'s ``axis_name``:
    ``(step, state)``, the :class:`MvdrStep` of this rank's bins (padding
    bins carry zero weight) and its initial state.  Each rank takes the
    whole block, folds and solves only its bins, and the [D] Capon powers
    are all-reduced; ``weight_refresh`` decimates the solve as in
    :func:`make_mvdr_step` (the carried spectrum is replicated)."""
    step = MvdrStep(points, theta, phi, array_cfg, frame_size, hop, f_low,
                    f_high, ema_alpha, diagonal_loading, channel_mask,
                    weight_refresh, Layout(mesh).device(device),
                    Axis(mesh, axis_name))
    return step, step.init()
