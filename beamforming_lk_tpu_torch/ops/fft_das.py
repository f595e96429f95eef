"""Separable frequency-domain DAS heatmap for lattice apertures
(counterpart of ``beamforming_lk_tpu.ops.fft_das``, ``power_path="fused"``).

For a planar rectangular-lattice array steered over the heatmap's
sin-projected tensor direction grid the steering delay is separable,
``tau[d, c] = fs/c * (u_x[dx] x[cx] - u_y[dy] y[cy])``, so the beamform is
two small per-bin transforms between a forward DFT and a restricted inverse:

    X[cy, cx, f]  = DFT_t(window)                   # [L, 2F] cos|-sin matmul
    B1[dx, cy, f] = sum_cx Ex[f, dx, cx] X[..]
    B2[dy, dx, f] = sum_cy Ey[f, dy, cy] B1[..]
    power[d]      = sum_t (B2 @ pow_ri)[d, t]^2     # bandpass + 1/(T n) folded in

Every spectrum is an (re, im) pair of real planes and every stage a real
matrix product (``torch.einsum``), as in the JAX package.  Dead channels
of a binary mask are removed by subtracting their rank-1 contribution.
The constants are built in numpy float64 by :func:`make_fft_heatmap_model`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from beamforming_lk_tpu_torch.ops import delay as dl


@dataclasses.dataclass(frozen=True)
class Lattice:
    """Rectangular-lattice factorization of a planar element cloud."""

    x: np.ndarray      # [Cx] sorted unique x coordinates
    y: np.ndarray      # [Cy] sorted unique y coordinates
    perm: np.ndarray   # [Cy*Cx] channel index at lattice site (iy, ix)


def lattice_factorization(points, tol: float = 1e-5) -> Optional[Lattice]:
    """The lattice of ``points [3, C]`` if they form a complete planar
    rectangular lattice (z constant, each (x, y) pair once), else None."""
    pts = np.asarray(points, np.float64)
    if pts.shape[0] != 3 or pts.shape[1] == 0:
        return None
    if np.ptp(pts[2]) > tol:
        return None
    c = pts.shape[1]

    def _unique(v):
        sv = np.sort(v)
        edges = np.nonzero(np.diff(sv) > tol)[0]
        return np.concatenate([[sv[0]], sv[edges + 1]])

    ux, uy = _unique(pts[0]), _unique(pts[1])
    if len(ux) * len(uy) != c:
        return None
    ix = np.argmin(np.abs(pts[0][None, :] - ux[:, None]), axis=0)
    iy = np.argmin(np.abs(pts[1][None, :] - uy[:, None]), axis=0)
    if np.max(np.abs(pts[0] - ux[ix])) > tol or np.max(np.abs(pts[1] - uy[iy])) > tol:
        return None
    site = iy * len(ux) + ix
    if len(np.unique(site)) != c:
        return None
    perm = np.empty(c, np.int64)
    perm[site] = np.arange(c)
    return Lattice(x=ux, y=uy, perm=perm)


def _grid_axes(mimo_cfg):
    """Per-axis direction components (u_x[cols], u_y[rows]) of the grid."""
    fov = np.radians(mimo_cfg.fov_degrees)
    rows, cols = mimo_cfg.rows, mimo_cfg.columns
    sep_r = np.sin(fov / 2.0) / (rows / 2.0)
    sep_c = np.sin(fov / 2.0) / (cols / 2.0)
    uy = np.arange(rows) * sep_r - rows * sep_r / 2.0 + sep_r / 2.0
    ux = np.arange(cols) * sep_c - cols * sep_c / 2.0 + sep_c / 2.0
    return ux, uy


def _offdisc_gather(mimo_cfg) -> Optional[np.ndarray]:
    """[D] source map: identity on the FOV disc, nearest on-disc pixel for
    the corner pixels outside it (mimo.cpp:36-43 analog); None if all in."""
    ux, uy = _grid_axes(mimo_cfg)
    rows, cols = mimo_cfg.rows, mimo_cfg.columns
    yy, xx = np.meshgrid(uy, ux, indexing="ij")
    norm = np.hypot(xx, yy).reshape(-1)
    src = np.arange(rows * cols, dtype=np.int64)
    out = norm > 1.0
    if not out.any():
        return None
    px = xx.reshape(-1)[out] / norm[out]
    py = yy.reshape(-1)[out] / norm[out]
    in_idx = np.nonzero(~out)[0]
    gx = xx.reshape(-1)[in_idx]
    gy = yy.reshape(-1)[in_idx]
    d2 = (gx[None, :] - px[:, None]) ** 2 + (gy[None, :] - py[:, None]) ** 2
    src[out] = in_idx[d2.argmin(axis=1)]
    return src


class FftHeatmapModel(nn.Module):
    """Constant operands of the separable heatmap, held as buffers on one
    device.  ``ex_s``/``ey_s`` are [F, D_axis, 2C_axis] = [cos | sin] of the
    per-axis steering phase; ``dft`` [L, 2F] = [cos | -sin]; ``pow_ri``
    [2F, Tp] the bandpass-folded restricted inverse DFT with the power
    normalization folded in; ``perm_matrix`` [C, C] one-hot site<-channel
    (None when channel order is lattice order); ``src_map`` [D] the
    off-disc gather (None when every pixel is on the disc); ``dead_*`` the
    rank-1 terms of masked channels (None without dead channels)."""

    def __init__(self, *, ex_s, ey_s, dft, pow_ri, perm_matrix=None,
                 src_map=None, dead=None, rows: int, columns: int,
                 block_size: int, fft_len: int, n_active: float,
                 compute: str = "float32", device=None):
        super().__init__()

        def buf(name, a, dtype=torch.float32):
            t = None if a is None else torch.as_tensor(
                np.array(a), dtype=dtype, device=device
            )
            self.register_buffer(name, t)

        buf("ex_s", ex_s)
        buf("ey_s", ey_s)
        buf("dft", dft)
        buf("pow_ri", pow_ri)
        buf("perm_matrix", perm_matrix)
        buf("src_map", src_map, torch.long)
        dead = dead or (None,) * 5
        for name, a in zip(("dead_xre", "dead_xim", "dead_yre", "dead_yim"),
                           dead[:4]):
            buf(name, a)
        buf("dead_chan", dead[4], torch.long)
        self.rows = rows
        self.columns = columns
        self.block_size = block_size
        self.fft_len = fft_len
        self.n_active = n_active
        self.compute = compute

    def forward(self, window):
        return fft_heatmap_powers(window, self)


def make_fft_heatmap_model(
    points,
    mimo_cfg,
    dsp_cfg,
    array_cfg,
    channel_mask=None,
    compute: Optional[str] = None,
    device=None,
) -> Optional[FftHeatmapModel]:
    """Precompute the separable steering factors in numpy float64, or
    return None when the configuration does not factor (non-lattice points
    or a non-binary gain mask)."""
    if mimo_cfg.phat:
        raise NotImplementedError(
            "SRP-PHAT whitening is not ported to the torch heatmap yet"
        )
    lat = lattice_factorization(points)
    if lat is None:
        return None
    mask = None
    if channel_mask is not None:
        mask = np.asarray(channel_mask, np.float64)
        if not np.all((mask < 1e-12) | (np.abs(mask - 1.0) < 1e-6)):
            return None  # gain masks are not rank-1-correctable
    taps = dl.LINEAR_TAPS if dsp_cfg.interp == "linear" else dsp_cfg.fir_taps
    s, t = dsp_cfg.shift_range, dsp_cfg.block_size
    L = s + t
    spm = array_cfg.samples_per_meter
    ux, uy = _grid_axes(mimo_cfg)

    # beam[t] reads window position t + (S - taps) + offset - tau[d, c],
    # with tau = raw - min_d, raw = spm * (ux*x - uy*y); min_d splits per
    # axis, so (S - taps) + offset + mx folds into Ex and my into Ey.  The
    # offset is 1 for linear interp (the backwards-interp quirk,
    # delay.cpp:24) and the FIR bank's centre otherwise.
    f = np.arange(L // 2 + 1, dtype=np.float64)
    raw_x = spm * np.outer(ux, lat.x)                 # [Dx, Cx]
    raw_y = -spm * np.outer(uy, lat.y)                # [Dy, Cy]
    mx = raw_x.min(axis=1, keepdims=True)
    my = raw_y.min(axis=1, keepdims=True)
    offset = 1.0 if dsp_cfg.interp == "linear" else dl.FIR_DEFAULT_CENTER
    dx_shift = (s - taps) + offset + mx - raw_x
    dy_shift = my - raw_y
    ang_x = 2.0 * np.pi * f[:, None, None] * dx_shift[None] / L
    ang_y = 2.0 * np.pi * f[:, None, None] * dy_shift[None] / L

    def _stacked(a):
        return np.concatenate([np.cos(a), np.sin(a)], axis=-1).astype(np.float32)

    n_t = np.arange(L, dtype=np.float64)[:, None]
    w_ang = 2.0 * np.pi * n_t * f[None, :] / L
    dft = np.concatenate([np.cos(w_ang), -np.sin(w_ang)], axis=1).astype(np.float32)
    # Inverse rfft restricted to the first T samples, [2F, T].
    wt = np.full(len(f), 2.0)
    wt[0] = 1.0
    if L % 2 == 0:
        wt[-1] = 1.0
    i_ang = 2.0 * np.pi * f[:, None] * np.arange(t, dtype=np.float64)[None, :] / L
    idft_np = np.concatenate(
        [np.cos(i_ang) * wt[:, None] / L, -np.sin(i_ang) * wt[:, None] / L],
        axis=0,
    )
    if dsp_cfg.use_bandpass:
        pow_np = 0.5 * idft_np[:, 1:-1] - 0.25 * (idft_np[:, 2:] + idft_np[:, :-2])
    else:
        pow_np = idft_np
    t_pad = (-pow_np.shape[1]) % 128
    if t_pad:
        pow_np = np.pad(pow_np, ((0, 0), (0, t_pad)))

    dead = None
    n_active = float(points.shape[1])
    if mask is not None:
        dead_chan = np.nonzero(mask < 0.5)[0]
        n_active = float(points.shape[1] - len(dead_chan))
        if len(dead_chan):
            site_of_chan = np.empty_like(lat.perm)
            site_of_chan[lat.perm] = np.arange(len(lat.perm))
            sites = site_of_chan[dead_chan]
            cxs, cys = sites % len(lat.x), sites // len(lat.x)
            dead = (
                np.cos(ang_x[:, :, cxs]).astype(np.float32),
                np.sin(ang_x[:, :, cxs]).astype(np.float32),
                np.cos(ang_y[:, :, cys]).astype(np.float32),
                np.sin(ang_y[:, :, cys]).astype(np.float32),
                dead_chan,
            )
    pow_ri = (pow_np / np.sqrt(t * max(n_active, 1.0))).astype(np.float32)
    perm_matrix = None
    if not np.array_equal(lat.perm, np.arange(len(lat.perm))):
        perm_matrix = np.zeros((len(lat.perm), len(lat.perm)), np.float32)
        perm_matrix[np.arange(len(lat.perm)), lat.perm] = 1.0
    return FftHeatmapModel(
        ex_s=_stacked(ang_x), ey_s=_stacked(ang_y), dft=dft, pow_ri=pow_ri,
        perm_matrix=perm_matrix, src_map=_offdisc_gather(mimo_cfg), dead=dead,
        rows=mimo_cfg.rows, columns=mimo_cfg.columns, block_size=t,
        fft_len=L, n_active=n_active, compute=compute or "float32",
        device=device,
    )


def _steered_spectra(window, model: FftHeatmapModel, mm):
    """Per-direction beam spectra ``(b2_re, b2_im)``, each [Dy, Dx, F].
    Each complex contraction is one real einsum: the steering factor's re
    and im are stacked along the contracted axis and the outputs' re and im
    ride a doubled batch axis."""
    cx = model.ex_s.shape[-1] // 2
    cy = model.ey_s.shape[-1] // 2
    f_half = model.dft.shape[-1] // 2
    x_ri = mm("ct,tf->cf", window, model.dft)               # [C, 2F]
    if model.perm_matrix is not None:
        x_ri = mm("sc,cf->sf", model.perm_matrix, x_ri)
    x = x_ri.reshape(cy, cx, 2, f_half)
    x_re, x_im = x[..., 0, :], x[..., 1, :]                 # [Cy, Cx, F]
    x_for = torch.cat([
        torch.cat([x_re, -x_im], dim=1),                    # -> b1_re
        torch.cat([x_im, x_re], dim=1),                     # -> b1_im
    ], dim=0)                                               # [2Cy, 2Cx, F]
    b1 = mm("fdc,ycf->dyf", model.ex_s, x_for)              # [Dx, 2Cy, F]
    b1_re, b1_im = b1[:, :cy], b1[:, cy:]
    b1_for = torch.cat([
        torch.cat([b1_re, -b1_im], dim=1),                  # -> b2_re
        torch.cat([b1_im, b1_re], dim=1),                   # -> b2_im
    ], dim=0)                                               # [2Dx, 2Cy, F]
    dx = b1.shape[0]
    b2s = mm("fdc,xcf->dxf", model.ey_s, b1_for)            # [Dy, 2Dx, F]
    b2_re, b2_im = b2s[:, :dx], b2s[:, dx:]
    if model.dead_chan is not None:
        s_ri = mm("nt,tf->nf", window[model.dead_chan], model.dft)  # [Nd, 2F]
        srt = s_ri[:, :f_half].T[:, None, :]                # [F, 1, Nd]
        sit = s_ri[:, f_half:].T[:, None, :]
        xdr, xdi = model.dead_xre, model.dead_xim
        ydr, ydi = model.dead_yre, model.dead_yim
        t1_r = xdr * srt - xdi * sit                        # [F, Dx, Nd]
        t1_i = xdr * sit + xdi * srt
        b2_re = b2_re - (
            mm("fxn,fyn->yxf", t1_r, ydr) - mm("fxn,fyn->yxf", t1_i, ydi)
        )
        b2_im = b2_im - (
            mm("fxn,fyn->yxf", t1_r, ydi) + mm("fxn,fyn->yxf", t1_i, ydr)
        )
    return b2_re, b2_im


def _mm_builders(model: FftHeatmapModel):
    """(mm_mid, mm_f32): einsums with inputs in the compute dtype.
    ``mm_mid`` writes its output in the compute dtype, as the JAX package's
    intermediate stages do; ``mm_f32`` returns float32 — for bf16 it runs
    on bf16-rounded inputs cast to float32, which is a bf16-input,
    f32-accumulate, f32-output product."""
    dtype = torch.bfloat16 if model.compute == "bfloat16" else torch.float32

    def mm_mid(sub, a, b):
        return torch.einsum(sub, a.to(dtype), b.to(dtype))

    def mm_f32(sub, a, b):
        return torch.einsum(
            sub, a.to(dtype).to(torch.float32), b.to(dtype).to(torch.float32)
        )

    return mm_mid, mm_f32


def fft_heatmap_powers(window, model: FftHeatmapModel):
    """Heatmap powers [rows*columns] from a DAS window [C, S+T]: band-passed
    mean power over the beamformed block, normalized by T * active channels,
    with the [D, T] beam never materialized."""
    mm_mid, mm_f32 = _mm_builders(model)
    b2_re, b2_im = _steered_spectra(window, model, mm_mid)
    b2_ri = torch.cat([b2_re, b2_im], dim=-1)               # [Dy, Dx, 2F]
    bp = mm_f32("yxf,ft->yxt", b2_ri, model.pow_ri)         # [Dy, Dx, Tp]
    powers = torch.sum(bp * bp, dim=-1).reshape(model.rows * model.columns)
    if model.src_map is not None:
        powers = powers[model.src_map]
    return powers
