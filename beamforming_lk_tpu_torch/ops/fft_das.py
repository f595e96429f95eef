"""Separable frequency-domain DAS heatmap for lattice apertures
(counterpart of ``beamforming_lk_tpu.ops.fft_das``: the three power paths,
the chunked form, and the power-stage kernel ``power_matmul``).

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
SRP-PHAT (``MimoConfig.phat``) whitens each channel's spectrum to unit
magnitude and keeps the bins of ``phat_band``.  A model built with
``assume_lattice_order=True`` takes windows whose rows are already in
lattice-site order (row ``s`` = channel ``channel_perm[s]``) and skips the
permutation product.  The constants are built in numpy float64 by
:func:`make_fft_heatmap_model`.

The final power stage is the model's ``power_path``: ``"fused"`` (the
einsum against ``pow_ri``, then the square-reduce), ``"pallas"`` (the same
contraction and square-reduce as one hand-written CUDA kernel,
:func:`power_matmul`, source ``csrc/power_matmul.cu``; the name is the JAX
package's) or ``"beam"`` (the [D, T] beam through ``idft``, then
``das_power``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import os
from typing import Optional

import numpy as np
import torch
from torch import nn

from beamforming_lk_tpu_torch.device import resolve_device
from beamforming_lk_tpu_torch.ops import delay as dl
from beamforming_lk_tpu_torch.ops.cuda_tracker import check_operand, require_cuda

POWER_PATHS = ("fused", "pallas", "beam")
_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc", "power_matmul.cu",
)


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
    per-axis steering phase; ``dft`` [L, 2F] = [cos | -sin]; ``idft``
    [2F, T] the restricted inverse rfft (the "beam" path); ``pow_ri``
    [2F, Tp] the bandpass-folded restricted inverse DFT with the power
    normalization folded in; ``perm_matrix`` [C, C] one-hot site<-channel
    (None when channel order is lattice order); ``src_map`` [D] the
    off-disc gather (None when every pixel is on the disc); ``dead_*`` the
    rank-1 terms of masked channels, ``dead_chan`` their window rows (None
    without dead channels); ``band_weight`` [F] the PHAT band (None without
    PHAT).  ``channel_perm`` (numpy, not a buffer) is the channel of each
    window row under the lattice-order promise, None without it or when
    channel order is lattice order."""

    def __init__(self, *, ex_s, ey_s, dft, idft, pow_ri, perm_matrix=None,
                 src_map=None, dead=None, rows: int, columns: int,
                 block_size: int, fft_len: int, n_active: float,
                 use_bandpass: bool = True, compute: str = "float32",
                 phat: bool = False, band_weight=None, channel_perm=None,
                 power_path: str = "fused", device="cuda"):
        super().__init__()
        if power_path not in POWER_PATHS:
            raise ValueError(f"power_path {power_path!r} not in {POWER_PATHS}")
        device = resolve_device(device)

        def buf(name, a, dtype=torch.float32):
            t = None if a is None else torch.as_tensor(
                np.array(a), dtype=dtype, device=device
            )
            self.register_buffer(name, t)

        buf("ex_s", ex_s)
        buf("ey_s", ey_s)
        buf("dft", dft)
        buf("idft", idft)
        buf("pow_ri", pow_ri)
        buf("perm_matrix", perm_matrix)
        buf("src_map", src_map, torch.long)
        dead = dead or (None,) * 5
        for name, a in zip(("dead_xre", "dead_xim", "dead_yre", "dead_yim"),
                           dead[:4]):
            buf(name, a)
        buf("dead_chan", dead[4], torch.long)
        buf("band_weight", band_weight)
        self.phat = phat
        self.channel_perm = channel_perm
        self.rows = rows
        self.columns = columns
        self.block_size = block_size
        self.fft_len = fft_len
        self.n_active = n_active
        self.use_bandpass = use_bandpass
        self.compute = compute
        self.power_path = power_path

    def forward(self, window):
        return fft_heatmap_powers(window, self)


def make_fft_heatmap_model(
    points,
    mimo_cfg,
    dsp_cfg,
    array_cfg,
    channel_mask=None,
    compute: Optional[str] = None,
    phat_band=(550.0, 9000.0),
    power_path: str = "fused",
    assume_lattice_order: bool = False,
    device="cuda",
) -> Optional[FftHeatmapModel]:
    """Precompute the separable steering factors in numpy float64, or
    return None when the configuration does not factor (non-lattice points
    or a non-binary gain mask).  ``power_path`` selects the final stage
    (module docstring); ``phat_band`` [Hz] the bins PHAT keeps.
    ``assume_lattice_order=True`` promises windows whose rows are in
    lattice-site order (row ``s`` = channel ``model.channel_perm[s]``),
    which drops the per-block permutation product.  The model lies on
    ``device``, the card unless it names the CPU."""
    device = resolve_device(device)
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
                # A dead channel's window row: its site under the promise.
                sites if assume_lattice_order else dead_chan,
            )
    pow_ri = (pow_np / np.sqrt(t * max(n_active, 1.0))).astype(np.float32)
    perm_matrix = channel_perm = None
    if not np.array_equal(lat.perm, np.arange(len(lat.perm))):
        if assume_lattice_order:
            channel_perm = lat.perm.copy()
        else:
            perm_matrix = np.zeros((len(lat.perm), len(lat.perm)), np.float32)
            perm_matrix[np.arange(len(lat.perm)), lat.perm] = 1.0
    band_weight = None
    if mimo_cfg.phat:
        hz = f * array_cfg.sample_rate / L
        band_weight = ((hz >= phat_band[0]) & (hz <= phat_band[1])).astype(np.float32)
    return FftHeatmapModel(
        ex_s=_stacked(ang_x), ey_s=_stacked(ang_y), dft=dft,
        idft=idft_np.astype(np.float32), pow_ri=pow_ri,
        perm_matrix=perm_matrix, src_map=_offdisc_gather(mimo_cfg), dead=dead,
        rows=mimo_cfg.rows, columns=mimo_cfg.columns, block_size=t,
        fft_len=L, n_active=n_active, use_bandpass=dsp_cfg.use_bandpass,
        compute=compute or "float32", phat=bool(mimo_cfg.phat),
        band_weight=band_weight, channel_perm=channel_perm,
        power_path=power_path, device=device,
    )


def _whiten(re, im, model: FftHeatmapModel):
    """SRP-PHAT: the spectra [..., F] at unit magnitude per bin, weighted by
    the model's band; unchanged without PHAT."""
    if not model.phat:
        return re, im
    mag = torch.sqrt(re * re + im * im) + 1e-12
    return re / mag * model.band_weight, im / mag * model.band_weight


def _steered_spectra(window, model: FftHeatmapModel, mm):
    """Per-direction beam spectra ``(b2_re, b2_im)``, each [..., Dy, Dx, F],
    of a window [C, S+T] or of a stack of windows [..., C, S+T] (the chunk
    axis rides every product as a batch axis).  Each complex contraction is
    one real einsum: the steering factor's re and im are stacked along the
    contracted axis and the outputs' re and im ride a doubled batch axis."""
    cx = model.ex_s.shape[-1] // 2
    cy = model.ey_s.shape[-1] // 2
    f_half = model.dft.shape[-1] // 2
    lead = window.shape[:-2]
    x_ri = mm("...ct,tf->...cf", window, model.dft)         # [..., C, 2F]
    if model.perm_matrix is not None:
        x_ri = mm("sc,...cf->...sf", model.perm_matrix, x_ri)
    x = x_ri.reshape(*lead, cy, cx, 2, f_half)
    x_re, x_im = _whiten(x[..., 0, :], x[..., 1, :], model)  # [..., Cy, Cx, F]
    x_for = torch.cat([
        torch.cat([x_re, -x_im], dim=-2),                   # -> b1_re
        torch.cat([x_im, x_re], dim=-2),                    # -> b1_im
    ], dim=-3)                                              # [..., 2Cy, 2Cx, F]
    b1 = mm("fdc,...ycf->...dyf", model.ex_s, x_for)        # [..., Dx, 2Cy, F]
    b1_re, b1_im = b1[..., :cy, :], b1[..., cy:, :]
    b1_for = torch.cat([
        torch.cat([b1_re, -b1_im], dim=-2),                 # -> b2_re
        torch.cat([b1_im, b1_re], dim=-2),                  # -> b2_im
    ], dim=-3)                                              # [..., 2Dx, 2Cy, F]
    dx = b1.shape[-3]
    b2s = mm("fdc,...xcf->...dxf", model.ey_s, b1_for)      # [..., Dy, 2Dx, F]
    b2_re, b2_im = b2s[..., :dx, :], b2s[..., dx:, :]
    if model.dead_chan is not None:
        s_ri = mm("...nt,tf->...nf", window[..., model.dead_chan, :],
                  model.dft)                                # [..., Nd, 2F]
        sr, si = _whiten(s_ri[..., :f_half], s_ri[..., f_half:], model)
        srt = sr.transpose(-1, -2)[..., None, :]            # [..., F, 1, Nd]
        sit = si.transpose(-1, -2)[..., None, :]
        xdr, xdi = model.dead_xre, model.dead_xim
        ydr, ydi = model.dead_yre, model.dead_yim
        t1_r = xdr * srt - xdi * sit                        # [..., F, Dx, Nd]
        t1_i = xdr * sit + xdi * srt
        b2_re = b2_re - (
            mm("...fxn,fyn->...yxf", t1_r, ydr)
            - mm("...fxn,fyn->...yxf", t1_i, ydi)
        )
        b2_im = b2_im - (
            mm("...fxn,fyn->...yxf", t1_r, ydi)
            + mm("...fxn,fyn->...yxf", t1_i, ydr)
        )
    return b2_re, b2_im


def _compute_dtype(model: FftHeatmapModel):
    return torch.bfloat16 if model.compute == "bfloat16" else torch.float32


def _mm_builders(model: FftHeatmapModel):
    """(mm_mid, mm_f32): einsums with inputs in the compute dtype.
    ``mm_mid`` writes its output in the compute dtype, as the JAX package's
    intermediate stages do, except under PHAT, whose whitening wants f32
    magnitudes: there it is ``mm_f32``.  ``mm_f32`` returns float32 — for
    bf16 it runs on bf16-rounded inputs cast to float32, which is a
    bf16-input, f32-accumulate, f32-output product."""
    dtype = _compute_dtype(model)

    def mm_mid(sub, a, b):
        return torch.einsum(sub, a.to(dtype), b.to(dtype))

    def mm_f32(sub, a, b):
        return torch.einsum(
            sub, a.to(dtype).to(torch.float32), b.to(dtype).to(torch.float32)
        )

    return (mm_f32 if model.phat else mm_mid), mm_f32


def _power_stage(b2_re, b2_im, model: FftHeatmapModel, mm_f32):
    """Powers [..., Dy*Dx] of the steered spectra [..., Dy, Dx, F] through
    the ``"fused"`` or ``"pallas"`` path, over all leading rows at once."""
    lead = b2_re.shape[:-3]
    d = model.rows * model.columns
    f_half = b2_re.shape[-1]
    if model.power_path == "pallas":
        dtype = _compute_dtype(model)
        # The kernel reads rows from a 16-byte aligned start; einsum may hand
        # back a permuted layout or a view into a larger product.
        def rows(x):
            x = x.reshape(-1, f_half).to(dtype).contiguous()
            return x if x.data_ptr() % 16 == 0 else x.clone()

        powers = power_matmul(rows(b2_re), rows(b2_im),
                              model.pow_ri[:f_half], model.pow_ri[f_half:])
    else:
        b2_ri = torch.cat([b2_re, b2_im], dim=-1)           # [..., Dy, Dx, 2F]
        bp = mm_f32("...yxf,ft->...yxt", b2_ri, model.pow_ri)
        powers = torch.sum(bp * bp, dim=-1)
    return powers.reshape(*lead, d)


def fft_heatmap_powers(window, model: FftHeatmapModel):
    """Heatmap powers [rows*columns] from a DAS window [C, S+T]: band-passed
    mean power over the beamformed block, normalized by T * active channels.
    The ``"fused"`` and ``"pallas"`` paths never materialize the [D, T]
    beam; ``"beam"`` does, then takes :func:`ops.delay.das_power`."""
    mm_mid, mm_f32 = _mm_builders(model)
    b2_re, b2_im = _steered_spectra(window, model, mm_mid)
    if model.power_path == "beam":
        t = model.block_size
        b2_ri = torch.cat([b2_re, b2_im], dim=-1)           # [Dy, Dx, 2F]
        beam = mm_f32("yxf,ft->yxt", b2_ri, model.idft).reshape(-1, t)
        powers = dl.das_power(beam, use_bandpass=model.use_bandpass,
                              divisor=t * model.n_active)
    else:
        powers = _power_stage(b2_re, b2_im, model, mm_f32)
    if model.src_map is not None:
        powers = powers[model.src_map]
    return powers


def fft_heatmap_powers_chunked(windows, model: FftHeatmapModel):
    """Heatmap powers [chunk, rows*columns] of stacked windows
    [chunk, C, S+T]: the steering stages with the chunk as a batch axis,
    then ONE power stage over all ``chunk * D`` direction rows (a single
    :func:`power_matmul` launch on the ``"pallas"`` path).  As in the JAX
    package, the ``"beam"`` path takes the fused power stage here."""
    mm_mid, mm_f32 = _mm_builders(model)
    b2_re, b2_im = _steered_spectra(windows, model, mm_mid)  # [ck, Dy, Dx, F]
    powers = _power_stage(b2_re, b2_im, model, mm_f32)
    if model.src_map is not None:
        powers = powers[:, model.src_map]
    return powers


def power_matmul_reference(a_re, a_im, pow_cos, pow_msin):
    """Plain twin of the power-stage kernel:
    ``powers[r] = sum_t (a_re @ pow_cos + a_im @ pow_msin)[r, t]^2`` with
    every input rounded to ``a_re``'s dtype and f32 products and sums."""
    dtype = a_re.dtype

    def f(x):
        return x.to(dtype).to(torch.float32)

    return (f(a_re) @ f(pow_cos) + f(a_im) @ f(pow_msin)).square().sum(-1)


_TILE_ROWS, _TP = 64, 256
_CTA_COLS = 128          # bf16: columns of one CTA of a 2-CTA cluster
_SMS = 132               # an H100 SXM's SMs: the bf16 grid is one CTA per SM
_MAX_SMEM = 232_448      # shared memory a block may use on Hopper


def power_matmul_plan(r: int, f: int, tp: int, dtype) -> dict:
    """Launch plan of the power-stage kernel for ``r`` rows, ``f`` bins,
    ``tp`` columns and the planes' ``dtype`` (``csrc/power_matmul.cu``
    computes the same and refuses another).  Both paths read ``[a_re |
    a_im]`` by ``[pow_cos ; pow_msin]`` as one product over ``k_pad``
    (2F zero-padded to a multiple of 16), the im plane from ``im_k0``; rows
    in tiles of ``tile_rows`` (``tiles``), each tile's span of ``span_bytes``
    per plane.

    - bf16: ``cluster`` = 2 CTAs of ``cta_cols`` columns each, persistent
      over the tiles (``grid`` CTAs of ``threads``, at most one per SM); B
      resident as bf16; a ring of ``slots`` raw slots of ``stage_rows``
      rows of both planes (``stage_bytes`` each, one bulk copy a plane)
      repacked into ``a_tiles`` A tiles; ``im_k0`` = F rounded up to 8.
    - f32: one CTA per tile and all 256 columns (``grid`` = ``tiles``),
      k-tiles of ``k_tile`` double-buffered (``stage_bytes`` each);
      ``im_k0`` = F.

    ``smem_bytes`` is the kernel's shared-memory total.  Raises
    ``ValueError`` for a shape the kernel does not take."""
    if r < 1 or f < 1:
        raise ValueError(f"power_matmul needs rows and bins, got [{r}, {f}]")
    if tp != _TP:
        raise ValueError(f"power_matmul takes Tp = {_TP} columns, got {tp}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"power_matmul takes float32 or bfloat16, got {dtype}")
    tiles = -(-r // _TILE_ROWS)
    if dtype == torch.bfloat16:
        im_k0 = -(-f // 8) * 8
        k_pad = -(-2 * im_k0 // 16) * 16
        stage_rows, slots = _TILE_ROWS // 4, 5
        plane = -(-stage_rows * f * 2 // 16) * 16
        smem = (_CTA_COLS * k_pad * 2 + 2 * _TILE_ROWS * k_pad * 2
                + slots * 2 * plane + 2 * 2 * _TILE_ROWS * 4 + (4 + 2 * slots) * 8)
        cluster = tp // _CTA_COLS
        plan = dict(cluster=cluster, cta_cols=_CTA_COLS,
                    grid=cluster * min(tiles, _SMS // cluster), threads=14 * 32,
                    a_tiles=2, stage_rows=stage_rows, slots=slots,
                    stage_bytes=2 * plane, span_bytes=_TILE_ROWS * f * 2)
    else:
        k_tile = 16
        im_k0, k_pad = f, -(-2 * f // k_tile) * k_tile
        stage = (k_tile * (_TILE_ROWS + 4) + k_tile * tp) * 4
        smem = 2 * stage + 4 * _TILE_ROWS * 4
        plan = dict(cluster=1, k_tile=k_tile, grid=tiles, threads=256,
                    stage_bytes=stage, a_tiles=2,
                    span_bytes=_TILE_ROWS * f * 4)
    if smem > _MAX_SMEM:
        raise ValueError(f"F = {f} needs {smem} bytes of shared memory")
    return dict(plan, tile_rows=_TILE_ROWS, tiles=tiles,
                k_pad=k_pad, im_k0=im_k0, smem_bytes=smem)


@functools.cache
def _library():
    from beamforming_lk_tpu_torch.ops import nvcc

    lib = ctypes.CDLL(nvcc.build("power_matmul", [_SOURCE]))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.power_matmul_launch.argtypes = [ptr] * 5 + [i32] * 4 + [ptr, ptr]
    lib.power_matmul_launch.restype = i32
    lib.power_matmul_error_string.argtypes = [i32]
    lib.power_matmul_error_string.restype = ctypes.c_char_p
    return lib


def power_matmul(a_re, a_im, pow_cos, pow_msin):
    """Powers [R] f32 of steered spectra planes ``a_re``/``a_im`` [R, F]
    (f32 or bf16) against the power matrix halves ``pow_cos``/``pow_msin``
    [F, Tp] f32, which are rounded to ``a_re``'s dtype (round to nearest
    even) as the JAX package's ``power_matmul_pallas`` does; the kernel
    rounds them as it stages them, so a call is one launch.  The [R, Tp]
    beam never reaches device memory.  Every operand is contiguous and
    starts 16-byte aligned (``a_re[1:]`` does not), on every device.  CPU
    tensors take :func:`power_matmul_reference`; ``power_matmul.launches``
    counts kernel launches."""
    device = a_re.device
    dtype = a_re.dtype
    r, f = a_re.shape
    tp = pow_cos.shape[-1]
    check_operand("a_re", a_re, device, (torch.float32, torch.bfloat16), (r, f))
    check_operand("a_im", a_im, device, (dtype,), (r, f))
    check_operand("pow_cos", pow_cos, device, (torch.float32,), (f, tp))
    check_operand("pow_msin", pow_msin, device, (torch.float32,), (f, tp))
    for name, t in (("a_re", a_re), ("a_im", a_im), ("pow_cos", pow_cos),
                    ("pow_msin", pow_msin)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned")
    plan = power_matmul_plan(r, f, tp, dtype)
    if device.type == "cpu":
        return power_matmul_reference(a_re, a_im, pow_cos, pow_msin)
    require_cuda("power_matmul", device)
    out = torch.empty((r,), dtype=torch.float32, device=device)
    lib = _library()
    err = lib.power_matmul_launch(
        a_re.data_ptr(), a_im.data_ptr(), pow_cos.data_ptr(), pow_msin.data_ptr(),
        out.data_ptr(), r, f, tp, int(dtype == torch.bfloat16),
        (ctypes.c_int * 6)(plan["grid"], plan["threads"], plan["cluster"],
                           plan["tile_rows"], plan["k_pad"], plan["smem_bytes"]),
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            "power_matmul kernel launch failed: "
            + lib.power_matmul_error_string(err).decode()
        )
    power_matmul.launches += 1
    return out


power_matmul.launches = 0
