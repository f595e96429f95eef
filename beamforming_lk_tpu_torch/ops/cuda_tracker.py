"""The whole per-block swarm update as CUDA kernels, with their plain twins.

Counterparts of ``beamforming_lk_tpu.ops.pallas_tracker.swarm_chain_pallas``
(one block: ``n_iter`` iterations of [``n_sub`` chained 4-probe monopulse
sub-steps + merge + seeker jump + promote], then the publish prune and the
MISO audio beam at the refined listener direction) and ``swarm_chunk_pallas``
(K consecutive blocks of that update in one launch, with the seeker resets
of a reset table and the published targets carried block to block), and
of ``monopulse_chain_pallas`` (``n_sub`` chained sub-steps with a per-sub-step
row mask and no boundary: the unfused tracker and MISO steps run one launch
per iteration).  The CUDA source of all three is
``beamforming_lk_tpu_torch/csrc/swarm_chain.cu``.

Operand layout of one block (shared by the kernels and the twins; the
chunk forms stack the per-block operands on a leading axis of K):

- ``xyz``        [4, C] f32: x, y, z times samples-per-metre, channel mask
- ``window_bp``  [C, span+T-2] compact probe window with the 3-tap bandpass
                 applied, f32 or bf16 (the probe compute dtype)
- ``window_raw`` [C, span+T] f32 compact raw window (the MISO beam)
- ``rows``       [16, P] f32 per-particle rows, named by :data:`ROW_FIELDS`;
                 particle rows are laid out trackers | miso | seekers
- ``jumps``      [2, n_iter, P] f32 seeker jump offsets (theta, phi)
- ``reference``  [] f32 the prune floor (channel-0 bandpass power)
- ``stamp``      [] f32 the block's index (:func:`block_stamp`), the start
                 of a tracker promoted in the block (single block only; the
                 chunk forms take block 0's index on the host)
- ``resets``     [K, 3, P] f32 (chunk only): flag, theta, phi of the seeker
                 reset before block k (seeker rows take theta, phi when the
                 flag is set)

The probe beam of row r, probe q is gathered straight from the compact
window, ``beam[t] = sum_c sum_j w_j(r,q,c) * bp[c, shift(r,q,c) + j + t]``:
the same numbers as the TPU kernel's dense one-hot stencil against its
s-major window (row ``s*C + c`` of which is ``bp[c, s + t]``).

:func:`swarm_chain`, :func:`swarm_chunk` and :func:`monopulse_chain`
dispatch on the device of their tensors: CPU tensors take the twin, CUDA
tensors launch the kernel (or the call raises), any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os

import numpy as np
import torch

from beamforming_lk_tpu_torch.device import resolve_device
from beamforming_lk_tpu_torch.ops import delay as dl
from beamforming_lk_tpu_torch.ops.geometry import PI_HALF

#: Rows of the packed per-particle operand; the first :data:`STATE_ROWS`
#: come back updated.
ROW_FIELDS = (
    "theta", "phi", "grad_theta", "grad_phi", "radius", "error",
    "tracking", "start", "rate", "spread", "is_tracker", "is_seeker",
    "is_miso", "target_theta", "target_phi", "target_valid",
)
STATE_ROWS = 8
#: Particle fields the monopulse chain updates (theta .. error).
CHAIN_STATE = 6

_QUADRANT_DEG = (45.0, 315.0, 225.0, 135.0)
_NEARBY_DEG = (0.0, 90.0, 180.0, 270.0)
_EPS = 1e-9
_TWO_PI = 2.0 * math.pi
_MAX_TAPS = 16
#: Shared memory a thread block can use on an H100 (227 KB).
MAX_SMEM = 232448
#: The monopulse-chain kernel's threads per CTA and samples per warp segment.
CHAIN_THREADS = 512
CHAIN_SEGMENT = 64
_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "csrc", "swarm_chain.cu",
)


def block_stamp(block_index, like: torch.Tensor) -> torch.Tensor:
    """The promote stamp of a block: its host index as an f32 scalar on
    ``like``'s device (``float(block_index)`` rounded to f32); a tensor is
    the stamp already."""
    if isinstance(block_index, torch.Tensor):
        return block_index
    return torch.full((), float(block_index), dtype=torch.float32,
                      device=like.device)


def pack_geometry(points, samples_per_meter, channel_mask=None, device="cuda"):
    """[4, C] f32 geometry operand on ``device`` (the card unless it names
    the CPU): rows x, y, z times samples-per-metre and the channel validity
    mask."""
    pts = np.asarray(points, np.float64) * float(samples_per_meter)
    mask = (
        np.ones(pts.shape[1], np.float64)
        if channel_mask is None
        else np.asarray(channel_mask, np.float64)
    )
    return torch.as_tensor(
        np.vstack([pts, mask[None]]), dtype=torch.float32,
        device=resolve_device(device),
    )


def bandpass_window(pw):
    """Compact probe window [..., C, W] -> its 3-tap bandpass [..., C, W-2]
    (``ops.delay.bandpass_ma`` along time).  The bandpass commutes with the
    shift stencil, so the probe beams come out band-passed."""
    return 0.5 * pw[..., 1:-1] - 0.25 * (pw[..., 2:] + pw[..., :-2])


def _consts(probe_layout, taps, theta_limit):
    """Host constants the kernel and the twin share, rounded to f32 once:
    the probe ring's unit (cos, sin) per azimuth, the Blackman window, and
    sin/cos of the theta limit."""
    deg = _QUADRANT_DEG if probe_layout == "quadrant" else _NEARBY_DEG
    base = np.deg2rad(np.asarray(deg, np.float64))
    f32 = lambda v: [float(x) for x in np.asarray(v, np.float32)]  # noqa: E731
    return {
        "cos_b": f32(np.cos(base)),
        "sin_b": f32(np.sin(base)),
        "blackman": f32(np.blackman(taps)),
        "sin_tl": f32([np.sin(theta_limit)])[0],
        "cos_tl": f32([np.cos(theta_limit)])[0],
    }


def _probe_dirs(theta, phi, spread, k):
    """Unit steering components (ux, uy, uz), each [4, P], of the 4 probes
    around every row: the probe ring at inclination ``spread`` rotated by
    Rz(phi) Ry(rt), with the FoV-edge back-off, and pulled to the theta
    limit at the same azimuth in Cartesian form (no inverse trig)."""
    near = theta + spread > PI_HALF
    rt = torch.where(near, theta - spread, theta)
    c_t, s_t = torch.cos(rt), torch.sin(rt)
    c_p, s_p = torch.cos(phi), torch.sin(phi)
    sin_sp, cos_sp = torch.sin(spread), torch.cos(spread)
    us = []
    for cb, sb in zip(k["cos_b"], k["sin_b"]):
        bx = sin_sp * cb
        by = sin_sp * sb
        vx = c_t * bx + s_t * cos_sp
        vz = -s_t * bx + c_t * cos_sp
        wx = c_p * vx - s_p * by
        wy = s_p * vx + c_p * by
        clipped = vz < k["cos_tl"]
        r = torch.clamp(torch.sqrt(wx * wx + wy * wy), min=1e-12)
        ux = torch.where(clipped, k["sin_tl"] * wx / r, wx)
        uy = -torch.where(clipped, k["sin_tl"] * wy / r, wy)
        uz = torch.where(clipped, torch.full_like(vz, k["cos_tl"]), vz)
        us.append((ux, uy, uz))
    return tuple(torch.stack([u[i] for u in us]) for i in range(3))


def _stencil(ux, uy, uz, xyz, span, taps, interp, fir_phases, blackman):
    """Directions [R] -> (shift [R, C] long, weights [R, C, taps] f32): the
    min-subtracted delays split at ``shift = (span - taps) - floor(tau)``,
    weighted ``[frac, 1-frac]`` (linear) or by the closed-form windowed-sinc
    row at the quantized fraction (FIR), times the channel mask.  The min
    runs over all channels, masked ones included."""
    px, py, pz, mask = xyz[0], xyz[1], xyz[2], xyz[3]
    tau = ux[:, None] * px + uy[:, None] * py + uz[:, None] * pz
    tau = torch.clamp(
        tau - tau.amin(dim=1, keepdim=True), 0.0, float(span - taps)
    )
    whole = torch.floor(tau)
    frac = tau - whole
    shift = (span - taps) - whole.to(torch.long)
    if interp == "linear":
        w = torch.stack([frac, 1.0 - frac], dim=-1)
    else:
        fq = torch.round(frac * (fir_phases - 1)) / float(fir_phases - 1)
        d = dl.FIR_DEFAULT_CENTER - fq
        sin_pd = torch.sin(math.pi * d)     # sin(pi(t - d)) = -(-1)^t sin(pi d)
        hs = []
        for t in range(taps):
            x = math.pi * (float(t) - d)
            sign = 1.0 if t % 2 == 1 else -1.0
            near = torch.abs(x) < 1e-4
            s = torch.where(
                near, 1.0 - x * x * (1.0 / 6.0),
                sign * sin_pd / torch.where(near, 1.0, x),
            )
            hs.append(s * blackman[t])
        hsum = hs[0]
        for h in hs[1:]:
            hsum = hsum + h
        w = torch.stack([h / hsum for h in hs], dim=-1)
    return shift, w * mask[None, :, None]


def _gather_beams(win, shift, w, n_out):
    """beam[r, t] = sum_c sum_j w[r, c, j] * win[c, shift[r, c] + j + t]
    for t < n_out, in f32."""
    unf = win.unfold(1, n_out, 1)                       # [C, W-n_out+1, n_out]
    cidx = torch.arange(win.shape[0], device=win.device)
    beam = torch.zeros(
        (shift.shape[0], n_out), dtype=torch.float32, device=win.device
    )
    for j in range(w.shape[-1]):
        g = unf[cidx, shift + j].to(torch.float32)      # [R, C, n_out]
        beam = beam + (w[..., j, None] * g).sum(dim=1)
    return beam


def _substep(active, state, rate, spread, xyz, window_bp, k, *, span, taps,
             interp, fir_phases, inv_div, quadrant, theta_limit, beams=None):
    """One 4-probe monopulse sub-step of every row, in the kernels' f32
    arithmetic (probe weights rounded to the window's dtype before the
    product, as the TPU kernels' ``w.astype(win.dtype)``), with inactive
    rows masked back: ``state`` is (theta, phi, grad_theta, grad_phi,
    radius, error), each [P]; returns the new state.  ``beams(shift, w)``
    replaces the gather of the probe beams [4P, T-2] from ``window_bp``."""
    theta, phi, gt, gp, rad, err = state
    p = theta.shape[0]
    ux, uy, uz = _probe_dirs(theta, phi, spread, k)              # [4, P]
    shift, w = _stencil(
        ux.reshape(-1), uy.reshape(-1), uz.reshape(-1), xyz, span, taps,
        interp, fir_phases, k["blackman"],
    )
    w = w.to(window_bp.dtype).to(torch.float32)
    if beams is None:
        beam = _gather_beams(window_bp, shift, w, window_bp.shape[1] - span)
    else:
        beam = beams(shift, w)
    q1, q2, q3, q4 = ((beam * beam).sum(dim=1) * inv_div).reshape(4, p)
    total = torch.clamp(q1 + q2 + q3 + q4, min=1e-30)
    if quadrant:
        g_t = ((q1 + q2) - (q3 + q4)) / total
        g_p = ((q1 + q4) - (q2 + q3)) / total
    else:
        g_t = (q1 - q3) / torch.clamp(torch.maximum(q1, q3), min=1e-30)
        g_p = (q2 - q4) / torch.clamp(torch.maximum(q2, q4), min=1e-30)
    e = torch.abs(g_t) + torch.abs(g_p)
    r = total * 0.25
    near = theta + spread > PI_HALF
    adj = torch.where(near, theta - spread / 2.0, theta)
    new_t = adj + rate * g_t
    new_p = phi + (rate * g_p) / torch.sin(_EPS + new_t)
    new_t = torch.clamp(new_t, 0.0, theta_limit)
    new_p = new_p - torch.floor(new_p / _TWO_PI) * _TWO_PI
    sel = lambda a, b: torch.where(active, a, b)  # noqa: E731
    return (sel(new_t, theta), sel(new_p, phi), sel(g_t, gt),
            sel(g_p, gp), sel(r, rad), sel(e, err))


def monopulse_chain_reference(
    xyz, window_bp, rows, active, *, span, taps=dl.LINEAR_TAPS, theta_limit,
    divisor, probe_layout="quadrant", interp="linear", fir_phases=101,
):
    """Plain PyTorch twin of the monopulse-chain kernel: ``active.shape[0]``
    chained sub-steps of :func:`_substep` over ``rows`` [8, P] (theta, phi,
    grad_theta, grad_phi, radius, error, rate, spread), row r stepping in
    sub-step j where ``active[j, r] > 0``.  Returns the six state rows
    [6, P] after the chain."""
    k = _consts(probe_layout, taps, theta_limit)
    state = tuple(rows[:CHAIN_STATE].unbind(0))
    for act in active:
        state = _substep(
            act > 0.0, state, rows[6], rows[7], xyz, window_bp, k, span=span,
            taps=taps, interp=interp, fir_phases=fir_phases,
            inv_div=1.0 / float(divisor),
            quadrant=probe_layout == "quadrant", theta_limit=theta_limit,
        )
    return torch.stack(state)


def swarm_chain_reference(
    xyz, window_bp, window_raw, rows, jumps, reference, *,
    block_index, n_iter, n_sub, refine, n_trackers, span,
    taps=dl.LINEAR_TAPS, theta_limit, divisor, closeness, error_threshold,
    probe_layout="quadrant", interp="linear", fir_phases=101,
    min_power_fraction=0.0, active_counts=None,
):
    """Plain PyTorch twin of the swarm-chain kernel, same operands and same
    f32 arithmetic (:func:`_substep`).  Every row is computed and inactive
    rows are masked back, which gives the same values as the kernel's
    active-rows-only schedule; a list ``active_counts`` receives each
    sub-step's number of active rows (the rows the kernel computes).

    Returns ``(state [8, P], mean [], beam [T])``: the updated first
    :data:`STATE_ROWS` rows (tracking post-prune), the mean valid-seeker
    power and the MISO audio beam."""
    k = _consts(probe_layout, taps, theta_limit)
    p = rows.shape[1]
    t_len = window_raw.shape[1] - span
    cos_cl = float(np.cos(closeness))
    theta, phi, gt, gp, rad, err, tracking, start = rows[:STATE_ROWS].unbind(0)
    rate, spread = rows[8], rows[9]
    is_tracker, is_seeker, is_miso = rows[10] > 0.5, rows[11] > 0.5, rows[12] > 0.5
    tgt_th, tgt_ph, tgt_va = rows[13], rows[14], rows[15]
    row_idx = torch.arange(p, device=rows.device)
    nt = n_trackers
    stamp = block_stamp(block_index, rows)
    mean = torch.zeros((), dtype=torch.float32, device=rows.device)
    sub_kw = dict(span=span, taps=taps, interp=interp, fir_phases=fir_phases,
                  inv_div=1.0 / float(divisor),
                  quadrant=probe_layout == "quadrant", theta_limit=theta_limit)

    def pick(mask, v):
        return torch.where(mask, v, torch.zeros_like(v)).sum()

    for it in range(n_iter):
        trk_b = tracking > 0.5
        for j in range(n_sub):
            active = (is_tracker & trk_b) | (is_seeker & (j == 0))
            if it * n_sub + j < refine:
                active = active | is_miso
            if active_counts is not None:
                active_counts.append(int(active.sum()))
            theta, phi, gt, gp, rad, err = _substep(
                active, (theta, phi, gt, gp, rad, err), rate, spread, xyz,
                window_bp, k, **sub_kw,
            )
        n_tracking = trk_b.sum().to(torch.float32)

        # Merge close trackers (oldest / lowest index survives) and flag
        # seekers inside a previously published target's capture zone.
        cos_t, sin_t = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
        th_n, ph_n, st_n = theta[None, :nt], phi[None, :nt], start[None, :nt]
        cos_ang = cos_t * torch.cos(th_n) + sin_t * torch.sin(th_n) * torch.cos(
            phi[:, None] - ph_n
        )
        close = (
            (cos_ang > cos_cl) & trk_b[:, None] & (tracking[None, :nt] > 0.5)
            & (row_idx[:, None] != row_idx[None, :nt]) & is_tracker[:, None]
        )
        older = (start[:, None] > st_n) | (
            (start[:, None] == st_n) & (row_idx[:, None] > row_idx[None, :nt])
        )
        t_th, t_ph = tgt_th[None, :nt], tgt_ph[None, :nt]
        cos_tg = cos_t * torch.cos(t_th) + sin_t * torch.sin(t_th) * torch.cos(
            phi[:, None] - t_ph
        )
        near_t = (cos_tg > cos_cl) & (tgt_va[None, :nt] > 0.5)
        tracking = torch.where((close & older).any(dim=1), 0.0, tracking)
        too_close = near_t.any(dim=1) & is_seeker

        # Jump seekers out of capture zones (pre-drawn offsets).
        j_theta = torch.clamp(theta + jumps[0, it], 0.0, theta_limit)
        j_phi = phi + jumps[1, it]
        j_phi = j_phi - torch.floor(j_phi / _TWO_PI) * _TWO_PI
        theta = torch.where(too_close, j_theta, theta)
        phi = torch.where(too_close, j_phi, phi)

        # Promote the best converged seeker (first index of the max) to
        # every free tracker.
        valid = is_seeker & ~too_close
        converged = valid & (err < error_threshold)
        pm = torch.where(converged, rad, torch.full_like(rad, -3.0e38))
        is_best = converged & (pm >= pm.max())
        idx_best = torch.where(
            is_best, row_idx, torch.full_like(row_idx, 2 ** 30)
        ).min()
        oh = row_idx == idx_best
        better = (converged & (rad > 0.0)).any()
        promote = better & (n_tracking < float(nt)) & ~(tracking > 0.5) & is_tracker
        theta = torch.where(promote, pick(oh, theta), theta)
        phi = torch.where(promote, pick(oh, phi), phi)
        start = torch.where(promote, stamp, start)
        tracking = torch.where(promote, 1.0, tracking)

        n_valid = torch.clamp(valid.sum().to(torch.float32), min=1.0)
        mean = torch.where(valid, rad, torch.zeros_like(rad)).sum() / n_valid

    # Publish: prune weak / diverged trackers, then the sidelobe gate.
    weak = (rad < mean) | (rad < reference) | (err > error_threshold)
    tracking = torch.where(weak, 0.0, tracking)
    if min_power_fraction > 0.0:
        strongest = torch.where(
            tracking > 0.5, rad, torch.zeros_like(rad)
        ).max()
        tracking = torch.where(
            rad >= min_power_fraction * strongest, tracking, 0.0
        )

    # MISO audio beam at the listener row's final direction, in f32.
    th_m, ph_m = pick(is_miso, theta), pick(is_miso, phi)
    st_m, ct_m = torch.sin(th_m), torch.cos(th_m)
    shift, w = _stencil(
        (st_m * torch.cos(ph_m)).reshape(1), (-st_m * torch.sin(ph_m)).reshape(1),
        ct_m.reshape(1), xyz, span, taps, interp, fir_phases, k["blackman"],
    )
    beam = _gather_beams(window_raw, shift, w, t_len)[0]
    state = torch.stack([theta, phi, gt, gp, rad, err, tracking, start])
    return state, mean, beam


def carry_rows(rows, state):
    """The rows entering the next block of a chunk: a block's ``state``
    [8, P], the constant rows of ``rows``, and the block's published
    trackers (theta, phi, tracking) as target rows, zero on other rows."""
    is_tracker = rows[10] > 0.5
    zero = torch.zeros_like(state[0])
    return torch.cat([state, rows[STATE_ROWS:13], torch.stack([
        torch.where(is_tracker, state[0], zero),
        torch.where(is_tracker, state[1], zero),
        state[6],
    ])])


def swarm_chunk_reference(
    xyz, windows_bp, windows_raw, rows, jumps, resets, references, *,
    block_index0, chain=None, **kw,
):
    """Plain twin of the chunk kernel: K calls of
    :func:`swarm_chain_reference`.  Before block k the seeker rows take the
    reset directions where ``resets[k, 0]`` is set; after it the published
    trackers (theta, phi, tracking) become block k+1's target rows, zero on
    the other rows.  ``kw`` are :func:`swarm_chain_reference`'s keywords;
    ``chain`` replaces it as the per-block update (``swarm_chain`` holds the
    chunk kernel against K single-block launches on the card).

    Returns ``(state [K, 8, P], mean [K], beams [K, T])``."""
    chain = chain or swarm_chain_reference
    is_seeker = rows[11] > 0.5
    states, means, beams = [], [], []
    for k in range(windows_bp.shape[0]):
        reset = (resets[k, 0] > 0.5) & is_seeker
        rows = torch.cat([
            torch.stack([torch.where(reset, resets[k, 1], rows[0]),
                         torch.where(reset, resets[k, 2], rows[1])]),
            rows[2:],
        ])
        state, mean, beam = chain(
            xyz, windows_bp[k], windows_raw[k], rows, jumps[k], references[k],
            block_index=block_index0 + k, **kw,
        )
        rows = carry_rows(rows, state)
        states.append(state)
        means.append(mean)
        beams.append(beam)
    return torch.stack(states), torch.stack(means), torch.stack(beams)


@functools.cache
def _library():
    from beamforming_lk_tpu_torch.ops import nvcc

    return load_library(nvcc.build("swarm_chain", [_SOURCE]))


def load_library(path):
    """The built swarm-chain library at ``path``, its entry points typed."""
    lib = ctypes.CDLL(path)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.swarm_chain_launch.argtypes = [ptr, ptr, i32] + [ptr] * 12
    lib.swarm_chunk_launch.argtypes = (
        [ptr, ptr, i32] + [ptr] * 8 + [i32, i64] + [ptr] * 4
    )
    lib.monopulse_chain_launch.argtypes = [ptr, ptr, i32] + [ptr] * 8
    lib.swarm_chain_launch.restype = i32
    lib.swarm_chunk_launch.restype = i32
    lib.monopulse_chain_launch.restype = i32
    lib.swarm_chain_error_string.argtypes = [i32]
    lib.swarm_chain_error_string.restype = ctypes.c_char_p
    lib.swarm_cluster_size.argtypes = []
    lib.swarm_cluster_size.restype = i32
    return lib


def cluster_size() -> int:
    """The CTAs of the thread block cluster that every :func:`swarm_chain`
    and :func:`swarm_chunk` launch runs on the current card (16 where the
    card can schedule it, else 8); raises when neither can run."""
    n = _library().swarm_cluster_size()
    if n <= 0:
        _raise_on("swarm cluster", -n)
    return n


def check_operand(name, t, device, dtypes, shape):
    """Raise unless ``t`` is a contiguous tensor of ``shape`` on ``device``
    with one of ``dtypes`` (what a kernel wrapper checks before a launch)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda(entry, device):
    """Raise for a device that is neither the CPU (twin) nor CUDA (kernel)."""
    if device.type != "cuda":
        raise RuntimeError(
            f"{entry} runs on CUDA (kernel) or CPU (twin), not {device}"
        )


def _check_operands(xyz, window_bp, window_raw, rows, jumps, reference,
                    resets, *, n_iter, n_trackers, span, taps, interp,
                    stamp=None, **_):
    """Raise unless the operands fit the kernel (``resets`` is None for the
    single-block kernel, whose operands have no block axis and whose
    ``stamp`` is a tensor).  Run on every device, so the CPU twin's callers
    are held to the kernel's layout."""
    chunk = resets is not None
    lead = tuple(window_bp.shape[:1]) if chunk else ()
    device = rows.device
    c, p = xyz.shape[1], rows.shape[1]
    t_len = window_raw.shape[-1] - span
    if taps > _MAX_TAPS or interp not in ("linear", "fir"):
        raise ValueError(f"unsupported stencil: interp={interp} taps={taps}")
    if t_len < 3:
        raise ValueError(f"window_raw has {window_raw.shape[-1]} columns; need span + T")
    if chunk and lead[0] < 1:
        raise ValueError("a chunk needs at least one block")
    f32 = (torch.float32,)
    check_operand("xyz", xyz, device, f32, (4, c))
    check_operand("window_bp", window_bp, device,
                  (torch.float32, torch.bfloat16), lead + (c, span + t_len - 2))
    check_operand("window_raw", window_raw, device, f32, lead + (c, span + t_len))
    check_operand("rows", rows, device, f32, (len(ROW_FIELDS), p))
    check_operand("jumps", jumps, device, f32, lead + (2, n_iter, p))
    check_operand("reference", reference, device, f32, lead)
    if chunk:
        check_operand("resets", resets, device, f32, lead + (3, p))
    else:
        check_operand("stamp", stamp, device, f32, ())
    if not 0 < n_trackers <= p:
        raise ValueError(f"n_trackers={n_trackers} outside (0, {p}]")


def _launch(entry, xyz, window_bp, window_raw, rows, jumps, reference,
            resets, *, block_index, n_iter, n_sub, refine, n_trackers, span,
            taps, theta_limit, divisor, closeness, error_threshold,
            probe_layout, interp, fir_phases, min_power_fraction):
    """Allocate the outputs of one launch of checked operands and launch on
    the current stream (``block_index``: the chunk's host index of block 0,
    or the single block's stamp tensor)."""
    lead = tuple(window_bp.shape[:1]) if resets is not None else ()
    device = rows.device
    p = rows.shape[1]
    t_len = window_raw.shape[-1] - span
    state = torch.empty(lead + (STATE_ROWS, p), dtype=torch.float32, device=device)
    mean = torch.empty(lead, dtype=torch.float32, device=device)
    beam = torch.empty(lead + (t_len,), dtype=torch.float32, device=device)
    lib = _library()
    head = (xyz.data_ptr(), window_bp.data_ptr(),
            int(window_bp.dtype == torch.bfloat16), window_raw.data_ptr(),
            rows.data_ptr(), jumps.data_ptr())
    outs = (state.data_ptr(), mean.data_ptr(), beam.data_ptr())
    tail = _host_tail(
        device, xyz.shape[1], p, t_len, span, taps, n_iter, n_sub, refine,
        n_trackers, probe_layout, interp, fir_phases, theta_limit, divisor,
        closeness, error_threshold, min_power_fraction,
    )
    if resets is not None:
        err = lib.swarm_chunk_launch(
            *head, resets.data_ptr(), reference.data_ptr(), *outs, lead[0],
            int(block_index), *tail,
        )
    else:
        err = lib.swarm_chain_launch(
            *head, reference.data_ptr(), block_index.data_ptr(), *outs, *tail,
        )
    _raise_on(entry, err)
    return state, mean, beam


def _host_tail(device, c, p, t_len, span, taps, n_iter, n_sub, refine,
               n_trackers, probe_layout, interp, fir_phases, theta_limit,
               divisor, closeness, error_threshold, min_power_fraction):
    """The trailing launch arguments every entry point shares: the host
    arrays ``dims``, ``scalars`` and ``host_consts`` (see the CUDA source)
    and the current stream."""
    k = _consts(probe_layout, taps, theta_limit)
    dims = (ctypes.c_int * 12)(
        c, p, t_len, span, taps, n_iter, n_sub, refine, n_trackers,
        int(probe_layout == "quadrant"), int(interp == "fir"), fir_phases,
    )
    scalars = (ctypes.c_float * 7)(
        float(theta_limit), k["sin_tl"], k["cos_tl"], 1.0 / float(divisor),
        float(np.cos(closeness)), float(error_threshold),
        float(min_power_fraction),
    )
    host = (ctypes.c_float * 24)(
        *(k["cos_b"] + k["sin_b"] + k["blackman"]
          + [0.0] * (_MAX_TAPS - taps))
    )
    # ctypes keeps the arrays alive for the call through these references.
    return (dims, scalars, host, torch.cuda.current_stream(device).cuda_stream)


def _raise_on(entry, err):
    if err:
        raise RuntimeError(
            f"{entry} kernel launch failed: "
            + _library().swarm_chain_error_string(err).decode()
        )


def swarm_chain(
    xyz, window_bp, window_raw, rows, jumps, reference, *,
    block_index, n_iter, n_sub, refine, n_trackers, span,
    taps=dl.LINEAR_TAPS, theta_limit, divisor, closeness, error_threshold,
    probe_layout="quadrant", interp="linear", fir_phases=101,
    min_power_fraction=0.0,
):
    """The per-block swarm update (see the module docstring for operands;
    ``block_index`` the host index or its :func:`block_stamp`, which the
    kernel reads on the card, so that a CUDA graph of the launch takes it
    as an operand).  Returns ``(state [8, P], mean [], beam [T])``;
    ``swarm_chain.launches`` counts kernel launches."""
    stamp = block_stamp(block_index, rows)
    kw = dict(
        n_iter=n_iter, n_sub=n_sub, refine=refine,
        n_trackers=n_trackers, span=span, taps=taps, theta_limit=theta_limit,
        divisor=divisor, closeness=closeness, error_threshold=error_threshold,
        probe_layout=probe_layout, interp=interp, fir_phases=fir_phases,
        min_power_fraction=min_power_fraction,
    )
    _check_operands(xyz, window_bp, window_raw, rows, jumps, reference, None,
                    stamp=stamp, **kw)
    if rows.device.type == "cpu":
        return swarm_chain_reference(
            xyz, window_bp, window_raw, rows, jumps, reference,
            block_index=stamp, **kw,
        )
    require_cuda("swarm_chain", rows.device)
    out = _launch("swarm_chain", xyz, window_bp, window_raw, rows, jumps,
                  reference, None, block_index=stamp, **kw)
    swarm_chain.launches += 1
    return out


swarm_chain.launches = 0


def swarm_chunk(
    xyz, windows_bp, windows_raw, rows, jumps, resets, references, *,
    block_index0, n_iter, n_sub, refine, n_trackers, span,
    taps=dl.LINEAR_TAPS, theta_limit, divisor, closeness, error_threshold,
    probe_layout="quadrant", interp="linear", fir_phases=101,
    min_power_fraction=0.0,
):
    """K consecutive blocks of the swarm update in one launch: the operands
    of :func:`swarm_chain` stacked on a leading block axis, plus ``resets``
    [K, 3, P]; ``rows`` is the state entering block 0.  Block k's outputs
    equal k+1 calls of :func:`swarm_chain` with the same per-block operands.
    Returns ``(state [K, 8, P], mean [K], beams [K, T])``;
    ``swarm_chunk.launches`` counts kernel launches."""
    kw = dict(
        n_iter=n_iter, n_sub=n_sub, refine=refine,
        n_trackers=n_trackers, span=span, taps=taps, theta_limit=theta_limit,
        divisor=divisor, closeness=closeness, error_threshold=error_threshold,
        probe_layout=probe_layout, interp=interp, fir_phases=fir_phases,
        min_power_fraction=min_power_fraction,
    )
    _check_operands(xyz, windows_bp, windows_raw, rows, jumps, references,
                    resets, **kw)
    if rows.device.type == "cpu":
        return swarm_chunk_reference(
            xyz, windows_bp, windows_raw, rows, jumps, resets, references,
            block_index0=block_index0, **kw,
        )
    require_cuda("swarm_chunk", rows.device)
    out = _launch("swarm_chunk", xyz, windows_bp, windows_raw, rows, jumps,
                  references, resets, block_index=block_index0, **kw)
    swarm_chunk.launches += 1
    return out


swarm_chunk.launches = 0


def _align16(n: int) -> int:
    return (n + 15) // 16 * 16


def monopulse_chain_plan(c: int, p: int, t_len: int, span: int, taps: int,
                         elem: int) -> dict:
    """Launch plan of the monopulse-chain kernel for ``p`` rows of ``c``
    channels, a block of ``t_len`` samples (``t_len - 2`` beam samples), a
    probe ``span`` and ``taps``, on a window of ``elem``-byte values: one
    CTA per row (``grid``) of ``threads`` threads, ``warps_per_probe``
    warps on each of the 4 probes, each warp owning segments of
    ``segment`` samples; the window staged in each CTA's shared memory
    (``staged``, ``window_bytes``) where it fits beside the scratch, else
    read from L2.  ``smem_bytes`` is the kernel's ``make_chain_layout``
    total, which the launch checks."""
    n_out = t_len - 2
    window = _align16(c * (span + n_out) * elem)
    scratch = (_align16(4 * c * taps * 4) + _align16(4 * c * 4)
               + _align16(4 * n_out * 4) + _align16((CHAIN_STATE + 2 + 4) * 4))
    if scratch > MAX_SMEM:
        raise ValueError(f"the chain's scratch ({scratch} bytes) exceeds "
                         f"{MAX_SMEM} bytes of shared memory")
    staged = window + scratch <= MAX_SMEM
    return {
        "grid": p, "threads": CHAIN_THREADS,
        "warps_per_probe": CHAIN_THREADS // 32 // 4, "segment": CHAIN_SEGMENT,
        "staged": staged, "window_bytes": window,
        "smem_bytes": scratch + (window if staged else 0),
    }


def monopulse_chain(
    xyz, window_bp, rows, active, *, span, taps=dl.LINEAR_TAPS, theta_limit,
    divisor, probe_layout="quadrant", interp="linear", fir_phases=101,
):
    """``n_sub = active.shape[0]`` chained monopulse sub-steps in one launch
    (the JAX package's ``monopulse_chain_pallas``): ``xyz`` [4, C],
    ``window_bp`` [C, span+T-2] (f32 or bf16), ``rows`` [8, P] f32 (theta,
    phi, grad_theta, grad_phi, radius, error, rate, spread), ``active``
    [n_sub, P] f32 (row r steps in sub-step j where ``active[j, r] > 0``;
    a row never active keeps its values).  Returns the six state rows
    [6, P]; ``monopulse_chain.launches`` counts kernel launches."""
    device = rows.device
    c, p = xyz.shape[1], rows.shape[1]
    n_sub = active.shape[0]
    if taps > _MAX_TAPS or interp not in ("linear", "fir"):
        raise ValueError(f"unsupported stencil: interp={interp} taps={taps}")
    if window_bp.shape[-1] - span < 1 or n_sub < 1:
        raise ValueError(f"window_bp has {window_bp.shape[-1]} columns for a "
                         f"span of {span}; {n_sub} sub-steps")
    f32 = (torch.float32,)
    check_operand("xyz", xyz, device, f32, (4, c))
    check_operand("window_bp", window_bp, device,
                  (torch.float32, torch.bfloat16), (c, window_bp.shape[-1]))
    check_operand("rows", rows, device, f32, (CHAIN_STATE + 2, p))
    check_operand("active", active, device, f32, (n_sub, p))
    kw = dict(span=span, taps=taps, theta_limit=theta_limit, divisor=divisor,
              probe_layout=probe_layout, interp=interp, fir_phases=fir_phases)
    if device.type == "cpu":
        return monopulse_chain_reference(xyz, window_bp, rows, active, **kw)
    require_cuda("monopulse_chain", device)
    out = torch.empty((CHAIN_STATE, p), dtype=torch.float32, device=device)
    t_len = window_bp.shape[-1] - span + 2
    plan = monopulse_chain_plan(c, p, t_len, span, taps, window_bp.element_size())
    err = _library().monopulse_chain_launch(
        xyz.data_ptr(), window_bp.data_ptr(),
        int(window_bp.dtype == torch.bfloat16), rows.data_ptr(),
        active.data_ptr(), out.data_ptr(),
        (ctypes.c_int * 4)(plan["grid"], plan["threads"], int(plan["staged"]),
                           plan["smem_bytes"]),
        *_host_tail(device, c, p, t_len, span, taps, 1, n_sub, 0, 0,
                    probe_layout, interp, fir_phases, theta_limit, divisor,
                    0.0, 0.0, 0.0),
    )
    _raise_on("monopulse_chain", err)
    monopulse_chain.launches += 1
    return out


monopulse_chain.launches = 0


def monopulse_chain_sharded(
    xyz, window_bp, rows, active, *, channels: slice, reduce, compute,
    span, taps=dl.LINEAR_TAPS, theta_limit, divisor, probe_layout="quadrant",
    interp="linear", fir_phases=101,
):
    """:func:`monopulse_chain` with the array's channels sharded over ranks
    (the JAX package's XLA chain under a ``ch`` mesh axis): each sub-step
    needs the full array's probe beams before it squares them, so the chain
    runs one sub-step at a time.  Per sub-step: the probe stencil from the
    full geometry ``xyz`` [4, C] (its min over all channels, as the JAX
    package's ``pmin``), this rank's ``channels`` of it through the
    DAS-beam kernel (:func:`ops.cuda_das.das_beam`, K4; its twin on the
    CPU) on this rank's window ``window_bp`` [C_loc, span+T-2] (f32; with
    ``compute="bfloat16"`` the kernel rounds the window and the weights),
    ``reduce`` (the all-reduce over ``ch``) of the partial beams [4P, T-2],
    then :func:`_substep`'s powers and update.  Returns the six state rows
    [6, P]."""
    from beamforming_lk_tpu_torch.ops.cuda_das import das_beam

    def beams(shift, w):
        part = das_beam(window_bp, shift[:, channels].to(torch.int32).contiguous(),
                        w[:, channels].contiguous(), span=span, compute=compute)
        return reduce(part)

    k = _consts(probe_layout, taps, theta_limit)
    state = tuple(rows[:CHAIN_STATE].unbind(0))
    for act in active:
        state = _substep(
            act > 0.0, state, rows[6], rows[7], xyz, window_bp, k, span=span,
            taps=taps, interp=interp, fir_phases=fir_phases,
            inv_div=1.0 / float(divisor),
            quadrant=probe_layout == "quadrant", theta_limit=theta_limit,
            beams=beams,
        )
    return torch.stack(state)
