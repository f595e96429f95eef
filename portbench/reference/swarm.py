"""The tracker swarm's per-block update and the MISO listener, in plain
PyTorch (beamforming-lk ``src/dsp/gradient_ascend.cpp:301-409``,
``particle.cpp``, ``miso.cpp:25-55``).

A frozen copy of the port's plain twins (``beamforming_lk_tpu_torch/ops/
cuda_tracker.py``: ``_consts``, ``_probe_dirs``, ``_stencil``,
``_gather_beams``, ``_substep``, ``swarm_chain_reference`` and
``monopulse_chain_reference``), linear interpolation only, with the
precision of the probe products as an argument: the bandpassed window and
the probe weights are rounded to it before the product, sums run in f32.

Rows are laid out ``trackers | listener | seekers`` (the listener only
where the tracker and the listener share one update); a particle is the
six fields theta, phi, grad_theta, grad_phi, radius, error.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.precision import round_to

PI_HALF = math.pi / 2.0
_QUADRANT_DEG = (45.0, 315.0, 225.0, 135.0)
_NEARBY_DEG = (0.0, 90.0, 180.0, 270.0)
_EPS = 1e-9
_TWO_PI = 2.0 * math.pi
TAPS = 2


def consts(probe_layout: str, theta_limit: float) -> dict:
    """The probe ring's unit (cos, sin) per azimuth and sin/cos of the
    theta limit, rounded to f32 once."""
    deg = _QUADRANT_DEG if probe_layout == "quadrant" else _NEARBY_DEG
    base = np.deg2rad(np.asarray(deg, np.float64))
    f32 = lambda v: [float(x) for x in np.asarray(v, np.float32)]  # noqa: E731
    return {"cos_b": f32(np.cos(base)), "sin_b": f32(np.sin(base)),
            "sin_tl": f32([np.sin(theta_limit)])[0],
            "cos_tl": f32([np.cos(theta_limit)])[0]}


def probe_dirs(theta, phi, spread, k):
    """Unit steering components (ux, uy, uz), each [4, P], of the 4 probes
    around every row, backed off at the field of view's edge and pulled to
    the theta limit at the same azimuth."""
    near = theta + spread > PI_HALF
    rt = torch.where(near, theta - spread, theta)
    c_t, s_t = torch.cos(rt), torch.sin(rt)
    c_p, s_p = torch.cos(phi), torch.sin(phi)
    sin_sp, cos_sp = torch.sin(spread), torch.cos(spread)
    us = []
    for cb, sb in zip(k["cos_b"], k["sin_b"]):
        bx, by = sin_sp * cb, sin_sp * sb
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


def stencil(ux, uy, uz, xyz, span: int):
    """Directions [R] -> (shift [R, C], weights [R, C, 2]): least-delay
    subtracted delays split at ``shift = (span - 2) - floor(tau)``, weighted
    ``[frac, 1 - frac]``, times the channel mask."""
    px, py, pz, mask = xyz[0], xyz[1], xyz[2], xyz[3]
    tau = ux[:, None] * px + uy[:, None] * py + uz[:, None] * pz
    tau = torch.clamp(tau - tau.amin(dim=1, keepdim=True), 0.0, float(span - TAPS))
    whole = torch.floor(tau)
    frac = tau - whole
    shift = (span - TAPS) - whole.to(torch.long)
    return shift, torch.stack([frac, 1.0 - frac], dim=-1) * mask[None, :, None]


def gather_beams(win, shift, w, n_out: int):
    """beam[r, t] = sum_c sum_j w[r, c, j] * win[c, shift[r, c] + j + t]."""
    unf = win.unfold(1, n_out, 1)
    cidx = torch.arange(win.shape[0], device=win.device)
    beam = torch.zeros((shift.shape[0], n_out), dtype=torch.float32,
                       device=win.device)
    for j in range(w.shape[-1]):
        beam = beam + (w[..., j, None] * unf[cidx, shift + j].to(torch.float32)).sum(1)
    return beam


def substep(active, state, rate, spread, xyz, window_bp, k, *, span,
            inv_div, quadrant, theta_limit, precision):
    """One 4-probe monopulse sub-step of every row, inactive rows kept."""
    theta, phi, gt, gp, rad, err = state
    p = theta.shape[0]
    ux, uy, uz = probe_dirs(theta, phi, spread, k)
    shift, w = stencil(ux.reshape(-1), uy.reshape(-1), uz.reshape(-1), xyz, span)
    w = round_to(w, precision)
    beam = gather_beams(window_bp, shift, w, window_bp.shape[1] - span)
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
    return (sel(new_t, theta), sel(new_p, phi), sel(g_t, gt), sel(g_p, gp),
            sel(r, rad), sel(e, err))


def beam_at(theta, phi, xyz, window_raw, span: int):
    """The f32 delay-and-sum beam [T] of the raw window at one direction."""
    st = torch.sin(theta)
    shift, w = stencil((st * torch.cos(phi)).reshape(1),
                       (-st * torch.sin(phi)).reshape(1),
                       torch.cos(theta).reshape(1), xyz, span)
    return gather_beams(window_raw, shift, w, window_raw.shape[1] - span)[0]


def swarm_block(xyz, window_bp, window_raw, rows, jumps, reference, *,
                block_index, n_iter, n_sub, refine, n_trackers, span,
                theta_limit, divisor, closeness, error_threshold,
                probe_layout, min_power_fraction, precision):
    """One block's update of every row (``rows`` [16, P] as the port packs
    them: six particle fields, tracking, start, rate, spread, the three
    family flags, the previous targets' theta, phi and valid).  Returns
    ``(state [8, P], beam [T])``: the six fields, tracking after the
    publish prune and start, and the listener's beam (zero without one)."""
    k = consts(probe_layout, theta_limit)
    p = rows.shape[1]
    t_len = window_raw.shape[1] - span
    cos_cl = float(np.cos(closeness))
    theta, phi, gt, gp, rad, err, tracking, start = rows[:8].unbind(0)
    rate, spread = rows[8], rows[9]
    is_tracker, is_seeker, is_miso = rows[10] > 0.5, rows[11] > 0.5, rows[12] > 0.5
    tgt_th, tgt_ph, tgt_va = rows[13], rows[14], rows[15]
    row_idx = torch.arange(p, device=rows.device)
    nt = n_trackers
    mean = torch.zeros((), dtype=torch.float32, device=rows.device)
    sub_kw = dict(span=span, inv_div=1.0 / float(divisor),
                  quadrant=probe_layout == "quadrant", theta_limit=theta_limit,
                  precision=precision)

    def pick(mask, v):
        return torch.where(mask, v, torch.zeros_like(v)).sum()

    for it in range(n_iter):
        trk_b = tracking > 0.5
        for j in range(n_sub):
            active = (is_tracker & trk_b) | (is_seeker & (j == 0))
            if it * n_sub + j < refine:
                active = active | is_miso
            theta, phi, gt, gp, rad, err = substep(
                active, (theta, phi, gt, gp, rad, err), rate, spread, xyz,
                window_bp, k, **sub_kw)
        n_tracking = trk_b.sum().to(torch.float32)

        # Merge close trackers (the oldest, then the lowest index, stays);
        # flag seekers inside a previously published target's zone.
        cos_t, sin_t = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
        th_n, ph_n, st_n = theta[None, :nt], phi[None, :nt], start[None, :nt]
        cos_ang = cos_t * torch.cos(th_n) + sin_t * torch.sin(th_n) * torch.cos(
            phi[:, None] - ph_n)
        close = ((cos_ang > cos_cl) & trk_b[:, None] & (tracking[None, :nt] > 0.5)
                 & (row_idx[:, None] != row_idx[None, :nt]) & is_tracker[:, None])
        older = (start[:, None] > st_n) | (
            (start[:, None] == st_n) & (row_idx[:, None] > row_idx[None, :nt]))
        t_th, t_ph = tgt_th[None, :nt], tgt_ph[None, :nt]
        cos_tg = cos_t * torch.cos(t_th) + sin_t * torch.sin(t_th) * torch.cos(
            phi[:, None] - t_ph)
        near_t = (cos_tg > cos_cl) & (tgt_va[None, :nt] > 0.5)
        tracking = torch.where((close & older).any(dim=1), 0.0, tracking)
        too_close = near_t.any(dim=1) & is_seeker

        # Seekers in a zone jump by the drawn offsets.
        j_theta = torch.clamp(theta + jumps[0, it], 0.0, theta_limit)
        j_phi = phi + jumps[1, it]
        j_phi = j_phi - torch.floor(j_phi / _TWO_PI) * _TWO_PI
        theta = torch.where(too_close, j_theta, theta)
        phi = torch.where(too_close, j_phi, phi)

        # The best converged seeker (first index of the largest power) is
        # promoted to every free tracker.
        valid = is_seeker & ~too_close
        converged = valid & (err < error_threshold)
        pm = torch.where(converged, rad, torch.full_like(rad, -3.0e38))
        is_best = converged & (pm >= pm.max())
        idx_best = torch.where(is_best, row_idx,
                               torch.full_like(row_idx, 2 ** 30)).min()
        oh = row_idx == idx_best
        better = (converged & (rad > 0.0)).any()
        promote = better & (n_tracking < float(nt)) & ~(tracking > 0.5) & is_tracker
        theta = torch.where(promote, pick(oh, theta), theta)
        phi = torch.where(promote, pick(oh, phi), phi)
        start = torch.where(promote, float(block_index), start)
        tracking = torch.where(promote, 1.0, tracking)

        n_valid = torch.clamp(valid.sum().to(torch.float32), min=1.0)
        mean = torch.where(valid, rad, torch.zeros_like(rad)).sum() / n_valid

    # Publish: prune weak or diverged trackers, then the sidelobe gate.
    weak = (rad < mean) | (rad < reference) | (err > error_threshold)
    tracking = torch.where(weak, 0.0, tracking)
    if min_power_fraction > 0.0:
        strongest = torch.where(tracking > 0.5, rad, torch.zeros_like(rad)).max()
        tracking = torch.where(rad >= min_power_fraction * strongest, tracking, 0.0)

    if bool(is_miso.any()):
        beam = beam_at(pick(is_miso, theta), pick(is_miso, phi), xyz,
                       window_raw, span)
    else:
        beam = torch.zeros((t_len,), dtype=torch.float32, device=rows.device)
    state = torch.stack([theta, phi, gt, gp, rad, err, tracking, start])
    return state, beam


def listener_block(xyz, window_bp, window_raw, particle, *, steps, rate,
                   spread, span, theta_limit, divisor, probe_layout,
                   precision):
    """The listener's own update (``steps`` monopulse sub-steps at
    ``rate``) and its beam, where it does not ride the swarm's update:
    ``particle`` [6] -> (particle [6], beam [T])."""
    k = consts(probe_layout, theta_limit)
    state = tuple(particle.reshape(6, 1).unbind(0))
    ones = torch.ones((1,), dtype=torch.bool, device=particle.device)
    rate_t = torch.full((1,), rate, dtype=torch.float32, device=particle.device)
    spread_t = torch.full((1,), spread, dtype=torch.float32, device=particle.device)
    for _ in range(steps):
        state = substep(ones, state, rate_t, spread_t, xyz, window_bp, k,
                        span=span, inv_div=1.0 / float(divisor),
                        quadrant=probe_layout == "quadrant",
                        theta_limit=theta_limit, precision=precision)
    out = torch.cat(state)
    return out, beam_at(out[0], out[1], xyz, window_raw, span)
