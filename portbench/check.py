"""How ``correct`` is decided: the program's outputs at sampled calls of the
window against the plain reference (:mod:`portbench.reference`).

For each sampled call the harness keeps the pipeline's state before it,
its outputs and its state after it (references only: every call makes new
tensors).  After the window:

- the heatmap the call shows is worked out again from the stream's samples
  (float64, :mod:`.reference.heatmap`): ``map_gap``, the largest gap over
  the map as a share of the map's peak;
- the ring history after the call against the stream's last samples:
  ``history_gap``, exact;
- the swarm and the listener follow the call's blocks from the program's
  state before it (the reference cannot re-derive a chaotic swarm over
  thousands of blocks), with the draws made again from the seed
  (:mod:`.reference.draws`), at the probe precision the configuration
  states: ``target_gap_rad``, the largest angle between a published target
  of the call's first block and the reference's (a flag that differs
  counts pi); ``beam_gap``, the largest gap of the listener's beam, every
  block, as a share of its peak; after a one-block call,
  ``state_gap_rad``, the largest angle over the listener and the trackers
  that track on both sides.  A longer call adds ``chunk_gap_rad``: on
  every block after the first, the reference starts the trackers from
  where the judged side's trackers stood after the block before, and
  compares those that were tracking there and still are, on both sides,
  in the same life (a flag that differs counts pi where no slot was
  stamped in the block: a new tracker can prune an old one by the power
  gate).  A longer call hands on no ``state_gap_rad``: chained freely over
  12 blocks the seekers part ways on rounding within a few blocks, and
  the listener by as much as the control does (PERF.md, section 6); the
  trackers it hands on are the last block's, and its listener is the one
  the last block's beam is steered by.

A configuration whose ``"pipeline"`` names an adaptive estimator (MVDR,
MUSIC) turns the DAS map off: its map shows nothing, and ``map_gap`` is
not computed.  The spectrum the operator sees is the estimator's, and
``spectrum_gap`` judges it: the estimator's reference
(:mod:`.reference.estimators`) follows the call's blocks from the
program's estimator state before the call, and the largest gap of the
program's spectrum after the call is taken as a share of the reference's
peak.  The estimator carries a covariance across blocks, so, as with the
swarm, the reference starts from the program's own state, and
``estimator_state_gap`` judges the state the program hands on: its state
after the call against the reference's, each tensor's largest gap over
the reference's peak, a counter or a missing carry that differs reading
1.  A state left unchanged (the covariance never advancing) reads no
spectrum gap, since the reference starts from it, and is caught there.

The control is the same reference computed one precision lower
(:data:`.reference.precision.BELOW`), put in the program's place.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import heatmap as ref_map
from portbench.reference import swarm as ref_swarm
from portbench.reference.draws import SwarmDraws
from portbench.reference.geometry import probe_span
from portbench.reference.precision import BELOW, round_to

NUMBERS = ("map_gap", "history_gap", "target_gap_rad", "beam_gap")
#: Compared where a call holds one block.
STATE = "state_gap_rad"
#: Compared where a call holds more than one block.
CHUNK = "chunk_gap_rad"
#: Compared in place of ``map_gap`` where the pipeline runs an estimator.
SPECTRUM = "spectrum_gap"
#: Compared beside it: the estimator's state after the call.
ESTIMATOR_STATE = "estimator_state_gap"
#: The precision the port's estimators state: f32 products without TF32
#: (``models/mvdr.py``, ``models/music.py``); the control runs below it.
ESTIMATOR_PRECISION = "float32"
#: Samples after the beamformed block that the ring keeps unread.
LOOKAHEAD = 8


class Layout:
    """Shapes and constants of one configuration that the reference needs."""

    def __init__(self, cfg: dict, points):
        a, d, m, t = cfg["array"], cfg["dsp"], cfg["mimo"], cfg["tracker"]
        self.cfg = cfg
        self.points = points
        self.h, self.tl, self.s = d["history"], d["block_size"], d["shift_range"]
        self.taps = ref_swarm.TAPS
        self.spm = a["sample_rate"] / a["propagation_speed"]
        self.span = probe_span(points, self.spm, self.taps, self.s)
        self.every = max(m["heatmap_every"], 1)
        self.nt, self.ns = t["n_trackers"], t["n_seekers"]
        self.fused = t["iterations"] <= 4 and t["iterations"] * t["tracker_steps"] >= 3
        self.n_miso = 1 if self.fused else 0
        self.refine = cfg["miso"]["refine_steps"]
        self.theta_limit = math.radians(t["fov_degrees"] / 2.0)
        tr = t["tracker_step_gain"] * t["tracker_spread"]
        nl = self.n_miso
        self.rate = [tr] * self.nt + [tr / 3.0] * nl + [
            t["seeker_step_gain"] * t["seeker_spread"]] * self.ns
        self.spread = [t["tracker_spread"]] * (self.nt + nl) + [t["seeker_spread"]] * self.ns
        self.kw = dict(n_iter=t["iterations"], n_sub=t["tracker_steps"],
                       refine=self.refine if self.fused else 0,
                       n_trackers=self.nt, span=self.span,
                       theta_limit=self.theta_limit, divisor=float(self.tl),
                       closeness=t["tracker_closeness"],
                       error_threshold=t["error_threshold"],
                       probe_layout=t["probe_layout"],
                       min_power_fraction=t["min_power_fraction"])

    def window_start(self, k: int) -> int:
        """Stream sample (history zeros included) where block k's window
        starts, once block k is in the ring."""
        return (k + 1) * self.tl + self.h - self.tl - LOOKAHEAD - (self.s - self.taps)


def _angle(t1, p1, t2, p2):
    """Great-circle angles [rad] between paired directions, f64."""
    def unit(t, p):
        t, p = t.double(), p.double()
        return torch.stack([torch.sin(t) * torch.cos(p),
                            torch.sin(t) * torch.sin(p), torch.cos(t)])
    chord = (unit(t1, p1) - unit(t2, p2)).norm(dim=0)
    return 2.0 * torch.asin(torch.clamp(chord / 2.0, max=1.0))


def _rel(got, want) -> float:
    scale = float(want.abs().max())
    return float((got.double() - want.double()).abs().max()) / max(scale, 1e-30)


def _plain_state(state):
    """The program's carried state as the reference's plain tensors."""
    sw = state.swarm
    return dict(
        trackers=torch.stack([f.float() for f in sw.trackers]),
        seekers=torch.stack([f.float() for f in sw.seekers]),
        miso=torch.stack([f.float() for f in state.miso.particle]).reshape(6),
        tracking=sw.tracking.float(), start=sw.start.float(),
        target_theta=sw.target_theta.float(), target_phi=sw.target_phi.float(),
        target_valid=sw.target_valid.float(), reset_count=int(sw.reset_count),
        block_index=int(state.block_index))


def block_outputs(out, j: int, m: int):
    """(powers [D], theta, phi, valid [nt], beam [T]) of block j of a call."""
    tg = out.targets
    if m == 1:
        return out.powers, tg.theta, tg.phi, tg.valid, out.miso_beam
    return out.powers[j], tg.theta[j], tg.phi[j], tg.valid[j], out.miso_beam[j]


def block_start(out, j: int, m: int):
    """The trackers' start stamps [nt] of block j of a call."""
    return out.targets.start if m == 1 else out.targets.start[j]


class Reference:
    """The reference of one run's configuration and stream."""

    def __init__(self, cfg: dict, traffic, device, seed: int, estimator=None):
        self.lay = Layout(cfg, traffic.points)
        #: The estimator's reference module (``follow``), or None for DAS.
        self.estimator = estimator
        self.traffic = traffic
        self.device = device
        self.swarm_draws = SwarmDraws(seed, cfg["tracker"], device)
        self.draws = {}
        lay = self.lay
        pts = torch.as_tensor(traffic.points * lay.spm, dtype=torch.float32)
        self.xyz = torch.cat([pts, torch.ones((1, pts.shape[1]))]).to(device)
        d = cfg["dsp"]
        self.map_precision = d["compute"]
        self.probe_precision = d["probe_compute"]

    def window(self, k: int):
        lay = self.lay
        w0 = lay.window_start(k)
        return self.traffic.samples(w0, w0 + lay.tl + lay.s, lay.h, self.device)

    def history(self, n_pushed: int):
        lay = self.lay
        return self.traffic.samples(n_pushed * lay.tl, n_pushed * lay.tl + lay.h,
                                    lay.h, self.device)

    def blocks(self, k0: int, m: int):
        """Stream blocks ``k0 .. k0+m`` [m, C, T] in float64."""
        lay = self.lay
        start = lay.h + k0 * lay.tl
        x = self.traffic.samples(start, start + m * lay.tl, lay.h, self.device)
        return x.to(torch.float64).reshape(x.shape[0], m, lay.tl).permute(1, 0, 2)

    def estimate(self, state, k0: int, m: int, control: bool):
        """The estimator's (spectrum [D], state as compared) after stream
        blocks ``k0 .. k0+m``, followed from the program's estimator
        ``state`` before them."""
        prec = BELOW[ESTIMATOR_PRECISION] if control else "float64"
        spectrum, after = self.estimator.follow(state._asdict(), self.blocks(k0, m),
                                                self.lay.points, self.lay.cfg, prec)
        return spectrum, self.comparable(after)

    def comparable(self, state: dict) -> dict:
        """What of an estimator state is compared: the module's
        ``comparable`` where it has one, else the state as it is."""
        return getattr(self.estimator, "comparable", dict)(state)

    def heatmap(self, k: int, control: bool):
        w = self.window(k)
        prec = BELOW[self.map_precision] if control else "float64"
        return ref_map.powers(w, self.lay.points, self.lay.cfg, prec)

    def prepare(self, captures) -> None:
        """Make the draws of every block the captured calls hold."""
        ks = [c["k0"] + j for c in captures for j in range(c["m"])]
        self.draws = self.swarm_draws.of_blocks(ks)

    def follow(self, state: dict, k0: int, m: int, control: bool, forced=None):
        """The swarm and listener over stream blocks k0 .. k0+m from
        ``state``: per block (theta, phi, valid [nt], beam [T], start,
        radius, error [nt]), and the state after the last block.  With
        ``forced`` (per block the judged side's (theta, phi, valid, start,
        radius, error) of its trackers), each block after the first starts
        its trackers from the judged side's trackers of the block before:
        the trackers' own angles read no seeker, so each block of a chunk
        is checked from where the judged side stood."""
        lay, dev = self.lay, self.device
        prec = self.probe_precision
        if control:
            prec = BELOW[prec]
        t = lay.cfg["tracker"]
        st = {k: (v.clone().to(dev) if torch.is_tensor(v) else v)
              for k, v in state.items()}
        const = torch.tensor([lay.rate, lay.spread], dtype=torch.float32, device=dev)
        nt, ns, nl = lay.nt, lay.ns, lay.n_miso
        p = nt + nl + ns
        fam = torch.zeros((3, p), dtype=torch.float32, device=dev)
        fam[0, :nt] = 1.0
        fam[1, nt + nl:] = 1.0
        fam[2, nt:nt + nl] = 1.0
        zeros = torch.zeros((p - nt,), dtype=torch.float32, device=dev)
        outs = []
        for j in range(m):
            window = self.window(k0 + j)
            if control:
                window = round_to(window, prec)
            pw = window[:, lay.s - lay.span:]
            bp = 0.5 * pw[:, 1:-1] - 0.25 * (pw[:, 2:] + pw[:, :-2])
            win_bp = round_to(bp, prec)
            b0 = lay.s - lay.taps
            r0 = window[0, b0:b0 + lay.tl]
            r0 = 0.5 * r0[1:-1] - 0.25 * (r0[2:] + r0[:-2])
            reference = (r0 * r0).sum() / float(lay.tl - 2)
            if forced is not None and j > 0:
                f_th, f_ph, f_va, f_st, f_rad, f_err = (
                    x.to(dev).float() for x in forced[j - 1])
                trackers = st["trackers"].clone()
                trackers[0], trackers[1], trackers[4], trackers[5] = f_th, f_ph, f_rad, f_err
                st.update(trackers=trackers, tracking=f_va, start=f_st,
                          target_theta=f_th, target_phi=f_ph, target_valid=f_va)
            seekers = st["seekers"].clone()
            r_th, r_ph, j_th, j_ph = self.draws[k0 + j]
            if r_th is not None:
                seekers[0], seekers[1] = r_th, r_ph
            parts = [st["trackers"]] + ([st["miso"][:, None]] if nl else []) + [seekers]
            particles = torch.cat(parts, dim=1)                       # [6, P]
            rows = torch.cat([
                particles,
                torch.cat([st["tracking"], zeros])[None],
                torch.cat([st["start"], zeros])[None],
                const, fam,
                torch.cat([st["target_theta"], zeros])[None],
                torch.cat([st["target_phi"], zeros])[None],
                torch.cat([st["target_valid"], zeros])[None],
            ])
            jumps = torch.zeros((2, t["iterations"], p), dtype=torch.float32, device=dev)
            jumps[0, :, nt + nl:] = j_th
            jumps[1, :, nt + nl:] = j_ph
            new, beam = ref_swarm.swarm_block(
                self.xyz, win_bp, pw, rows, jumps, reference,
                block_index=st["block_index"], precision=prec, **lay.kw)
            if nl:
                miso = new[:6, nt]
            else:
                miso, beam = ref_swarm.listener_block(
                    self.xyz, win_bp, pw, st["miso"], steps=lay.refine,
                    rate=lay.rate[0] / 3.0, spread=lay.spread[0], span=lay.span,
                    theta_limit=lay.theta_limit, divisor=float(lay.tl),
                    probe_layout=t["probe_layout"], precision=prec)
            tracking = new[6, :nt]
            st.update(trackers=new[:6, :nt], seekers=new[:6, nt + nl:], miso=miso,
                      tracking=tracking, start=new[7, :nt],
                      target_theta=new[0, :nt], target_phi=new[1, :nt],
                      target_valid=tracking, reset_count=st["reset_count"] + 1,
                      block_index=st["block_index"] + 1)
            outs.append((new[0, :nt], new[1, :nt], tracking > 0.5, beam, new[7, :nt],
                         new[4, :nt], new[5, :nt]))
        return outs, st


def _target_gap(th, ph, valid, r_th, r_ph, r_valid) -> float:
    both = valid & r_valid
    gap = float(_angle(th[both], ph[both], r_th[both], r_ph[both]).max()) if both.any() else 0.0
    return math.pi if bool((valid != r_valid).any()) else gap


def _state_gap(st: dict, ref: dict, trackers: bool, k0: int):
    """Largest angle over the listener, and with ``trackers`` the trackers
    that track after the call on both sides, of two states: the seekers
    search at random and part ways on rounding, and a tracker slot that
    tracks on neither side holds the copy of a seeker that no later block
    reads (a slot that tracks on one side only is ``target_gap_rad``'s pi).
    Returns (that angle, the largest over every tracker slot, and which
    slot that was: ``(kind, theta)``)."""
    rows = (["trackers"] if trackers else []) + ["miso"]
    got = torch.cat([st[r].reshape(6, -1) for r in rows], dim=1)
    want = torch.cat([ref[r].reshape(6, -1) for r in rows], dim=1).to(got.device)
    gaps = _angle(got[0], got[1], want[0], want[1])
    counted = torch.ones_like(gaps, dtype=torch.bool)
    kinds = ["listener"] * gaps.shape[0]
    if trackers:
        nt = gaps.shape[0] - 1
        g_tr = st["tracking"].to(got.device) > 0.5
        r_tr = ref["tracking"].to(got.device) > 0.5
        counted[:nt] = g_tr & r_tr
        stamped = (st["start"].to(got.device) >= k0) | (ref["start"].to(got.device) >= k0)
        for i in range(nt):
            kinds[i] = (("tracking" if counted[i] else "not tracking")
                        + (", stamped in the call" if stamped[i] else ""))
    i = int(torch.argmax(gaps))
    return (float(gaps[counted].max()), float(gaps[i]), (kinds[i], float(want[0, i])))


def _chunk_gap(old, s0, stamped: bool, th, ph, valid, start, r_th, r_ph, r_valid,
               r_start) -> float:
    """:data:`CHUNK` on one block after a chunk's first: the trackers
    ``old`` (tracking on the judged side after the block before, stamped
    ``s0``) that both sides keep in the same life; a flag that differs
    counts pi where no slot was stamped in this block on either side (a new
    tracker can prune an old one by the power gate)."""
    same = old & (start == s0) & (r_start == s0)
    both = same & valid & r_valid
    gap = float(_angle(th[both], ph[both], r_th[both], r_ph[both]).max()) if both.any() else 0.0
    if not stamped and bool((old & (valid != r_valid)).any()):
        return math.pi
    return gap


def _estimator_state_gap(got: dict, want: dict) -> float:
    """:data:`ESTIMATOR_STATE`: the largest over ``want``'s entries of a
    tensor's gap over its peak; a host counter, or a carry present on one
    side only, that differs reads 1."""
    gap = 0.0
    for key, w in want.items():
        g = got[key]
        if torch.is_tensor(w) and torch.is_tensor(g):
            gap = max(gap, _rel(g.to(w.device), w))
        elif torch.is_tensor(w) or torch.is_tensor(g) or g != w:
            gap = max(gap, 1.0)
    return gap


def _judged(cap, got, m: int):
    """Per block the judged side's (powers or None, theta, phi, valid,
    beam, start, radius, error): the program's outputs, or the control's."""
    out = []
    for j in range(m):
        if got is not None:
            th, ph, valid, beam, start, rad, err = got[j]
            out.append((None, th, ph, valid, beam, start.float(), rad, err))
        else:
            powers, th, ph, valid, beam = block_outputs(cap["out"], j, m)
            tg = cap["out"].targets
            prob = tg.probability if m == 1 else tg.probability[j]
            power = tg.power if m == 1 else tg.power[j]
            out.append((powers, th, ph, valid, beam, block_start(cap["out"], j, m).float(),
                        power, 1.0 / prob.float()))
    return out


def compare(ref: Reference, captures, control: bool = False, notes=None) -> dict:
    """The numbers of :data:`NUMBERS`, with :data:`STATE` where a call holds
    one block and :data:`CHUNK` where one holds more, over ``captures`` (each a dict with ``k0``, ``m``,
    ``before``, ``out`` and ``after``, and with an estimator
    ``estimator_before`` and ``estimator_after``, its state before and
    after the call, and ``spectrum``, its spectrum after it): the program
    against the reference, or with ``control`` the control against it.
    With an estimator :data:`SPECTRUM` stands in for ``map_gap``, and
    :data:`ESTIMATOR_STATE` is compared beside it.  ``notes``, a dict,
    gets for each call the ``state_gap_rad`` read, the largest over every
    tracker slot, and the slot behind it."""
    lay = ref.lay
    estimator = ref.estimator is not None
    worst = {n: 0.0 for n in NUMBERS if not (estimator and n == "map_gap")}
    if estimator:
        worst[SPECTRUM] = worst[ESTIMATOR_STATE] = 0.0
    if any(c["m"] == 1 for c in captures):
        worst[STATE] = 0.0
    if any(c["m"] > 1 for c in captures):
        worst[CHUNK] = 0.0
    maps = {}
    if not ref.draws:
        ref.prepare(captures)

    def bump(name, v):
        if not math.isfinite(v):
            v = math.inf
        worst[name] = max(worst[name], v)

    for cap in captures:
        k0, m = cap["k0"], cap["m"]
        before = _plain_state(cap["before"])
        if control:
            got, got_state = ref.follow(before, k0, m, control=True)
            hist = round_to(ref.history(k0 + m), BELOW[ref.map_precision])
        else:
            got, got_state = None, _plain_state(cap["after"])
            hist = cap["after"].history
        judged = _judged(cap, got, m)
        forced = [(th, ph, valid, start, rad, err)
                  for _, th, ph, valid, _, start, rad, err in judged]
        want, want_state = ref.follow(before, k0, m, control=False, forced=forced)
        bump("history_gap", float((hist.float() - ref.history(k0 + m)).abs().max()))
        if estimator:
            if control:
                spectrum, est_after = ref.estimate(cap["estimator_before"], k0, m,
                                                   control=True)
            else:
                spectrum = cap["spectrum"]
                est_after = ref.comparable(cap["estimator_after"]._asdict())
            r_spectrum, r_after = ref.estimate(cap["estimator_before"], k0, m,
                                               control=False)
            bump(SPECTRUM, _rel(spectrum.to(r_spectrum.device), r_spectrum))
            bump(ESTIMATOR_STATE, _estimator_state_gap(est_after, r_after))
        for j in range(m):
            k = k0 + j
            powers, th, ph, valid, beam, start, _, _ = judged[j]
            if not estimator:
                kmap = k - k % lay.every
                if kmap not in maps:
                    maps[kmap] = ref.heatmap(kmap, control=False)
                if control:
                    powers = ref.heatmap(kmap, control=True)
                bump("map_gap", _rel(powers.to(maps[kmap].device), maps[kmap]))
            r_th, r_ph, r_valid, r_beam, r_start, _, _ = want[j]
            dev = r_th.device
            th, ph, valid, start = (x.to(dev) for x in (th, ph, valid, start))
            if j == 0:
                bump("target_gap_rad", _target_gap(th, ph, valid, r_th, r_ph, r_valid))
            else:
                _, _, _, p_valid, _, p_start, _, _ = judged[j - 1]
                p_valid, p_start = p_valid.to(dev), p_start.to(dev)
                stamped = bool((start >= k).any() or (r_start >= k).any())
                bump(CHUNK, _chunk_gap(p_valid, p_start, stamped, th, ph, valid,
                                       start, r_th, r_ph, r_valid, r_start))
            bump("beam_gap", _rel(beam.to(r_beam.device), r_beam))
        gap, every_slot, row = _state_gap(got_state, want_state, m == 1, k0)
        if m == 1:
            bump(STATE, gap)
        if notes is not None:
            notes.setdefault("state_gap_rows", []).append([gap, every_slot, *row])
    return worst


def lock_report(ref: Reference, powers, targets, sources) -> str:
    """Where the map (an estimator's spectrum) peaks and how far the
    nearest published target lies from each static source
    (``chip_smoke.py``'s ``check_map`` and ``check_lock``, as a report, not
    a judgement)."""
    m = ref.lay.cfg["mimo"]
    peak = divmod(int(torch.argmax(powers)), m["columns"])
    th, ph = (x.double().cpu() for x in targets[:2])
    valid = targets[2].cpu().bool()
    parts = [f"map peak at pixel {peak}"]
    for src in sources:
        if src.get("phi_rate_deg_s", 0.0):
            continue
        s_th = torch.full_like(th, src["theta"])
        s_ph = torch.full_like(ph, src["phi"])
        off = _angle(th, ph, s_th, s_ph)[valid]
        parts.append(f"nearest target {math.degrees(float(off.min())):.2f} deg from "
                     f"({src['theta']}, {src['phi']})" if off.numel() else
                     f"no target near ({src['theta']}, {src['phi']})")
    return "; ".join(parts)


def verdict(numbers: dict, limits: dict | None):
    """(correct, the numbers beside their limits)."""
    shown = {k: {"value": v, "limit": None if limits is None else limits.get(k)}
             for k, v in numbers.items()}
    if limits is None:
        return False, shown
    ok = all(math.isfinite(v) and k in limits and v <= limits[k]
             for k, v in numbers.items())
    return ok, shown
