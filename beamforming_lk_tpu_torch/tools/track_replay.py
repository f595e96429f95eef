"""Offline track-algorithm replay, the ``math_toolbox/track_algorithm.py``
equivalent (counterpart of the repository's ``tools/track_replay.py``).

Replays a recorded ray-pair log (the reference's ``Targets.txt`` format,
also written by ``models.fusion.TargetFusion(log_path=...)``: one
``o1,d1;o2,d2;timestamp`` line per compared pair with space-separated
vectors) through the triangulation and the track store, and prints hit
statistics.  Every ray pair is triangulated in one batched call on the
device, the card unless the CPU is asked for, and fetched back once; the
track store then takes the hits on the host in log order.  Usage::

    python -m beamforming_lk_tpu_torch.tools.track_replay Targets.txt \\
        [--plot out.png] [--distance-threshold M] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import sys

import numpy as np
import torch

from beamforming_lk_tpu_torch.config import TriangulationConfig
from beamforming_lk_tpu_torch.device import resolve_device
from beamforming_lk_tpu_torch.models.fusion import TrackStore, triangulate_rays

# One number as numpy's text parser reads it (C's strtod without hex): a
# decimal with an optional exponent, inf, infinity or nan (with "(chars)").
_NUMBER = re.compile(r"[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
                     r"|inf(?:inity)?|nan(?:\([0-9A-Za-z_]*\))?)", re.IGNORECASE)
_WHITESPACE = " \t\n\v\f\r"


def parse_vector(text: str) -> np.ndarray:
    """The float64 values of a space-separated vector, as
    ``np.fromstring(text, sep=" ")`` reads them: from the left, each number
    that parses, until one does not or is followed by neither whitespace
    nor the end (numpy keeps what it read there and warns).  Like numpy,
    leading whitespace before no number reads as one value, -1."""
    text = text.split("\0", 1)[0]
    lead = len(text) - len(text.lstrip(_WHITESPACE))
    values, pos = [], lead
    while pos < len(text):
        number = _NUMBER.match(text, pos)
        if number is None:
            break
        values.append(float(number.group().partition("(")[0]))
        pos = number.end()
        gap = len(text) - len(text[pos:].lstrip(_WHITESPACE))
        if gap == pos:
            break
        pos = gap
    if lead and not values:
        values.append(-1.0)
    return np.array(values, np.float64)


def parse_log(path: str):
    """Yield (o1, d1, o2, d2, t) per line; skips a line that has not three
    ``;`` fields, a pair that is not two vectors, a timestamp that does not
    parse and a vector that is not 3 long."""
    with open(path) as f:
        for line in f:
            parts = line.strip().split(";")
            if len(parts) != 3:
                continue
            try:
                o1, d1 = (parse_vector(v) for v in parts[0].split(","))
                o2, d2 = (parse_vector(v) for v in parts[1].split(","))
                t = float(parts[2])
            except ValueError:
                continue
            if any(v.shape != (3,) for v in (o1, d1, o2, d2)):
                continue
            yield o1, d1, o2, d2, t


@dataclasses.dataclass
class Replay:
    """A replayed log: the track store after its last hit, each ray pair's
    intersection [N, 3] (f32; the reference's zero sentinel where a gate
    failed) and valid flag [N], and the normalised timestamps [N]."""

    store: TrackStore
    points: np.ndarray
    valid: np.ndarray
    times: np.ndarray

    @property
    def hits(self) -> np.ndarray:
        """The valid intersections [H, 3], in log order."""
        return self.points[self.valid]


def replay(path: str, cfg: TriangulationConfig = TriangulationConfig(),
           device="cuda") -> Replay:
    """Replay the log at ``path`` on ``device`` and print its summary."""
    device = resolve_device(device)
    store = TrackStore(cfg)
    rays = list(parse_log(path))
    if not rays:
        print("no valid ray pairs in log")
        return Replay(store, np.zeros((0, 3), np.float32), np.zeros(0, bool),
                      np.zeros(0))
    vectors = torch.as_tensor(np.stack([np.stack([r[i] for r in rays])
                                        for i in range(4)]),
                              dtype=torch.float32, device=device)
    pts, valid = triangulate_rays(*vectors, cfg)
    fetched = torch.cat([pts, valid[:, None].to(pts.dtype)], dim=1).cpu().numpy()
    pts, valid = fetched[:, :3], fetched[:, 3] > 0.5
    ts = np.array([r[4] for r in rays])
    # Normalize timestamps (the reference logs epoch counts).
    ts = (ts - ts.min()) * (1e-9 if ts.max() - ts.min() > 1e6 else 1.0)
    for k in np.flatnonzero(valid):
        store.add_target(pts[k], float(ts[k]))
        store.update(float(ts[k]))
    print(f"{len(rays)} ray pairs, {valid.sum()} valid intersections")
    print(f"{len(store.tracks)} tracks ({len(store.valid_tracks())} alive at end)")
    for i, tr in enumerate(store.tracks):
        print(f"  track {i}: pos={np.round(tr.position, 2)} hits={tr.hits} "
              f"valid={tr.valid}")
    if store.best is not None:
        print(f"best: {np.round(store.best.position, 3)} ({store.best.hits} hits)")
    return Replay(store, pts, valid, ts)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("log")
    ap.add_argument("--plot", default=None, help="save a 3D scatter PNG")
    ap.add_argument("--distance-threshold", type=float, default=1.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the rays are triangulated (the card by default)")
    args = ap.parse_args(argv)
    cfg = TriangulationConfig(distance_threshold=args.distance_threshold)
    result = replay(args.log, cfg, args.device)
    if args.plot and result.valid.any():
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure()
        ax = fig.add_subplot(projection="3d")
        h = result.hits
        ax.scatter(h[:, 0], h[:, 1], h[:, 2], s=4, alpha=0.4)
        for tr in result.store.valid_tracks():
            ax.scatter(*tr.position, marker="x", s=80)
        ax.set_xlabel("x [m]"); ax.set_ylabel("y [m]"); ax.set_zlabel("z [m]")
        fig.savefig(args.plot, dpi=120)
        print(f"plot -> {args.plot}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
