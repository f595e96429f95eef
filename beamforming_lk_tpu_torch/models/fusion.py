"""Multi-array fusion: ray triangulation, track store, geo-referencing
(counterpart of ``beamforming_lk_tpu.models.fusion``).

The reference's ``src/target_handler/``: ``triangulatePoint``
(``triangulate.cpp:10-41``), the pairwise intersection sweep
(``target_handler.cpp:130-169``), the track store
(``target_handler.cpp:81-128``) and ``PositionToGPS``
(``triangulate.cpp:43-54``).  The geometry runs over all cross-array ray
pairs at once in torch, on the inputs' device; the small sequential track
store runs on the host in float64, as the reference's 5 ms fusion thread.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from beamforming_lk_tpu_torch.config import TriangulationConfig
from beamforming_lk_tpu_torch.device import full_f32, resolve_device
from beamforming_lk_tpu_torch.ops.geometry import spherical_to_cartesian


def triangulate_rays(origins1, dirs1, origins2, dirs2,
                     cfg: TriangulationConfig = TriangulationConfig()):
    """Closest-point triangulation of ray pairs, in f32 on the device of
    ``origins1`` (the CPU for numpy input).

    All inputs [..., 3].  Returns (points [..., 3], valid [...]): the
    midpoint of the two closest points, or the reference's {0,0,0}
    sentinel where a gate fails (triangulate.cpp:10-41): parallel rays;
    closest approach > ``distance_threshold``; midpoint norm >
    ``max_range``; z1 + z2 < ``min_z`` (behind); midpoint z < ``near_z``
    (static noise)."""
    o1 = torch.as_tensor(origins1, dtype=torch.float32)
    d1, o2, d2 = (torch.as_tensor(v, dtype=torch.float32, device=o1.device)
                  for v in (dirs1, origins2, dirs2))
    o1, d1, o2, d2 = torch.broadcast_tensors(o1, d1, o2, d2)
    n = torch.linalg.cross(d1, d2)
    nn = torch.sum(n * n, dim=-1, keepdim=True)
    safe_nn = torch.clamp(nn, min=1e-20)        # parallel rays: gated below
    do = o2 - o1
    t1 = torch.sum(torch.linalg.cross(d2, n) * do, dim=-1, keepdim=True) / safe_nn
    t2 = torch.sum(torch.linalg.cross(d1, n) * do, dim=-1, keepdim=True) / safe_nn
    p1 = o1 + d1 * t1
    p2 = o2 + d2 * t2
    mid = (p1 + p2) / 2.0
    approach = torch.linalg.norm(p1 - p2, dim=-1)
    valid = (
        (nn[..., 0] > 1e-20)
        & (approach <= cfg.distance_threshold)
        & (torch.linalg.norm(mid, dim=-1) <= cfg.max_range)
        & (p1[..., 2] + p2[..., 2] >= cfg.min_z)
        & (mid[..., 2] >= cfg.near_z)
    )
    return torch.where(valid[..., None], mid, torch.zeros_like(mid)), valid


def target_rays(targets: Sequence[dict], position) -> tuple:
    """Per-array target dicts -> (origins [N, 3], unit directions [N, 3]),
    f32 numpy: each target's spherical direction as a world ray from the
    array's mounting position (target_handler.cpp:46-63)."""
    position = np.asarray(position, np.float32)
    if not targets:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    dirs = np.stack([
        spherical_to_cartesian(torch.tensor(t["theta"], dtype=torch.float32),
                               torch.tensor(t["phi"], dtype=torch.float32)).numpy()
        for t in targets
    ])
    dirs /= np.maximum(np.linalg.norm(dirs, axis=-1, keepdims=True), 1e-12)
    return np.broadcast_to(position, dirs.shape).copy(), dirs


@dataclasses.dataclass
class Track:
    """One fused track (reference: Track struct, target_handler.h)."""

    position: np.ndarray
    time_last_hit: float
    valid: bool = True
    hits: int = 1


class TrackStore:
    """Sequential track store with the reference's update rules
    (target_handler.cpp:65-128): merge hits within a per-axis box, drop
    bit-identical duplicates, reuse invalidated slots, expire idle tracks,
    select the best track by hit count."""

    def __init__(self, cfg: TriangulationConfig = TriangulationConfig()):
        self.cfg = cfg
        self.tracks: List[Track] = []
        self.best: Optional[Track] = None

    def adaptive_distance(self, track: Track) -> float:
        """Log-scaled per-track merge distance
        (CalculateDistanceThreshold, target_handler.cpp:116-121)."""
        return min(
            self.cfg.track_merge_distance + 0.325 * math.log(max(track.hits, 1)),
            4.0,
        )

    def add_target(self, position, now: float) -> None:
        """CheckTracksForTarget (target_handler.cpp:81-114)."""
        position = np.asarray(position, np.float64)
        invalid_index = -1
        for i, track in enumerate(self.tracks):
            if not track.valid:
                invalid_index = i
                continue
            delta = np.abs(position - track.position)
            if np.all(delta < self.cfg.track_duplicate_eps):
                return  # bit-identical: usually static noise, drop
            merge_dist = (self.adaptive_distance(track) if self.cfg.adaptive_merge
                          else self.cfg.track_merge_distance)
            if np.all(delta < merge_dist):
                track.position = position
                track.hits += 1
                track.time_last_hit = now
                return
        if invalid_index != -1:
            self.tracks[invalid_index] = Track(position, now)
            return
        if len(self.tracks) < self.cfg.max_tracks:
            self.tracks.append(Track(position, now))

    def update(self, now: float) -> Optional[Track]:
        """UpdateTracks (target_handler.cpp:65-79): expire, pick the best."""
        best_hits = -1
        for track in self.tracks:
            if now - track.time_last_hit > self.cfg.track_timeout:
                track.valid = False
                continue
            if track.valid and track.hits > best_hits:
                self.best = track
                best_hits = track.hits
        return self.best

    def valid_tracks(self) -> List[Track]:
        return [t for t in self.tracks if t.valid]


class TargetFusion:
    """The TargetHandler: fuse the target lists of two or more arrays.

    Holds (pipeline, position) pairs; each :meth:`step` fetches every
    array's targets (one device fetch per array), triangulates every
    cross-array ray pair on ``device`` (the card unless the CPU is asked
    for) and feeds the hits into the host track store (reference worker
    loop: target_handler.cpp:27-37).  ``log_path`` writes the reference's
    ``Targets.txt`` ray log; :meth:`close` closes it."""

    def __init__(self, cfg: TriangulationConfig = TriangulationConfig(),
                 log_path: Optional[str] = None, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.store = TrackStore(cfg)
        self.positions: List[np.ndarray] = []
        self._pipelines: List = []
        # One line per compared pair, "o1,d1;o2,d2;timestamp" with
        # space-separated vectors (target_handler.cpp:24-25,145-152).
        self._log = open(log_path, "w") if log_path else None

    def add_array(self, pipeline, position) -> "TargetFusion":
        """AddAWPU (target_handler.cpp:39-43)."""
        self._pipelines.append(pipeline)
        self.positions.append(np.asarray(position, np.float32))
        return self

    def step(self, now: float, target_lists: Optional[List[List[dict]]] = None):
        """One fusion pass; returns the current best track (or None).
        ``target_lists`` replaces the registered pipelines' targets (offline
        replay)."""
        if target_lists is None:
            target_lists = [p.targets() for p in self._pipelines]
        rays = [target_rays(tl, pos)
                for tl, pos in zip(target_lists, self.positions)]
        for i, j in itertools.combinations(range(len(rays)), 2):
            o1, d1 = rays[i]
            o2, d2 = rays[j]
            if len(o1) == 0 or len(o2) == 0:
                continue
            # All cross pairs between array i and array j.
            oo1 = np.repeat(o1, len(o2), axis=0)
            dd1 = np.repeat(d1, len(o2), axis=0)
            oo2 = np.tile(o2, (len(o1), 1))
            dd2 = np.tile(d2, (len(o1), 1))
            if self._log is not None:
                for k in range(len(oo1)):
                    self._log.write(
                        f"{' '.join(map(str, oo1[k]))},{' '.join(map(str, dd1[k]))};"
                        f"{' '.join(map(str, oo2[k]))},{' '.join(map(str, dd2[k]))};"
                        f"{now}\n"
                    )
            with full_f32():
                pts, valid = triangulate_rays(
                    *(torch.as_tensor(v, device=self.device)
                      for v in (oo1, dd1, oo2, dd2)), self.cfg)
            fetched = torch.cat([pts, valid[:, None].to(pts.dtype)], dim=1).cpu().numpy()
            pts, valid = fetched[:, :3], fetched[:, 3] > 0.5
            # The reference's norm-limit gate at the sweep level
            # (target_handler.cpp:154).
            norms = np.linalg.norm(pts, axis=-1)
            for p in pts[valid & (norms > 0) & (norms <= self.cfg.norm_limit)]:
                self.store.add_target(p, now)
        return self.store.update(now)

    def close(self) -> None:
        """Close the ray log, if any."""
        if self._log is not None:
            self._log.close()
            self._log = None


def position_to_gps(position, latitude: float, longitude: float, altitude: float):
    """Local ENU offset [3] -> (lat, lon, alt) with the reference's
    1 deg ~= 111111 m flat-earth model (triangulate.cpp:43-54)."""
    position = np.asarray(position, np.float64)
    return {
        "latitude": latitude + position[0] / 111111.0,
        "longitude": longitude + position[1] / (
            111111.0 * math.cos(math.radians(latitude))),
        "altitude": altitude + position[2],
        "type": "GeoPoint",
    }


def heading_rotation(heading: float) -> np.ndarray:
    """The WARA PS publish rotation: swap z and y, rotate to heading
    (target_handler.cpp:189-196)."""
    c, s = math.cos(heading), math.sin(heading)
    return np.array([[c, 0.0, s], [-s, 0.0, c], [0.0, 1.0, 0.0]])
