"""The port's Kalman filter and multi-array fusion against the JAX
package's (``models/kalman.py``, ``models/fusion.py``) and against plain
geometry, on the CPU: the JAX package's test_kalman.py and test_fusion.py
on the port, plus parity on the same inputs."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import beamforming_lk_tpu.config as jcfg  # noqa: E402
from beamforming_lk_tpu.models import fusion as jfu  # noqa: E402
from beamforming_lk_tpu.models.kalman import KalmanFilter3D as JaxKalman  # noqa: E402
from beamforming_lk_tpu_torch import config as tcfg  # noqa: E402
from beamforming_lk_tpu_torch.app import AwpuPipeline  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.models.fusion import (  # noqa: E402
    TargetFusion, TrackStore, heading_rotation, position_to_gps, target_rays,
    triangulate_rays,
)
from beamforming_lk_tpu_torch.models.kalman import KalmanFilter3D  # noqa: E402
from tests import reference_impl as ref  # noqa: E402

CFG = tcfg.TriangulationConfig()
JCFG = jcfg.TriangulationConfig()
TARGET = np.array([0.4, 0.6, 6.0])
ARRAYS = ([-1.0, 0.0, 0.0], [1.0, 0.0, 0.0])


def _ray_through(origin, point):
    d = np.asarray(point, np.float64) - origin
    return np.asarray(origin, np.float32), (d / np.linalg.norm(d)).astype(np.float32)


def _spherical_of(origin, point, jitter=0.0):
    """The published target dict of a source at ``point`` seen from
    ``origin``: the (theta, phi) whose ray (``spherical_to_cartesian``)
    points at it, theta moved by ``jitter``."""
    d = np.asarray(point, np.float64) - np.asarray(origin)
    d = d / np.linalg.norm(d)
    return {"theta": float(np.arccos(d[2])) + jitter,
            "phi": float(np.arctan2(d[1], d[0])), "power": 1.0,
            "probability": 1.0, "start": 0.0}


# ---------------------------------------------------------------- Kalman


def test_kalman_matrices_match_reference():
    kf, jkf = KalmanFilter3D(0.2, device="cpu"), JaxKalman(0.2)
    a, q, h, r = ref.kalman_ref_matrices(0.2)
    for name, want in zip("aqhr", (a, q, h, r)):
        got = getattr(kf, name)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jkf, name)))


def test_kalman_update_matches_numpy_truth_and_jax():
    """Ten updates: within 1e-3 of the float64 numpy filter (the JAX
    package's bound) and within 1e-5 of the JAX package's f32 filter
    (rounding of the 3x3 inverse and the products)."""
    kf, jkf = KalmanFilter3D(0.2, device="cpu"), JaxKalman(0.2)
    state, jstate = kf.init(), jkf.init()
    a, q, h, r = ref.kalman_ref_matrices(0.2)
    x, p = np.zeros(9), np.eye(9)
    rng = np.random.default_rng(0)
    for _ in range(10):
        z = rng.standard_normal(3)
        state = kf.update(state, z.astype(np.float32))
        jstate = jkf.update(jstate, z.astype(np.float32))
        x = a @ x
        p = a @ p @ a.T + q
        k = p @ h.T @ np.linalg.inv(h @ p @ h.T + r)
        x = x + k @ (z - h @ x)
        p = (np.eye(9) - k @ h) @ p
    assert np.allclose(state.x.numpy(), x, atol=1e-3)
    np.testing.assert_allclose(state.x.numpy(), np.asarray(jstate.x), atol=1e-5)
    np.testing.assert_allclose(state.p.numpy(), np.asarray(jstate.p), atol=1e-5)
    for steps in (0, 1, 3):
        np.testing.assert_allclose(kf.predict(state, steps).numpy(),
                                   np.asarray(jkf.predict(jstate, steps)),
                                   rtol=1e-5, atol=1e-5)
    for t in (0.0, 2.5, 11.0):
        np.testing.assert_allclose(kf.predict_time(state, t).numpy(),
                                   np.asarray(jkf.predict_time(jstate, t)),
                                   rtol=1e-5, atol=1e-5)


def test_kalman_tracks_constant_velocity():
    kf = KalmanFilter3D(1.0, device="cpu")
    state = kf.init()
    for t in range(30):
        state = kf.update(state, np.array([t * 1.0, 0.0, 0.0], np.float32))
    pos, vel = kf.position(state).numpy(), kf.velocity(state).numpy()
    assert abs(pos[0] - 29.0) < 0.5
    assert abs(vel[0] - 1.0) < 0.2
    # predict(0) applies one A step: leads the target by ~one dt.
    assert kf.predict(state, 0).numpy()[0] <= pos[0] + 2.5
    one = kf.predict_time(state, 0.0).numpy()
    assert abs(one[0] - (pos[0] + vel[0])) < 1.0


# ---------------------------------------------------------- triangulation


def _both(o1, d1, o2, d2, cfg=CFG):
    """(port points, port valid) after checking them against the JAX
    package's on the same inputs: equal flags, points within 1e-5 m."""
    pts, valid = triangulate_rays(o1, d1, o2, d2, cfg)
    jpts, jvalid = jfu.triangulate_rays(o1, d1, o2, d2, JCFG)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpts), atol=1e-5)
    assert pts.dtype == torch.float32
    return pts.numpy(), valid.numpy()


def test_exact_intersection_recovered():
    target = np.array([1.5, 0.5, 4.0])
    pts, valid = _both(*_ray_through(ARRAYS[0], target),
                       *_ray_through(ARRAYS[1], target))
    assert bool(valid)
    np.testing.assert_allclose(pts, target, atol=1e-5)


def test_gates():
    # Closest approach above threshold -> invalid, the {0,0,0} sentinel.
    d2 = np.array([0.0, 1e-3, 1.0], np.float32)
    d2 /= np.linalg.norm(d2)
    pts, valid = _both(np.array(ARRAYS[0], np.float32),
                       np.array([0.0, 0.0, 1.0], np.float32),
                       np.array(ARRAYS[1], np.float32), d2)
    assert not bool(valid) and np.all(pts == 0.0)
    # Behind the arrays, too close (static noise), beyond max range.
    for target in ([0.0, 0.0, -4.0], [0.0, 0.0, 0.5], [0.0, 0.0, 30.0]):
        o1, d1 = _ray_through(ARRAYS[0], target)
        o2, d2 = _ray_through(ARRAYS[1], target)
        _, valid = _both(o1, d1, o2, d2)
        assert not bool(valid), target
    # Parallel rays -> invalid, no NaNs.
    pts, valid = _both(o1, d1, o1 + [2, 0, 0], d1)
    assert not bool(valid) and np.all(np.isfinite(pts))


def test_batched_pairs():
    targets = np.array([[0.0, 1.0, 5.0], [2.0, -1.0, 8.0], [0.0, 0.0, 3.0]])
    rays = [[_ray_through(o, t) for t in targets] for o in ARRAYS]
    o1, d1, o2, d2 = (np.stack([r[k] for r in rays[a]])
                      for a in (0, 1) for k in (0, 1))
    pts, valid = _both(o1, d1, o2, d2)
    assert valid.all()
    np.testing.assert_allclose(pts, targets, atol=1e-4)
    for i in range(3):
        want = ref.triangulate_ref(o1[i], d1[i], o2[i], d2[i], 1.0)
        np.testing.assert_allclose(pts[i], want, atol=1e-5)


def test_target_rays_match_jax():
    lists = [_spherical_of(o, TARGET, 1e-4 * k) for k in range(3) for o in ARRAYS]
    for pos in ARRAYS:
        got, want = target_rays(lists, pos), jfu.target_rays(lists, pos)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, atol=1e-7)
    assert target_rays([], ARRAYS[0])[0].shape == (0, 3)


# ------------------------------------------------------------ track store


def test_track_store_merge_and_expire():
    store = TrackStore(CFG)
    store.add_target([0.0, 0.0, 5.0], now=0.0)
    store.add_target([0.2, 0.1, 5.1], now=0.1)   # within 1 m box -> merge
    assert len(store.tracks) == 1 and store.tracks[0].hits == 2
    # Bit-identical duplicate -> dropped entirely.
    store.add_target(store.tracks[0].position.copy(), now=0.15)
    assert store.tracks[0].hits == 2
    store.add_target([5.0, 0.0, 10.0], now=0.2)  # far -> new track
    assert len(store.tracks) == 2
    assert store.update(now=0.3) is store.tracks[0]
    # Expire: after the timeout both are invalid; a slot is reused.
    store.update(now=1.0)
    assert not any(t.valid for t in store.tracks)
    store.add_target([1.0, 1.0, 3.0], now=1.1)
    assert len(store.tracks) == 2 and store.tracks[-1].valid


def test_adaptive_merge_grows_with_hits():
    cfg = dataclasses.replace(CFG, adaptive_merge=True)
    store = TrackStore(cfg)
    store.add_target([0.0, 0.0, 5.0], now=0.0)
    for i in range(30):  # threshold = 1 + 0.325 * log(hits)
        store.add_target([0.0, 0.0, 5.0 + 1e-6 * (i + 1)], now=0.01 * i)
    assert store.tracks[0].hits == 31
    thresh = store.adaptive_distance(store.tracks[0])
    assert thresh > 2.0
    store.add_target([0.0, 0.0, 5.0 + 0.5 * (thresh + 1.0)], now=0.5)
    assert len(store.tracks) == 1, "adaptive box should have merged"
    store2 = TrackStore(CFG)
    store2.add_target([0.0, 0.0, 5.0], now=0.0)
    store2.add_target([0.0, 0.0, 5.0 + 0.5 * (thresh + 1.0)], now=0.1)
    assert len(store2.tracks) == 2


@pytest.mark.parametrize("adaptive", [False, True])
def test_track_store_replay_matches_jax(adaptive):
    """A seeded replay of noisy target lists from two arrays (the true
    source, clutter, dropouts, a gap past the timeout) through both
    packages' ``TargetFusion``: the same track count, hit counts and valid
    flags after every step, the same best track, positions within 1e-5 m."""
    cfg = dataclasses.replace(CFG, adaptive_merge=adaptive)
    ours = TargetFusion(cfg, device="cpu")
    theirs = jfu.TargetFusion(dataclasses.replace(JCFG, adaptive_merge=adaptive))
    for f in (ours, theirs):
        for pos in ARRAYS:
            f.add_array(None, pos)
    rng = np.random.default_rng(11)
    now = 0.0
    for step in range(60):
        now += 0.7 if step == 30 else 0.02
        lists = []
        for pos in ARRAYS:
            tl = []
            if rng.random() > 0.2:
                tl.append(_spherical_of(pos, TARGET, rng.normal(0.0, 2e-3)))
            for _ in range(rng.integers(0, 3)):
                tl.append(_spherical_of(pos, rng.uniform([-3, -3, 1], [3, 3, 12])))
            lists.append(tl)
        a, b = ours.step(now, lists), theirs.step(now, lists)
        assert (a is None) == (b is None)
        assert [(t.hits, t.valid) for t in ours.store.tracks] == [
            (t.hits, t.valid) for t in theirs.store.tracks]
        for t, u in zip(ours.store.tracks, theirs.store.tracks):
            np.testing.assert_allclose(t.position, u.position, atol=1e-5)
        if a is not None:
            assert ([t is a for t in ours.store.tracks]
                    == [t is b for t in theirs.store.tracks])
    assert a is not None and a.hits >= 5
    if not adaptive:    # the grown box lets clutter pull the track away
        np.testing.assert_allclose(a.position, TARGET, atol=0.1)


def test_fusion_replay_two_arrays():
    """Two arrays at +/-1 m see a target at known angles, slightly
    jittered (bit-identical repeats are dropped by the duplicate gate);
    fusion recovers its 3D position."""
    fusion = TargetFusion(CFG, device="cpu")
    for pos in ARRAYS:
        fusion.add_array(None, pos)
    for k in range(3):
        lists = [[_spherical_of(ARRAYS[0], TARGET, 1e-4 * k)],
                 [_spherical_of(ARRAYS[1], TARGET, -1e-4 * k)]]
        best = fusion.step(now=0.01 * k, target_lists=lists)
    assert best is not None and best.hits >= 2
    np.testing.assert_allclose(best.position, TARGET, atol=1e-3)


def test_fusion_of_two_pipelines():
    """Two realtime pipelines (64 mics, CPU) at x = +/-1 m, each hearing a
    plane wave from the direction of a source at (0.4, 0.6, 6.0) m in the
    published convention (the wave's (theta, phi) are the ones whose
    ``spherical_to_cartesian`` ray points at the source; the steering row's
    y is negated, so a wave made from world geometry would fuse at the
    mirror image).  ``TargetFusion`` fetches their targets each block; the
    best track sits within 0.1 m of the source, and the JAX package's
    fusion on the same target lists gives the same tracks."""
    cfg = tcfg.realtime(tcfg.Config(mimo=tcfg.MimoConfig(rows=16, columns=16)))
    fusion = TargetFusion(cfg.triangulation, device="cpu")
    theirs = jfu.TargetFusion(JCFG)
    pipes = []
    for i, pos in enumerate(ARRAYS):
        pipe = AwpuPipeline(cfg, channels=64, seed=i, device="cpu")
        fusion.add_array(pipe, pos)
        theirs.add_array(None, pos)
        pipes.append(pipe)
    src = [_spherical_of(pos, TARGET) for pos in ARRAYS]
    rng = np.random.default_rng(0)
    for b in range(24):
        for pipe, s in zip(pipes, src):
            pipe.process_block(plane_wave_block(
                pipe.points, [(s["theta"], s["phi"], 5000.0)], b * 256, 256,
                noise_std=0.02, rng=rng))
        now = b * 256 / 48828.0
        best = fusion.step(now)
        jbest = theirs.step(now, [p.targets() for p in pipes])
        assert [(t.hits, t.valid) for t in fusion.store.tracks] == [
            (t.hits, t.valid) for t in theirs.store.tracks]
    assert best is not None and best.hits >= 2
    np.testing.assert_allclose(best.position, jbest.position, atol=1e-5)
    assert np.linalg.norm(best.position - TARGET) < 0.1


def test_gps_and_heading():
    gps = position_to_gps([111.111, 0.0, 10.0], 57.0, 16.0, 100.0)
    assert abs(gps["latitude"] - 57.001) < 1e-6
    assert gps["altitude"] == 110.0
    assert gps == jfu.position_to_gps([111.111, 0.0, 10.0], 57.0, 16.0, 100.0)
    rot = heading_rotation(0.0)  # heading 0: swap y and z
    np.testing.assert_allclose(rot @ np.array([1.0, 2.0, 3.0]), [1.0, 3.0, 2.0])
    np.testing.assert_array_equal(heading_rotation(0.7), jfu.heading_rotation(0.7))


def test_ray_log_round_trip(tmp_path):
    """The ``Targets.txt`` ray log is byte for byte the JAX package's for
    the steps of the JAX package's test (which tools/track_replay.py
    replays; their directions come from the JAX ``cartesian_to_spherical``),
    and parses back to the rays of both packages within 1e-7 on seeded
    jittered steps, where an f32 sine may round apart by one ulp between
    the frameworks."""
    from beamforming_lk_tpu.ops.geometry import cartesian_to_spherical

    def jax_spherical(origin, jitter):
        d = TARGET - np.asarray(origin)
        th, ph, _ = np.asarray(cartesian_to_spherical(d / np.linalg.norm(d)),
                               np.float64)
        return {"theta": float(th) + jitter, "phi": float(ph), "power": 1.0,
                "probability": 1.0, "start": 0.0}

    rng = np.random.default_rng(5)
    for case, spherical in (("jax_test", jax_spherical), ("jittered", lambda o, j: (
            _spherical_of(o, TARGET, j + rng.normal(0.0, 1e-3))))):
        logs = [str(tmp_path / f"port_{case}.txt"), str(tmp_path / f"jax_{case}.txt")]
        fusions = [TargetFusion(CFG, log_path=logs[0], device="cpu"),
                   jfu.TargetFusion(JCFG, log_path=logs[1])]
        for f in fusions:
            for pos in ARRAYS:
                f.add_array(None, pos)
        for k in range(3):
            lists = [[spherical(ARRAYS[0], 1e-4 * k)],
                     [spherical(ARRAYS[1], -1e-4 * k)]]
            for f in fusions:
                f.step(now=0.01 * k, target_lists=lists)
        fusions[0].close()
        fusions[1]._log.close()
        port, jax_log = (open(p, "rb").read() for p in logs)
        assert port.count(b"\n") == 3
        if case == "jax_test":
            assert port == jax_log

        def parse(text):
            return np.array([[float(v) for part in line.split(";")[:2]
                              for vec in part.split(",") for v in vec.split()]
                             for line in text.decode().splitlines()])

        np.testing.assert_allclose(parse(port), parse(jax_log), rtol=0, atol=1e-7)
        assert [line.split(";")[2] for line in port.decode().splitlines()] == [
            "0.0", "0.01", "0.02"]
