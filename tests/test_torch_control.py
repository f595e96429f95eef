"""The port's control unit on the CPU: the multi-array run loop, fusion to
a 3D best track, frame rendering, MISO WAV/MP3/playback, recording and
click-to-steer (the JAX package's control-unit cases, on ``device="cpu"``),
the adaptive heatmaps, and what the port's unit adds: its device, its
stage timer, its refusal of a mesh that is not a ``DeviceMesh`` (a real
mesh runs in ``tests/test_torch_multihost.py``)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from beamforming_lk_tpu_torch.app.control import ControlUnit  # noqa: E402
from beamforming_lk_tpu_torch.config import (  # noqa: E402
    Config, MimoConfig, TrackerConfig,
)
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402

CFG = Config(mimo=MimoConfig(rows=16, columns=16),
             tracker=TrackerConfig(iterations=4))


def _unit(cfg=CFG, **kw):
    return ControlUnit(cfg, device="cpu", **kw)


def _direction(position, target):
    d = np.asarray(target, np.float64) - np.asarray(position, np.float64)
    d /= np.linalg.norm(d)
    return float(np.arccos(d[2])), float(np.arctan2(d[1], d[0]))


def _blocks_for(points, position, target, n):
    """Blocks as seen by an array at ``position`` for a world target."""
    theta, phi = _direction(position, target)
    return [plane_wave_block(points, [(theta, phi, 4500.0)], b * 256, 256,
                             CFG.array, noise_std=0.02) for b in range(n)]


def test_two_array_fusion_to_world_track(tmp_path):
    from beamforming_lk_tpu_torch.io.wav import read_wav
    from beamforming_lk_tpu_torch.utils.png import read_png_size

    positions = [np.array([-1.0, 0.0, 0.0]), np.array([1.0, 0.0, 0.0])]
    unit = _unit(n_arrays=2, enable_tracker=True, enable_miso=True,
                 array_positions=positions)
    assert unit.fusion.device == unit._kf.device == torch.device("cpu")
    target = np.array([0.3, 0.2, 5.0])
    n = 10
    sources = [_blocks_for(unit.pipelines[i].points, positions[i], target, n)
               for i in range(2)]
    out_dir = str(tmp_path / "frames")
    wav = str(tmp_path / "miso.wav")
    summary = unit.run(sources, n_blocks=n, render_every=4, output_dir=out_dir,
                       miso_wav=wav)
    assert summary["blocks"] == n
    frames = sorted(os.listdir(out_dir))
    assert frames, "no frames rendered"
    assert read_png_size(os.path.join(out_dir, frames[0])) == (512, 256)
    data, rate = read_wav(wav)
    assert data.shape == (1, n * 256) and rate == 48828
    best = unit.best_track()
    assert best is not None, "fusion produced no track"
    assert np.linalg.norm(best.position - target) < 1.5, best.position
    smoothed = unit.smoothed_best()
    assert smoothed.shape == (3,) and np.isfinite(smoothed).all()
    assert np.isfinite(unit.smoothed_best(lead_seconds=0.01)).all()
    # The host stages the run timed, each with its calls.
    stages = summary["stages"]
    assert stages["step"]["calls"] == stages["sync"]["calls"] == n
    assert stages["ingest"]["calls"] >= n
    assert stages["fusion"]["calls"] == n and stages["render"]["calls"] == 2
    assert stages["audio"]["calls"] == n


def test_live_playback_and_mp3_recording(tmp_path):
    """``play="miso"`` streams s16le PCM of the beam through the player
    command and ``miso_mp3`` pipes the same samples to the encoder."""
    from beamforming_lk_tpu_torch.io.wav import read_wav

    unit = _unit(enable_tracker=False, enable_miso=True)
    n = 6
    blocks = _blocks_for(unit.pipelines[0].points, (0, 0, 0), (0.5, 0.3, 5.0), n)
    played, encoded = str(tmp_path / "played.pcm"), str(tmp_path / "encoded.pcm")
    wav = str(tmp_path / "out.wav")
    summary = unit.run(
        [blocks], n_blocks=n, miso_wav=wav, miso_mp3=str(tmp_path / "out.mp3"),
        play="miso", player_command=["sh", "-c", f"cat > {played}"],
        mp3_command=["sh", "-c", f"cat > {encoded}"],
    )
    assert summary["blocks"] == n
    pcm = np.frombuffer(open(played, "rb").read(), "<i2")
    assert pcm.shape == (n * 256,)
    np.testing.assert_array_equal(pcm, np.frombuffer(open(encoded, "rb").read(), "<i2"))
    data, _rate = read_wav(wav)
    np.testing.assert_allclose(pcm / 32767.0, np.clip(data[0], -1, 1), atol=1.0 / 32000)
    assert np.abs(pcm).max() > 0, "beam was silent"


def test_raw_playback_streams_mic0(tmp_path):
    unit = _unit(enable_tracker=False, enable_miso=False)
    n = 3
    blocks = _blocks_for(unit.pipelines[0].points, (0, 0, 0), (0.5, 0.3, 5.0), n)
    played = str(tmp_path / "raw.pcm")
    unit.run([blocks], n_blocks=n, play="raw",
             player_command=["sh", "-c", f"cat > {played}"])
    pcm = np.frombuffer(open(played, "rb").read(), "<i2") / 32767.0
    want = np.clip(np.concatenate([b[0] for b in blocks]), -1, 1)
    np.testing.assert_allclose(pcm, want, atol=1.0 / 32000)


def test_audio_degrades_without_player_or_encoder(tmp_path, capsys, monkeypatch):
    """No player or encoder binary: a note on stderr, and the run goes on."""
    import beamforming_lk_tpu_torch.io.audio_out as ao

    monkeypatch.setattr(ao, "default_player_command", lambda *_: None)
    monkeypatch.setattr(ao, "default_encoder_command", lambda *_: None)
    unit = _unit(enable_tracker=False, enable_miso=True)
    blocks = _blocks_for(unit.pipelines[0].points, (0, 0, 0), (0.5, 0.3, 5.0), 2)
    summary = unit.run([blocks], n_blocks=2, play="miso",
                       miso_mp3=str(tmp_path / "x.mp3"))
    assert summary["blocks"] == 2
    err = capsys.readouterr().err
    assert "audio playback disabled" in err and "mp3 recording disabled" in err


def test_click_to_steer_moves_miso_listener():
    from beamforming_lk_tpu_torch.utils.overlay import (
        direction_to_pixel, pixel_to_direction,
    )

    unit = _unit(enable_tracker=False, enable_miso=True)
    n = unit.frame_size
    for th, ph in [(0.3, 0.7), (0.9, -2.0), (0.05, 3.0)]:
        r, c = direction_to_pixel(th, ph, n, CFG.mimo.fov_degrees)
        th2, ph2 = pixel_to_direction(r, c, n, CFG.mimo.fov_degrees)
        assert abs(th2 - th) < 0.02
        assert abs((ph2 - ph + np.pi) % (2 * np.pi) - np.pi) < 0.2 / max(th, 0.1)
    before = float(unit.pipelines[0].state.miso.particle.theta[0])
    hit = unit.handle_click(n // 4, n // 4)
    assert hit is not None
    tile, theta, phi = hit
    assert tile == 0
    after = unit.pipelines[0].state.miso.particle
    assert float(after.theta[0]) == np.float32(theta) != before
    assert float(after.phi[0]) == np.float32(phi)
    assert unit.handle_click(-1, 0) is None
    assert unit.handle_click(0, 5 * n) is None
    unit_f = _unit(enable_tracker=False, enable_miso=True, flip=True)
    hit_f = unit_f.handle_click(n // 4, n - 1 - n // 4)
    assert hit_f is not None
    assert abs(hit_f[1] - theta) < 1e-6 and abs(hit_f[2] - phi) < 1e-6


def test_debug_overlay_draws_tracker_count():
    unit = _unit(enable_tracker=True, enable_miso=False, debug=True)
    for b in _blocks_for(unit.pipelines[0].points, (0, 0, 0), (0.5, 0.3, 5.0), 6):
        unit.process([b])
    frame = unit.render_frame()
    assert (frame[4:18, 4:18] == 255).all(axis=-1).any(), "no debug text pixels"
    assert isinstance(len(unit.pipelines[0].targets()), int)


def test_render_draws_the_listener_only_with_miso():
    """The MISO circle is drawn from the pipeline's public ``miso_enabled``
    and the listener's direction; a pipeline without MISO draws none."""
    from beamforming_lk_tpu_torch.utils.overlay import direction_to_pixel

    frames = {}
    for miso in (True, False):
        unit = _unit(enable_tracker=False, enable_miso=miso, frame_size=64)
        assert unit.pipelines[0].miso_enabled is miso
        unit.pipelines[0].steer(0.6, 1.0)
        block = _blocks_for(unit.pipelines[0].points, (0, 0, 0), (0.5, 0.3, 5.0), 1)[0]
        unit.process([block])
        frames[miso] = unit.render_frame()
    changed = np.argwhere((frames[True] != frames[False]).any(axis=-1))
    assert changed.size, "no listener drawn"
    p = unit.pipelines[0]
    assert p.last is not None and not p.miso_enabled
    r, c = direction_to_pixel(0.6, 1.0, 64, CFG.mimo.fov_degrees)
    assert np.abs(changed - [r, c]).max() <= 8       # the circle around it


def test_batched_run_matches_per_block(tmp_path):
    """run(batch=N) drives N blocks per call (``process_blocks``) and
    records the same MISO WAV and block count as per-block stepping."""
    from beamforming_lk_tpu_torch.io.wav import read_wav

    cfg = Config(mimo=MimoConfig(rows=16, columns=16),
                 tracker=TrackerConfig(iterations=1))
    n = 7
    blocks = None
    wavs = {}
    for batch in (1, 3):
        unit = _unit(cfg, enable_tracker=False, enable_miso=True)
        if blocks is None:
            blocks = _blocks_for(unit.pipelines[0].points, (0, 0, 0), (0.5, 0.3, 5.0), n)
        wav = str(tmp_path / f"b{batch}.wav")
        summary = unit.run([blocks], n_blocks=n, miso_wav=wav, batch=batch)
        assert summary["blocks"] == n
        assert summary["stages"]["step"]["calls"] == (n if batch == 1 else 3)
        wavs[batch] = read_wav(wav)[0]
    np.testing.assert_allclose(wavs[3], wavs[1], rtol=1e-6, atol=2.0 / 32767)


def test_run_summary_reports_audio_stats(tmp_path):
    unit = _unit(enable_tracker=False, enable_miso=True)
    n = 4
    blocks = _blocks_for(unit.pipelines[0].points, (0, 0, 0), (0.5, 0.3, 5.0), n)
    sink = str(tmp_path / "sink.pcm")
    summary = unit.run([blocks], n_blocks=n, play="miso",
                       player_command=["sh", "-c", f"cat > {sink}"])
    audio = summary["audio"]
    assert audio["queued"] == n and audio["dropped"] == 0
    assert audio["played"] == n


def test_run_summary_reports_the_render_rate():
    """``render_fps`` is the unit's frame meter where two frames or more
    were rendered, and absent where fewer were."""
    unit = _unit(enable_tracker=False, enable_miso=False)
    blocks = _blocks_for(unit.pipelines[0].points, (0, 0, 0), (0.5, 0.3, 5.0), 3)
    frames = []
    summary = unit.run([blocks], n_blocks=3, render_every=1, on_frame=frames.append)
    assert len(frames) == 3 and summary["stages"]["render"]["calls"] == 3
    assert summary["render_fps"] == unit.fps.fps > 0.0
    one = _unit(enable_tracker=False, enable_miso=False)
    summary = one.run([blocks], n_blocks=1, render_every=1, on_frame=frames.append)
    assert len(frames) == 4 and "render_fps" not in summary


def test_logo_overlay_composited():
    logo = np.full((10, 20, 3), 200, np.uint8)
    unit = _unit(enable_tracker=False, enable_miso=False, logo=logo)
    block = _blocks_for(unit.pipelines[0].points, (0, 0, 0), (0.5, 0.3, 5.0), 1)[0]
    unit.process([block])
    frame = unit.render_frame()
    assert tuple(frame[0, 0]) == (200, 200, 200)
    assert unit._logo.shape[0] == unit.frame_size // 6
    unit2 = _unit(enable_tracker=False, enable_miso=False)
    unit2.process([block])
    unit3 = _unit(enable_tracker=False, enable_miso=False,
                  logo=np.zeros((10, 20, 4), np.uint8))
    unit3.process([block])
    np.testing.assert_array_equal(unit3.render_frame(), unit2.render_frame())


def test_runtime_record_toggle(monkeypatch, tmp_path):
    """'r' opens a recorder, 'r' again closes it, and a re-start writes a
    numbered sibling."""
    from beamforming_lk_tpu_torch.utils import video as vid

    opened, closed = [], []

    class _FakeRecorder:
        def __init__(self, path, fps=60.0):
            self.path = path
            opened.append(path)

        def write(self, frame):
            pass

        def close(self):
            closed.append(self.path)

    monkeypatch.setattr(vid, "VideoRecorder", _FakeRecorder)
    base = str(tmp_path / "cap.avi")
    rec, n = ControlUnit._toggle_record(None, base, 0)
    assert isinstance(rec, _FakeRecorder) and rec.path == base and n == 1
    rec2, n = ControlUnit._toggle_record(rec, base, n)
    assert rec2 is None and closed == [base] and n == 1
    rec3, n = ControlUnit._toggle_record(None, base, n)
    assert rec3.path == str(tmp_path / "cap_1.avi") and n == 2
    rec4, n4 = ControlUnit._toggle_record(None, None, 0)
    assert rec4.path == "recording.avi" and n4 == 1


def test_runtime_record_toggle_in_run_loop(monkeypatch):
    """A display whose key stream is r, None, r, q makes the run loop
    record exactly the frames between the two presses."""
    from beamforming_lk_tpu_torch.utils import video as vid

    frames_written = []

    class _FakeRecorder:
        def __init__(self, path, fps=60.0):
            self.path = path

        def write(self, frame):
            frames_written.append(np.asarray(frame).shape)

        def close(self):
            pass

    class _FakeDisplay:
        def __init__(self, title="x"):
            self.keys = iter(["r", None, "r", "q"])

        def show(self, frame):
            return next(self.keys, None)

        def pop_clicks(self):
            return []

        def close(self):
            pass

    monkeypatch.setattr(vid, "VideoRecorder", _FakeRecorder)
    monkeypatch.setattr(vid, "LiveDisplay", _FakeDisplay)
    cfg = Config(mimo=MimoConfig(rows=8, columns=8), tracker=TrackerConfig(iterations=2))
    unit = _unit(cfg, n_arrays=1, enable_tracker=False)
    pts = unit.pipelines[0].points
    blocks = [plane_wave_block(pts, [(0.3, 1.0, 4000.0)], b * 256, 256, cfg.array)
              for b in range(8)]
    unit.run([blocks], n_blocks=8, render_every=1, display=True)
    assert len(frames_written) == 2, frames_written


def test_control_unit_camera_underlay():
    from beamforming_lk_tpu_torch.io.synthetic import synthetic_blocks

    cfg = Config(mimo=MimoConfig(rows=8, columns=8))
    cam = np.full((480, 640, 3), 90, np.uint8)
    unit = _unit(cfg, enable_tracker=False, frame_size=32, camera=lambda: cam)
    plain = _unit(cfg, enable_tracker=False, frame_size=32)
    for b in synthetic_blocks(unit.pipelines[0].points, [(0.4, 1.0, 5000.0)], 3):
        unit.process([b])
        plain.process([b])
    with_cam, without = unit.render_frame(), plain.render_frame()
    assert with_cam.shape == without.shape == (32, 32, 3)
    assert not np.array_equal(with_cam, without)


@pytest.mark.parametrize("kw", [dict(mesh=object())], ids=["mesh"])
def test_not_ported_modes_raise(kw):
    """A mesh that is not a ``DeviceMesh`` raises the pipeline's
    ``TypeError`` (a real mesh runs: ``tests/test_torch_multihost.py``)."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        _unit(**kw)


@pytest.mark.parametrize("kw", [
    dict(heatmap_mode="mvdr", mvdr_refresh=2),
    dict(heatmap_mode="music", music_solver="eigh", music_sources=2),
], ids=["mvdr", "music"])
def test_adaptive_modes_run(kw):
    """MVDR and MUSIC: each pipeline gets the estimator with the unit's
    options, the DAS heatmap off, and the rendered frame shows the
    estimator's peak at the source."""
    cfg = Config(mimo=MimoConfig(rows=16, columns=16))
    unit = _unit(cfg, n_arrays=1, enable_tracker=False, frame_size=16, **kw)
    pipe = unit.pipelines[0]
    est = pipe._mvdr_step
    if kw["heatmap_mode"] == "mvdr":
        assert est.weight_refresh == 2
    else:
        assert (est.solver, est.n_sources) == ("eigh", 2)
    assert pipe.step.fft_model is None and pipe.step.mimo_model is None
    blocks = [plane_wave_block(pipe.points, [(0.5, 1.2, 5000.0)], b * 256, 256,
                               cfg.array, noise_std=0.02) for b in range(4)]
    summary = unit.run([blocks], n_blocks=4, render_every=4)
    assert summary["blocks"] == 4 and pipe._mvdr_state.count == 4
    img = pipe.heatmap()
    assert img.max() == 255
    assert np.unravel_index(img.argmax(), img.shape) == np.unravel_index(
        int(pipe._mvdr_powers.argmax()), img.shape)


def test_unit_places_its_parts_on_its_device():
    """The pipelines, the fusion and the Kalman filter take the unit's
    device (the card by default: ``test_torch_boundaries.py``)."""
    unit = _unit(n_arrays=2)
    assert {p.device.type for p in unit.pipelines} == {"cpu"}
    assert unit.fusion.device.type == unit._kf.device.type == "cpu"
    assert unit._kf.init().x.device.type == "cpu"
