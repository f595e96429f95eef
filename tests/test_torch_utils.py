"""The port's rendering utilities, metrics, profiling and filter designer.

The copies of the JAX package's numpy modules (colormaps, upscale, blur,
PNG, overlays, metrics, filters) are held bitwise against those modules on
identical numpy inputs."""

import itertools
import json
import os
import struct
import zlib
from contextlib import nullcontext

import numpy as np
import pytest
from scipy import signal

torch = pytest.importorskip("torch")

from beamforming_lk_tpu.ops import filters as jfilters  # noqa: E402
from beamforming_lk_tpu.utils import colormap as jcm  # noqa: E402
from beamforming_lk_tpu.utils import metrics as jmetrics  # noqa: E402
from beamforming_lk_tpu.utils import overlay as jov  # noqa: E402
from beamforming_lk_tpu.utils import png as jpng  # noqa: E402
from beamforming_lk_tpu_torch.ops import filters  # noqa: E402
from beamforming_lk_tpu_torch.utils import colormap as cm  # noqa: E402
from beamforming_lk_tpu_torch.utils import metrics  # noqa: E402
from beamforming_lk_tpu_torch.utils import overlay as ov  # noqa: E402
from beamforming_lk_tpu_torch.utils import png  # noqa: E402
from beamforming_lk_tpu_torch.utils import profiling  # noqa: E402

RNG_IMAGE = np.random.default_rng(0).integers(0, 256, (16, 16)).astype(np.uint8)


def test_luts_match_jax_and_shape():
    for ours, theirs in ((cm.jet_lut(), jcm.jet_lut()), (cm.ocean_lut(), jcm.ocean_lut())):
        assert ours.shape == (256, 3) and ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, theirs)
    j = cm.jet_lut()
    assert j[0, 2] > j[0, 0] and j[255, 0] > j[255, 2] and j[128, 1] > 200


@pytest.mark.parametrize("lut", ["jet", "ocean"])
def test_apply_colormap_matches_jax(lut):
    rgb = cm.apply_colormap(RNG_IMAGE, getattr(cm, f"{lut}_lut")())
    assert rgb.shape == (16, 16, 3) and rgb.dtype == np.uint8
    np.testing.assert_array_equal(
        rgb, jcm.apply_colormap(RNG_IMAGE, getattr(jcm, f"{lut}_lut")()))


@pytest.mark.parametrize("bilinear", [True, False])
def test_upscale_matches_jax(bilinear):
    for size in ((64, 64), (256, 256), (40, 24)):
        np.testing.assert_array_equal(cm.upscale(RNG_IMAGE, size, bilinear),
                                      jcm.upscale(RNG_IMAGE, size, bilinear))


def test_upscale_preserves_constant_and_interpolates():
    up = cm.upscale(np.full((8, 8), 100, np.uint8), (32, 32))
    assert up.shape == (32, 32) and np.all(up == 100)
    img2 = np.zeros((2, 2), np.uint8)
    img2[:, 1] = 200
    up2 = cm.upscale(img2, (2, 8))
    assert up2[0, 0] == 0 and up2[0, -1] == 200
    assert np.any((up2[0] > 10) & (up2[0] < 190))
    assert set(np.unique(cm.upscale(img2, (2, 8), bilinear=False))) == {0, 200}


def test_gaussian_blur_matches_jax_and_smooths():
    for sigma in (1.0, 2.0):
        out = cm.gaussian_blur(RNG_IMAGE, sigma)
        np.testing.assert_array_equal(out, jcm.gaussian_blur(RNG_IMAGE, sigma))
        assert abs(float(out.mean()) - float(RNG_IMAGE.mean())) < 8.0
        assert out.std() < RNG_IMAGE.std()
    rgb = np.stack([RNG_IMAGE] * 3, axis=-1)
    np.testing.assert_array_equal(cm.gaussian_blur(rgb, 1.0), jcm.gaussian_blur(rgb, 1.0))


def test_png_bytes_match_jax(tmp_path):
    gray = (np.arange(64, dtype=np.uint8).reshape(8, 8)) * 4
    for name, img in (("g", gray), ("c", cm.apply_colormap(gray))):
        ours, theirs = str(tmp_path / f"{name}.png"), str(tmp_path / f"{name}_j.png")
        png.write_png(ours, img)
        jpng.write_png(theirs, img)
        assert open(ours, "rb").read() == open(theirs, "rb").read()
        assert png.read_png_size(ours) == (8, 8)
        np.testing.assert_array_equal(png.read_png(ours), jpng.read_png(theirs))


def test_read_png_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (13, 9, 3), np.uint8)
    gray = rng.integers(0, 256, (7, 5), np.uint8)
    png.write_png(str(tmp_path / "rgb.png"), rgb)
    png.write_png(str(tmp_path / "gray.png"), gray)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "rgb.png")), rgb)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "gray.png")), gray)


def test_read_png_all_filters(tmp_path):
    """Rows under every PNG filter type (0-4) and RGBA decode."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (5, 4, 4), np.int32)  # RGBA
    h, w, ch = img.shape
    stride = w * ch
    flat = img.reshape(h, stride)

    def paeth(a, b, c):
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)

    raw = bytearray()
    for y, ft in enumerate([0, 1, 2, 3, 4]):
        raw.append(ft)
        up = flat[y - 1] if y > 0 else np.zeros(stride, np.int32)
        for x in range(stride):
            a = flat[y][x - ch] if x >= ch else 0
            b = up[x]
            c = up[x - ch] if x >= ch else 0
            pred = {0: 0, 1: a, 2: b, 3: (a + b) // 2, 4: paeth(a, b, c)}[ft]
            raw.append(int(flat[y][x] - pred) & 0xFF)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    path = str(tmp_path / "filt.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(bytes(raw))))
        f.write(chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.read_png(path), img.astype(np.uint8))


def test_metrics_match_jax(monkeypatch):
    """BlockMetrics on the same clock readings gives the JAX package's
    summary; FpsMeter the same rates."""
    ticks = iter(np.cumsum(np.random.default_rng(2).uniform(1e-4, 9e-3, 400)))
    readings = [float(t) for t in ticks]
    summaries = []
    for mod in (metrics, jmetrics):
        it = iter(readings)
        monkeypatch.setattr(mod.time, "perf_counter", lambda: next(it))
        m = mod.BlockMetrics(block_size=256, sample_rate=48828.0, window=64)
        for i in range(99):
            m.start_block()
            m.end_block(n=1 + i % 3)
        summaries.append(m.summary())
        monkeypatch.undo()
    assert summaries[0] == summaries[1]
    assert summaries[0]["blocks"] == 198 and summaries[0]["deadline_misses"] > 0
    f, jf = metrics.FpsMeter(), jmetrics.FpsMeter()
    for t in (0.0, 0.1, 0.25, 0.26):
        assert f.tick(t) == jf.tick(t)
    f = metrics.FpsMeter()
    f.tick(0.0)
    assert abs(f.tick(0.1) - 10.0) < 1e-6


def test_direction_to_pixel_round_trip():
    from beamforming_lk_tpu_torch.config import MimoConfig
    from beamforming_lk_tpu_torch.models.mimo import make_mimo_grid

    theta, phi = make_mimo_grid(MimoConfig(rows=16, columns=16))
    for d in (0, 5, 37, 130, 255):
        r, c = d // 16, d % 16
        row, col = ov.direction_to_pixel(float(theta[d]), float(phi[d]), 16)
        if np.hypot(r - 7.5, c - 7.5) > 7.5:     # clamped edge pixels
            continue
        assert abs(row - r) < 0.51 and abs(col - c) < 0.51, (d, row, col, r, c)
    for th, ph in [(0.3, 0.7), (0.9, -2.0), (0.05, 3.0)]:
        assert ov.pixel_to_direction(*ov.direction_to_pixel(th, ph, 64), 64) == \
            jov.pixel_to_direction(*jov.direction_to_pixel(th, ph, 64), 64)


def test_overlays_match_jax():
    """Markers, age labels, the MISO circle, flip and text: the frames equal
    the JAX package's."""
    targets = [{"theta": 0.3, "phi": 0.5, "start": 2.0},
               {"theta": 0.6, "phi": 2.5, "start": 1.0}]
    for kw in ({}, {"miso_direction": (0.2, 1.0)}, {"now_block": 191.0},
               {"flip": True, "miso_direction": (0.4, -1.0), "now_block": 50.0}):
        frames = [np.zeros((64, 64, 3), np.uint8) for _ in range(2)]
        out = ov.overlay_targets(frames[0], targets, **kw)
        jov.overlay_targets(frames[1], targets, **kw)
        assert out is frames[0] and (frames[0] == 255).any()
        np.testing.assert_array_equal(frames[0], frames[1])
    frames = [np.zeros((64, 64, 3), np.uint8) for _ in range(2)]
    ov.draw_text(frames[0], 2, 2, "123s", (255, 255, 255), scale=2)
    jov.draw_text(frames[1], 2, 2, "123s", (255, 255, 255), scale=2)
    assert frames[0].any()
    np.testing.assert_array_equal(frames[0], frames[1])


def test_overlay_age_labels_add_pixels():
    tgts = [{"theta": 0.3, "phi": 1.0, "start": 0.0}]
    with_age = ov.overlay_targets(np.zeros((64, 64, 3), np.uint8), tgts, now_block=191.0)
    without = ov.overlay_targets(np.zeros((64, 64, 3), np.uint8), tgts)
    assert (with_age > 0).sum() > (without > 0).sum()
    frame = np.zeros((64, 64, 3), np.uint8)
    ov.overlay_targets(frame, [{"theta": 0.3, "phi": 0.5, "start": 2.0}],
                       miso_direction=(0.2, 1.0))
    assert (frame[..., 0] == 255).sum() > (frame[..., 2] == 255).sum()


def test_blend_underlay_and_nearest_resize_match_jax():
    cam = np.full((6, 9, 3), 100, np.uint8)
    hm = np.zeros((4, 4, 3), np.uint8)
    hm[:, :, 0] = 200
    out = ov.blend_underlay(cam, hm, alpha=0.5)
    assert out.shape == cam.shape and out.dtype == np.uint8
    np.testing.assert_array_equal(out[0, 0], [150, 50, 50])
    np.testing.assert_array_equal(out, jov.blend_underlay(cam, hm, alpha=0.5))
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    assert ov.nearest_resize(img, (3, 4)) is img
    for shape in ((6, 8), (5, 7), (2, 3)):
        np.testing.assert_array_equal(ov.nearest_resize(img, shape),
                                      jov.nearest_resize(img, shape))


def test_filter_banks_match_jax():
    for band in (0, 1, 6):
        kw = dict(phases=11, bandpass_order=20, sinc_half_width=18)
        np.testing.assert_array_equal(
            filters.bandpass_fractional_bank(filters.REFERENCE_BANDS[band], **kw),
            jfilters.bandpass_fractional_bank(jfilters.REFERENCE_BANDS[band], **kw))
    np.testing.assert_array_equal(filters.windowed_sinc_delay(18, 0.37),
                                  jfilters.windowed_sinc_delay(18, 0.37))
    ours, theirs = filters.reference_band_banks(5), jfilters.reference_band_banks(5)
    assert set(ours) == set(theirs) == set(range(7))
    for i in ours:
        assert np.all(np.isfinite(ours[i])) and ours[i].shape[0] == 5
        np.testing.assert_array_equal(ours[i], theirs[i])
        np.testing.assert_array_equal(filters.bank_group_delay(ours[i]),
                                      jfilters.bank_group_delay(theirs[i]))


def test_sinc_delay_interpolates():
    h = filters.windowed_sinc_delay(18, 0.5)
    t = np.arange(256, dtype=np.float64)
    y = np.convolve(np.sin(2 * np.pi * 0.05 * t), h)[18:18 + 256]
    want = np.sin(2 * np.pi * 0.05 * (t - 0.5))
    np.testing.assert_allclose(y[30:-30], want[30:-30], atol=5e-3)


def test_band1_gain_profile():
    bank = filters.bandpass_fractional_bank(filters.REFERENCE_BANDS[0], phases=11,
                                            bandpass_order=20, sinc_half_width=18)
    assert bank.shape == (11, 20 + 37)
    nyq = filters.SAMPLE_RATE / 2.0
    for row in bank[::5]:
        w, h = signal.freqz(row, 1, worN=2048)
        freqs, mag = w / np.pi * nyq, np.abs(h)
        assert abs(mag.max() - 1.0) < 1e-6
        assert mag[(freqs > 7000) & (freqs < 8500)].mean() > 0.5
        assert mag[freqs < 2000].max() < 0.1


def test_fractional_group_delay_progression():
    bank = filters.bandpass_fractional_bank(filters.REFERENCE_BANDS[1], phases=5,
                                            bandpass_order=28, sinc_half_width=14)
    gd = filters.bank_group_delay(bank)
    np.testing.assert_allclose(gd - gd[0], [0.0, 0.25, 0.5, 0.75, 1.0], atol=0.1)


def test_bank_feeds_the_dense_heatmap():
    """A designed bank drops into the port's dense heatmap (the DAS-beam
    kernel's plain twin on the CPU) as ``fir_bank``: the powers equal the
    JAX package's within 1e-4 of the peak and peak near the source.  The
    bank has 15 taps: the DAS-beam kernel takes at most 16."""
    import jax.numpy as jnp

    from beamforming_lk_tpu.config import ArrayConfig as JArray
    from beamforming_lk_tpu.config import DspConfig as JDsp
    from beamforming_lk_tpu.config import MimoConfig as JMimo
    from beamforming_lk_tpu.io import ring as jrg
    from beamforming_lk_tpu.models import mimo as jmm
    from beamforming_lk_tpu_torch.config import ArrayConfig, DspConfig, MimoConfig
    from beamforming_lk_tpu_torch.io import ring as rg
    from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block
    from beamforming_lk_tpu_torch.models import mimo as mm
    from beamforming_lk_tpu_torch.ops import antenna as ant
    from beamforming_lk_tpu_torch.ops.geometry import spherical_angle

    bank = filters.bandpass_fractional_bank(filters.REFERENCE_BANDS[0], phases=21,
                                            bandpass_order=6, sinc_half_width=4)
    taps = bank.shape[1]
    assert taps == 15
    dcfg = DspConfig(interp="fir", fir_taps=taps, shift_range=64)
    points = ant.create_antenna_grid()
    model = mm.make_mimo_model(points, MimoConfig(rows=12, columns=12), dcfg,
                               ArrayConfig(), fir_bank=bank, device="cpu")
    src = (0.4, 1.0, 7800.0)  # in band 1
    block = plane_wave_block(points, [src], 0, 256, ArrayConfig(), noise_std=0.02)
    window = rg.ring_window(rg.ring_push(rg.ring_init(64, 1024, device="cpu"),
                                       torch.as_tensor(block)),
                            256, dcfg.shift_range, taps)
    powers = mm.mimo_power(window, model).numpy()

    jmodel = jmm.make_mimo_model(points, JMimo(rows=12, columns=12),
                                 JDsp(interp="fir", fir_taps=taps, shift_range=64),
                                 JArray(), fir_bank=bank)
    jwin = jrg.ring_window(jrg.ring_push(jrg.ring_init(64, 1024), jnp.asarray(block)),
                           256, 64, taps)
    want = np.asarray(jmm.mimo_power(jwin, jmodel))
    np.testing.assert_allclose(powers, want, atol=1e-4 * want.max())
    d = int(np.argmax(powers))
    ang = float(spherical_angle(torch.tensor(float(model.theta[d])),
                                torch.tensor(float(model.phi[d])),
                                torch.tensor(src[0]), torch.tensor(src[1])))
    assert ang < np.radians(15), ang


def test_trace_writes_a_chrome_trace(tmp_path):
    """``trace(dir)`` writes ``dir/trace.json`` with the enclosed ops;
    ``trace(None)`` records nothing."""
    log_dir = str(tmp_path / "prof")
    with profiling.trace(log_dir):
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(os.path.join(log_dir, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in e.get("name", "") for e in events)
    with profiling.trace(None):
        pass


def test_stage_timer_accumulates(monkeypatch):
    """The totals, and under a profiler each stage as ``control.<name>``
    with the same totals."""
    from types import SimpleNamespace

    from torch.profiler import ProfilerActivity, profile

    clock = itertools.cycle([0.0, 0.002, 0.010, 0.013, 0.020, 0.021])
    # The timer's clock alone: the profiler reads the time module's.
    monkeypatch.setattr(profiling, "time",
                        SimpleNamespace(perf_counter=lambda: next(clock)))
    for profiled in (False, True):
        st = profiling.StageTimer()
        with (profile(activities=[ProfilerActivity.CPU]) if profiled
              else nullcontext()) as prof:
            for name in ("step", "render", "step"):
                with st.stage(name):
                    pass
        s = st.summary()
        assert s["step"]["calls"] == 2 and s["render"]["calls"] == 1
        assert s["step"]["mean_ms"] == pytest.approx(1.5)
        assert s["render"]["total_s"] == pytest.approx(0.003)
    names = [e.name for e in prof.events() if e.name.startswith("control.")]
    assert names == ["control.step", "control.render", "control.step"]
