"""The JAX package's golden wire-to-track acceptance tests, through the
port's CLI on the CPU (``--device cpu``), with the same truth bounds: a
wire-format capture of a moving source -> tracks, the rendered heatmap and
the MISO WAV; a two-link capture -> fusion -> WARA PS GeoPoints."""

import json
import math
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from beamforming_lk_tpu_torch.app.cli import main  # noqa: E402
from beamforming_lk_tpu_torch.config import ArrayConfig  # noqa: E402
from beamforming_lk_tpu_torch.io import packets as pk  # noqa: E402
from beamforming_lk_tpu_torch.io import pcap as pc  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402

SRC_FREQ = 5000.0
PHI_DEG = 45.0
THETA_DEG_START, THETA_DEG_END = 16.0, 24.0
N_BLOCKS = 16
BLOCK = 256
MIMO_RES = 32


def _write_moving_source_pcap(path: str) -> None:
    """Wire-format capture of a source sweeping theta 16 -> 24 deg."""
    points = ant.create_antenna_grid(8, 8, 0.02)
    payloads = []
    for b in range(N_BLOCKS):
        th = math.radians(THETA_DEG_START
                          + (THETA_DEG_END - THETA_DEG_START) * b / (N_BLOCKS - 1))
        block = plane_wave_block(points, [(th, math.radians(PHI_DEG), SRC_FREQ)],
                                 b * BLOCK, BLOCK, ArrayConfig(), noise_std=0.02)
        wire = pk.build_packets(block, start_counter=b * BLOCK)
        payloads.extend(wire[i * pk.PACKET_SIZE:(i + 1) * pk.PACKET_SIZE]
                        for i in range(BLOCK))
    pc.write_pcap(path, payloads, dst_port=21844)


def _write_two_array_pcap(path: str, positions, trajectory) -> None:
    """Wire-format capture of two links (one port each, interleaved per
    sample) observing one moving world target."""
    points = ant.create_antenna_grid(8, 8, 0.02)
    payloads = []
    for b, target in enumerate(trajectory):
        per_array_wire = []
        for pos in positions:
            d = np.asarray(target, np.float64) - np.asarray(pos, np.float64)
            d /= np.linalg.norm(d)
            th, ph = math.acos(d[2]), math.atan2(d[1], d[0])
            block = plane_wave_block(points, [(th, ph, SRC_FREQ)], b * BLOCK, BLOCK,
                                     ArrayConfig(), noise_std=0.02)
            per_array_wire.append(pk.build_packets(block, start_counter=b * BLOCK))
        for i in range(BLOCK):
            for a, wire in enumerate(per_array_wire):
                payloads.append((wire[i * pk.PACKET_SIZE:(i + 1) * pk.PACKET_SIZE],
                                 21844 + a))
    pc.write_pcap(path, payloads)


def test_two_array_wire_to_geopoint_golden(tmp_path):
    """Two-array wire capture -> CLI with fusion + WARA PS NDJSON sink ->
    published GeoPoints within 1.5 m of the truth trajectory."""
    positions = [(-1.0, 0.0, 0.0), (1.0, 0.0, 0.0)]
    n = 24
    trajectory = [np.array([0.2 + 0.4 * b / (n - 1), -0.2 + 0.5 * b / (n - 1), 5.0])
                  for b in range(n)]
    cap = str(tmp_path / "two_array.pcap")
    _write_two_array_pcap(cap, positions, trajectory)
    ndjson = str(tmp_path / "telemetry.ndjson")
    lat0, lon0, alt0 = 57.76, 16.68, 10.0
    rc = main([
        "--source", "pcap", "--pcap", cap,
        "--port", "21844", "--port", "21845", "--arrays", "2",
        "--tracking", "--blocks", str(n), "--mimo-res", "16",
        "--wara-ps", "--telemetry-file", ndjson,
        "--gps", str(lat0), str(lon0), str(alt0),
        "--render-every", "4", "--device", "cpu",
    ])
    assert rc == 0
    with open(ndjson) as f:
        msgs = [json.loads(line) for line in f if line.strip()]
    geo = [m["payload"] for m in msgs if m["topic"] == "sensor/position"]
    assert geo, "no GeoPoint published"
    for g in geo:
        assert g["type"] == "GeoPoint"
        # Invert the publish transform (heading 0: out = (x, z, y)).
        x = (g["latitude"] - lat0) * 111111.0
        z = (g["longitude"] - lon0) * 111111.0 * math.cos(math.radians(lat0))
        y = g["altitude"] - alt0
        err = min(np.linalg.norm(np.array([x, y, z]) - t) for t in trajectory)
        assert err < 1.5, ((x, y, z), err)


@pytest.mark.parametrize("profile", ["default", "realtime"])
def test_wire_to_track_golden(profile, tmp_path, capsys):
    """Wire capture -> CLI -> the tracker within 2.5 deg of the end of the
    sweep, the rendered heatmap's peak within two cells of it, the MISO
    beam's tone SNR over 10 dB.  The default profile is the JAX golden's;
    the realtime one replays 12 blocks per call through the chunk kernel's
    twin, then 4 block by block."""
    from beamforming_lk_tpu_torch.io.wav import read_wav
    from beamforming_lk_tpu_torch.utils.overlay import pixel_to_direction
    from beamforming_lk_tpu_torch.utils.png import read_png

    cap = str(tmp_path / "moving_source.pcap")
    _write_moving_source_pcap(cap)
    out_dir = str(tmp_path / "frames")
    wav = str(tmp_path / "beam.wav")
    rc = main([
        "--source", "pcap", "--pcap", cap, "--port", "21844",
        "--mimo", "--tracking", "--miso",
        "--blocks", str(N_BLOCKS), "--mimo-res", str(MIMO_RES),
        "--miso-wav", wav, "--steer", "20", str(PHI_DEG),
        "--output-dir", out_dir, "--render-every", str(N_BLOCKS), "--device", "cpu",
    ] + (["--realtime"] if profile == "realtime" else []))
    assert rc == 0
    out = capsys.readouterr().out

    targets = re.findall(r"target theta=([-\d.]+) phi=([-\d.]+) power=([\d.e+-]+)", out)
    assert targets, f"no tracker targets published:\n{out}"
    best = max(targets, key=lambda t: float(t[2]))
    assert abs(float(best[0]) - THETA_DEG_END) < 2.5, best
    assert abs(float(best[1]) - PHI_DEG) < 2.5 / math.sin(math.radians(THETA_DEG_END)), best

    frames = sorted(os.listdir(out_dir))
    assert frames
    rgb = read_png(os.path.join(out_dir, frames[-1])).astype(int)
    score = rgb[..., 0] - rgb[..., 2]  # red minus blue: max at peak power
    r, c = np.unravel_index(np.argmax(score), score.shape)
    th_px, ph_px = pixel_to_direction(r, c, rgb.shape[0], 180.0)
    assert abs(math.degrees(th_px) - THETA_DEG_END) < 2 * 180.0 / MIMO_RES
    dphi = (math.degrees(ph_px) - PHI_DEG + 180.0) % 360.0 - 180.0
    assert abs(dphi) < 2 * 180.0 / (MIMO_RES * math.sin(math.radians(20.0)))

    data, rate = read_wav(wav)
    assert data.shape == (1, N_BLOCKS * BLOCK) and rate == 48828
    x = data[0] - data[0].mean()
    spec = np.abs(np.fft.rfft(x * np.hanning(x.size))) ** 2
    freqs = np.fft.rfftfreq(x.size, 1.0 / rate)
    tone = spec[np.abs(freqs - SRC_FREQ) < 100.0].sum()
    snr_db = 10.0 * np.log10(tone / max(spec.sum() - tone, 1e-30))
    assert snr_db > 10.0, f"MISO beam SNR {snr_db:.1f} dB"
