"""The port's CLI, ``python -m beamforming_lk_tpu_torch.app.cli``, on the
CPU (``--device cpu``): the JAX package's CLI cases, its sources (pcap,
UDP, native ingest), its profile and state flags, the adaptive heatmaps
(--mvdr, --music), what it refuses, and parity with the JAX CLI on one
capture and one synthetic source."""

import json
import math
import os
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from beamforming_lk_tpu_torch.app import cli  # noqa: E402
from beamforming_lk_tpu_torch.io import packets as pk  # noqa: E402
from beamforming_lk_tpu_torch.io import pcap as pc  # noqa: E402
from beamforming_lk_tpu_torch.io.synthetic import plane_wave_block  # noqa: E402
from beamforming_lk_tpu_torch.ops import antenna as ant  # noqa: E402

SOURCE_DEG = (20.0, 45.0, 5000.0)


def _main(argv):
    return cli.main(list(argv) + ["--device", "cpu"])


def _summary(out: str) -> dict:
    """The JSON summary that ``--fps`` prints."""
    start = out.index("{\n")
    return json.JSONDecoder().raw_decode(out[start:])[0]


def _source_blocks(n, channels=64, seed=0):
    points = ant.multi_array_cluster(channels, 8, 8, 0.02)
    th, ph, f = SOURCE_DEG
    rng = np.random.default_rng(seed)
    return [plane_wave_block(points, [(math.radians(th), math.radians(ph), f)],
                             b * 256, 256, noise_std=0.02, rng=rng)
            for b in range(n)]


def _write_pcap(path, blocks, port=21844):
    payloads = []
    for b, block in enumerate(blocks):
        wire = pk.build_packets(block, start_counter=b * 256)
        payloads.extend(wire[i * pk.PACKET_SIZE:(i + 1) * pk.PACKET_SIZE]
                        for i in range(block.shape[1]))
    pc.write_pcap(path, payloads, dst_port=port)


def _free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _send_when_bound(blocks, port, timeout=60.0):
    """A thread that sends ``blocks`` as wire packets to 127.0.0.1:port once
    a socket is bound there (the CLI opens its source lazily), 32 packets
    at a time, 1 ms apart, so that a busy receiver's socket buffer never
    overflows."""
    def udp_bound():
        with open("/proc/net/udp") as f:
            return any(line.split()[1].endswith(f":{port:04X}")
                       for line in f.readlines()[1:])

    def send():
        deadline = time.time() + timeout
        while not udp_bound() and time.time() < deadline:
            time.sleep(0.01)
        size = pk.PACKET_SIZE
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as sock:
            for b, block in enumerate(blocks):
                wire = pk.build_packets(block, start_counter=b * block.shape[1])
                for i in range(block.shape[1]):
                    sock.sendto(wire[i * size:(i + 1) * size], ("127.0.0.1", port))
                    if i % 32 == 31:
                        time.sleep(0.001)

    t = threading.Thread(target=send)
    t.start()
    return t


def test_cli_synthetic_smoke(tmp_path, capsys):
    out_dir = str(tmp_path / "frames")
    rc = _main(["--mimo", "--tracking", "--blocks", "6", "--mimo-res", "16",
                "--output-dir", out_dir, "--render-every", "3", "--fps",
                "--synthetic-source", "20", "45", "5000"])
    assert rc == 0
    out = capsys.readouterr().out
    summary = _summary(out)
    assert summary["blocks"] == 6 and summary["stages"]["render"]["calls"] == 2
    assert os.listdir(out_dir)
    assert "array 0: target theta=" in out


def test_cli_heatmap_chunk_replay(tmp_path, capsys):
    """--heatmap-chunk N replays N blocks per call and renders the same
    heatmap as the per-block path."""
    from beamforming_lk_tpu_torch.utils.png import read_png

    frames = {}
    for name, extra in {"plain": [], "chunk": ["--heatmap-chunk", "4"]}.items():
        out_dir = str(tmp_path / name)
        rc = _main(["--mimo", "--blocks", "8", "--mimo-res", "16", "--fps",
                    "--output-dir", out_dir, "--render-every", "8",
                    "--synthetic-source", "20", "45", "5000"] + extra)
        assert rc == 0
        assert _summary(capsys.readouterr().out)["blocks"] == 8
        files = sorted(os.listdir(out_dir))
        assert files, name
        frames[name] = read_png(os.path.join(out_dir, files[-1])).astype(int)
    assert np.abs(frames["chunk"] - frames["plain"]).max() <= 1


def test_cli_realtime_profile_and_replay_batch(monkeypatch):
    """--realtime is the port's ``realtime(cfg)`` (heatmap every 3rd block
    unless --heatmap-every says otherwise), and offline sources replay 12
    blocks per call (one chunk-kernel launch); live sources stay per
    block."""
    from beamforming_lk_tpu_torch.app import control

    seen = {}

    def fake_run(self, sources, **kw):
        seen["cfg"], seen["batch"] = self.cfg, kw["batch"]
        return {"blocks": 0}

    monkeypatch.setattr(control.ControlUnit, "run", fake_run)
    for argv, every, batch in (
        (["--tracking", "--miso", "--realtime"], 3, 12),
        (["--tracking", "--realtime", "--heatmap-every", "5"], 5, 12),
        (["--tracking", "--realtime", "--heatmap-every", "1"], 1, 12),
        (["--tracking", "--realtime", "--heatmap-every", "0"], 1, 12),
        (["--tracking", "--heatmap-every", "2"], 2, 1),
        (["--tracking"], 1, 1),
        (["--mimo", "--heatmap-chunk", "4"], 1, 4),
        (["--tracking", "--realtime", "--replay-batch", "24"], 3, 24),
    ):
        assert _main(argv + ["--source", "synthetic", "--blocks", "1",
                             "--mimo-res", "8"]) == 0
        cfg = seen["cfg"]
        assert cfg.mimo.heatmap_every == every, (argv, cfg.mimo)
        assert seen["batch"] == batch, argv
    assert cfg.tracker.probe_kernel == "pallas" and cfg.dsp.fused_chunk == 12


ADAPTIVE = ["--blocks", "6", "--mimo-res", "16", "--render-every", "3", "--fps",
            "--synthetic-source", "25", "60", "4000"]


@pytest.mark.parametrize("flag", ["--mvdr", "--music"])
def test_cli_adaptive_estimators_run(flag, tmp_path, capsys):
    """--mvdr and --music render the estimator (the JAX package's
    ``test_control.py::test_cli_mvdr_smoke``, and --music): frames written,
    6 blocks, and the estimator's options reach the pipeline."""
    from beamforming_lk_tpu_torch.app import control

    units = []
    real_init = control.ControlUnit.__init__

    def init(self, *args, **kw):
        real_init(self, *args, **kw)
        units.append(self)

    out_dir = str(tmp_path / "frames")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(control.ControlUnit, "__init__", init)
        assert _main([flag, "--output-dir", out_dir, "--music-solver", "eigh",
                      "--music-sources", "2", "--mvdr-refresh", "2"] + ADAPTIVE) == 0
    assert len(os.listdir(out_dir)) == 2
    assert _summary(capsys.readouterr().out)["blocks"] == 6
    (pipe,) = units[0].pipelines
    assert pipe.heatmap_mode == flag[2:] and pipe._mvdr_state.count == 6
    est = pipe._mvdr_step
    assert (est.weight_refresh == 2 if flag == "--mvdr"
            else (est.solver, est.n_sources) == ("eigh", 2))


@pytest.mark.parametrize("flag", ["--mvdr", "--music"])
def test_cli_adaptive_matches_jax_cli(flag, tmp_path, monkeypatch):
    """One synthetic source through both CLIs: both write their frames, and
    every rendered heatmap peaks on the same cell, the source's."""
    from beamforming_lk_tpu.app import awpu as jawpu
    from beamforming_lk_tpu.app import cli as jcli
    from beamforming_lk_tpu_torch.app import awpu

    peaks = {}
    for name, main, module, dev in (("port", cli.main, awpu, ["--device", "cpu"]),
                                    ("jax", jcli.main, jawpu, [])):
        images = _record_heatmaps(monkeypatch, module)
        out_dir = str(tmp_path / name)
        assert main([flag, "--output-dir", out_dir] + ADAPTIVE + dev) == 0
        assert len(os.listdir(out_dir)) == 2
        peaks[name] = [np.unravel_index(img.argmax(), img.shape) for img in images]
    assert peaks["port"] == peaks["jax"] and len(peaks["port"]) == 2
    theta, phi = (math.radians(a) for a in (25.0, 60.0))
    x, y = math.sin(theta) * math.cos(phi), math.sin(theta) * math.sin(phi)
    sep = 1.0 / 8              # sin(90 deg) over half the 16 rows
    want = (round(y / sep + 7.5), round(x / sep + 7.5))
    r, c = peaks["port"][-1]
    assert max(abs(r - want[0]), abs(c - want[1])) <= 1, (peaks, want)


def test_cli_defaults_to_cuda(monkeypatch):
    """Without --device the CLI runs on the card, and raises on a host
    without CUDA."""
    assert cli.build_parser().parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--blocks", "1", "--mimo-res", "8"])


def test_cli_native_ingest_source(capsys):
    """--source native on the port's build of csrc/ingest.c: every block
    sent over loopback is processed, the source ends at the ingest's 5 s
    timeout, and the summary carries the ingest counters."""
    blocks = _source_blocks(6)
    port = _free_udp_port()
    sender = _send_when_bound(blocks, port)
    rc = _main(["--source", "native", "--ip-address", "127.0.0.1", "--port",
                str(port), "--blocks", "0", "--mimo", "--tracking", "--realtime",
                "--mimo-res", "16", "--fps"])
    sender.join(timeout=30)
    assert rc == 0 and not sender.is_alive()
    summary = _summary(capsys.readouterr().out)
    (ingest,) = summary["ingest"]
    assert ingest == {"port": port, "packets_received": 6 * 256,
                      "blocks_produced": 6, "blocks_dropped": 0, "counter_gaps": 0}
    assert summary["blocks"] + ingest["blocks_dropped"] == 6


def test_cli_udp_source(capsys):
    """--source udp: the handshake takes packet 0, then whole blocks."""
    blocks = _source_blocks(3)
    port = _free_udp_port()
    sender = _send_when_bound(blocks, port)
    rc = _main(["--source", "udp", "--ip-address", "127.0.0.1", "--port", str(port),
                "--blocks", "2", "--miso", "--steer", "20", "45", "--mimo-res", "16",
                "--fps"])
    sender.join(timeout=30)
    assert rc == 0 and not sender.is_alive()
    assert _summary(capsys.readouterr().out)["blocks"] == 2


def test_cli_profile_and_state_flags(tmp_path, capsys):
    """--profile writes a torch.profiler trace; --calibrate prints the
    channels kept; --save-state / --load-state round-trip the pipeline."""
    prof = str(tmp_path / "prof")
    state = str(tmp_path / "state.npz")
    base = ["--tracking", "--miso", "--realtime", "--mimo-res", "16",
            "--synthetic-source", "20", "45", "5000"]
    rc = _main(base + ["--blocks", "12", "--calibrate", "--verbose",
                       "--profile", prof, "--save-state", state])
    assert rc == 0
    out = capsys.readouterr().out
    assert "calibration: 64/64 channels usable" in out
    with open(os.path.join(prof, "trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    with np.load(state) as data:
        # The source holds 12 blocks: 4 fill the ring for calibration.
        assert int(data[".block_index"]) == 12
    rc = _main(base + ["--blocks", "12", "--load-state", state, "--fps"])
    assert rc == 0
    assert _summary(capsys.readouterr().out)["blocks"] == 12


def _record_heatmaps(monkeypatch, awpu_module):
    """Record every ``AwpuPipeline.heatmap()`` image the control unit
    renders."""
    images = []
    real = awpu_module.AwpuPipeline.heatmap

    def heatmap(self):
        img = real(self)
        images.append(np.array(img))
        return img

    monkeypatch.setattr(awpu_module.AwpuPipeline, "heatmap", heatmap)
    return images


@pytest.mark.parametrize("profile", ["default", "realtime"])
def test_cli_matches_jax_cli(profile, tmp_path, monkeypatch):
    """One wire capture through both CLIs, the tracker off and the MISO
    listener steered: every rendered heatmap within 1 uint8 level of the
    JAX CLI's, the MISO WAVs within 2/32767 (the JAX package's batched-run
    bound)."""
    from beamforming_lk_tpu.app import awpu as jawpu
    from beamforming_lk_tpu.app import cli as jcli
    from beamforming_lk_tpu_torch.app import awpu
    from beamforming_lk_tpu_torch.io.wav import read_wav

    cap = str(tmp_path / "cap.pcap")
    _write_pcap(cap, _source_blocks(9))
    extra = ["--realtime", "--replay-batch", "1"] if profile == "realtime" else []
    runs = {}
    for name, main, module, dev in (("port", cli.main, awpu, ["--device", "cpu"]),
                                    ("jax", jcli.main, jawpu, [])):
        images = _record_heatmaps(monkeypatch, module)
        wav = str(tmp_path / f"{name}.wav")
        rc = main(["--source", "pcap", "--pcap", cap, "--port", "21844", "--mimo",
                   "--miso", "--steer", "20", "45", "--blocks", "9", "--mimo-res",
                   "16", "--render-every", "1", "--output-dir",
                   str(tmp_path / name), "--miso-wav", wav] + extra + dev)
        assert rc == 0
        runs[name] = (images, read_wav(wav)[0])
    (ours, our_wav), (theirs, their_wav) = runs["port"], runs["jax"]
    assert len(ours) == len(theirs) == 9
    for a, b in zip(ours, theirs):
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert our_wav.shape == (1, 9 * 256)
    np.testing.assert_allclose(our_wav, their_wav, rtol=0, atol=2.0 / 32767)
    assert np.abs(our_wav).max() > 1e-3
