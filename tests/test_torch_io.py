"""The port's host I/O: the wire format, pcap replay, UDP and native
ingest, WAV and playback, gpsd and WARA PS telemetry.

The copies of the JAX package's framework-neutral modules are held
bitwise against those modules on identical numpy inputs; the native ingest
runs against the port's own build of ``csrc/ingest.c``."""

import json
import os
import socket
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from beamforming_lk_tpu.io import gps as jgps  # noqa: E402
from beamforming_lk_tpu.io import packets as jpk  # noqa: E402
from beamforming_lk_tpu.io import pcap as jpc  # noqa: E402
from beamforming_lk_tpu.io import wav as jwav  # noqa: E402
from beamforming_lk_tpu_torch.io import gps  # noqa: E402
from beamforming_lk_tpu_torch.io import native  # noqa: E402
from beamforming_lk_tpu_torch.io import packets as pk  # noqa: E402
from beamforming_lk_tpu_torch.io import pcap as pc  # noqa: E402
from beamforming_lk_tpu_torch.io import udp  # noqa: E402
from beamforming_lk_tpu_torch.io.wav import WavWriter, read_wav  # noqa: E402
from beamforming_lk_tpu_torch.ops import nvcc  # noqa: E402


def _int24_blocks(seed, n, c, t, scale=2**20):
    rng = np.random.default_rng(seed)
    return [(rng.integers(-scale, scale, size=(c, t)) / 2**23).astype(np.float32)
            for _ in range(n)]


def reference_demux(stream_row, n_sensors, columns=8):
    """Scalar transcription of pipeline.cpp:277-291 for one sample."""
    out = np.zeros(n_sensors, np.float32)
    inverted = 0
    for s in range(n_sensors):
        if s % columns == 0:
            inverted = not inverted
        index = columns * (1 + s // columns) - 1 - s % columns if inverted else s
        out[s] = np.float32(stream_row[index]) / np.float32(2**23)
    return out


@pytest.mark.parametrize("channels", [64, 128, 256])
def test_wire_format_matches_jax(channels):
    """Column map, packets and their parse: bitwise the JAX package's."""
    np.testing.assert_array_equal(pk.column_flip_map(channels),
                                  jpk.column_flip_map(channels))
    stream = np.random.default_rng(0).integers(-(2**23), 2**23, size=channels)
    np.testing.assert_array_equal(
        stream[pk.column_flip_map(channels)].astype(np.float32) / np.float32(2**23),
        reference_demux(stream, channels))
    (block,) = _int24_blocks(channels, 1, channels, 24, 2**23)
    wire = pk.build_packets(block, start_counter=11)
    assert wire == jpk.build_packets(block, start_counter=11)
    got, want = (m.parse_packets(np.frombuffer(wire, np.uint8), channels)
                 for m in (pk, jpk))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert pk.parse_header(wire[:pk.PACKET_SIZE]) == (48828, channels // 64, 1, 11)


def test_packet_round_trip():
    (block,) = _int24_blocks(1, 1, 64, 32, 2**23)
    wire = pk.build_packets(block, start_counter=7)
    assert len(wire) == 32 * pk.PACKET_SIZE
    freq, n_arrays, _, counter = pk.parse_header(wire[:pk.PACKET_SIZE])
    assert (freq, n_arrays, counter) == (48828, 1, 7)
    out, counters = pk.parse_packets(np.frombuffer(wire, np.uint8), n_sensors=64)
    np.testing.assert_allclose(out, block, atol=1.0 / 2**23)
    np.testing.assert_array_equal(counters, np.arange(7, 39))


def test_pcap_matches_jax(tmp_path):
    """The capture file and its replay: bitwise the JAX package's, two links
    mixed in one file and filtered back out by port."""
    blocks = _int24_blocks(2, 3, 64, 64)
    wire = [pk.build_packets(b, start_counter=i * 64) for i, b in enumerate(blocks)]
    payloads = [(w[i * pk.PACKET_SIZE:(i + 1) * pk.PACKET_SIZE], 21844 + (i % 2))
                for w in wire for i in range(64)]
    paths = [str(tmp_path / f"{name}.pcap") for name in ("port", "jax")]
    pc.write_pcap(paths[0], payloads)
    jpc.write_pcap(paths[1], payloads)
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    for port in (21844, 21845):
        got = list(pc.replay_blocks(paths[0], 64, 32, port=port))
        want = list(jpc.replay_blocks(paths[0], 64, 32, port=port))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert list(pc.replay_blocks(paths[0], 64, 32, port=9)) == []


def test_pcap_replay_round_trip(tmp_path):
    blocks = _int24_blocks(2, 3, 64, 64)
    wire = b"".join(pk.build_packets(b, start_counter=i * 64)
                    for i, b in enumerate(blocks))
    payloads = [wire[i * pk.PACKET_SIZE:(i + 1) * pk.PACKET_SIZE]
                for i in range(len(wire) // pk.PACKET_SIZE)]
    path = str(tmp_path / "capture.pcap")
    pc.write_pcap(path, payloads, dst_port=21844)
    got = list(pc.replay_blocks(path, n_sensors=64, block_size=64, port=21844))
    assert len(got) == 3
    for g, b in zip(got, blocks):
        np.testing.assert_allclose(g, b, atol=1.0 / 2**23)


def test_udp_loopback_python():
    sock = udp.open_receiver("127.0.0.1", 0, timeout=5.0)
    port = sock.getsockname()[1]
    blocks = _int24_blocks(3, 2, 64, 16)
    sender = threading.Thread(target=udp.send_blocks, args=(blocks, "127.0.0.1", port))
    sender.start()
    n_sensors, freq = udp.handshake(sock)          # consumes packet 0
    assert (n_sensors, freq) == (64, 48828)
    got = next(udp.receive_blocks(sock, n_sensors=64, block_size=16))
    sender.join(timeout=10)
    sock.close()
    assert not sender.is_alive()
    # Sample 0 went to the handshake: the block is samples 1..16.
    want = np.concatenate(blocks, axis=1)[:, 1:17]
    np.testing.assert_allclose(got, want, atol=1.0 / 2**23)


def test_udp_resilient_resync():
    """resilient=True drops a partial block after a timeout and resumes."""
    sock = udp.open_receiver("127.0.0.1", 0, timeout=0.2)
    port = sock.getsockname()[1]
    b1, b2 = _int24_blocks(7, 2, 64, 8)
    stream = udp.receive_blocks(sock, 64, block_size=8, resilient=True)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    wire1 = pk.build_packets(b1)
    for i in range(4):
        tx.sendto(wire1[i * pk.PACKET_SIZE:(i + 1) * pk.PACKET_SIZE], ("127.0.0.1", port))

    def send_full():
        time.sleep(0.5)  # after the timeout fires
        wire2 = pk.build_packets(b2)
        for i in range(8):
            tx.sendto(wire2[i * pk.PACKET_SIZE:(i + 1) * pk.PACKET_SIZE],
                      ("127.0.0.1", port))

    t = threading.Thread(target=send_full)
    t.start()
    got = next(stream)
    t.join(timeout=10)
    sock.close()
    tx.close()
    assert not t.is_alive()
    np.testing.assert_allclose(got, b2, atol=1.0 / 2**23)


def test_native_library_builds_into_the_port():
    """The port compiles csrc/ingest.c itself into its _build directory
    under a source-hash name, never the JAX package's csrc/libingest.so."""
    lib = native.load_ingest_library()
    path = lib._name
    assert os.path.dirname(path) == nvcc.BUILD_DIR
    assert os.path.basename(path).startswith("libingest-") and path.endswith(".so")
    assert os.path.exists(path + ".log")


def test_native_ingest_raises_without_compiler(monkeypatch):
    """No compiler: NativeIngest raises, and nothing falls back to the
    Python UDP path."""
    monkeypatch.setattr(nvcc.shutil, "which", lambda name: None)
    native.load_ingest_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="C compiler"):
            native.NativeIngest("127.0.0.1", 0, n_sensors=64)
    finally:
        native.load_ingest_library.cache_clear()


def test_native_ingest_loopback():
    blocks = _int24_blocks(4, 4, 64, 32)
    with native.NativeIngest("127.0.0.1", 0, n_sensors=64, block_size=32) as ingest:
        port = ingest.port
        assert port > 0
        udp.send_blocks(blocks, "127.0.0.1", port)
        got = []
        for seq, block in ingest.blocks(timeout=2.0):
            got.append((seq, block))
            if len(got) == 4:
                break
        stats = ingest.stats()
    assert [s for s, _ in got] == [0, 1, 2, 3]
    for (_, g), b in zip(got, blocks):
        np.testing.assert_allclose(g, b, atol=1.0 / 2**23)
    assert stats == {"packets_received": 128, "blocks_produced": 4,
                     "blocks_dropped": 0, "counter_gaps": 0}


def test_native_ingest_matches_the_python_parse():
    """A 256-mic block through the C shim equals the Python demux of the
    same packets bitwise (column unflip, int24 scaling)."""
    (block,) = _int24_blocks(5, 1, 256, 16, 2**23)
    wire = pk.build_packets(block)
    want, _ = pk.parse_packets(np.frombuffer(wire, np.uint8), 256)
    with native.NativeIngest("127.0.0.1", 0, n_sensors=256, block_size=16) as ingest:
        udp.send_blocks([block], "127.0.0.1", ingest.port)
        seq, got = ingest.next_block(timeout=2.0)
    assert seq == 0
    np.testing.assert_array_equal(got, want)


def test_native_ingest_overrun_accounting():
    """Overrunning the ring drops the oldest blocks and counts them."""
    blocks = _int24_blocks(9, 8, 64, 8)
    with native.NativeIngest("127.0.0.1", 0, n_sensors=64, block_size=8,
                             n_slots=4) as ingest:
        udp.send_blocks(blocks, "127.0.0.1", ingest.port)
        deadline = time.time() + 3.0
        while time.time() < deadline and ingest.stats()["blocks_produced"] < 8:
            time.sleep(0.05)
        stats = ingest.stats()
        assert stats["blocks_produced"] == 8
        assert stats["blocks_dropped"] >= 4
        seqs = []
        for seq, block in ingest.blocks(timeout=0.3):
            seqs.append(seq)
            np.testing.assert_allclose(block, blocks[seq], atol=1.0 / 2**23)
        assert seqs == sorted(seqs) and seqs[-1] == 7
        assert len(seqs) + stats["blocks_dropped"] == 8


def test_wav_matches_jax(tmp_path):
    """WAV files bitwise the JAX package's (16 and 24 bit), and read back."""
    t = np.arange(48828, dtype=np.float32) / 48828.0
    signal = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    for bits, atol in ((24, 2.0 / 2**23), (16, 2.0 / 32767.0)):
        paths = [str(tmp_path / f"{name}{bits}.wav") for name in ("port", "jax")]
        for path, writer in zip(paths, (WavWriter, jwav.WavWriter)):
            with writer(path, channels=1, bits=bits) as w:
                for i in range(0, len(signal), 256):
                    w.write(signal[i:i + 256])
        assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
        data, rate = read_wav(paths[0])
        assert rate == 48828 and data.shape == (1, signal.size)
        np.testing.assert_allclose(data[0], signal, atol=atol)


def test_audio_player_pipes_pcm(tmp_path):
    """AudioPlayer streams s16le PCM to the player subprocess (a file
    reader stands in for aplay)."""
    from beamforming_lk_tpu_torch.io.audio_out import AudioPlayer

    out = tmp_path / "pcm.raw"
    t = np.arange(512, dtype=np.float32) / 48828.0
    sig = (0.25 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
    with AudioPlayer(command=["sh", "-c", f"cat > {out}"]) as player:
        player.play(sig[:256])
        player.play(sig[256:])
    pcm = np.frombuffer(out.read_bytes(), "<i2").astype(np.float32) / 32767.0
    np.testing.assert_allclose(pcm, sig, atol=1.0 / 32767.0)


def test_audio_player_bounded_buffer_drops():
    """A stalled consumer fills the bounded queue; further blocks are
    dropped and counted instead of stalling the block cadence."""
    from beamforming_lk_tpu_torch.io.audio_out import AudioPlayer

    p = AudioPlayer(48828.0, command=["sh", "-c", "sleep 30"], max_buffer_blocks=2)
    big = np.zeros(65536, np.float32)  # 128 KiB PCM > pipe capacity
    for _ in range(8):
        p.play(big)
    st = p.stats()
    assert st["queued"] + st["dropped"] == 8
    assert st["dropped"] >= 3 and st["max_depth"] >= 1
    p.close()
    assert p.stats()["dropped"] >= 3


_GPSD_REPORTS = [
    {"class": "SKY", "satellites": []},
    {"class": "TPV", "mode": 1},  # no fix -> ignored
    {"class": "TPV", "mode": 3, "lat": 57.7, "lon": 16.6, "alt": 12.0,
     "track": 90.0, "speed": 1.5},
    {"class": "TPV", "mode": 2, "lat": 57.75, "lon": 16.65, "altHAE": 3.0},
    {"class": "TPV", "mode": 3, "lat": 57.8, "lon": 16.7},
]


def _fake_gpsd(reports):
    """Minimal gpsd: VERSION banner, wait for ?WATCH, stream reports."""
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.bind(("127.0.0.1", 0))
    server.listen(1)
    port = server.getsockname()[1]

    def serve():
        conn, _ = server.accept()
        conn.sendall(b'{"class":"VERSION","release":"3.x"}\n')
        buf = b""
        while b"\n" not in buf:
            buf += conn.recv(1024)
        for r in reports:
            conn.sendall((json.dumps(r) + "\n").encode())
        time.sleep(0.3)
        conn.close()
        server.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    return port, t


def test_gpsd_client_parses_latest_tpv():
    port, t = _fake_gpsd(_GPSD_REPORTS)
    client = gps.GpsdClient.connect("127.0.0.1", port)
    assert client is not None
    fix = None
    for _ in range(50):
        fix = client.poll()
        if fix is not None and fix.latitude == 57.8:
            break
        time.sleep(0.02)
    assert fix == gps.GpsFix(57.8, 16.7, 0.0, 0.0, 0.0, 3)
    t.join(timeout=5)
    assert client.poll().latitude == 57.8      # sticky after the server left
    client.close()


def test_gpsd_parse_matches_jax():
    """Every report line gives the JAX package's fix, field for field."""
    a, b = socket.socketpair()
    try:
        ours, theirs = gps.GpsdClient(a), jgps.GpsdClient(b)
        for report in _GPSD_REPORTS + [{"class": "TPV", "mode": 3, "lat": 1.0}]:
            line = json.dumps(report).encode()
            ours._handle(line)
            theirs._handle(line)
            assert ours._fix == theirs._fix
            assert ours._fix is None or tuple(ours._fix) == tuple(theirs._fix)
        ours._handle(b"not json")
        assert tuple(ours._fix) == tuple(theirs._fix)
    finally:
        a.close()
        b.close()


def test_gpsd_connect_degrades_gracefully():
    assert gps.GpsdClient.connect("127.0.0.1", 1, timeout=0.2) is None


def test_telemetry_heartbeat_rate_limits(tmp_path):
    from beamforming_lk_tpu_torch.app.waraps import TelemetryHeartbeat, TelemetrySink

    path = str(tmp_path / "telemetry.ndjson")
    sink = TelemetrySink(fallback_path=path)
    hb = TelemetryHeartbeat(sink, interval=1.0)
    fix = gps.GpsFix(57.7, 16.6, 10.0, 45.0, 2.0, 3)
    assert hb.maybe_publish(fix, now=0.0)
    assert not hb.maybe_publish(fix, now=0.5)
    assert not hb.maybe_publish(None, now=2.0)
    assert hb.maybe_publish(fix, now=2.0)
    sink.close()
    lines = [json.loads(line) for line in open(path)]
    assert len(lines) == 2
    assert lines[0]["payload"]["heading"] == 45.0
    assert lines[0]["payload"]["latitude"] == 57.7


def test_waraps_publisher_matches_jax(tmp_path):
    """The published GeoPoints of a best track, with a heading and an origin
    update, equal the JAX package's publisher's."""
    from beamforming_lk_tpu.app import waraps as jw
    from beamforming_lk_tpu_torch.app import waraps as tw
    from beamforming_lk_tpu_torch.models.fusion import Track

    lines = {}
    for name, mod in (("port", tw), ("jax", jw)):
        path = str(tmp_path / f"{name}.ndjson")
        sink = mod.TelemetrySink(fallback_path=path)
        pub = mod.WaraPsPublisher(sink, 57.76, 16.68, 10.0, heading=0.3)
        track = Track(np.array([0.4, 0.6, 6.0]), 0.0)
        assert pub.maybe_publish(track, now=0.0)
        assert not pub.maybe_publish(track, now=0.2)
        assert not pub.maybe_publish(None, now=1.0)
        pub.update_origin(57.8, 16.7, 12.0, heading=1.1)
        assert pub.maybe_publish(track, now=1.0)
        sink.close()
        lines[name] = open(path).read()
    assert lines["port"] == lines["jax"]
    assert lines["port"].count("GeoPoint") == 2
