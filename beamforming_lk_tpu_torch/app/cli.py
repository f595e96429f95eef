"""CLI entry point — ``python -m beamforming_lk_tpu_torch.app.cli``
(counterpart of ``beamforming_lk_tpu.app.cli``).

Mirrors the reference's flag surface (``src/main.cpp:19-97``: ``--mimo
--mimo-res --tracking --miso --fov --fps --port --ip-address --wara-ps
--verbose ...``) plus the source selection the reference splits across
binaries and udpreplay: ``--source synthetic|pcap|udp|native``, and
``--device cuda|cpu``: the card by default (raising on a host without
CUDA), the CPU (the kernels' plain twins) when asked for.  ``--mvdr`` and
``--music`` render the adaptive estimators (``models.mvdr``,
``models.music``) in place of the DAS heatmap, on the same device.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="beamforming_lk_tpu_torch",
        description="acoustic-array beamformer (PyTorch + CUDA)",
    )
    # Reference flags (src/main.cpp:19-97)
    p.add_argument("--mimo", action="store_true", help="enable MIMO heatmap")
    p.add_argument("--mimo-res", type=int, default=64, help="heatmap grid size")
    p.add_argument("--tracking", action="store_true", help="enable gradient tracker")
    p.add_argument("--miso", action="store_true", help="enable steered listening")
    p.add_argument("--fov", type=float, default=180.0, help="field of view [deg]")
    p.add_argument("--fps", action="store_true", help="print FPS/latency metrics")
    p.add_argument(
        "--port", type=int, action="append", default=None,
        help="UDP port per FPGA link (repeatable)",
    )
    p.add_argument("--ip-address", default="0.0.0.0")
    p.add_argument("--wara-ps", action="store_true", help="publish best track")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--flipped", action="store_true",
                   help="mirror the heatmap horizontally")
    p.add_argument("--aesthetic", action="store_true",
                   help="circular FOV mask on rendered frames")
    p.add_argument("--debug", action="store_true",
                   help="on-frame debug text (tracker count; the reference's "
                        "--debug cv::putText overlay)")
    # Source selection (replaces the synthetic ctor + udpreplay workflow)
    p.add_argument(
        "--source", choices=["synthetic", "pcap", "udp", "native"],
        default="synthetic",
    )
    p.add_argument("--pcap", default=None, help="capture file for --source pcap")
    p.add_argument("--blocks", type=int, default=256, help="blocks to process (0=endless)")
    p.add_argument("--arrays", type=int, default=1, help="number of array links")
    p.add_argument("--channels", type=int, default=64, help="mics per link")
    p.add_argument(
        "--synthetic-source", nargs=3, type=float, action="append", default=None,
        metavar=("THETA_DEG", "PHI_DEG", "FREQ_HZ"),
        help="synthetic plane-wave source (repeatable)",
    )
    p.add_argument("--noise", type=float, default=0.02, help="synthetic noise std")
    # Output
    p.add_argument("--output-dir", default=None, help="PNG frame directory")
    p.add_argument("--render-every", type=int, default=8)
    p.add_argument("--miso-wav", default=None, help="record MISO beam to WAV")
    p.add_argument("--miso-mp3", default=None,
                   help="record MISO beam to MP3 (lame/ffmpeg; degrades to "
                        "WAV-only when no encoder exists — the reference "
                        "records output.wav AND output.mp3)")
    p.add_argument("--play", choices=["raw", "miso"], default=None,
                   help="live audio playback: the mic-0 feed or the steered "
                        "MISO beam (the reference's --audio PortAudio "
                        "callbacks; degrades gracefully without a player)")
    p.add_argument("--steer", nargs=2, type=float, default=None,
                   metavar=("THETA_DEG", "PHI_DEG"), help="pin MISO direction")
    p.add_argument("--colormap", choices=["jet", "ocean"], default="jet")
    p.add_argument("--blur", type=float, default=0.0, help="gaussian blur sigma")
    p.add_argument("--mvdr", action="store_true",
                   help="adaptive (Capon) heatmap instead of DAS power")
    p.add_argument("--music", action="store_true",
                   help="MUSIC subspace DOA pseudo-spectrum heatmap")
    p.add_argument("--music-sources", type=int, default=3,
                   help="MUSIC model order K (assumed number of "
                        "simultaneous sources; slight overestimates are "
                        "benign)")
    p.add_argument("--mvdr-refresh", type=int, default=1,
                   help="recompute the Capon solve only every Nth block "
                        "(the covariance EMA still updates every block) — "
                        "the display-rate decimation of the 256-mic "
                        "Cholesky solve")
    p.add_argument("--music-solver", choices=["subspace", "eigh"],
                   default="subspace",
                   help="MUSIC decomposition: 'subspace' (default; "
                        "warm-started signal-subspace tracking) or 'eigh' "
                        "(exact full eigendecomposition per bin)")
    p.add_argument("--realtime", action="store_true",
                   help="deployment profile: bf16 compute + fft heatmap + "
                        "2-iteration tracker cadence, the swarm kernel per "
                        "block live and the chunk kernel per 12 blocks in "
                        "replay")
    p.add_argument("--phat", action="store_true",
                   help="SRP-PHAT spectral whitening for the heatmap "
                        "(robust localization; implies --heatmap-backend fft)")
    p.add_argument("--heatmap-backend", choices=["dense", "fft"],
                   default="dense",
                   help="DAS heatmap compute: dense shift-matmul or the "
                        "separable frequency-domain transform (planar-"
                        "lattice arrays, ~20x fewer FLOPs)")
    p.add_argument("--heatmap-chunk", type=int, default=0,
                   help="heatmap-only chunked streaming: beamform this many "
                        "blocks per device dispatch (needs --mimo without "
                        "--tracking/--miso)")
    p.add_argument("--heatmap-every", type=int, default=None,
                   help="display-rate heatmap decimation: recompute the "
                        "heatmap only every Nth block (tracker/MISO still "
                        "step every block; the reference UI consumes ~every "
                        "3rd map at 60 fps).  0/1 = every block (also "
                        "overriding --realtime's default of 3)")
    p.add_argument("--replay-batch", type=int, default=0,
                   help="blocks per device dispatch when replaying offline "
                        "sources (synthetic/pcap); 0 = --heatmap-chunk if "
                        "set, else per-block")
    p.add_argument("--logo", default=None, metavar="FILE.png",
                   help="composite this logo into the frame's top-left "
                        "corner (the reference's --logo overlay)")
    p.add_argument("--record", default=None, metavar="FILE.avi",
                   help="record frames to AVI (requires cv2)")
    p.add_argument("--display", action="store_true",
                   help="live cv2 window ('q' quits)")
    p.add_argument("--telemetry-file", default=None,
                   help="NDJSON sink when MQTT is unavailable")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run to "
                        "DIR/trace.json")
    p.add_argument("--calibrate", action="store_true",
                   help="auto-calibrate channel masks from the first blocks "
                        "(the reference's connect-time calibration)")
    p.add_argument("--save-state", default=None, metavar="FILE.npz",
                   help="checkpoint pipeline state at exit")
    p.add_argument("--load-state", default=None, metavar="FILE.npz",
                   help="resume pipeline state at startup")
    p.add_argument("--gps", nargs=3, type=float, default=(57.76, 16.68, 0.0),
                   metavar=("LAT", "LON", "ALT"))
    p.add_argument("--gpsd", nargs="?", const="127.0.0.1:2947", default=None,
                   metavar="HOST:PORT",
                   help="read live position/heading from gpsd (degrades "
                        "gracefully when unreachable, like the reference)")
    p.add_argument("--camera", type=int, default=None, metavar="INDEX",
                   help="composite the heatmap over this camera feed "
                        "(requires cv2)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the pipelines run: the card, or the CPU "
                        "(the kernels' plain twins)")
    return p


def make_sources(args, cfg, pipelines, ingest_stats=None):
    """One block iterator per array link.  A live source closes its socket
    when it ends or is closed; a native one then appends its ingest
    counters to ``ingest_stats``."""
    from beamforming_lk_tpu_torch.io import pcap as pc
    from beamforming_lk_tpu_torch.io.synthetic import synthetic_blocks

    n_blocks = args.blocks if args.blocks > 0 else 10**9
    if args.source == "synthetic":
        srcs = args.synthetic_source or [[20.0, 45.0, 5000.0]]
        parsed = [
            (math.radians(s[0]), math.radians(s[1]), s[2]) for s in srcs
        ]
        return [
            synthetic_blocks(
                pipe.points, parsed, n_blocks, cfg.dsp.block_size, cfg.array,
                noise_std=args.noise, seed=i,
            )
            for i, pipe in enumerate(pipelines)
        ]
    if args.source == "pcap":
        if not args.pcap:
            raise SystemExit("--source pcap requires --pcap FILE")
        ports = args.port or [None] * len(pipelines)
        return [
            pc.replay_blocks(
                args.pcap, args.channels, cfg.dsp.block_size, port=ports[i]
            )
            for i in range(len(pipelines))
        ]
    ports = args.port or [21844 + i for i in range(len(pipelines))]
    if args.source == "udp":
        from beamforming_lk_tpu_torch.io import udp

        def udp_source(port):
            sock = udp.open_receiver(args.ip_address, port, timeout=5.0)
            try:
                n_sensors, _ = udp.handshake(sock)
                yield from udp.receive_blocks(sock, n_sensors, cfg.dsp.block_size)
            finally:
                sock.close()

        return [udp_source(p) for p in ports]
    # native
    from beamforming_lk_tpu_torch.io.native import NativeIngest

    def native_source(port):
        with NativeIngest(
            args.ip_address, port, args.channels, cfg.dsp.block_size
        ) as ingest:
            try:
                for _seq, block in ingest.blocks(timeout=5.0):
                    yield block
            finally:
                if ingest_stats is not None:
                    ingest_stats.append(dict(port=port, **ingest.stats()))

    return [native_source(p) for p in ports]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from beamforming_lk_tpu_torch.config import (
        Config, MimoConfig, TrackerConfig, realtime,
    )
    from beamforming_lk_tpu_torch.app.control import ControlUnit

    # Reference default: MIMO on unless only other workers requested.
    enable_mimo = args.mimo or not (args.tracking or args.miso)
    backend = "fft" if args.phat else args.heatmap_backend
    cfg = Config(
        mimo=MimoConfig(rows=args.mimo_res, columns=args.mimo_res,
                        fov_degrees=args.fov, backend=backend,
                        phat=args.phat,
                        heatmap_chunk=max(args.heatmap_chunk, 0),
                        heatmap_every=max(args.heatmap_every or 0, 1)),
        tracker=TrackerConfig(fov_degrees=args.fov),
    )
    if args.realtime:
        cfg = realtime(cfg)
        if args.heatmap_every is not None:
            # Explicit flag overrides the profile's 3 — including
            # --heatmap-every 0/1 to force every-block recompute.
            cfg = dataclasses.replace(
                cfg, mimo=dataclasses.replace(
                    cfg.mimo, heatmap_every=max(args.heatmap_every, 1)
                )
            )
    n_arrays = max(args.arrays, len(args.port or []))
    logo = None
    if args.logo is not None:
        from beamforming_lk_tpu_torch.utils.png import read_png

        try:
            logo = read_png(args.logo)
        except (OSError, ValueError) as e:
            # Degrade like the reference's logo load error (stderr note).
            print(f"logo disabled: {e}", file=sys.stderr)
    camera = None
    if args.camera is not None:
        from beamforming_lk_tpu_torch.utils.video import CameraSource

        try:
            camera = CameraSource(args.camera)
        except RuntimeError as e:  # degrade like the reference's load errors
            print(f"camera disabled: {e}", file=sys.stderr)
    unit = ControlUnit(
        cfg,
        n_arrays=n_arrays,
        enable_mimo=enable_mimo,
        enable_tracker=args.tracking,
        enable_miso=args.miso,
        colormap=args.colormap,
        blur_sigma=args.blur,
        heatmap_mode=(
            "music" if args.music else "mvdr" if args.mvdr else "das"
        ),
        music_solver=args.music_solver,
        music_sources=args.music_sources,
        mvdr_refresh=max(args.mvdr_refresh, 1),
        flip=args.flipped,
        circle_mask=args.aesthetic,
        channels=args.channels,
        camera=camera.read if camera is not None else None,
        debug=args.debug,
        logo=logo,
        device=args.device,
    )
    if args.load_state:
        for i, pipe in enumerate(unit.pipelines):
            pipe.restore(
                args.load_state if len(unit.pipelines) == 1
                else f"{args.load_state}.{i}"
            )
    if args.steer is not None:
        for pipe in unit.pipelines:
            pipe.steer(math.radians(args.steer[0]), math.radians(args.steer[1]))

    publisher = heartbeat = gpsd = None
    if args.gpsd:
        from beamforming_lk_tpu_torch.io.gps import GpsdClient

        host, _, port = args.gpsd.partition(":")
        gpsd = GpsdClient.connect(host, int(port or 2947))
    if args.wara_ps:
        from beamforming_lk_tpu_torch.app.waraps import (
            TelemetryHeartbeat,
            TelemetrySink,
            WaraPsPublisher,
        )
        import os

        sink = TelemetrySink(
            broker=os.environ.get("MQTT_BROKER"),
            username=os.environ.get("MQTT_USERNAME"),
            password=os.environ.get("MQTT_PASSWORD"),
            fallback_path=args.telemetry_file or "telemetry.ndjson",
        )
        publisher = WaraPsPublisher(sink, *args.gps)
        heartbeat = TelemetryHeartbeat(sink)

    def on_frame(_frame):
        fix = gpsd.poll() if gpsd is not None else None
        if publisher is not None:
            if fix is not None:
                # Geo-reference tracks to the live fix (the reference reads
                # gpsd each pass, target_handler.cpp:196-206).
                publisher.update_origin(
                    fix.latitude, fix.longitude, fix.altitude, heading=fix.track
                )
            publisher.maybe_publish(unit.best_track())
        if heartbeat is not None:
            heartbeat.maybe_publish(fix)

    from beamforming_lk_tpu_torch.utils.profiling import trace

    ingest_stats = []
    sources = make_sources(args, cfg, unit.pipelines, ingest_stats)
    if args.calibrate:
        # The reference waits 4 barriers (a full ring) before calibrating.
        n_cal = cfg.dsp.history // cfg.dsp.block_size
        for pipe, src in zip(unit.pipelines, sources):
            import itertools as _it

            result = pipe.calibrate(list(_it.islice(src, n_cal)))
            if args.verbose:
                print(
                    f"calibration: {int(result.usable)}/"
                    f"{result.mask.shape[0]} channels usable"
                )
    # Offline sources can run many blocks per dispatch (the faster-than-
    # real-time udpreplay analog); live sources stay per-block.  Heatmap-
    # only pipelines batch at the heatmap chunk; fused pipelines at the
    # fused chunk (the chunked swarm kernel, docs/performance.md).
    batch = args.replay_batch
    if batch <= 0 and args.source in ("synthetic", "pcap"):
        if cfg.mimo.heatmap_chunk > 1 and not (args.tracking or args.miso):
            batch = cfg.mimo.heatmap_chunk
        elif cfg.dsp.fused_chunk > 1:
            batch = cfg.dsp.fused_chunk
    batch = max(batch, 1)
    try:
        with trace(args.profile):
            summary = unit.run(
                sources,
                n_blocks=args.blocks if args.blocks > 0 else None,
                batch=batch,
                render_every=args.render_every,
                output_dir=args.output_dir,
                on_frame=on_frame if (publisher or gpsd) else None,
                miso_wav=args.miso_wav,
                miso_mp3=args.miso_mp3,
                play=args.play,
                record_avi=args.record,
                display=args.display,
                verbose=args.verbose,
            )
    finally:
        for src in sources:
            src.close()
    if ingest_stats:
        summary["ingest"] = ingest_stats
    if gpsd is not None:
        gpsd.close()
    if camera is not None:
        camera.close()
    if args.save_state:
        for i, pipe in enumerate(unit.pipelines):
            pipe.save(
                args.save_state if len(unit.pipelines) == 1
                else f"{args.save_state}.{i}"
            )
    if args.fps or args.verbose:
        import json

        print(json.dumps(summary, indent=2))
    if args.tracking:
        for i, pipe in enumerate(unit.pipelines):
            for t in pipe.targets():
                print(
                    f"array {i}: target theta={math.degrees(t['theta']):.1f} "
                    f"phi={math.degrees(t['phi']):.1f} power={t['power']:.2e}"
                )
        best = unit.best_track()
        if best is not None:
            print(f"best track: {np.round(best.position, 2)} hits={best.hits}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
