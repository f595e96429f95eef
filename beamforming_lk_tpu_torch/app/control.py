"""Control unit: multi-array orchestration, rendering, recording, fusion
(counterpart of ``beamforming_lk_tpu.app.control``).

Re-design of the reference's ``AWControlUnit`` (``src/aw_control_unit/
aw_control_unit.cpp``): one AWPU pipeline per source link, TargetHandler
fusion at >= 2 arrays (registered at the same hardcoded +/-1 m x-offsets,
``aw_control_unit.cpp:261-265``), and the render loop (per-AWPU heatmap ->
upscale -> blur -> colormap -> hconcat -> FPS meter,
``aw_control_unit.cpp:277-441``) — but headless-first: frames are numpy RGB
arrays handed to a callback / PNG sequence / optional cv2 window, and every
step is observable through :class:`BlockMetrics` and a :class:`StageTimer`
(ingest, the step's host enqueue, the wait for the device, fusion, audio,
render).

The pipelines, the fusion and the Kalman filter run on ``device``, the
card unless the CPU is asked for.  A block's device work is waited on with
one ``torch.cuda.synchronize`` (on the card) before its latency is taken,
and each batch's MISO beam is fetched to the host once.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from beamforming_lk_tpu_torch.app.awpu import AwpuPipeline
from beamforming_lk_tpu_torch.config import Config
from beamforming_lk_tpu_torch.device import resolve_device
from beamforming_lk_tpu_torch.models.fusion import TargetFusion
from beamforming_lk_tpu_torch.models.kalman import KalmanFilter3D
from beamforming_lk_tpu_torch.utils.colormap import (
    apply_colormap,
    gaussian_blur,
    jet_lut,
    ocean_lut,
    upscale,
)
from beamforming_lk_tpu_torch.utils.metrics import BlockMetrics, FpsMeter
from beamforming_lk_tpu_torch.utils.png import write_png
from beamforming_lk_tpu_torch.utils.profiling import StageTimer


class ControlUnit:
    """Top-level app: feeds per-array block sources through AWPU pipelines,
    fuses targets, renders frames.

    ``heatmap_mode`` "mvdr" or "music" renders each pipeline's adaptive
    estimator in place of the DAS heatmap, with ``mvdr_refresh``,
    ``music_solver`` and ``music_sources`` passed on to it.

    ``mesh`` (one control unit a rank, each built with the same arguments)
    shards every pipeline over it; the mesh's first rank alone writes the
    frames, the WAV, MP3 and AVI, plays the audio and calls ``on_frame``
    (the CLI's WARA PS and telemetry), while every rank runs the same
    steps and renders (the heatmap gathers over ``dir``).  The live window
    (``display``) runs without a mesh: its keys would stop one rank."""

    def __init__(
        self,
        cfg: Config,
        n_arrays: int = 1,
        enable_mimo: bool = True,
        enable_tracker: bool = True,
        enable_miso: bool = False,
        array_positions: Optional[Sequence] = None,
        colormap: str = "jet",
        blur_sigma: float = 0.0,
        frame_size: int = 256,
        mesh=None,
        seed: int = 0,
        heatmap_mode: str = "das",
        music_solver: str = "subspace",
        music_sources: int = 3,
        mvdr_refresh: int = 1,
        flip: bool = False,
        circle_mask: bool = False,
        channels: Optional[int] = None,
        camera: Optional[Callable[[], Optional[np.ndarray]]] = None,
        debug: bool = False,
        logo: Optional[np.ndarray] = None,
        device="cuda",
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.flip = flip
        self.circle_mask = circle_mask
        # On-frame debug text (tracker count), aw_control_unit.cpp:336-350.
        self.debug = debug
        # Camera underlay: a callable returning the current RGB camera
        # frame (or None) — the heatmap is alpha-blended over it
        # (the reference's --camera compositing, aw_control_unit.cpp).
        self.camera = camera
        self.pipelines: List[AwpuPipeline] = [
            AwpuPipeline(
                cfg,
                mesh=mesh,
                seed=seed + i,
                enable_mimo=enable_mimo,
                enable_tracker=enable_tracker,
                enable_miso=enable_miso,
                heatmap_mode=heatmap_mode,
                channels=channels,
                music_solver=music_solver,
                music_sources=music_sources,
                mvdr_refresh=mvdr_refresh,
                device=self.device,
            )
            for i in range(n_arrays)
        ]
        self.mesh = mesh
        self.metrics = BlockMetrics(cfg.dsp.block_size, cfg.array.sample_rate)
        self.stages = StageTimer()
        self.fps = FpsMeter()
        # Logo overlay, composited into the top-left frame corner (the
        # reference's --logo cv::imread + corner copy,
        # src/main.cpp:19-97 / aw_control_unit.cpp).  RGB or RGBA uint8;
        # scaled to ~1/6 of the frame height.
        self._logo = None
        if logo is not None:
            from beamforming_lk_tpu_torch.utils.overlay import nearest_resize

            logo = np.asarray(logo)
            if logo.ndim == 2:
                logo = np.repeat(logo[..., None], 3, axis=-1)
            lh = max(frame_size // 6, 1)
            lw = max(int(round(logo.shape[1] * lh / logo.shape[0])), 1)
            self._logo = nearest_resize(logo.astype(np.uint8), (lh, lw))
        self.lut = ocean_lut() if colormap == "ocean" else jet_lut()
        self.blur_sigma = blur_sigma
        self.frame_size = frame_size
        # Kalman smoothing of the best track (the reference smooths/leads the
        # oldest tracker's direction in the heatmap UI,
        # gradient_ascend.cpp:242-246; here it runs on the fused 3D track).
        self._kf = KalmanFilter3D(dt=cfg.dsp.block_seconds, device=self.device)
        self._kf_state = None
        self.fusion: Optional[TargetFusion] = None
        if n_arrays >= 2 and enable_tracker:
            # Reference registers 2 AWPUs at +/-1 m x-offsets
            # (aw_control_unit.cpp:261-265).
            if array_positions is None:
                # i=0 -> -1 m, i=1 -> +1 m, i=2 -> -2 m, ...
                array_positions = [
                    ((-1.0) ** (i + 1) * (1.0 + i // 2), 0.0, 0.0)
                    for i in range(n_arrays)
                ]
            self.fusion = TargetFusion(cfg.triangulation, device=self.device)
            for pipe, pos in zip(self.pipelines, array_positions):
                self.fusion.add_array(pipe, pos)

    def _sync(self) -> None:
        """Wait for the device work enqueued so far (nothing to wait for on
        the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _fuse(self, now: float) -> None:
        if self.fusion is None:
            return
        with self.stages.stage("fusion"):
            best = self.fusion.step(now)
            if best is not None and best.valid:
                if self._kf_state is None:
                    self._kf_state = self._kf.init()
                self._kf_state = self._kf.update(
                    self._kf_state, np.asarray(best.position, np.float32)
                )

    def process(self, blocks: Sequence[np.ndarray], now: float = 0.0,
                sync: bool = True):
        """Feed one [C, T] block per array; returns per-array outputs.

        ``sync=False`` leaves the dispatch asynchronous — the device queue
        absorbs host jitter (the replacement for the reference's condvar
        barrier tolerance; SURVEY §7 "real-time host-device feeding").
        Latency metrics are only meaningful on synced blocks.
        """
        self.metrics.start_block()
        with self.stages.stage("step"):
            outs = [p.process_block(b) for p, b in zip(self.pipelines, blocks)]
        if sync:
            with self.stages.stage("sync"):
                self._sync()       # honest latency accounting
        self.metrics.end_block()
        self._fuse(now)
        return outs

    def process_batch(self, blocks: Sequence[np.ndarray], now: float = 0.0):
        """Feed M stacked blocks [M, C, T] per array in ONE call each
        (:meth:`AwpuPipeline.process_blocks` — the chunked replay path).
        Returns per-array stacked outputs; fusion and the KF see the final
        block's targets (``pipe.last``)."""
        m = int(blocks[0].shape[0])
        self.metrics.start_block()
        with self.stages.stage("step"):
            outs = [p.process_blocks(b) for p, b in zip(self.pipelines, blocks)]
        with self.stages.stage("sync"):
            self._sync()           # honest amortized latency
        self.metrics.end_block(n=m)
        self._fuse(now)
        return outs

    def render_frame(
        self, flip: Optional[bool] = None, circle_mask: Optional[bool] = None
    ) -> np.ndarray:
        """Compose the current heatmaps into one RGB frame
        (draw path: aw_processing_unit.cpp:245-259 + UI loop).

        ``flip`` mirrors horizontally (the reference's ``--flipped`` for
        rear-mounted arrays); ``circle_mask`` blanks pixels outside the FOV
        disc (the ``--aesthetic`` circular mask,
        aw_control_unit.cpp:320-330)."""
        from beamforming_lk_tpu_torch.utils.overlay import (
            blend_underlay,
            nearest_resize,
            overlay_targets,
        )

        flip = self.flip if flip is None else flip
        circle_mask = self.circle_mask if circle_mask is None else circle_mask
        cam_frame = self.camera() if self.camera is not None else None
        tiles = []
        for tile_i, pipe in enumerate(self.pipelines):
            img = pipe.heatmap()
            img = upscale(img, (self.frame_size, self.frame_size))
            if self.blur_sigma > 0:
                img = gaussian_blur(img, self.blur_sigma)
            rgb = apply_colormap(img, self.lut)
            camera_tile = cam_frame is not None and tile_i == 0
            if camera_tile:
                # Composite the heatmap over the (square-resized) camera view
                # — camera mode replaces the circular mask in the reference
                # (only on THIS tile; other tiles keep their mask).
                cam_sq = nearest_resize(cam_frame, (self.frame_size, self.frame_size))
                rgb = blend_underlay(cam_sq, rgb)
            if circle_mask and not camera_tile:
                n = self.frame_size
                yy, xx = np.mgrid[0:n, 0:n]
                r = (2.0 * xx / (n - 1) - 1.0) ** 2 + (2.0 * yy / (n - 1) - 1.0) ** 2
                rgb = np.where(r[..., None] <= 1.0, rgb, 0).astype(np.uint8)
            if flip:
                rgb = np.ascontiguousarray(rgb[:, ::-1])
            # Tracker squares / oldest crosshair / MISO circle
            # (gradient_ascend.cpp:157-293, miso.cpp:57-77).
            targets = pipe.targets()
            miso_dir = None
            if pipe.last is not None and pipe.miso_enabled:
                p = pipe.state.miso.particle
                miso_dir = tuple(torch.cat([p.theta[:1], p.phi[:1]]).cpu().tolist())
            if targets or miso_dir is not None:
                overlay_targets(
                    rgb, targets, self.cfg.mimo.fov_degrees,
                    miso_direction=miso_dir, flip=flip,
                    now_block=float(pipe.state.block_index),
                    block_seconds=self.cfg.dsp.block_seconds,
                )
            if self.debug:
                # Tracker-count debug text, top-left of each tile (the
                # reference's on-frame cv::putText count,
                # aw_control_unit.cpp:336-350).
                from beamforming_lk_tpu_torch.utils.overlay import draw_text

                draw_text(rgb, 4, 4, f"{len(targets)}s", (255, 255, 255),
                          scale=2)
            tiles.append(rgb)
        self.fps.tick()
        frame = np.concatenate(tiles, axis=1) if len(tiles) > 1 else tiles[0]
        if self._logo is not None:
            frame = frame.copy()
            lg = self._logo
            lh, lw = lg.shape[:2]
            region = frame[:lh, :lw]
            if lg.shape[-1] == 4:  # alpha composite
                a = lg[..., 3:4].astype(np.float32) / 255.0
                region[:] = (
                    a * lg[..., :3] + (1.0 - a) * region
                ).astype(np.uint8)
            else:
                region[:] = lg
        return frame

    def handle_click(self, row: int, col: int) -> Optional[tuple]:
        """Steer the clicked tile's MISO listener at a rendered-frame pixel
        (the reference's ``clickEvent``, aw_control_unit.cpp:30-47).

        ``(row, col)`` indexes the hconcat frame from :meth:`render_frame`;
        returns the ``(array_index, theta, phi)`` steered, or None for
        clicks outside the frame."""
        from beamforming_lk_tpu_torch.utils.overlay import pixel_to_direction

        n = self.frame_size
        tile = int(col) // n
        if not (0 <= tile < len(self.pipelines)) or not (0 <= row < n):
            return None
        tcol = int(col) % n
        if self.flip:  # render mirrors columns; un-mirror the click
            tcol = n - 1 - tcol
        theta, phi = pixel_to_direction(
            row, tcol, n, self.cfg.mimo.fov_degrees
        )
        self.pipelines[tile].steer(theta, phi)
        return tile, theta, phi

    @staticmethod
    def _toggle_record(recorder, record_avi, record_count):
        """Start/stop AVI capture (the reference's runtime 'r' toggle,
        aw_control_unit.cpp:150-162).  Returns the new (recorder, count);
        re-starts write numbered siblings of the base path so an earlier
        capture is never overwritten."""
        if recorder is not None:
            recorder.close()
            print("recording stopped", file=sys.stderr)
            return None, record_count
        from beamforming_lk_tpu_torch.utils.video import VideoRecorder

        base = record_avi or "recording.avi"
        root, ext = os.path.splitext(base)
        path = base if record_count == 0 else f"{root}_{record_count}{ext}"
        try:
            recorder = VideoRecorder(path)
        except RuntimeError as e:  # no cv2 — degrade like the reference
            print(f"recording unavailable: {e}", file=sys.stderr)
            return None, record_count
        print(f"recording started: {path}", file=sys.stderr)
        return recorder, record_count + 1

    def best_track(self):
        return self.fusion.store.best if self.fusion is not None else None

    def smoothed_best(self, lead_seconds: float = 0.0):
        """KF-smoothed best-track position, optionally extrapolated ahead
        (the reference's lead circle, gradient_ascend.cpp:242-246)."""
        if self._kf_state is None:
            return None
        if lead_seconds > 0.0:
            pos = self._kf.predict_time(self._kf_state, lead_seconds)
        else:
            pos = self._kf.position(self._kf_state)
        return pos.cpu().numpy()

    def run(
        self,
        sources: Sequence,
        n_blocks: Optional[int] = None,
        render_every: int = 4,
        output_dir: Optional[str] = None,
        on_frame: Optional[Callable[[np.ndarray], None]] = None,
        miso_wav: Optional[str] = None,
        miso_mp3: Optional[str] = None,
        record_avi: Optional[str] = None,
        display: bool = False,
        verbose: bool = False,
        sync_every: int = 1,
        play: Optional[str] = None,
        player_command: Optional[Sequence[str]] = None,
        mp3_command: Optional[Sequence[str]] = None,
        batch: int = 1,
    ) -> dict:
        """Drive block iterators (one per array) to completion.

        ``sources``: iterables of [C, T] blocks (synthetic generator, pcap
        replay, UDP receiver, native ingest — anything).  Returns the final
        metrics summary, with the host stages' times under ``"stages"`` and,
        where the run rendered two frames or more, the rendered frame rate
        (:attr:`fps`, an EMA) under ``"render_fps"``.

        ``play``: live playback through :class:`io.audio_out.AudioPlayer` —
        ``"miso"`` streams the steered beam, ``"raw"`` streams mic 0 of
        array 0 (the reference's two PortAudio callbacks,
        audio_wrapper.cpp:93-143); degrades with a warning when no player
        exists.  ``miso_mp3`` records the beam as MP3 alongside the WAV
        (audio_wrapper.cpp:12-85), degrading likewise without an encoder.

        ``batch`` > 1 feeds that many blocks per call through
        :meth:`process_batch` — the offline-replay throughput path (the
        udpreplay analog runs faster than real time this way; 12 blocks a
        launch of the chunk kernel in the realtime profile, and with
        ``MimoConfig.heatmap_chunk`` set and tracker/MISO off the batched
        heatmap).  Rendering/fusion then see state at batch granularity.

        Under a mesh every rank takes the same steps and renders the same
        frames (a frame gathers over the mesh); only the first rank writes
        or plays anything.
        """
        if self.mesh is not None and display:
            raise ValueError("the live display runs without a mesh")
        root = all(p.is_root for p in self.pipelines)
        wav = None
        if miso_wav is not None and root:
            from beamforming_lk_tpu_torch.io.wav import WavWriter

            wav = WavWriter(miso_wav, self.cfg.array.sample_rate)
        mp3 = player = None
        if miso_mp3 is not None and root:
            from beamforming_lk_tpu_torch.io.audio_out import Mp3Recorder

            try:
                mp3 = Mp3Recorder(
                    miso_mp3, self.cfg.array.sample_rate, command=mp3_command
                )
            except RuntimeError as e:
                print(f"mp3 recording disabled: {e}", file=sys.stderr)
        if play is not None and play not in ("raw", "miso"):
            raise ValueError(f"play must be 'raw' or 'miso', got {play!r}")
        if play is not None and root:
            from beamforming_lk_tpu_torch.io.audio_out import AudioPlayer

            try:
                player = AudioPlayer(
                    self.cfg.array.sample_rate, command=player_command
                )
            except RuntimeError as e:
                print(f"audio playback disabled: {e}", file=sys.stderr)
                play = None
        recorder = screen = None
        record_count = 0
        if record_avi is not None and root:
            from beamforming_lk_tpu_torch.utils.video import VideoRecorder

            recorder = VideoRecorder(record_avi)
            record_count = 1
        if display:
            from beamforming_lk_tpu_torch.utils.video import LiveDisplay

            screen = LiveDisplay()
        if output_dir is not None and root:
            os.makedirs(output_dir, exist_ok=True)
        import itertools as _it

        iters = [iter(s) for s in sources]
        i = 0
        batch = max(int(batch), 1)
        player_ref = player  # stats survive playback-error degrade
        try:
            while n_blocks is None or i < n_blocks:
                want = (
                    batch if n_blocks is None else min(batch, n_blocks - i)
                )
                with self.stages.stage("ingest"):
                    per_source = [list(_it.islice(it, want)) for it in iters]
                k = min((len(g) for g in per_source), default=0)
                if k == 0:
                    break
                per_source = [g[:k] for g in per_source]
                now = i * self.cfg.dsp.block_seconds
                if k == 1 and batch == 1:
                    outs = self.process(
                        [g[0] for g in per_source], now=now,
                        sync=((i + 1) % max(sync_every, 1) == 0),
                    )
                else:
                    outs = self.process_batch(
                        [np.stack(g) for g in per_source], now=now
                    )
                if wav is not None or mp3 is not None or player is not None:
                    with self.stages.stage("audio"):
                        # [T] single or [M, T] stacked; fetched once.
                        beam = (outs[0].miso_beam.reshape(-1).cpu().numpy()
                                if wav is not None or mp3 is not None
                                or play == "miso" else None)
                        if wav is not None:
                            wav.write(beam)
                        if mp3 is not None:
                            mp3.write(beam)
                        if player is not None:
                            try:
                                if play == "miso":
                                    player.play(beam)
                                else:  # raw: mic 0 of array 0 (audioCallback)
                                    player.play(
                                        np.concatenate(
                                            [np.asarray(b)[0] for b in per_source[0]]
                                        )
                                    )
                            except RuntimeError as e:
                                print(f"audio playback stopped: {e}",
                                      file=sys.stderr)
                                player = None
                want_frame = (
                    output_dir is not None or on_frame is not None
                    or record_avi is not None or recorder is not None
                    or screen is not None
                )
                rendered_boundary = (i + k) // render_every != i // render_every
                if rendered_boundary and want_frame:
                    with self.stages.stage("render"):
                        frame = self.render_frame()
                        if output_dir is not None and root:
                            write_png(
                                os.path.join(
                                    output_dir, f"frame_{i + k - 1:06d}.png"
                                ),
                                frame,
                            )
                        if recorder is not None:
                            recorder.write(frame)
                    if screen is not None:
                        key = screen.show(frame)
                        if key == "q":
                            break  # reference UI: 'q' quits
                        if key == "r":
                            # Runtime record toggle (the reference's 'r' key
                            # starts/stops AVI capture mid-run,
                            # aw_control_unit.cpp:150-162).  --record makes
                            # the run start already recording; each re-start
                            # opens a fresh numbered file.
                            recorder, record_count = self._toggle_record(
                                recorder, record_avi, record_count
                            )
                        for r, c in screen.pop_clicks():
                            self.handle_click(r, c)  # click-to-steer
                    if on_frame is not None and root:
                        on_frame(frame)
                if verbose and root and (i + k) // 64 != i // 64:
                    s = self.metrics.summary()
                    print(
                        f"block {i + k}: {s['blocks_per_s']:.1f} blocks/s "
                        f"({s['realtime_factor']:.2f}x realtime), "
                        f"p50 {s['latency_p50_ms']:.2f} ms"
                    )
                i += k
        finally:
            if wav is not None:
                wav.close()
            if mp3 is not None:
                mp3.close()
            if player_ref is not None:
                player_ref.close()
            if recorder is not None:
                recorder.close()
            if screen is not None:
                screen.close()
        summary = self.metrics.summary()
        summary["stages"] = self.stages.summary()
        if self.stages.counts.get("render", 0) >= 2:
            summary["render_fps"] = self.fps.fps
        if player_ref is not None:
            # Playback buffer health (bounded queue: played/dropped/depth),
            # same story as the ingest drop counters.
            summary["audio"] = player_ref.stats()
        return summary
