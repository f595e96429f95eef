"""Live audio playback + MP3 recording of the MISO beam (optional).

The reference plays the beam through PortAudio callbacks and simultaneously
records ``output.wav`` AND ``output.mp3``
(``src/audio/audio_wrapper.cpp:12-85,93-143``).  A compute framework
shouldn't hard-depend on a sound stack, so playback here is a thin pipe to
``aplay`` (ALSA) — or any compatible PCM-on-stdin player — and MP3 encoding
pipes to ``lame``/``ffmpeg`` when present, both degrading gracefully when
the binary/sound device is missing (the WAV recorder in io/wav.py is the
always-available sink).

A copy of ``beamforming_lk_tpu.io.audio_out`` (numpy and the standard
library only), kept in the port so that the port loads no module of the
JAX package.
"""

from __future__ import annotations

import queue
import shutil
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np


def default_player_command(sample_rate: float) -> Optional[Sequence[str]]:
    """The aplay invocation for mono float->s16le blocks, or None if no
    player binary is available."""
    if shutil.which("aplay") is None:
        return None
    return [
        "aplay", "-q", "-f", "S16_LE", "-r", str(int(round(sample_rate))),
        "-c", "1", "-t", "raw", "-",
    ]


class AudioPlayer:
    """Streams float blocks to a PCM player subprocess through a BOUNDED
    queue with real-time drop semantics.

    The reference's PortAudio callback is clocked by the audio device with a
    fixed-size buffer (``src/audio/audio_wrapper.cpp:93-143``) — a stalled
    consumer can never back up the compute thread.  Piping straight into
    ``aplay`` loses that contract: blocks queue unboundedly in the pipe.
    Here a writer thread drains a ``max_buffer_blocks``-deep queue into the
    player; when the consumer falls behind, :meth:`play` DROPS the block
    and counts it (the same health story as the ingest ring's drop
    counters, ``csrc/ingest.c``) instead of stalling the 5.24 ms block
    cadence.  :meth:`stats` exposes played/dropped/queue-depth counters,
    surfaced in the run summary (``app/control.py``).

    ``command`` overrides the player (tests pipe to a file reader); raises
    RuntimeError when no player is available and none is given.
    """

    def __init__(
        self,
        sample_rate: float = 48828.0,
        command: Optional[Sequence[str]] = None,
        max_buffer_blocks: int = 8,
    ):
        if command is None:
            command = default_player_command(sample_rate)
        if command is None:
            raise RuntimeError(
                "no audio player available (aplay not found); "
                "record with io.wav.WavWriter instead"
            )
        self._proc = subprocess.Popen(
            list(command), stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        self._queue: "queue.Queue[Optional[bytes]]" = queue.Queue(
            maxsize=max(int(max_buffer_blocks), 1)
        )
        self._queued = 0
        self._played = 0
        self._dropped = 0
        self._max_depth = 0
        self._error: Optional[BaseException] = None
        self._writer = threading.Thread(target=self._drain, daemon=True)
        self._writer.start()

    def _drain(self) -> None:
        while True:
            pcm = self._queue.get()
            if pcm is None:
                return
            if self._error is not None:
                continue  # keep emptying so close() cannot hang
            try:
                self._proc.stdin.write(pcm)
                self._proc.stdin.flush()
                self._played += 1
            except (BrokenPipeError, OSError, ValueError) as e:
                self._error = e

    def play(self, block) -> None:
        """Queue one float block [T] in [-1, 1].

        Never blocks: a full buffer (consumer behind real time) drops the
        block and bumps the ``dropped`` counter.  Raises RuntimeError once
        the player process has exited (callers degrade gracefully)."""
        if self._error is not None:
            raise RuntimeError("audio player exited") from self._error
        data = np.clip(np.asarray(block, np.float32), -1.0, 1.0)
        pcm = np.round(data * 32767.0).astype("<i2").tobytes()
        self._max_depth = max(self._max_depth, self._queue.qsize())
        try:
            self._queue.put_nowait(pcm)
            self._queued += 1
        except queue.Full:
            self._dropped += 1

    def stats(self) -> dict:
        """Buffer health counters: blocks queued/played/dropped, current
        and high-water queue depth (the AudioWrapper buffer accounting the
        reference's fixed PortAudio ring gives for free)."""
        return {
            "queued": self._queued,
            "played": self._played,
            "dropped": self._dropped,
            "depth": self._queue.qsize(),
            "max_depth": self._max_depth,
        }

    def close(self) -> None:
        sent = True
        try:
            self._queue.put_nowait(None)
        except queue.Full:
            sent = False
        self._writer.join(timeout=2)
        if self._writer.is_alive():
            # Consumer wedged mid-write on a full pipe: kill the player so
            # the blocked write fails and the writer drains out.
            self._proc.terminate()
            if not sent:
                try:
                    self._queue.put(None, timeout=5)
                except queue.Full:
                    pass
            self._writer.join(timeout=5)
        if self._proc.stdin and not self._writer.is_alive():
            try:
                self._proc.stdin.close()
            except (BrokenPipeError, OSError):
                pass
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait(timeout=10)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def default_encoder_command(path: str, sample_rate: float) -> Optional[Sequence[str]]:
    """An MP3 encoder reading s16le PCM on stdin (``lame`` preferred, the
    reference's encoder, audio_wrapper.cpp:46-63; ``ffmpeg`` fallback), or
    None when neither binary exists."""
    rate = int(round(sample_rate))
    if shutil.which("lame") is not None:
        return ["lame", "-r", "-s", str(rate), "-m", "m", "--signed",
                "--bitwidth", "16", "--little-endian", "-", path]
    if shutil.which("ffmpeg") is not None:
        return ["ffmpeg", "-loglevel", "quiet", "-y", "-f", "s16le",
                "-ar", str(rate), "-ac", "1", "-i", "-", path]
    return None


class Mp3Recorder:
    """Streams float blocks to an MP3 encoder subprocess
    (audio_wrapper.cpp:12-85 records output.mp3 alongside output.wav).

    ``command`` overrides the encoder (tests substitute a PCM sink); raises
    RuntimeError when no encoder is available and none is given — callers
    degrade to WAV-only.
    """

    def __init__(
        self,
        path: str,
        sample_rate: float = 48828.0,
        command: Optional[Sequence[str]] = None,
    ):
        if command is None:
            command = default_encoder_command(path, sample_rate)
        if command is None:
            raise RuntimeError(
                "no MP3 encoder available (lame/ffmpeg not found); "
                "record with io.wav.WavWriter instead"
            )
        self.path = path
        self._proc = subprocess.Popen(
            list(command), stdin=subprocess.PIPE,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )

    def write(self, block) -> None:
        """Append one float block [T] in [-1, 1]."""
        data = np.clip(np.asarray(block, np.float32), -1.0, 1.0)
        pcm = np.round(data * 32767.0).astype("<i2").tobytes()
        try:
            self._proc.stdin.write(pcm)
        except BrokenPipeError as e:
            raise RuntimeError("MP3 encoder exited") from e

    def close(self) -> None:
        if self._proc.stdin:
            try:
                self._proc.stdin.close()
            except BrokenPipeError:
                pass
        self._proc.wait(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
