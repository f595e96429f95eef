"""Audio output: WAV recording of the MISO beam / raw channels.

The reference plays the beam through PortAudio and simultaneously flushes
~3 s chunks to ``output.wav`` (libsndfile) and ``output.mp3`` (LAME)
(``src/audio/audio_wrapper.cpp:12-85, 275-287``).  Here recording is a
dependency-free stdlib ``wave`` writer (float blocks -> 16/24-bit PCM);
playback and MP3 are out of scope for a compute framework (WAV is the
interchange format; SURVEY §2.4).

A copy of ``beamforming_lk_tpu.io.wav`` (numpy and the standard library
only), kept in the port so that the port loads no module of the JAX
package.
"""

from __future__ import annotations

import wave
from typing import Optional

import numpy as np


class WavWriter:
    """Streaming mono/multichannel WAV sink with block-buffered flushes.

    Mirrors the reference's buffered ``processAudioData`` flush behavior
    (audio_wrapper.cpp:275-287) without the audio-callback thread.
    """

    def __init__(
        self,
        path: str,
        sample_rate: float = 48828.0,
        channels: int = 1,
        bits: int = 24,
        flush_seconds: float = 3.0,  # BUFFER_THRESHOLD analog (audio_wrapper.h:24)
    ):
        if bits not in (16, 24):
            raise ValueError("bits must be 16 or 24")
        self.path = path
        self.bits = bits
        self.channels = channels
        self._wave = wave.open(path, "wb")
        self._wave.setnchannels(channels)
        self._wave.setsampwidth(bits // 8)
        self._wave.setframerate(int(round(sample_rate)))
        self._pending: list = []
        self._pending_samples = 0
        self._flush_samples = int(flush_seconds * sample_rate)
        self.frames_written = 0

    def write(self, block) -> None:
        """Append a float block [T] (mono) or [channels, T]."""
        block = np.asarray(block, np.float32)
        if block.ndim == 1:
            block = block[None, :]
        if block.shape[0] != self.channels:
            raise ValueError(f"expected {self.channels} channels, got {block.shape[0]}")
        self._pending.append(block)
        self._pending_samples += block.shape[1]
        if self._pending_samples >= self._flush_samples:
            self.flush()

    def _encode(self, data: np.ndarray) -> bytes:
        # data [C, T] -> interleaved frames
        clipped = np.clip(data.T, -1.0, 1.0)           # [T, C]
        if self.bits == 16:
            ints = np.round(clipped * 32767.0).astype("<i2")
            return ints.tobytes()
        ints = np.round(clipped * float(2**23 - 1)).astype("<i4")
        raw = ints.astype("<i4").tobytes()
        b = np.frombuffer(raw, np.uint8).reshape(-1, 4)
        return b[:, :3].tobytes()                      # little-endian 24-bit

    def flush(self) -> None:
        if not self._pending:
            return
        data = np.concatenate(self._pending, axis=1)
        self._wave.writeframes(self._encode(data))
        self.frames_written += data.shape[1]
        self._pending = []
        self._pending_samples = 0

    def close(self) -> None:
        self.flush()
        self._wave.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_wav(path: str) -> tuple:
    """(data [C, T] float32 in [-1, 1], sample_rate) — for tests/analysis."""
    with wave.open(path, "rb") as w:
        channels = w.getnchannels()
        width = w.getsampwidth()
        rate = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, "<i2").astype(np.float32) / 32767.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        as32 = np.zeros((b.shape[0], 4), np.uint8)
        as32[:, 1:] = b
        ints = as32.view("<i4")[:, 0] >> 8
        data = ints.astype(np.float32) / float(2**23 - 1)
    else:
        raise ValueError(f"unsupported sample width {width}")
    return data.reshape(-1, channels).T, float(rate)
