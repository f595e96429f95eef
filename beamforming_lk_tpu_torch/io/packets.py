"""FPGA wire format: packing, parsing, demux.

The FPGA sends one UDP packet per time sample across all mics
(reference: ``src/fpga/receiver.h:24-30``):

    packed LE struct { uint16 frequency; uint8 n_arrays; uint8 version;
                       uint32 counter; int32 stream[256] }  -> 1032 bytes

Demux per sample (``src/fpga/pipeline.cpp:277-291``): arrays are
daisy-chained, so every other 8-mic column arrives reversed — the column
group containing sensor 0 IS flipped (the reference toggles ``inverted``
starting at true).  Samples are 24-bit PCM in an int32, normalized to
float by 2^23 (``src/fpga/pipeline.h:25``).

Everything here is vectorized numpy over whole packet batches — the
per-sample scalar loop of the reference becomes one reshape + index map.

A copy of ``beamforming_lk_tpu.io.packets`` (numpy and the standard
library only), kept in the port so that the port loads no module of the
JAX package.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

HEADER_FORMAT = "<HBBI"
HEADER_SIZE = struct.calcsize(HEADER_FORMAT)   # 8 bytes
MAX_N_SENSORS = 256                            # receiver.h:17
PACKET_SIZE = HEADER_SIZE + 4 * MAX_N_SENSORS  # 1032 bytes
MAX_VALUE_FLOAT = float(2**23)                 # pipeline.h:25


def column_flip_map(n_sensors: int, columns: int = 8) -> np.ndarray:
    """index_map[s] = wire index holding logical sensor s.

    Mirrors pipeline.cpp:277-291: groups of ``columns`` sensors alternate
    reversed/normal, starting reversed (the ``inverted`` toggle flips to
    true at sensor 0).
    """
    s = np.arange(n_sensors)
    group = s // columns
    flipped = (group % 2) == 0
    rev = columns * (1 + group) - 1 - (s % columns)
    return np.where(flipped, rev, s).astype(np.int64)


def parse_header(packet: bytes) -> Tuple[int, int, int, int]:
    """(frequency, n_arrays, version, counter) from one packet."""
    return struct.unpack_from(HEADER_FORMAT, packet, 0)


def parse_packets(
    data: np.ndarray, n_sensors: int, columns: int = 8, column_flip: bool = True
) -> Tuple[np.ndarray, np.ndarray]:
    """Batch-parse raw packets -> ([C, T] float block, counters [T]).

    ``data``: uint8 array [T, PACKET_SIZE] (or bytes of T concatenated
    packets).  Applies the daisy-chain unflip and the 2^23 normalization.
    """
    raw = np.frombuffer(bytes(data), np.uint8).reshape(-1, PACKET_SIZE)
    counters = raw[:, 4:8].copy().view(np.uint32)[:, 0]
    stream = raw[:, HEADER_SIZE:].copy().view("<i4")       # [T, 256]
    stream = stream[:, :n_sensors]
    if column_flip:
        stream = stream[:, column_flip_map(n_sensors, columns)]
    block = stream.T.astype(np.float32) / MAX_VALUE_FLOAT  # [C, T]
    return block, counters.astype(np.int64)


def build_packets(
    block: np.ndarray,
    start_counter: int = 0,
    frequency: int = 48828,
    n_arrays: int | None = None,
    version: int = 1,
    columns: int = 8,
    column_flip: bool = True,
) -> bytes:
    """[C, T] float block -> T wire packets (inverse of parse_packets).

    Used by the synthetic UDP sender and tests; the reference has no
    equivalent (its fake FPGA bypasses the socket, pipeline.cpp:81-157).
    """
    block = np.asarray(block)
    c, t = block.shape
    if n_arrays is None:
        n_arrays = max(1, c // 64)
    ints = np.clip(
        np.round(block * MAX_VALUE_FLOAT), -(2**31), 2**31 - 1
    ).astype("<i4")                                        # [C, T]
    wire = np.zeros((t, MAX_N_SENSORS), "<i4")
    if column_flip:
        wire[:, column_flip_map(c, columns)] = ints.T
    else:
        wire[:, :c] = ints.T
    out = bytearray()
    for i in range(t):
        out += struct.pack(
            HEADER_FORMAT, frequency, n_arrays, version, (start_counter + i) & 0xFFFFFFFF
        )
        out += wire[i].tobytes()
    return bytes(out)
