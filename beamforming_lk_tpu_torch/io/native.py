"""ctypes binding for the native C ingest shim (``csrc/ingest.c``)
(counterpart of ``beamforming_lk_tpu.io.native``).

The native path replaces the reference's per-packet ``recv`` producer
thread (``src/fpga/pipeline.cpp:243-296``) with a ``recvmmsg`` batch loop
demuxing directly into a block ring — needed to hold 48 828 pkt/s without
Python in the packet path.  The repository's ``csrc/ingest.c`` is built at
first use with the system's C compiler and ``csrc/Makefile``'s flags into
``beamforming_lk_tpu_torch/_build/``, keyed by a hash of the source
(``ops/nvcc.py``).  Without a compiler :class:`NativeIngest` raises; the
pure-Python :mod:`beamforming_lk_tpu_torch.io.udp` is a separate source
that the caller chooses.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Iterator

import numpy as np

_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "csrc", "ingest.c",
)


@functools.cache
def load_ingest_library():
    """The native library, built on first use; raises ``RuntimeError`` when
    it cannot be built."""
    from beamforming_lk_tpu_torch.ops import nvcc

    lib = ctypes.CDLL(nvcc.build("ingest", [_SOURCE], nvcc.cc_command()))
    lib.ingest_open.restype = ctypes.c_void_p
    lib.ingest_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.ingest_next_block.restype = ctypes.c_int64
    lib.ingest_next_block.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_double,
    ]
    lib.ingest_stats.restype = None
    lib.ingest_stats.argtypes = [ctypes.c_void_p] + [
        ctypes.POINTER(ctypes.c_uint64)
    ] * 4
    lib.ingest_port.restype = ctypes.c_int
    lib.ingest_port.argtypes = [ctypes.c_void_p]
    lib.ingest_close.restype = None
    lib.ingest_close.argtypes = [ctypes.c_void_p]
    return lib


class NativeIngest:
    """High-rate FPGA link backed by the C shim.

    Usage::

        with NativeIngest("0.0.0.0", 21844, n_sensors=64) as ingest:
            for seq, block in ingest.blocks(timeout=1.0):
                ...  # block: [C, T] float32
    """

    def __init__(
        self,
        address: str,
        port: int,
        n_sensors: int,
        block_size: int = 256,
        n_slots: int = 16,
        column_flip: bool = True,
    ):
        lib = load_ingest_library()
        self._lib = lib
        self.n_sensors = n_sensors
        self.block_size = block_size
        self._handle = lib.ingest_open(
            address.encode(), port, n_sensors, block_size, n_slots,
            1 if column_flip else 0,
        )
        if not self._handle:
            raise OSError(f"ingest_open failed for {address}:{port}")

    @property
    def port(self) -> int:
        """Actual bound port (useful with port 0 in tests)."""
        return self._lib.ingest_port(self._handle)

    def next_block(self, timeout: float = 1.0):
        """(seq, [C, T] block) or (None, None) on timeout."""
        out = np.empty((self.n_sensors, self.block_size), np.float32)
        seq = self._lib.ingest_next_block(
            self._handle,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            float(timeout),
        )
        if seq < 0:
            return None, None
        return int(seq), out

    def blocks(self, timeout: float = 1.0) -> Iterator[tuple]:
        while True:
            seq, block = self.next_block(timeout)
            if seq is None:
                return
            yield seq, block

    def stats(self) -> dict:
        r = ctypes.c_uint64()
        p = ctypes.c_uint64()
        d = ctypes.c_uint64()
        g = ctypes.c_uint64()
        self._lib.ingest_stats(
            self._handle,
            ctypes.byref(r), ctypes.byref(p), ctypes.byref(d), ctypes.byref(g),
        )
        return {
            "packets_received": r.value,
            "blocks_produced": p.value,
            "blocks_dropped": d.value,
            "counter_gaps": g.value,
        }

    def close(self) -> None:
        if self._handle:
            self._lib.ingest_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
