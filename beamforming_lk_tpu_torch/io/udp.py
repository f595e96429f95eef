"""Live UDP ingest: the FPGA link.

Re-design of the reference's receiver + producer thread
(``src/fpga/receiver.cpp:28-58``, ``src/fpga/pipeline.cpp:243-296``): a
bound UDP socket receives one 1032-byte packet per sample (~48 828 pkt/s),
batches ``block_size`` packets, and demuxes them into [C, T] float blocks
with one vectorized call.  The handshake mirrors ``connect_real``
(``pipeline.cpp:43-79``): the first packet's ``n_arrays`` field sizes the
channel count (``n_sensors = n_arrays * 64``, pipeline.cpp:62).

A native C ingest shim (``csrc/ingest.c``, loaded via ctypes when built)
replaces the per-packet Python loop with a ``recvmmsg`` batch loop for
production packet rates; the pure-Python path is the fallback and the
reference for its behavior.

A copy of ``beamforming_lk_tpu.io.udp`` (numpy and the standard library
only), kept in the port so that the port loads no module of the JAX
package.
"""

from __future__ import annotations

import socket
from typing import Iterator, Optional, Tuple

import numpy as np

from beamforming_lk_tpu_torch.io import packets as pk

ELEMENTS = 64  # mics per array (antenna.h:18-20)


def open_receiver(address: str, port: int, timeout: Optional[float] = None):
    """Bind the FPGA-facing UDP socket (receiver.cpp:28-49)."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    # Deep receive buffer: at 48828 pkt/s a block is ~270 KB; give the
    # kernel room for several blocks of jitter.
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 * 1024 * 1024)
    sock.bind((address, port))
    if timeout is not None:
        sock.settimeout(timeout)
    return sock


def handshake(sock) -> Tuple[int, int]:
    """Read one packet to learn the stream shape -> (n_sensors, frequency)
    (connect_real, pipeline.cpp:54-62)."""
    data = sock.recv(pk.PACKET_SIZE)
    frequency, n_arrays, _version, _counter = pk.parse_header(data)
    return n_arrays * ELEMENTS, frequency


def receive_blocks(
    sock,
    n_sensors: int,
    block_size: int = 256,
    columns: int = 8,
    column_flip: bool = True,
    resilient: bool = False,
) -> Iterator[np.ndarray]:
    """Yield [C, T] float blocks from the socket (pure-Python path).

    Equivalent of ``receive_exposure`` (pipeline.cpp:260-296); packet loss
    is tolerated the same way (the block simply shears — no resync), and a
    counter gap is observable via :func:`packets.parse_packets` if callers
    need it.

    ``resilient=True`` upgrades on the reference (which prints and breaks
    on any receive error, pipeline.cpp:264-267): a timeout or short packet
    drops the partial block and resumes listening — the FPGA link can
    disappear and come back without killing the pipeline.
    """
    import socket as _socket

    buf = bytearray(block_size * pk.PACKET_SIZE)
    view = memoryview(buf)
    while True:
        try:
            for i in range(block_size):
                n = sock.recv_into(view[i * pk.PACKET_SIZE :], pk.PACKET_SIZE)
                if n != pk.PACKET_SIZE:
                    raise IOError(f"short packet: {n} bytes")
        except (_socket.timeout, IOError):
            if not resilient:
                raise
            continue  # drop the partial block, resync on the next one
        block, _counters = pk.parse_packets(
            np.frombuffer(buf, np.uint8), n_sensors, columns, column_flip
        )
        yield block


def send_blocks(
    blocks,
    address: str,
    port: int,
    start_counter: int = 0,
    pace: bool = False,
    sample_rate: float = 48828.0,
) -> int:
    """Transmit [C, T] blocks as FPGA wire packets — the synthetic FPGA /
    udpreplay stand-in (pipeline.cpp:81-157 paces the same way).

    Returns the number of packets sent.  ``pace=True`` sleeps to real-time
    block cadence.
    """
    import time

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sent = 0
    counter = start_counter
    for block in blocks:
        t = block.shape[1]
        wire = pk.build_packets(block, start_counter=counter)
        for i in range(t):
            sock.sendto(
                wire[i * pk.PACKET_SIZE : (i + 1) * pk.PACKET_SIZE],
                (address, port),
            )
            sent += 1
        counter += t
        if pace:
            time.sleep(t / sample_rate)
    sock.close()
    return sent
