"""Recorded-capture replay: a dependency-free pcap reader for FPGA traffic.

The reference's offline test workflow records FPGA UDP with Wireshark,
rewrites the destination IP (``udp/udpreplace.py``) and replays it with
``udpreplay`` against the live app (``udp/README.md``).  Here captures are
read directly — no replay daemon, no scapy: a minimal classic-pcap parser
(stdlib struct) extracts the UDP payloads and hands them to
:mod:`beamforming_lk_tpu_torch.io.packets` for batch demux into sample blocks.

A copy of ``beamforming_lk_tpu.io.pcap`` (numpy and the standard library
only), kept in the port so that the port loads no module of the JAX
package.
"""

from __future__ import annotations

import struct
from typing import Iterator, Optional

import numpy as np

from beamforming_lk_tpu_torch.io import packets as pk

PCAP_MAGIC_LE = 0xA1B2C3D4
PCAP_MAGIC_BE = 0xD4C3B2A1
LINKTYPE_ETHERNET = 1
LINKTYPE_NULL = 0
LINKTYPE_RAW = 101


def _udp_payload(frame: bytes, linktype: int) -> Optional[tuple]:
    """Extract (dst_port, payload) from a captured frame, or None."""
    if linktype == LINKTYPE_ETHERNET:
        if len(frame) < 14:
            return None
        ethertype = struct.unpack_from(">H", frame, 12)[0]
        if ethertype != 0x0800:  # IPv4 only
            return None
        ip = frame[14:]
    elif linktype == LINKTYPE_NULL:
        ip = frame[4:]
    else:  # raw IP
        ip = frame
    if len(ip) < 20 or (ip[0] >> 4) != 4:
        return None
    ihl = (ip[0] & 0xF) * 4
    if ip[9] != 17:  # UDP
        return None
    udp = ip[ihl:]
    if len(udp) < 8:
        return None
    dst_port, length = struct.unpack_from(">HH", udp, 2)[0], struct.unpack_from(">H", udp, 4)[0]
    return dst_port, udp[8 : 8 + max(length - 8, 0)]


def read_pcap_payloads(path: str, port: Optional[int] = None) -> Iterator[bytes]:
    """Yield UDP payloads from a classic .pcap file (optionally one port)."""
    with open(path, "rb") as f:
        header = f.read(24)
        if len(header) < 24:
            return
        magic = struct.unpack("<I", header[:4])[0]
        if magic == PCAP_MAGIC_LE:
            endian = "<"
        elif magic == PCAP_MAGIC_BE:
            endian = ">"
        else:
            raise ValueError(f"{path}: not a classic pcap file")
        linktype = struct.unpack(endian + "I", header[20:24])[0]
        while True:
            rec = f.read(16)
            if len(rec) < 16:
                return
            _, _, incl_len, _ = struct.unpack(endian + "IIII", rec)
            frame = f.read(incl_len)
            if len(frame) < incl_len:
                return
            got = _udp_payload(frame, linktype)
            if got is None:
                continue
            dst_port, payload = got
            if port is not None and dst_port != port:
                continue
            yield payload


def write_pcap(path: str, payloads, dst_port: int = 21844) -> None:
    """Write UDP payloads as a minimal raw-IP pcap (test fixture builder).

    Each payload may be raw ``bytes`` (sent to ``dst_port``) or a
    ``(bytes, port)`` pair — mixed ports model multi-FPGA captures (the
    reference replays one wireshark capture carrying several links,
    udp/README.md; ``replay_blocks(port=...)`` filters one link back out).
    """
    with open(path, "wb") as f:
        f.write(struct.pack("<IHHiIII", PCAP_MAGIC_LE, 2, 4, 0, 0, 65535, LINKTYPE_RAW))
        for i, payload in enumerate(payloads):
            port = dst_port
            if isinstance(payload, tuple):
                payload, port = payload
            udp = struct.pack(">HHHH", 12345, port, 8 + len(payload), 0) + payload
            ip = (
                bytes([0x45, 0])
                + struct.pack(">H", 20 + len(udp))
                + b"\x00\x00\x00\x00"
                + bytes([64, 17])
                + b"\x00\x00"
                + bytes([10, 0, 0, 2])
                + bytes([10, 0, 0, 1])
                + udp
            )
            f.write(struct.pack("<IIII", i // 48828, (i % 48828) * 20, len(ip), len(ip)))
            f.write(ip)


def replay_blocks(
    path: str,
    n_sensors: int,
    block_size: int = 256,
    port: Optional[int] = None,
    columns: int = 8,
    column_flip: bool = True,
    check_counters: bool = True,
) -> Iterator[np.ndarray]:
    """Stream a capture as consecutive [C, T] blocks (the udpreplay analog).

    Drops malformed payloads; optionally warns (via np.errstate-free check)
    when packet counters show gaps — the reference has no gap handling at
    all (a lost packet silently shears the block, pipeline.cpp:264-267).
    """
    batch = []
    last_counter = None
    for payload in read_pcap_payloads(path, port):
        if len(payload) != pk.PACKET_SIZE:
            continue
        batch.append(payload)
        if len(batch) == block_size:
            block, counters = pk.parse_packets(
                np.frombuffer(b"".join(batch), np.uint8),
                n_sensors,
                columns,
                column_flip,
            )
            if check_counters and last_counter is not None:
                if int(counters[0]) != (last_counter + 1) & 0xFFFFFFFF:
                    pass  # gap: tolerated, same as the reference
            last_counter = int(counters[-1])
            batch = []
            yield block
