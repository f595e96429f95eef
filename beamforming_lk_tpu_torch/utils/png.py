"""Minimal PNG writer — stdlib zlib only (headless heatmap/frame output).

A copy of ``beamforming_lk_tpu.utils.png`` (numpy and the standard
library only), kept in the port so that the port loads no module of the
JAX package.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path: str, image: np.ndarray) -> None:
    """Save uint8 [H, W] (grayscale) or [H, W, 3] (RGB) as PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError("write_png expects uint8")
    if img.ndim == 2:
        color_type = 0
        rows = img[:, :, None]
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
        rows = img
    else:
        raise ValueError(f"unsupported shape {img.shape}")
    h, w = img.shape[:2]
    raw = b"".join(
        b"\x00" + rows[y].tobytes() for y in range(h)
    )
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(
            _chunk(
                b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
            )
        )
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG to uint8 [H, W], [H, W, 3] or
    [H, W, 4] (gray / RGB / RGBA) — stdlib-only logo loader for the
    ``--logo`` overlay (the reference loads its logo with cv::imread,
    ``src/aw_control_unit/aw_control_unit.cpp``)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, w, h, channels = 8, b"", None, None, None
    while pos + 8 <= len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        chunk = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(
                ">IIBBBBB", chunk
            )
            if depth != 8 or interlace:
                raise ValueError("read_png: only 8-bit non-interlaced PNGs")
            try:
                channels = {0: 1, 2: 3, 4: 2, 6: 4}[color]
            except KeyError:
                raise ValueError(f"read_png: unsupported color type {color}")
        elif tag == b"IDAT":
            idat += chunk
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.int32)
    p = 0
    for y in range(h):
        ft = raw[p]
        row = np.frombuffer(raw[p + 1:p + 1 + stride], np.uint8).astype(
            np.int32
        )
        p += 1 + stride
        up = out[y - 1] if y > 0 else np.zeros(stride, np.int32)
        if ft == 0:
            out[y] = row
        elif ft == 2:  # Up
            out[y] = (row + up) & 0xFF
        elif ft in (1, 3, 4):  # Sub / Average / Paeth: sequential in x
            cur = out[y]
            for x in range(stride):
                a = cur[x - channels] if x >= channels else 0
                b = up[x]
                c = up[x - channels] if x >= channels else 0
                if ft == 1:
                    pred = a
                elif ft == 3:
                    pred = (a + b) // 2
                else:
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if (pa <= pb and pa <= pc) else (
                        b if pb <= pc else c
                    )
                cur[x] = (row[x] + pred) & 0xFF
        else:
            raise ValueError(f"read_png: bad filter {ft}")
    img = out.astype(np.uint8).reshape(h, w, channels)
    if channels == 2:  # gray+alpha -> expand gray, keep alpha
        img = np.concatenate([np.repeat(img[..., :1], 3, axis=-1),
                              img[..., 1:]], axis=-1)
    return img[..., 0] if channels == 1 else img


def read_png_size(path: str) -> tuple:
    """(width, height) from a PNG header — for tests."""
    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    w, h = struct.unpack(">II", head[16:24])
    return w, h
