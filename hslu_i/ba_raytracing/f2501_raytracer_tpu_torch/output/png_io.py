"""Minimal dependency-free PNG read/write (8-bit RGB), stdlib zlib only.

Replaces the reference's `png` crate usage (ref src/output/file.rs:27-50).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def png_bytes(rgb_u8: np.ndarray) -> bytes:
    """Encode (H, W, 3) uint8 to an in-memory 8-bit RGB PNG."""
    rgb_u8 = np.asarray(rgb_u8, dtype=np.uint8)
    h, w, c = rgb_u8.shape
    assert c == 3, "expected RGB"
    raw = b"".join(b"\x00" + rgb_u8[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        _MAGIC
        + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(raw, 6))
        + _chunk(b"IEND", b"")
    )


def write_png(path, rgb_u8: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(rgb_u8))


def read_png(path) -> np.ndarray:
    """Read an 8-bit RGB/RGBA PNG into (H, W, 3) uint8 (alpha dropped).
    Supports all five scanline filters, no interlacing, no palette."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == _MAGIC, "not a PNG"
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(">IIBBBBB", body)
            assert bit_depth == 8 and color_type in (2, 6) and interlace == 0
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    channels = 3 if color_type == 2 else 4
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw, dtype=np.uint8, count=stride, offset=pos + 1).copy()
        pos += 1 + stride
        if ftype == 0:
            pass
        elif ftype == 1:  # Sub
            for i in range(channels, stride):
                line[i] = (int(line[i]) + int(line[i - channels])) & 0xFF
        elif ftype == 2:  # Up
            line = (line.astype(np.int32) + prev.astype(np.int32)).astype(np.uint8)
        elif ftype == 3:  # Average
            for i in range(stride):
                left = int(line[i - channels]) if i >= channels else 0
                line[i] = (int(line[i]) + ((left + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:  # Paeth
            for i in range(stride):
                a = int(line[i - channels]) if i >= channels else 0
                b = int(prev[i])
                cph = int(prev[i - channels]) if i >= channels else 0
                p = a + b - cph
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - cph)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else cph)
                line[i] = (int(line[i]) + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter {ftype}")
        out[y] = line
        prev = line
    img = out.reshape(h, w, channels)
    return img[..., :3]
