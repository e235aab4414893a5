"""8-bit RGB and RGBA PNG files with zlib and struct alone.

texgs's tools write and read their images with imageio and resize with
PIL; the port needs neither.  ``encode`` writes non-interlaced 8-bit RGB
(colour type 2) or RGBA (6) with filter type 0 on every row; ``decode``
reads those two colour types at 8 bits, non-interlaced, with any of the
five filter types on each row (files other writers made choose filters
row by row).  Palette, grey, 16-bit and interlaced files raise
``ValueError``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {3: 2, 4: 6}  # channels -> PNG colour type


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode(image: np.ndarray) -> bytes:
    """(H, W, 3 or 4) uint8 -> PNG bytes."""
    image = np.asarray(image)
    if (image.dtype != np.uint8 or image.ndim != 3
            or image.shape[2] not in _COLOR_TYPES):
        raise ValueError(f"encode takes (H, W, 3 or 4) uint8, got "
                         f"{image.dtype} {image.shape}")
    h, w, c = image.shape
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(image).reshape(h, w * c)], 1)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(image))


def _unfilter_sequential(kind: int, line: bytearray, prev: bytes,
                         bpp: int) -> None:
    """Average (3) and Paeth (4) rows, in place: each byte depends on the
    one decoded bpp bytes before it."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3 or 4) uint8."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG file without IHDR")
    w, h, depth, color, _, _, interlace = header
    channels = {c: n for n, c in _COLOR_TYPES.items()}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"only non-interlaced 8-bit RGB and RGBA PNG files "
                         f"are read (bit depth {depth}, colour type {color}, "
                         f"interlace {interlace})")
    stride = w * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            row = line
        elif kind == 1:      # Sub: a running sum of each channel, mod 256
            row = np.cumsum(line.reshape(w, channels), 0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:      # Up
            row = line + prev
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_sequential(kind, buf, prev.tobytes(), channels)
            row = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"unknown PNG filter type {kind} in row {y}")
        out[y] = row
        prev = out[y]
    return out.reshape(h, w, channels)


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())
