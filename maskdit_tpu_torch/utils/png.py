"""A PNG codec on numpy and the standard library (zlib, struct).

The port writes its samples as PNGs and reads them back for FID without
Pillow, which the card's machine need not have. What it covers:

- ``write_png``: 8-bit gray (H, W) or (H, W, 1) and RGB (H, W, 3) uint8
  arrays, non-interlaced, every row with filter 0 (None);
- ``read_png``: 8-bit gray, gray + alpha, RGB and RGBA, non-interlaced,
  rows with any of the five filters (None, Sub, Up, Average, Paeth), every
  chunk's CRC checked. Gray comes back (H, W), the others (H, W, C), as
  ``np.asarray(PIL.Image.open(...))`` gives them.

Anything else (palette, 1-, 2-, 4- or 16-bit samples, Adam7 interlace, an
unknown critical chunk, a bad CRC or a short stream) raises ``ValueError``
naming what it met.
"""

from __future__ import annotations

import struct
import zlib
import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit samples only)
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray + alpha", 6: "RGBA"}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray) -> bytes:
    """The PNG file of an 8-bit gray or RGB image, as bytes (zlib level 6,
    Pillow's default)."""
    arr = np.asarray(image)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    if arr.dtype != np.uint8 or not (arr.ndim == 2 or (arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"write_png takes uint8 (H, W), (H, W, 1) or (H, W, 3); "
                         f"got {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    color = 0 if arr.ndim == 2 else 2
    rows = np.ascontiguousarray(arr).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)  # filter 0
    header = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray) -> None:
    data = encode_png(image)
    with open(path, "wb") as f:
        f.write(data)


def _paeth_row(raw: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(raw.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _average_row(raw: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = bytearray(raw.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _unfilter(data: bytes, h: int, stride: int, bpp: int, source: str) -> np.ndarray:
    if len(data) < h * (stride + 1):
        raise ValueError(f"{source}: image data holds {len(data)} bytes, "
                         f"{h} rows need {h * (stride + 1)}")
    rows = np.frombuffer(data, np.uint8, count=h * (stride + 1)).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, raw = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = raw
        elif kind == 1:  # Sub: a running sum along the row, per channel, mod 256
            cur = np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = raw + prev
        elif kind == 3:
            cur = _average_row(raw, prev, bpp)
        elif kind == 4:
            cur = _paeth_row(raw, prev, bpp)
        else:
            raise ValueError(f"{source}: row {y} has filter type {kind} (PNG defines 0-4)")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes, source: str = "<bytes>") -> np.ndarray:
    """The pixels of a PNG file's bytes; ``source`` names it in errors."""
    if data[:8] != SIGNATURE:
        raise ValueError(f"{source}: not a PNG file (bad signature)")
    pos, header, idat = 8, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{source}: truncated before IEND")
        (length,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{source}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{source}: CRC mismatch in the {kind!r} chunk")
        pos += 12 + length
        if kind == b"IHDR":
            if length != 13:
                raise ValueError(f"{source}: IHDR holds {length} bytes, not 13")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        elif kind != b"PLTE" and not kind[0] & 0x20:  # an unknown critical chunk
            raise ValueError(f"{source}: unsupported critical chunk {kind!r}")
    if header is None or not idat:
        raise ValueError(f"{source}: no IHDR or no IDAT chunk")
    w, h, depth, color, compression, filtering, interlace = header
    if color not in CHANNELS or depth != 8:
        raise ValueError(f"{source}: {depth}-bit {COLOR_NAMES.get(color, f'colour type {color}')} "
                         "is not supported (8-bit gray, gray + alpha, RGB, RGBA only)")
    if interlace != 0:
        raise ValueError(f"{source}: Adam7 interlacing is not supported")
    if compression != 0 or filtering != 0:
        raise ValueError(f"{source}: compression method {compression}, filter method "
                         f"{filtering} (PNG defines 0 only)")
    channels = CHANNELS[color]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError(f"{source}: corrupt image data ({exc})") from None
    pixels = _unfilter(raw, h, w * channels, channels, source)
    return pixels.reshape(h, w) if channels == 1 else pixels.reshape(h, w, channels)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), path)
