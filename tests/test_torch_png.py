"""The port's PNG codec (maskdit_tpu_torch/utils/png.py) against Pillow.

Files the port writes must read back through Pillow as the same pixels, bit
for bit; files Pillow writes (it picks a row filter per row: None, Sub, Up
and Paeth appear below) must read through the port as Pillow reads them.
Pillow never picks the Average filter, so files with every filter on
every row are written here by a reference filter encoder, and both readers
must return the source pixels. Also: PNG writing and reading in a process
where Pillow cannot be imported (the card's machine need not have it).
"""

import io
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from maskdit_tpu_torch.utils import png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def _images(seed: int, h: int = 19, w: int = 23):
    """Noise, gradients and a smooth field: content for which Pillow picks
    different row filters."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = np.cumsum(np.cumsum(rng.normal(size=(h, w)), 0), 1) * 4 + 128
    planes = [rng.integers(0, 256, (h, w)), (xx * 7 + yy * 3), (yy * 5), smooth,
              (xx * xx + yy * yy) // 2]
    return [np.asarray(p % 256, dtype=np.uint8) for p in planes]


def _row_filters(data: bytes) -> set:
    pos, idat = 8, []
    while True:
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            w, h, _, color = struct.unpack(">IIBB", body[:10])
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    stride = w * png.CHANNELS[color] + 1
    raw = zlib.decompress(b"".join(idat))
    return {raw[y * stride] for y in range(h)}


@pytest.mark.parametrize("channels", [1, 3])
def test_port_written_files_read_through_pillow(tmp_path, channels):
    for i, plane in enumerate(_images(channels)):
        image = plane if channels == 1 else np.stack([plane, plane[::-1], 255 - plane], -1)
        path = str(tmp_path / f"{i}.png")
        png.write_png(path, image)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), image)
        np.testing.assert_array_equal(png.read_png(path), image)
    # (H, W, 1) is written as gray
    png.write_png(str(tmp_path / "g.png"), image[..., :1])
    assert Image.open(str(tmp_path / "g.png")).mode == "L"


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_pillow_written_files_read_through_the_port(channels):
    seen = set()
    for plane in _images(10 + channels):
        image = plane if channels == 1 else np.stack(
            [np.roll(plane, k, axis=1) for k in range(channels)], -1)
        buf = io.BytesIO()
        Image.fromarray(image, MODES[channels]).save(buf, format="PNG")
        data = buf.getvalue()
        seen |= _row_filters(data)
        np.testing.assert_array_equal(png.decode_png(data), np.asarray(Image.open(buf)))
    assert {0, 1, 2, 4} <= seen, seen


def _filter_encode(image: np.ndarray, kind: int) -> bytes:
    """A PNG whose every row carries filter ``kind``: the PNG spec's forward
    filters, byte by byte."""
    h, w = image.shape[:2]
    bpp = 1 if image.ndim == 2 else image.shape[2]
    rows = image.reshape(h, -1).astype(np.int64)
    out = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        cur = rows[y]
        raw = []
        for i in range(len(cur)):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            raw.append((cur[i] - pred) % 256)
        out += bytes([kind] + raw)
        prev = cur
    color = {1: 0, 2: 4, 3: 2, 4: 6}[bpp]
    return (png.SIGNATURE + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(bytes(out))) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_every_filter_reads_as_pillow_reads_it(kind, channels):
    plane = _images(kind)[3][:9, :11]
    image = plane if channels == 1 else np.stack(
        [np.roll(plane, k, axis=0) for k in range(channels)], -1)
    data = _filter_encode(image, kind)
    assert _row_filters(data) == {kind}
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), image)
    np.testing.assert_array_equal(png.decode_png(data), image)


@pytest.mark.parametrize("what,match", [
    ("16-bit", "16-bit gray is not supported"),
    ("palette", "8-bit palette is not supported"),
    ("interlaced", "Adam7"),
    ("crc", "CRC mismatch in the b'IDAT' chunk"),
    ("truncated", "truncated"),
    ("filter", "filter type 7"),
    ("signature", "not a PNG file"),
])
def test_what_it_cannot_read_raises_naming_it(what, match):
    image = _images(0)[1][:4, :5]
    data = png.encode_png(image)
    if what == "16-bit":
        buf = io.BytesIO()
        Image.fromarray(image.astype(np.uint16) * 257).save(buf, format="PNG")
        data = buf.getvalue()
    elif what == "palette":
        buf = io.BytesIO()
        Image.fromarray(image).convert("P").save(buf, format="PNG")
        data = buf.getvalue()
    elif what == "interlaced":
        header = struct.pack(">IIBBBBB", 5, 4, 8, 0, 0, 0, 1)
        data = png.SIGNATURE + png._chunk(b"IHDR", header) + data[33:]
    elif what == "crc":
        data = data[:-13] + bytes([data[-13] ^ 1]) + data[-12:]
    elif what == "truncated":
        data = data[:-20]
    elif what == "filter":
        raw = bytearray(zlib.decompress(data[41:-16]))
        raw[0] = 7
        data = data[:33] + png._chunk(b"IDAT", zlib.compress(bytes(raw))) + data[-12:]
    else:
        data = b"GIF89a" + data[6:]
    with pytest.raises(ValueError, match=match):
        png.decode_png(data)


def test_save_images_needs_no_pillow(tmp_path):
    """In a process where ``import PIL`` fails, the port's ``save_images``
    writes PNGs and its dataset reads them back."""
    code = (
        "import sys\n"
        "sys.modules['PIL'] = None\n"
        "import numpy as np\n"
        "from maskdit_tpu_torch.sampling.generate import save_images, to_uint8\n"
        "from maskdit_tpu_torch.data.datasets import ImageFolderDataset\n"
        "from maskdit_tpu_torch.utils.png import read_png\n"
        "imgs = to_uint8(np.random.default_rng(0).uniform(-1, 1, (3, 3, 8, 8)))\n"
        f"save_images(imgs, [4, 5, 6], {str(tmp_path)!r})\n"
        f"got = [read_png({str(tmp_path)!r} + f'/{{s:06d}}.png') for s in (4, 5, 6)]\n"
        "assert all((g == i).all() for g, i in zip(got, imgs))\n"
        f"ds = ImageFolderDataset({str(tmp_path)!r})\n"
        "assert (ds[2][0] == imgs[2].transpose(2, 0, 1)).all()\n"
        "try:\n"
        "    import PIL\n"
        "except ImportError:\n"
        "    print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
