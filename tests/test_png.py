"""PNG codec (utils/imageio.py): zlib + struct, no image library.

Writes are checked by round trip; reads are checked against PNGs built here
with each of the five row filters (None, Sub, Up, Average, Paeth), since
other writers choose filters per row, and against a texture-size PNG that
mixes them the way adaptive encoders do.
"""

import struct
import zlib

import numpy as np
import pytest

from optix_renderer_tpu.utils import imageio as iio


@pytest.mark.parametrize("tonemap", [False, True])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("shape", [(1, 1), (17, 23)])
def test_png_write_read_roundtrip(tmp_path, shape, channels, tonemap):
    img = np.random.default_rng(0).uniform(0.0, 1.2, (*shape, channels)).astype(np.float32)
    p = tmp_path / "img.png"
    iio.write_png(p, img, tonemap=tonemap)
    ldr = iio.linear_to_srgb(img) if tonemap else img
    expect = np.clip(ldr * 255.0 + 0.5, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(iio.read_png(p), expect)
    assert p.read_bytes() == iio.encode_png(img, tonemap=tonemap)


def _chunk(tag, data):
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _png_with_filter(img, ftype, depth=8):
    """Encode [h,w,c] uint8 with one row filter on every row (PNG spec §9)."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(int)
    prev = [0] * (w * c)
    data = bytearray()
    for y in range(h):
        line = rows[y].tolist()
        out = []
        for i, x in enumerate(line):
            a = line[i - c] if i >= c else 0
            b = prev[i]
            ul = prev[i - c] if i >= c else 0
            pred = [0, a, b, (a + b) // 2, _paeth(a, b, ul)][ftype]
            out.append((x - pred) % 256)
        data += bytes([ftype] + out)
        prev = line
    return _png(w, h, c, bytes(data), depth)


def _png(w, h, c, data, depth=8):
    ctype = {1: 0, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b""))


def _filter_rows(img, ftypes):
    """Filter row y of [h,w,c] uint8 with ftypes[y], all rows at once."""
    h, w, c = img.shape
    x = img.astype(np.int16)
    a, b, ul = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, 1:], b[1:], ul[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    p = a + b - ul
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, ul))
    pred = np.stack([0 * a, a, b, (a + b) // 2, paeth])[ftypes, np.arange(h)]
    rows = ((x - pred) % 256).astype(np.uint8).reshape(h, w * c)
    return np.concatenate([ftypes.astype(np.uint8)[:, None], rows], axis=1).tobytes()


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_png_read_every_row_filter(tmp_path, ftype):
    rng = np.random.default_rng(ftype)
    for c in (1, 3, 4):
        img = rng.integers(0, 256, (9, 11, c), dtype=np.uint8)
        p = tmp_path / f"f{ftype}c{c}.png"
        p.write_bytes(_png_with_filter(img, ftype))
        np.testing.assert_array_equal(iio.read_png(p), img)
    # read_image: gray expands to RGB, alpha drops, values land in [0, 1]
    np.testing.assert_allclose(iio.read_image(p), img[..., :3] / 255.0, atol=1e-7)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_read_texture_size_mixed_filters(tmp_path, channels):
    """2048² texture, Paeth on six rows in seven and the other filters on
    the rest: an adaptive encoder's mix on photographic content."""
    h = w = 2048
    yy, xx = np.mgrid[0:h, 0:w]
    img = (128 + 90 * np.sin(xx / 41.0) * np.cos(yy / 29.0))[..., None]
    img = img + np.random.default_rng(channels).normal(0, 6, (h, w, channels))
    img = np.clip(img, 0, 255).astype(np.uint8)
    ftypes = np.full(h, 4)
    ftypes[::7] = np.arange(len(ftypes[::7])) % 4
    p = tmp_path / "tex.png"
    p.write_bytes(_png(w, h, channels, _filter_rows(img, ftypes)))
    np.testing.assert_array_equal(iio.read_png(p), img)


def test_png_reader_refuses_16_bit(tmp_path):
    p = tmp_path / "deep.png"
    p.write_bytes(_png_with_filter(np.zeros((2, 2, 3), np.uint8), 0, depth=16))
    with pytest.raises(ValueError, match="deep.png"):
        iio.read_png(p)


def test_read_image_refuses_other_ldr_formats(tmp_path):
    p = tmp_path / "tex.jpg"
    p.write_bytes(b"\xff\xd8\xff")
    with pytest.raises(ValueError, match="tex.jpg"):
        iio.read_image(p)
