"""Image I/O: OpenEXR (self-contained codec) + PNG, and sRGB conversion.

Counterpart of the reference `Bitmap` (include/nori/bitmap.h, src/utils/
bitmap.cpp): EXR for HDR render output, PNG for LDR. Both codecs are minimal
numpy + zlib implementations — the OpenEXR 2 scanline format (uncompressed
FLOAT channels) and 8-bit PNG — so no image library is needed.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_EXR_MAGIC = 20000630
_PXR24 = None  # compression codes: 0 none, 2 zips, 3 zip


def _attr(name: str, type_: str, data: bytes) -> bytes:
    return (
        name.encode() + b"\x00" + type_.encode() + b"\x00"
        + struct.pack("<i", len(data)) + data
    )


def _chlist(names) -> bytes:
    out = b""
    for n in sorted(names):
        # name, pixel type (2=FLOAT), pLinear, reserved[3], xSampling, ySampling
        out += n.encode() + b"\x00" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)
    return out + b"\x00"


def write_exr(path: str | Path, image: np.ndarray) -> None:
    """Write [h,w,3] (RGB) or [h,w,4] (RGBA) float32 as uncompressed EXR."""
    img = np.asarray(image, np.float32)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected [h,w,3|4], got {img.shape}")
    h, w, c = img.shape
    names = ["R", "G", "B"] + (["A"] if c == 4 else [])
    chan = {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2]}
    if c == 4:
        chan["A"] = img[..., 3]

    header = b""
    header += _attr("channels", "chlist", _chlist(names))
    header += _attr("compression", "compression", b"\x00")  # none
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", b"\x00")
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    preamble = struct.pack("<ii", _EXR_MAGIC, 2) + header
    offset0 = len(preamble) + 8 * h
    line_bytes = 8 + len(names) * w * 4
    offsets = struct.pack("<%dQ" % h, *[offset0 + y * line_bytes for y in range(h)])

    body = bytearray()
    for y in range(h):
        body += struct.pack("<ii", y, len(names) * w * 4)
        for n in sorted(names):
            body += chan[n][y].astype("<f4").tobytes()

    with open(path, "wb") as f:
        f.write(preamble)
        f.write(offsets)
        f.write(body)


def _read_exr_header(buf: bytes):
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _EXR_MAGIC:
        raise ValueError("not an EXR file")
    pos = 8
    attrs = {}
    while buf[pos] != 0:
        end = buf.index(b"\x00", pos)
        name = buf[pos:end].decode()
        pos = end + 1
        end = buf.index(b"\x00", pos)
        type_ = buf[pos:end].decode()
        pos = end + 1
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        attrs[name] = (type_, buf[pos : pos + size])
        pos += size
    return attrs, pos + 1


def read_exr(path: str | Path) -> np.ndarray:
    """Read an EXR written by `write_exr` (or any uncompressed/zip FLOAT
    scanline EXR with R,G,B[,A] channels). Returns [h,w,3|4] float32."""
    buf = Path(path).read_bytes()
    attrs, pos = _read_exr_header(buf)
    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"][1])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    compression = attrs["compression"][1][0]

    # parse channel list
    chdata = attrs["channels"][1]
    names = []
    cpos = 0
    while chdata[cpos] != 0:
        end = chdata.index(b"\x00", cpos)
        names.append(chdata[cpos:end].decode())
        cpos = end + 1 + 16
    names_sorted = sorted(names)

    n_lines_per_block = {0: 1, 1: 1, 2: 1, 3: 16}.get(compression)
    if n_lines_per_block is None:
        raise ValueError(f"unsupported EXR compression {compression}")
    n_blocks = (h + n_lines_per_block - 1) // n_lines_per_block
    offsets = struct.unpack_from("<%dQ" % n_blocks, buf, pos)

    out = {n: np.zeros((h, w), np.float32) for n in names_sorted}
    for off in offsets:
        y, size = struct.unpack_from("<ii", buf, off)
        data = buf[off + 8 : off + 8 + size]
        nlines = min(n_lines_per_block, h - (y - y0))
        raw_size = nlines * len(names_sorted) * w * 4
        if compression in (2, 3) and size != raw_size:
            data = zlib.decompress(data)
            d = np.frombuffer(data, np.uint8).copy()
            # EXR zip predictor: delta decode then de-interleave
            d[1:] = (np.cumsum(d.astype(np.int64)) % 256)[1:].astype(np.uint8)
            half = (len(d) + 1) // 2
            interleaved = np.empty(len(d), np.uint8)
            interleaved[0::2] = d[:half]
            interleaved[1::2] = d[half : half + len(d) - half]
            data = interleaved.tobytes()
        arr = np.frombuffer(data, "<f4").reshape(nlines, len(names_sorted), w)
        for li in range(nlines):
            for ci, n in enumerate(names_sorted):
                out[n][y - y0 + li] = arr[li, ci]

    chans = [out[n] for n in ["R", "G", "B"] if n in out]
    if "A" in out:
        chans.append(out["A"])
    return np.stack(chans, axis=-1)


def srgb_to_linear(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    return np.where(img <= 0.04045, img / 12.92, ((img + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float32)
    return np.where(
        img <= 0.0031308,
        12.92 * img,
        1.055 * np.maximum(img, 1e-12) ** (1.0 / 2.4) - 0.055,
    )


def read_hdr(path: str | Path) -> np.ndarray:
    """Read a Radiance RGBE `.hdr` file → [h,w,3] float32 linear HDR.

    Counterpart of the reference's HDRLoader (include/nori/HDRLoader.h:28-33
    decode: v = mantissa/256 · 2^(E−128)); handles both the new RLE scanline
    encoding and flat RGBE rows, vectorized with numpy.
    """
    buf = Path(path).read_bytes()
    # header: text lines until a blank line, then the resolution line
    pos = 0
    if not (buf.startswith(b"#?RADIANCE") or buf.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    while True:
        end = buf.index(b"\n", pos)
        line = buf[pos:end]
        pos = end + 1
        if line == b"":
            break
    end = buf.index(b"\n", pos)
    res = buf[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported HDR orientation {res}")
    h, w = int(res[1]), int(res[3])

    data = np.frombuffer(buf, np.uint8, offset=pos)
    rgbe = np.zeros((h, w, 4), np.uint8)
    dpos = 0
    for y in range(h):
        # new-style RLE scanline: 0x02 0x02 hi lo, per-channel RLE runs
        if w >= 8 and w < 32768 and data[dpos] == 2 and data[dpos + 1] == 2 and (
            (int(data[dpos + 2]) << 8) | int(data[dpos + 3])
        ) == w:
            dpos += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(data[dpos])
                    if count > 128:  # run of a repeated byte
                        rgbe[y, x : x + count - 128, c] = data[dpos + 1]
                        x += count - 128
                        dpos += 2
                    else:  # literal bytes
                        rgbe[y, x : x + count, c] = data[dpos + 1 : dpos + 1 + count]
                        x += count
                        dpos += 1 + count
        else:  # flat RGBE row (old format; ignore old-style 1,1,1 RLE)
            rgbe[y] = data[dpos : dpos + w * 4].reshape(w, 4)
            dpos += w * 4
    mant = rgbe[..., :3].astype(np.float32) / 256.0
    expo = rgbe[..., 3].astype(np.int32) - 128
    out = mant * np.exp2(expo.astype(np.float32))[..., None]
    out[rgbe[..., 3] == 0] = 0.0
    return out


_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# PNG color type → channels (0 gray, 2 RGB, 4 gray+alpha, 6 RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data)) + tag + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def _to_ldr(image: np.ndarray, tonemap: bool) -> np.ndarray:
    img = np.asarray(image, np.float32)
    if tonemap:
        img = linear_to_srgb(img)
    return np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)


def encode_png(image: np.ndarray, tonemap: bool = True) -> bytes:
    """[h,w,3|4] linear float → 8-bit RGB/RGBA PNG bytes (sRGB-encoded when
    `tonemap`, like hdrToLdr.cpp:22-40). Rows are stored unfiltered."""
    img = _to_ldr(image, tonemap)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected [h,w,3|4], got {img.shape}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (
        _PNG_SIG
        + _png_chunk(b"IHDR", ihdr)
        + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
        + _png_chunk(b"IEND", b"")
    )


def write_png(path: str | Path, image: np.ndarray, tonemap: bool = True) -> None:
    """Write [h,w,3|4] linear float32 → PNG (see `encode_png`)."""
    Path(path).write_bytes(encode_png(image, tonemap))


def _unfilter(raw: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (None, Sub, Up, Average, Paeth).

    Every filter predicts a pixel from its left (a), upper (b) and upper-left
    (c) neighbours only, so the pixels of one anti-diagonal (x + y constant)
    do not depend on each other: the loop walks the h + w - 1 diagonals, one
    vectorised step each, whatever mix of filters the rows use."""
    rows = raw.reshape(h, w * bpp + 1)
    ftype = rows[:, 0]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {ftype.max()}")
    line = rows[:, 1:].reshape(h, w, bpp).astype(np.int16)
    out = np.zeros((h + 1, w + 1, bpp), np.int16)  # row 0 and column 0: zero border
    for k in range(h + w - 1):
        y = np.arange(max(0, k - w + 1), min(h, k + 1))
        x = k - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(ftype[y, None], (0 * a, a, b, (a + b) >> 1, paeth))
        out[y + 1, x + 1] = (line[y, x] + pred) & 255
    return out[1:, 1:].astype(np.uint8).reshape(h, w * bpp)


def read_png(path: str | Path) -> np.ndarray:
    """Read an 8-bit, non-interlaced gray/RGB/RGBA PNG → [h,w,c] uint8."""
    buf = Path(path).read_bytes()
    if not buf.startswith(_PNG_SIG):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = len(_PNG_SIG), [], None
    while pos < len(buf):
        (n,) = struct.unpack_from(">I", buf, pos)
        tag, data = buf[pos + 4 : pos + 8], buf[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced gray/RGB/RGBA PNGs are read "
            f"(bit depth {depth}, color type {ctype}, interlace {interlace})"
        )
    c = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return _unfilter(raw, h, w, c).reshape(h, w, c)


def read_image(path: str | Path) -> np.ndarray:
    """Read PNG, `.hdr` (RGBE) or EXR → [h,w,3] float32; PNG lands in
    [0,1], HDR formats keep linear radiance. Other formats raise."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".exr":
        return read_exr(path)[..., :3]
    if suffix == ".hdr":
        return read_hdr(path)
    if suffix != ".png":
        raise ValueError(
            f"{path}: unsupported image format '{suffix}' "
            "(PNG, EXR and Radiance .hdr are read)"
        )
    img = read_png(path)
    if img.shape[2] in (1, 2):  # gray (+alpha) → RGB
        img = np.repeat(img[..., :1], 3, axis=2)
    return img[..., :3].astype(np.float32) / 255.0
