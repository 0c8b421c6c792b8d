"""OpenVDB reader validation against files with embedded ground truth.

OpenVDB embeds `file_voxel_count` and `file_bbox_min/max` metadata per grid
(written by the tool that produced the file), so the decoder is checked
against counts it does not compute. The files are small fluid-like grids
written here to the OpenVDB layout (float 5_4_3 trees, a vec3 grid to
skip), once with raw values and once the way fluid caches are stored:
blosc-compressed active values (lz4, byte shuffle; a memcpyed chunk for a
leaf with few active voxels). Mirrors the role of NvdbVolume.vdb.cpp:9-58
(the reference's .vdb ingestion).
"""

import struct
from pathlib import Path

import numpy as np
import pytest

from optix_renderer_tpu.scene import vdb as V
from optix_renderer_tpu.scene.volume_io import load_volume


def _str(s: str) -> bytes:
    return struct.pack("<I", len(s)) + s.encode()


def _mask(bits) -> bytes:
    return np.packbits(np.asarray(bits, bool), bitorder="little").tobytes()


def _values(vals) -> bytes:
    # per-node metadata byte NO_MASK_AND_ALL_VALS, then every value raw
    return bytes([6]) + np.asarray(vals, "<f4").tobytes()


def _lz4_literals(data: bytes) -> bytes:
    """An LZ4 block holding `data` as one literal run."""
    if len(data) < 15:
        return bytes([len(data) << 4]) + data
    ext = len(data) - 15
    return bytes([0xF0]) + b"\xff" * (ext // 255) + bytes([ext % 255]) + data


def _blosc(raw: bytes, typesize: int = 4) -> bytes:
    """A c-blosc 1.x chunk (lz4, byte shuffle) that decodes to `raw`. Under
    128 bytes c-blosc stores the values as they are: memcpyed, with the
    shuffle flag still set. Above, one shuffled block, its `typesize` byte
    planes each an LZ4 stream of their own."""
    n, flags = len(raw), 0x1 | (1 << 5)
    if n < 128:
        return bytes([2, 1, flags | 0x2, typesize]) + struct.pack("<III", n, n, 16 + n) + raw
    planes = np.frombuffer(raw, np.uint8).reshape(-1, typesize).T
    streams = [_lz4_literals(pl.tobytes()) for pl in planes]
    body = struct.pack("<I", 20) + b"".join(struct.pack("<i", len(b)) + b for b in streams)
    return bytes([2, 1, flags, typesize]) + struct.pack("<III", n, n, 16 + len(body)) + body


def _active_values(vals) -> bytes:
    # blosc + active mask: metadata NO_MASK_OR_INACTIVE_VALS, then the active
    # values only, as a sized blosc chunk (none at all when nothing is active)
    active = np.asarray(vals, "<f4")[np.asarray(vals) > 0]
    if active.size == 0:
        return bytes([0])
    chunk = _blosc(active.tobytes())
    return bytes([0]) + struct.pack("<q", len(chunk)) + chunk


def _float_tree(leaves: dict, blosc: bool) -> bytes:
    """Root → one 32³ internal node at the origin → one 16³ node at the
    origin → 8³ leaves at `leaves` origins (multiples of 8 below 128)."""
    values = _active_values if blosc else _values
    int1_child = np.zeros(16**3, bool)
    order = []
    for o in leaves:
        n = (o[0] // 8) * 256 + (o[1] // 8) * 16 + o[2] // 8
        int1_child[n] = True
        order.append((n, o))
    order = [o for _, o in sorted(order)]  # readers visit children by index
    int2_child = np.zeros(32**3, bool)
    int2_child[0] = True
    topo = struct.pack("<IfII", 1, 0.0, 0, 1) + struct.pack("<iii", 0, 0, 0)
    topo += _mask(int2_child) + _mask(np.zeros(32**3, bool)) + values(np.zeros(32**3))
    topo += _mask(int1_child) + _mask(np.zeros(16**3, bool)) + values(np.zeros(16**3))
    for o in order:
        topo += _mask(leaves[o] > 0)  # leaf topology: the value mask
    for o in order:
        topo += _mask(leaves[o] > 0) + values(leaves[o])
    return topo


def write_vdb(path, grids: dict, voxel_size: float = 0.05, blosc: bool = False) -> None:
    """Write {name: {leaf origin: float32[512] (x-major)}} float grids plus a
    vec3 `v` grid (opaque bytes) in OpenVDB file format 224; positive values
    are active. `blosc` stores active values only, blosc-compressed."""
    compression = V._COMPRESS_BLOSC | V._COMPRESS_ACTIVE_MASK if blosc else 0
    descs = []
    for name, leaves in grids.items():
        idx = np.array([(o[0] + i // 64, o[1] + i // 8 % 8, o[2] + i % 8)
                        for o, vals in leaves.items() for i in np.nonzero(vals > 0)[0]])
        meta = [("file_voxel_count", "int64", struct.pack("<q", len(idx))),
                ("file_bbox_min", "vec3i", struct.pack("<iii", *idx.min(0))),
                ("file_bbox_max", "vec3i", struct.pack("<iii", *idx.max(0)))]
        body = struct.pack("<I", compression) + struct.pack("<I", len(meta))
        body += b"".join(_str(k) + _str(t) + struct.pack("<I", len(v)) + v for k, t, v in meta)
        body += _str("UniformScaleMap") + struct.pack("<3d", *[voxel_size] * 3) + bytes(96)
        body += _float_tree(leaves, blosc)
        descs.append((name, "Tree_float_5_4_3", body))
    descs.append(("v", "Tree_vec3s_5_4_3", bytes(64)))

    out = struct.pack("<qIIIB", V._MAGIC, 224, 9, 0, 1) + b"0" * 36 + struct.pack("<I", 0)
    out += struct.pack("<I", len(descs))
    for name, gtype, body in descs:
        head = _str(name) + _str(gtype) + _str("")
        grid_pos = len(out) + len(head) + 24
        end_pos = grid_pos + len(body)
        out += head + struct.pack("<qqq", grid_pos, end_pos, end_pos) + body
    Path(path).write_bytes(out)


def _fluid_leaves(seed: int, scale: float):
    """8³ leaves of a smooth density-like field, empty (inactive) where it
    falls below a cut: three puffs, most voxels active, and a wisp of about
    a dozen."""
    rng = np.random.default_rng(seed)
    x, y, z = np.meshgrid(*(np.arange(8),) * 3, indexing="ij")
    leaves = {}
    for o, cut in (((0, 0, 0), 0.1), ((8, 0, 0), 0.1), ((0, 8, 8), 0.1), ((8, 8, 0), 0.9)):
        c = rng.uniform(2, 6, 3)
        f = np.exp(-((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / 18.0)
        leaves[o] = np.where(f > cut, scale * (0.05 + f), 0.0).astype(np.float32).reshape(-1)
    return leaves


def _grid_metadata(path, wanted):
    """Independent minimal parse of per-grid metadata maps (no tree decode)."""
    buf = open(path, "rb").read()
    r = V._R(buf)
    assert r.i64() == V._MAGIC
    version = r.u32()
    r.u32(), r.u32(), r.u8(), r.bytes_(36)
    V._skip_metamap(r)
    out = {}
    for _ in range(r.u32()):
        name = r.string().split("\x1e")[0]
        r.string()
        r.string()
        gp, _bp, ep = r.i64(), r.i64(), r.i64()
        r.pos = ep
        if name not in wanted:
            continue
        g = V._R(buf, gp)
        if version >= V._VER_NODE_MASK_COMPRESSION:
            g.u32()
        meta = {}
        for _ in range(g.u32()):
            k, _t = g.string(), g.string()
            meta[k] = g.bytes_(g.u32())
        out[name] = meta
    return out


@pytest.fixture(scope="module", params=["raw", "blosc"])
def fluid(request, tmp_path_factory):
    path = tmp_path_factory.mktemp("vdb") / "fluid.vdb"
    write_vdb(path, {"density": _fluid_leaves(0, 1.0), "temperature": _fluid_leaves(1, 1.2)},
              blosc=request.param == "blosc")
    return str(path)


@pytest.fixture(scope="module")
def fluid_grids(fluid):
    return V.read_vdb(fluid)


def test_active_voxel_count_matches_file_metadata(fluid, fluid_grids):
    meta = _grid_metadata(fluid, ("density", "temperature"))
    for name in ("density", "temperature"):
        expect = struct.unpack("<q", meta[name]["file_voxel_count"])[0]
        assert fluid_grids[name].active_count == expect, name


def test_bbox_matches_file_metadata(fluid, fluid_grids):
    meta = _grid_metadata(fluid, ("density",))
    bmin = np.array(struct.unpack("<iii", meta["density"]["file_bbox_min"]))
    bmax = np.array(struct.unpack("<iii", meta["density"]["file_bbox_max"]))
    g = fluid_grids["density"]
    # dense extents are leaf-aligned supersets of the active bbox
    lo_idx = g.bbox_min_world / g.voxel_size
    hi_idx = g.bbox_max_world / g.voxel_size
    assert np.all(lo_idx <= bmin) and np.all(hi_idx >= bmax + 1)
    assert np.all(lo_idx > bmin - 8) and np.all(hi_idx < bmax + 9)


def test_density_values_plausible(fluid_grids):
    d = fluid_grids["density"].values
    assert d.dtype == np.float32
    assert d.min() >= 0.0
    assert 0.5 < d.max() < 2.0  # fog density ~[0,1]
    assert (d > 0).sum() > 1000  # a real fluid, not an empty grid
    t = fluid_grids["temperature"].values
    assert t.shape == d.shape
    assert 0.0 <= t.min() and t.max() <= 1.5


def test_velocity_grid_skipped(fluid_grids):
    # vec3 grids are not in `wanted` and must not be decoded
    assert set(fluid_grids) == {"density", "temperature"}


def test_load_volume_vdb_path(fluid, tmp_path, monkeypatch):
    """scene/volume_io.py .vdb path end-to-end, including the .npz cache.

    The conversion cache lives under ORT_CACHE_DIR (default
    ~/.cache/optix_renderer_tpu/vdb), never beside the source — scene trees
    may be read-only checkouts (volume_io._load_vdb_cached)."""
    import os
    import shutil

    monkeypatch.setenv("ORT_CACHE_DIR", str(tmp_path / "cache"))
    local = tmp_path / "fluid.vdb"
    shutil.copy(fluid, local)
    v1 = load_volume(local)
    assert v1.temperature is not None
    assert v1.density.shape == v1.temperature.shape
    # cache file lands in the user cache dir, keyed by source path
    cached = list((tmp_path / "cache" / "vdb").glob("fluid-*.npz"))
    assert len(cached) == 1
    # nothing written beside the source
    assert list(tmp_path.glob("*.npz")) == []
    v2 = load_volume(local)  # cache hit
    assert np.array_equal(v1.density, v2.density)
    # mtime invalidation: touching the source forces a re-read
    os.utime(local, ns=(1, 1))
    v3 = load_volume(local)
    assert np.array_equal(v1.density, v3.density)


def test_lz4_block_roundtrip_overlapping_matches():
    """LZ4 decode incl. overlapping matches (RLE-style), vs a hand encoding."""
    # literals "abcd", then match offset=2 len=8 → "abcd" + "cdcdcdcd"
    src = bytes([0x44]) + b"abcd" + bytes([2, 0])
    # token 0x44: litlen 4, matchlen 0+4 → need matchlen 8 → token low=4
    src = bytes([0x44 | 0x04]) + b"abcd" + bytes([2, 0])
    out = V._lz4_block_decompress(src, 12)
    assert out == b"abcd" + b"cdcdcdcd"


def test_blosc_memcpy_chunk():
    payload = bytes(range(64))
    hdr = bytes([2, 1, 0x2, 1]) + struct.pack("<III", 64, 64, 16 + 64)
    assert V._blosc_decompress(hdr + payload) == payload


@pytest.mark.parametrize("blosc", [False, True], ids=["raw", "blosc"])
def test_written_grid_decodes_voxel_for_voxel(tmp_path, blosc):
    """Every written voxel lands at its index: leaf order x-major, leaves at
    their origins, the rest of the dense box at the background."""
    leaves = _fluid_leaves(3, 1.0)
    write_vdb(tmp_path / "f.vdb", {"density": leaves}, blosc=blosc)
    g = V.read_vdb(tmp_path / "f.vdb", wanted=("density",))["density"]
    lo = np.rint(g.bbox_min_world / g.voxel_size).astype(int)
    dense_xyz = g.values.transpose(2, 1, 0)
    expect = np.zeros_like(dense_xyz)
    for o, vals in leaves.items():
        s = np.array(o) - lo
        expect[s[0]:s[0] + 8, s[1]:s[1] + 8, s[2]:s[2] + 8] = vals.reshape(8, 8, 8)
    np.testing.assert_array_equal(dense_xyz, expect)
    assert g.active_count == sum(int((v > 0).sum()) for v in leaves.values())
