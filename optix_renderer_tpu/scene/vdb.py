"""Pure-Python OpenVDB `.vdb` reader → dense numpy grids.

Counterpart of the reference's OpenVDB→NanoVDB conversion path
(src/textures/NvdbVolume.vdb.cpp:9-58): where the reference densifies a
sparse VDB into a NanoVDB tree for GPU HDDA marching, this build
densifies it into a dense [Z,Y,X] numpy grid (the device representation is
dense bricks marched by delta tracking, ops/volume_grid.py).

Scope — exactly what the reference's scenes need (fluid_data_0050.vdb and
friends): OpenVDB file format ≥ 222 (NODE_MASK_COMPRESSION), scalar float
5_4_3 trees, optional half-float storage, per-grid "blosc + active values"
or zip or raw compression, UniformScale/Scale(+Translate)/Translation/Affine
transforms. Vec3 grids (velocity) are skipped via the grid-descriptor byte
offsets, so only the grids asked for are decoded.

The blosc container and LZ4 block codec are decoded in numpy/Python — VDB
ingestion is a one-time scene-compile step cached as .npz in the user cache
directory (scene/volume_io.py), so decode speed is irrelevant.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

_MAGIC = 0x56444220  # int64 " BDV" little-endian

# file format version milestones (openvdb/version.h)
_VER_GRID_INSTANCING = 219
_VER_BOOST_UUID = 221
_VER_NODE_MASK_COMPRESSION = 222

# per-grid compression flags (openvdb/io/Compression.h)
_COMPRESS_ZIP = 0x1
_COMPRESS_ACTIVE_MASK = 0x2
_COMPRESS_BLOSC = 0x4

# readCompressedValues node-metadata codes (openvdb/io/Compression.h)
_NO_MASK_OR_INACTIVE_VALS = 0
_NO_MASK_AND_MINUS_BG = 1
_NO_MASK_AND_ONE_INACTIVE_VAL = 2
_MASK_AND_NO_INACTIVE_VALS = 3
_MASK_AND_ONE_INACTIVE_VAL = 4
_MASK_AND_TWO_INACTIVE_VALS = 5
_NO_MASK_AND_ALL_VALS = 6


class VdbError(ValueError):
    pass


@dataclass
class VdbGrid:
    name: str
    values: np.ndarray  # [D,H,W] float32, (z,y,x) index order
    bbox_min_world: np.ndarray  # [3]
    bbox_max_world: np.ndarray  # [3]
    voxel_size: np.ndarray  # [3]
    background: float
    active_count: int  # active voxels (== file_voxel_count metadata)


class _R:
    """Little-endian byte-stream reader."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def bytes_(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise VdbError("unexpected end of file")
        self.pos += n
        return b

    def u8(self) -> int:
        return self.bytes_(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.bytes_(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self.bytes_(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.bytes_(8))[0]

    def f32(self) -> float:
        return struct.unpack("<f", self.bytes_(4))[0]

    def string(self) -> str:
        n = self.u32()
        return self.bytes_(n).decode("utf-8", "replace")

    def coord(self) -> tuple[int, int, int]:
        return struct.unpack("<iii", self.bytes_(12))


# ---------------------------------------------------------------------------
# blosc container + LZ4 block codec
# ---------------------------------------------------------------------------


def _lz4_block_decompress(src: bytes, dst_size: int) -> bytes:
    """LZ4 block format (token/literals/offset/match), pure Python."""
    dst = bytearray(dst_size)
    n_src, sp, dp = len(src), 0, 0
    while sp < n_src:
        token = src[sp]
        sp += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[sp]
                sp += 1
                lit += b
                if b != 255:
                    break
        if lit:
            dst[dp : dp + lit] = src[sp : sp + lit]
            sp += lit
            dp += lit
        if sp >= n_src:
            break  # last sequence has no match part
        offset = src[sp] | (src[sp + 1] << 8)
        sp += 2
        if offset == 0:
            raise VdbError("corrupt LZ4 stream (zero offset)")
        mlen = (token & 15) + 4
        if mlen == 19:
            while True:
                b = src[sp]
                sp += 1
                mlen += b
                if b != 255:
                    break
        ms = dp - offset
        if offset >= mlen:  # non-overlapping: slice copy
            dst[dp : dp + mlen] = dst[ms : ms + mlen]
            dp += mlen
        else:  # overlapping run: byte-at-a-time semantics
            for _ in range(mlen):
                dst[dp] = dst[ms]
                dp += 1
                ms += 1
    if dp != dst_size:
        raise VdbError(f"LZ4 decode size mismatch: {dp} != {dst_size}")
    return bytes(dst)


def _blosc_decompress(src: bytes) -> bytes:
    """Decode a c-blosc 1.x chunk (the only container OpenVDB writes).

    Header: version, versionlz, flags, typesize, nbytes, blocksize, cbytes
    (16 bytes); then per-block uint32 offsets; blocks are split into
    `typesize` sub-streams (c-blosc forward-compat split for blosclz/lz4),
    each sub-stream prefixed by an int32 compressed size. Shuffle applies
    per block; a memcpyed chunk holds the values as they are, whatever the
    shuffle flag says.
    """
    if len(src) < 16:
        raise VdbError("blosc chunk too short")
    version, _vlz, flags, typesize = src[0], src[1], src[2], src[3]
    nbytes, blocksize, cbytes = struct.unpack("<III", src[4:16])
    if version < 1 or version > 2:
        raise VdbError(f"unsupported blosc version {version}")
    if cbytes != len(src):
        # trailing bytes are tolerated (caller sliced by the stored count)
        src = src[:cbytes]
    shuffle = bool(flags & 0x1)
    memcpyed = bool(flags & 0x2)
    codec = flags >> 5  # 0 blosclz, 1 lz4/lz4hc, 3 zlib, 4 zstd

    if memcpyed:
        out = src[16 : 16 + nbytes]
    else:
        nblocks = (nbytes + blocksize - 1) // blocksize
        bstarts = struct.unpack(f"<{nblocks}I", src[16 : 16 + 4 * nblocks])
        # forward-compat split: blosclz/lz4 split blocks into typesize parts
        do_split = (
            codec in (0, 1)
            and 1 < typesize <= 16
            and blocksize % typesize == 0
            and blocksize // typesize >= 128
        )
        out = bytearray(nbytes)
        opos = 0
        for bi in range(nblocks):
            bsize = min(blocksize, nbytes - opos)
            nsplits = typesize if (do_split and bsize % typesize == 0) else 1
            neblock = bsize // nsplits
            sp = bstarts[bi]
            block = bytearray()
            for _ in range(nsplits):
                (csize,) = struct.unpack("<i", src[sp : sp + 4])
                sp += 4
                part = src[sp : sp + csize]
                sp += csize
                if csize == neblock:  # stored raw (incompressible)
                    dec = part
                elif codec == 1:
                    dec = _lz4_block_decompress(part, neblock)
                elif codec == 3:
                    import zlib

                    dec = zlib.decompress(part)
                else:
                    raise VdbError(f"unsupported blosc codec id {codec}")
                block += dec
            if shuffle and typesize > 1:
                block = _unshuffle(bytes(block), typesize)
            out[opos : opos + bsize] = block
            opos += bsize
        out = bytes(out)
    return out


def _unshuffle(block: bytes, typesize: int) -> bytes:
    """Undo c-blosc's byte shuffle of one block: `typesize` byte planes of
    the whole elements, then the trailing bytes unshuffled."""
    n = len(block) - len(block) % typesize
    planes = np.frombuffer(block, np.uint8, count=n).reshape(typesize, -1)
    return planes.T.tobytes() + block[n:]


# ---------------------------------------------------------------------------
# OpenVDB tree decode (float 5_4_3)
# ---------------------------------------------------------------------------

_LEAF_LOG2 = 3  # 8³ leaves
_INT1_LOG2 = 4  # 16³ children → spans 128 voxels
_INT2_LOG2 = 5  # 32³ children → spans 4096 voxels


def _load_mask(r: _R, size_bits: int) -> np.ndarray:
    """NodeMask::load → bool[size_bits] (bit i = (byte[i>>3]>>(i&7))&1)."""
    raw = np.frombuffer(r.bytes_(size_bits // 8), np.uint8)
    return np.unpackbits(raw, bitorder="little").astype(bool)


class _GridReader:
    """Sequential decoder for one scalar-float grid."""

    def __init__(self, r: _R, version: int, from_half: bool):
        self.r = r
        self.version = version
        self.from_half = from_half
        self.compression = 0
        self.background = 0.0
        # collected into the dense grid later:
        self.leaves: list[tuple[tuple[int, int, int], np.ndarray]] = []  # origin, mask
        self.tiles: list[tuple[tuple[int, int, int], int, float]] = []  # origin, span, value
        self.leaf_values: list[np.ndarray] = []  # [512] float32 per leaf (buffer pass)

    # -- low-level helpers ---------------------------------------------------

    def _read_values_raw(self, count: int) -> np.ndarray:
        """io::readData: blosc/zip/raw array of `count` stored values."""
        r = self.r
        itemsize = 2 if self.from_half else 4
        dtype = np.float16 if self.from_half else np.float32
        if self.compression & _COMPRESS_BLOSC:
            n = r.i64()
            if n <= 0:
                raw = r.bytes_(-n)
            else:
                raw = _blosc_decompress(r.bytes_(n))
        elif self.compression & _COMPRESS_ZIP:
            import zlib

            n = r.i64()
            if n <= 0:
                raw = r.bytes_(-n)
            else:
                raw = zlib.decompress(r.bytes_(n))
        else:
            raw = r.bytes_(count * itemsize)
        vals = np.frombuffer(raw, dtype, count=count)
        return vals.astype(np.float32)

    def _read_compressed_values(self, count: int, value_mask: np.ndarray) -> np.ndarray:
        """io::readCompressedValues → dense float32[count] (inactive = bg)."""
        r = self.r
        mask_compressed = bool(self.compression & _COMPRESS_ACTIVE_MASK)
        metadata = _NO_MASK_AND_ALL_VALS
        if self.version >= _VER_NODE_MASK_COMPRESSION:
            metadata = r.u8()
        inactive0 = self.background
        inactive1 = self.background
        if metadata in (
            _NO_MASK_AND_ONE_INACTIVE_VAL,
            _MASK_AND_ONE_INACTIVE_VAL,
            _MASK_AND_TWO_INACTIVE_VALS,
        ):
            inactive0 = self._read_value()
            if metadata == _MASK_AND_TWO_INACTIVE_VALS:
                inactive1 = self._read_value()
        elif metadata == _NO_MASK_AND_MINUS_BG:
            inactive0 = -self.background
        selection = None
        if metadata in (
            _MASK_AND_NO_INACTIVE_VALS,
            _MASK_AND_ONE_INACTIVE_VAL,
            _MASK_AND_TWO_INACTIVE_VALS,
        ):
            selection = _load_mask(r, count)
        stored = count
        if mask_compressed and metadata != _NO_MASK_AND_ALL_VALS:
            stored = int(value_mask.sum())
        if stored == 0:  # zero-count buffers are elided entirely on write
            return np.full(count, inactive0, np.float32)
        vals = self._read_values_raw(stored)
        if stored == count:
            return vals
        out = np.full(count, inactive0, np.float32)
        if selection is not None:
            # selection mask picks the second inactive value (-bg for case 3)
            second = -self.background if metadata == _MASK_AND_NO_INACTIVE_VALS else inactive1
            out[selection] = second
        out[value_mask] = vals
        return out

    def _read_value(self) -> float:
        # node-metadata inactive values are stored in the STORAGE type
        if self.from_half:
            return float(np.frombuffer(self.r.bytes_(2), np.float16)[0])
        return self.r.f32()

    # -- tree topology ---------------------------------------------------------

    def read_tree(self):
        r = self.r
        buffer_count = r.u32()  # TreeBase::readTopology
        if buffer_count != 1:
            raise VdbError(f"multi-buffer trees unsupported ({buffer_count})")
        # RootNode::readTopology — background stored in the FULL value type
        self.background = r.f32()
        num_tiles = r.u32()
        num_children = r.u32()
        for _ in range(num_tiles):
            ijk = r.coord()
            value = r.f32()
            active = r.u8() != 0
            if active:
                self.tiles.append((ijk, 1 << (_INT2_LOG2 + _INT1_LOG2 + _LEAF_LOG2), value))
        children = []
        for _ in range(num_children):
            ijk = r.coord()
            children.append(ijk)
            self._read_internal_topology(ijk, level=2)
        # buffers pass (root children in the same sorted-map order)
        for origin, mask in self.leaves:
            self._read_leaf_buffer(mask)

    def _read_internal_topology(self, origin, level: int):
        r = self.r
        log2 = _INT2_LOG2 if level == 2 else _INT1_LOG2
        n_entries = 1 << (3 * log2)
        child_span = (
            1 << (_INT1_LOG2 + _LEAF_LOG2) if level == 2 else 1 << _LEAF_LOG2
        )
        child_mask = _load_mask(r, n_entries)
        value_mask = _load_mask(r, n_entries)
        values = self._read_compressed_values(n_entries, value_mask)
        # active tiles: valueMask on, childMask off → constant child_span³ region
        tile_idx = np.nonzero(value_mask & ~child_mask)[0]
        dim = 1 << log2
        for n in tile_idx:
            x = int(n) >> (2 * log2)
            y = (int(n) >> log2) & (dim - 1)
            z = int(n) & (dim - 1)
            tijk = (
                origin[0] + x * child_span,
                origin[1] + y * child_span,
                origin[2] + z * child_span,
            )
            self.tiles.append((tijk, child_span, float(values[n])))
        for n in np.nonzero(child_mask)[0]:
            x = int(n) >> (2 * log2)
            y = (int(n) >> log2) & (dim - 1)
            z = int(n) & (dim - 1)
            cijk = (
                origin[0] + x * child_span,
                origin[1] + y * child_span,
                origin[2] + z * child_span,
            )
            if level == 2:
                self._read_internal_topology(cijk, level=1)
            else:
                leaf_mask = _load_mask(self.r, 512)  # LeafNode::readTopology
                self.leaves.append((cijk, leaf_mask))

    def _read_leaf_buffer(self, topo_mask: np.ndarray):
        # LeafNode::readBuffers: value mask again, then compressed buffer
        mask = _load_mask(self.r, 512)
        vals = self._read_compressed_values(512, mask)
        self.leaf_values.append(vals)


def _read_transform(r: _R) -> tuple[np.ndarray, np.ndarray]:
    """Transform::read → (voxel_size[3], translation[3]). Linear maps only."""
    name = r.string()
    vec3d = lambda: np.array(struct.unpack("<ddd", r.bytes_(24)))
    if name in ("UniformScaleMap", "ScaleMap"):
        scale = vec3d()
        r.bytes_(24 * 4)  # voxelSize, scaleInv, invScaleSqr, invTwiceScale
        return scale, np.zeros(3)
    if name in ("UniformScaleTranslateMap", "ScaleTranslateMap"):
        translation = vec3d()
        scale = vec3d()
        r.bytes_(24 * 4)
        return scale, translation
    if name == "TranslationMap":
        return np.ones(3), vec3d()
    if name == "AffineMap":
        m = np.array(struct.unpack("<16d", r.bytes_(128))).reshape(4, 4)
        return np.diagonal(m)[:3].copy(), m[3, :3].copy()
    raise VdbError(f"unsupported VDB transform map '{name}'")


def _skip_metamap(r: _R):
    count = r.u32()
    for _ in range(count):
        r.string()  # name
        r.string()  # type
        n = r.u32()  # value blob
        r.bytes_(n)


def read_vdb(path, wanted: tuple[str, ...] = ("density", "temperature")) -> dict:
    """Read `.vdb` → {grid_name: VdbGrid} for scalar-float grids in `wanted`.

    Raises VdbError on unsupported features with a message naming them.
    """
    buf = open(path, "rb").read()
    r = _R(buf)
    if r.i64() != _MAGIC:
        raise VdbError(f"{path}: not an OpenVDB file")
    version = r.u32()
    if version < _VER_NODE_MASK_COMPRESSION:
        raise VdbError(f"{path}: file version {version} < 222 unsupported")
    r.u32()  # library major
    r.u32()  # library minor
    r.u8()  # hasGridOffsets (always written by openvdb tools)
    if version >= _VER_BOOST_UUID:
        r.bytes_(36)  # raw ascii uuid
    else:
        r.string()
    _skip_metamap(r)

    out: dict[str, VdbGrid] = {}
    n_grids = r.u32()
    for _ in range(n_grids):
        unique = r.string()
        grid_name = unique.split("\x1e")[0]  # GridDescriptor name suffix sep
        grid_type = r.string()
        from_half = grid_type.endswith("_HalfFloat")
        base_type = grid_type.removesuffix("_HalfFloat")
        if version >= _VER_GRID_INSTANCING:
            r.string()  # instance parent name
        grid_pos = r.i64()
        _block_pos = r.i64()
        end_pos = r.i64()
        # grid data follows its descriptor inline; the next descriptor
        # starts at endPos (Archive::readGridDescriptors seek pattern)
        r.pos = end_pos

        if grid_name not in wanted:
            continue
        if base_type != "Tree_float_5_4_3":
            raise VdbError(
                f"{path}: grid '{grid_name}' has unsupported tree type {grid_type}"
            )

        g = _R(buf, grid_pos)
        gr = _GridReader(g, version, from_half)
        if version >= _VER_NODE_MASK_COMPRESSION:
            gr.compression = g.u32()
        _skip_metamap(g)
        voxel_size, translation = _read_transform(g)
        gr.read_tree()
        if g.pos > end_pos:
            raise VdbError(f"{path}: grid '{grid_name}' overran its extent")
        out[grid_name] = _densify(gr, grid_name, voxel_size, translation)
    return out


def _densify(gr: _GridReader, name: str, voxel_size, translation) -> VdbGrid:
    """Scatter leaves + active tiles into a dense [Z,Y,X] float32 grid."""
    mins, maxs = [], []
    for (o, mask), _ in zip(gr.leaves, gr.leaf_values):
        mins.append(o)
        maxs.append((o[0] + 8, o[1] + 8, o[2] + 8))
    for o, span, _ in gr.tiles:
        mins.append(o)
        maxs.append((o[0] + span, o[1] + span, o[2] + span))
    if not mins:
        lo = np.zeros(3, np.int64)
        hi = np.ones(3, np.int64)
    else:
        lo = np.min(np.array(mins), axis=0)
        hi = np.max(np.array(maxs), axis=0)
    shape_xyz = hi - lo
    if np.prod(shape_xyz) > 1_500_000_000:
        raise VdbError(f"grid '{name}' too large to densify: {shape_xyz}")
    dense = np.full(tuple(shape_xyz), gr.background, np.float32)  # [X,Y,Z]
    for o, span, value in gr.tiles:
        s = np.array(o) - lo
        dense[s[0] : s[0] + span, s[1] : s[1] + span, s[2] : s[2] + span] = value
    for (o, _topo_mask), vals in zip(gr.leaves, gr.leaf_values):
        s = np.array(o) - lo
        dense[s[0] : s[0] + 8, s[1] : s[1] + 8, s[2] : s[2] + 8] = vals.reshape(8, 8, 8)
    values_zyx = np.ascontiguousarray(dense.transpose(2, 1, 0))
    active = sum(int(m.sum()) for _, m in gr.leaves) + sum(
        span**3 for _, span, _ in gr.tiles
    )
    bbox_min = lo * voxel_size + translation
    bbox_max = hi * voxel_size + translation
    return VdbGrid(
        name=name,
        values=values_zyx,
        bbox_min_world=bbox_min.astype(np.float32),
        bbox_max_world=bbox_max.astype(np.float32),
        voxel_size=np.asarray(voxel_size, np.float32),
        background=float(gr.background),
        active_count=active,
    )
