"""Photon mapping: wavefront photon tracing + hash-grid radiance estimation.

Counterpart of the reference photon mapper
(src/integrators/photonmapper.cpp, include/nori/{photon,kdtree}.h):

* **Tracing** (`trace_photons`): the reference's per-photon while loop
  (photonmapper.cpp:88-150 — emitter pick via lightProb DPDF, samplePhoton,
  store at diffuse hits, RR after 3 bounces with min(W.max, 0.99) survival,
  BSDF-sampled continuation) becomes a masked `lax.scan` over a photon
  wavefront; every (photon, depth) slot yields a candidate store + validity.

* **Map** (`build_photon_map`): the balanced kd-tree (kdtree.h:124) is
  replaced by a **uniform hash grid sorted by cell hash** — range search
  becomes 27 neighbor-cell `searchsorted` lookups + bounded per-cell scans,
  which are pure gathers (no pointer chasing), the layout a wavefront wants
  (SURVEY.md §7 phase 4: "kd-tree → grid-hash gather").

* **Gather** (`estimate_radiance`): photon-density estimate at a shading
  point, Σ power·f(wi,wo) / (π r² · emitted) (photonmapper.cpp:212-236).

Caveat vs the reference: per-cell scans are capped at `MAX_PER_CELL` photons
(a static bound); with the default cell size = gather radius and typical
photon counts the cap is rarely hit, and the estimator stays consistent as
counts grow (the same class of truncation as the reference's fixed-size
result vector reserve).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from optix_renderer_tpu.core import warp
from optix_renderer_tpu.core.math import (
    EPSILON,
    Ray,
    frame_to_local,
    frame_to_world,
    make_frame,
    normalize,
)
from optix_renderer_tpu.core import dpdf as dpdf_mod
from optix_renderer_tpu.render import sampler as smp

# NOTE: ops.bsdf / ops.emitter / integrators.common are imported lazily inside
# functions — scene.data imports this module for the PhotonMap pytree type,
# and those modules import scene.data (the one deliberate cycle).

MAX_PER_CELL = 16
# photon-storing (isDiffuse) BSDF types — diffuse.cpp:142, disney.cpp:229
_DIFFUSE_TYPES = (0, 4)  # BsdfType.DIFFUSE, BsdfType.DISNEY


class PhotonMap(NamedTuple):
    """Hash-grid photon map (all arrays device-resident, sorted by hash)."""

    pos: jnp.ndarray  # [P,3]
    dir: jnp.ndarray  # [P,3] direction the photon arrived FROM (= -ray.d)
    power: jnp.ndarray  # [P,3]
    cell_hash: jnp.ndarray  # [P] int32, ascending
    origin: jnp.ndarray  # [3] grid origin
    inv_cell: jnp.ndarray  # [] 1/cell_size
    radius: jnp.ndarray  # [] gather radius
    inv_emitted: jnp.ndarray  # [] 1/#emitted photons
    table_size: int  # static: hash modulus (power of two)


def empty_photon_map() -> PhotonMap:
    return PhotonMap(
        pos=jnp.zeros((0, 3), jnp.float32),
        dir=jnp.zeros((0, 3), jnp.float32),
        power=jnp.zeros((0, 3), jnp.float32),
        cell_hash=jnp.zeros((0,), jnp.int32),
        origin=jnp.zeros((3,), jnp.float32),
        inv_cell=jnp.float32(1.0),
        radius=jnp.float32(0.0),
        inv_emitted=jnp.float32(0.0),
        table_size=1,
    )


def _hash_cells(cx, cy, cz, table_size: int):
    """Spatial hash (Teschner et al.) of integer cell coords → [0, M)."""
    h = (
        cx.astype(jnp.uint32) * jnp.uint32(73856093)
        ^ cy.astype(jnp.uint32) * jnp.uint32(19349663)
        ^ cz.astype(jnp.uint32) * jnp.uint32(83492791)
    )
    return (h & jnp.uint32(table_size - 1)).astype(jnp.int32)


def _hash_cells_np(c, table_size: int):
    h = (
        c[:, 0].astype(np.uint32) * np.uint32(73856093)
        ^ c[:, 1].astype(np.uint32) * np.uint32(19349663)
        ^ c[:, 2].astype(np.uint32) * np.uint32(83492791)
    )
    return (h & np.uint32(table_size - 1)).astype(np.int32)


# ---------------------------------------------------------------------------
# Photon emission (Emitter::samplePhoton counterparts)
# ---------------------------------------------------------------------------


def _scene_bounding_sphere(scene):
    """World bounding sphere (center [3], radius []) over all primitives."""
    geom = scene.geometry
    los, his = [], []
    if geom.tri_v0.shape[0] > 0:
        v0 = geom.tri_v0
        v1 = geom.tri_v0 + geom.tri_e1
        v2 = geom.tri_v0 + geom.tri_e2
        verts = jnp.concatenate([v0, v1, v2], axis=0)
        los.append(jnp.min(verts, axis=0))
        his.append(jnp.max(verts, axis=0))
    if geom.sph_center.shape[0] > 0:
        r = geom.sph_radius[:, None]
        los.append(jnp.min(geom.sph_center - r, axis=0))
        his.append(jnp.max(geom.sph_center + r, axis=0))
    if not los:
        return jnp.zeros(3), jnp.float32(1.0)
    lo = jnp.min(jnp.stack(los), axis=0)
    hi = jnp.max(jnp.stack(his), axis=0)
    center = 0.5 * (lo + hi)
    radius = 0.5 * jnp.linalg.norm(hi - lo) + 1e-3
    return center, radius


def sample_photon(scene, em_id, u2a, u2b, u1):
    """Emit one photon per lane from emitter `em_id`.

    Mirrors/extends the reference samplePhoton overloads:
    - area (arealight.cpp:127-144): surface point + cosine-hemisphere
      direction, W = π·area·radiance;
    - point (extension; reference base throws, emitter.h:114-118):
      uniform-sphere direction, W = power;
    - envmap (EnvMap::samplePhoton, environmentmap.cpp:133-145; corrected —
      the reference shoots the NEE shadow ray itself): luminance-importance
      direction, origin uniform on a disk tangent to the scene bounding
      sphere, W = L(ω)·πR²/pdf(ω);
    - volume (extension; volumelight.cpp:79-83 throws): bbox/ball-uniform
      point + uniform-sphere direction, W = 4π·V·radiance;
    - others: W = 0 (no photons; the lane dies immediately).

    `u2a`/`u2b` are [N,2]; `u1` is [N] (third volume-point axis / disk reuse).
    Returns (ray_o, ray_d, W).
    """
    from optix_renderer_tpu.ops import envmap as envmap_ops
    from optix_renderer_tpu.ops.emitter import _sample_shape_surface
    from optix_renderer_tpu.scene.data import EmitterGeom, EmitterType

    em = scene.emitters
    et = em.type[em_id]

    # area: point on surface + cosine hemisphere about the normal
    p_s, n_s, inv_area = _sample_shape_surface(scene, em_id, u2a)
    wi_local = warp.square_to_cosine_hemisphere(u2b)
    fr = make_frame(n_s)
    d_area = frame_to_world(fr, wi_local)
    w_area = (jnp.pi / jnp.maximum(inv_area, 1e-20))[..., None] * em.radiance[em_id]

    # point: uniform sphere
    d_point = warp.square_to_uniform_sphere(u2b)
    w_point = em.power[em_id]

    # envmap: importance-sampled incoming direction wi; photons travel -wi
    # from a disk of radius R placed outside the bounding sphere. Flux through
    # the disk: Φ = πR²·∫L dω → W = L·πR²/pdf with a uniform disk origin.
    wi_env, pdf_env, rad_env = envmap_ops.sample_dir(
        scene.envmap, scene.envmap_pick, u2a
    )
    c_w, r_w = _scene_bounding_sphere(scene)
    fr_env = make_frame(-wi_env)
    disk = warp.square_to_uniform_disk(jnp.stack([u1, u2b[..., 0]], -1)) * r_w
    o_env = (
        c_w
        + wi_env * (2.0 * r_w)
        + fr_env.s * disk[..., 0:1]
        + fr_env.t * disk[..., 1:2]
    )
    w_env = rad_env * (jnp.pi * r_w * r_w) / jnp.maximum(pdf_env, 1e-20)[..., None]

    # volume: uniform point in the attached shape's volume + uniform sphere
    # direction; W = Le/(pdf_p·pdf_ω) = radiance·V·4π
    u3 = jnp.stack([u2a[..., 0], u2a[..., 1], u1], -1)
    p_box = em.bbox_min[em_id] + em.bbox_extent[em_id] * u3
    if scene.geometry.sph_center.shape[0] > 0:
        sid_v = jnp.maximum(em.sphere_id[em_id], 0)
        p_ball = (
            scene.geometry.sph_center[sid_v]
            + scene.geometry.sph_radius[sid_v][..., None]
            * warp.square_to_uniform_sphere_volume(u3)
        )
        p_vol = jnp.where(
            (em.geom_kind[em_id] == EmitterGeom.SPHERE)[..., None], p_ball, p_box
        )
    else:
        p_vol = p_box
    w_vol = (4.0 * jnp.pi * em.volume[em_id])[..., None] * em.radiance[em_id]

    is_area = et == EmitterType.AREA
    is_point = et == EmitterType.POINT
    is_env = et == EmitterType.ENVMAP
    is_vol = et == EmitterType.VOLUME

    ro = jnp.where(
        is_area[..., None],
        p_s,
        jnp.where(
            is_env[..., None],
            o_env,
            jnp.where(is_vol[..., None], p_vol, em.position[em_id]),
        ),
    )
    rd = jnp.where(
        is_area[..., None],
        d_area,
        jnp.where(is_env[..., None], -wi_env, d_point),
    )
    W = jnp.where(
        is_area[..., None],
        w_area,
        jnp.where(
            is_point[..., None],
            w_point,
            jnp.where(
                is_env[..., None], w_env, jnp.where(is_vol[..., None], w_vol, 0.0)
            ),
        ),
    )
    # offset surface-emitter origins to avoid self-hits
    ro = ro + jnp.where((is_area | is_env)[..., None], rd * EPSILON, 0.0)
    return ro, rd, W


def trace_photons(scene, n_emit: int, max_depth: int, n_lights: int, stream):
    """Trace `n_emit` photons for `max_depth` bounces (jit-compiled).

    `stream` is a traced uint32 batch id (so emission batches don't retrace).
    Returns (pos [D,N,3], dir_in [D,N,3], power [D,N,3], valid [D,N]) where
    slot [d,i] is photon i's candidate store at depth d (valid where the
    surface isDiffuse — photonmapper.cpp:107-124).
    """
    from optix_renderer_tpu.integrators import common
    from optix_renderer_tpu.ops import bsdf as bsdf_ops

    n = n_emit
    idx = jnp.arange(n, dtype=jnp.uint32)
    # distinct stream from camera rays: fold a large odd constant into the
    # sample index axis
    s = smp.make_sampler(idx, jnp.uint32(0x9E3779B9) + stream)

    s, u_pick = smp.next_1d(s)
    em_id = dpdf_mod.sample(scene.emitter_pick, u_pick)
    s, u2a = smp.next_2d(s)
    s, u2b = smp.next_2d(s)
    s, u1 = smp.next_1d(s)
    ro, rd, W = sample_photon(scene, em_id, u2a, u2b, u1)
    W = W * float(n_lights)  # photonmapper.cpp:92 (×getLights().size())
    active = jnp.any(W > 0.0, axis=-1)

    def body(carry, depth):
        ro, rd, W, active, s = carry
        r = Ray(o=ro, d=rd, mint=jnp.full(n, EPSILON), maxt=jnp.full(n, jnp.inf))
        ctx = common.trace(scene, r)
        active = active & ctx.its.valid

        bt = scene.bsdfs.type[jnp.maximum(ctx.bsdf_id, 0)]
        is_diffuse = jnp.zeros(n, bool)
        for t in _DIFFUSE_TYPES:
            is_diffuse = is_diffuse | (bt == t)
        store = active & is_diffuse
        out_pos = ctx.its.p
        out_dir = -normalize(rd)
        out_pow = W

        # RR after 3 stored bounces (photonmapper.cpp:126-139)
        s, u_rr = smp.next_1d(s)
        succ = jnp.minimum(jnp.max(W, axis=-1), 0.99)
        rr_on = depth >= 3
        die = rr_on & (u_rr > succ) & active
        W = jnp.where(
            (rr_on & active)[..., None], W / jnp.maximum(succ, 1e-12)[..., None], W
        )
        active = active & (~die)

        # continue via BSDF sampling (photonmapper.cpp:141-149)
        wo_local = common.to_local(ctx, -normalize(rd))
        s, u2 = smp.next_2d(s)
        bs = bsdf_ops.sample_bsdf(
            scene.bsdfs, scene.textures, ctx.bsdf_id, wo_local, ctx.its.uv, u2
        )
        W = jnp.where(active[..., None], W * bs.weight, W)
        active = active & jnp.any(jnp.abs(W) > 1e-12, axis=-1)
        ro = jnp.where(active[..., None], ctx.its.p, ro)
        rd = jnp.where(active[..., None], common.to_world(ctx, bs.wo), rd)
        return (ro, rd, W, active, s), (out_pos, out_dir, out_pow, store)

    (_, _, _, _, _), (pos, dir_in, power, valid) = jax.lax.scan(
        body, (ro, rd, W, active, s), jnp.arange(max_depth)
    )
    return pos, dir_in, power, valid


def build_photon_map(scene, photon_count: int, radius: float, max_depth: int,
                     n_lights: int, seed: int = 0) -> PhotonMap:
    """Emit photons in batches until `photon_count` are stored, then build
    the sorted hash grid (host-side compaction, like the reference's
    host-side kd-tree build, photonmapper.cpp:152-154)."""
    if radius <= 0.0:
        # scene bbox extents.norm()/500 (photonmapper.cpp:75-77)
        g = scene.geometry
        pts = []
        if g.tri_v0.shape[0] > 0:
            v0 = np.asarray(g.tri_v0)
            pts += [v0, v0 + np.asarray(g.tri_e1), v0 + np.asarray(g.tri_e2)]
        if g.sph_center.shape[0] > 0:
            c = np.asarray(g.sph_center)
            r = np.asarray(g.sph_radius)[:, None]
            pts += [c - r, c + r]
        allp = np.concatenate(pts, 0) if pts else np.zeros((1, 3), np.float32)
        extents = allp.max(0) - allp.min(0)
        radius = float(np.linalg.norm(extents) / 500.0)
        radius = max(radius, 1e-4)

    batch = max(photon_count // 2, 1024)
    stored_pos, stored_dir, stored_pow = [], [], []
    stored = 0
    emitted = 0
    trace_jit = jax.jit(trace_photons, static_argnums=(1, 2, 3))
    for round_i in range(64):
        pos, dir_in, power, valid = trace_jit(
            scene, batch, max_depth, n_lights,
            jnp.uint32(seed * 65599 + round_i * 7919),
        )
        v = np.asarray(valid).reshape(-1)
        p = np.asarray(pos).reshape(-1, 3)[v]
        d = np.asarray(dir_in).reshape(-1, 3)[v]
        w = np.asarray(power).reshape(-1, 3)[v]
        emitted += batch
        stored_pos.append(p)
        stored_dir.append(d)
        stored_pow.append(w)
        stored += len(p)
        if stored >= photon_count:
            break
        if round_i >= 2 and stored == 0:
            break  # no diffuse surfaces / no photon-capable emitters

    pos = np.concatenate(stored_pos, 0)[:photon_count] if stored else np.zeros((0, 3), np.float32)
    dir_in = np.concatenate(stored_dir, 0)[:photon_count] if stored else np.zeros((0, 3), np.float32)
    power = np.concatenate(stored_pow, 0)[:photon_count] if stored else np.zeros((0, 3), np.float32)
    return make_photon_map(pos, dir_in, power, radius, emitted)


def make_photon_map(pos, dir_in, power, radius: float, emitted: int) -> PhotonMap:
    """Hash-sort raw photons into a queryable map (the m_photonMap->build()
    analog, photonmapper.cpp:154). Cell size = gather radius."""
    pos = np.asarray(pos, np.float32)
    dir_in = np.asarray(dir_in, np.float32)
    power = np.asarray(power, np.float32)
    n_ph = len(pos)
    if n_ph == 0:
        return empty_photon_map()

    table_size = 1 << max(int(np.ceil(np.log2(max(2 * n_ph, 2)))), 1)
    origin = pos.min(0).astype(np.float32)
    inv_cell = np.float32(1.0 / radius)
    cells = np.floor((pos - origin) * inv_cell).astype(np.int32)
    hashes = _hash_cells_np(cells, table_size)
    order = np.argsort(hashes, kind="stable")

    return PhotonMap(
        pos=jnp.asarray(pos[order]),
        dir=jnp.asarray(dir_in[order]),
        power=jnp.asarray(power[order]),
        cell_hash=jnp.asarray(hashes[order]),
        origin=jnp.asarray(origin),
        inv_cell=jnp.float32(inv_cell),
        radius=jnp.float32(radius),
        inv_emitted=jnp.float32(1.0 / emitted),
        table_size=table_size,
    )


# ---------------------------------------------------------------------------
# Radiance estimation (the kd-tree range search replacement)
# ---------------------------------------------------------------------------

_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]


def estimate_radiance(pm: PhotonMap, scene, ctx, wo_local: jnp.ndarray):
    """Photon-density radiance estimate at each lane's hit point.

    Li = Σ_photons power · f(wo, wi_photon) / (π r² · emitted)
    (photonmapper.cpp:212-236). 27 neighbor cells, ≤MAX_PER_CELL photons
    each; duplicate hash buckets among the 27 are masked so hash collisions
    never double-count.
    """
    from optix_renderer_tpu.ops import bsdf as bsdf_ops

    n = wo_local.shape[0]
    if pm.pos.shape[0] == 0:
        return jnp.zeros((n, 3), jnp.float32)
    P = pm.pos.shape[0]
    p = ctx.its.p
    base = jnp.floor((p - pm.origin) * pm.inv_cell).astype(jnp.int32)  # [N,3]

    # hashes of the 27 neighbor cells
    hs = []
    for dx, dy, dz in _OFFSETS:
        c = base + jnp.array([dx, dy, dz], jnp.int32)
        hs.append(_hash_cells(c[:, 0], c[:, 1], c[:, 2], pm.table_size))
    hs = jnp.stack(hs, axis=1)  # [N,27]
    eq = hs[:, :, None] == hs[:, None, :]  # [N,27,27]
    tri = jnp.tril(jnp.ones((27, 27), bool), k=-1)
    dup = jnp.any(eq & tri[None], axis=2)  # earlier identical hash exists

    lo = jnp.searchsorted(pm.cell_hash, hs, side="left")  # [N,27]
    hi = jnp.searchsorted(pm.cell_hash, hs, side="right")
    hi = jnp.minimum(hi, lo + MAX_PER_CELL)
    hi = jnp.where(dup, lo, hi)

    r2 = pm.radius * pm.radius
    rows = jnp.arange(n)

    def body(k, acc):
        idx = jnp.clip(lo + k, 0, P - 1)  # [N,27]
        valid = (lo + k) < hi
        ph_p = pm.pos[idx]  # [N,27,3]
        d2 = jnp.sum((ph_p - p[:, None, :]) ** 2, axis=-1)
        valid = valid & (d2 < r2)
        ph_d = pm.dir[idx]
        ph_w = pm.power[idx]
        # f(wi = camera wo, wo = photon dir) in the local frame
        wi_flat = frame_to_local(
            jax.tree.map(lambda a: jnp.repeat(a, 27, axis=0), ctx.frame),
            ph_d.reshape(-1, 3),
        )
        f = bsdf_ops.eval_bsdf(
            scene.bsdfs,
            scene.textures,
            jnp.repeat(ctx.bsdf_id, 27, axis=0),
            jnp.repeat(wo_local, 27, axis=0),
            wi_flat,
            jnp.repeat(ctx.its.uv, 27, axis=0),
        ).reshape(n, 27, 3)
        contrib = jnp.where(valid[..., None], ph_w * f, 0.0)
        return acc + jnp.sum(contrib, axis=1)

    acc = jax.lax.fori_loop(0, MAX_PER_CELL, body, jnp.zeros((n, 3), jnp.float32))
    scale = pm.inv_emitted / (jnp.pi * r2)
    return acc * scale
