"""Ray–scene intersection: batched Möller–Trumbore + analytic spheres.

Replacement of the reference's BVH traversal + per-shape `rayIntersect`
virtuals (src/utils/bvh.cpp, src/shapes/{mesh,sphere}.cpp): rays are a
wavefront `[N]`, primitives a flat SoA table. The path is chosen from the
scene's shape alone: below `bvh.MIN_TRIS_FOR_BVH` triangles (and
`bvh.MIN_SPHS_FOR_BVH` spheres) a brute-force sweep whose `[N, T]`
compare-and-argmin XLA fuses into one reduction; at or above them the LBVH
walk of `ops.bvh`.

All shapes are in world space (baked at build). Hit payload mirrors the
reference `Intersection` (shape.h:37-99): p, shading/geo frames, uv, shape id.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from optix_renderer_tpu.core.math import (
    Ray,
    coordinate_system,
    cross,
    dot,
    make_frame,
    normalize,
)
from optix_renderer_tpu.ops import bvh as bvh_mod
from optix_renderer_tpu.scene.data import Geometry

# primitive kinds in hit records
PRIM_NONE = 0
PRIM_TRI = 1
PRIM_SPHERE = 2

_BIG = 3.4e38


class Hit(NamedTuple):
    """Nearest-hit record per ray (pre-shading): all fields `[N]`."""

    t: jnp.ndarray
    prim_kind: jnp.ndarray  # int32: PRIM_NONE/TRI/SPHERE
    prim_id: jnp.ndarray  # int32 index into tri or sphere table
    u: jnp.ndarray  # triangle barycentric u
    v: jnp.ndarray


class Interaction(NamedTuple):
    """Shading-ready surface interaction (reference Intersection, shape.h:37-99)."""

    valid: jnp.ndarray  # [N] bool
    t: jnp.ndarray
    p: jnp.ndarray  # [N,3]
    n_s: jnp.ndarray  # shading normal
    n_g: jnp.ndarray  # geometric normal
    uv: jnp.ndarray  # [N,2]
    tang: jnp.ndarray  # [N,4] UV tangent dp/du + handedness w (zero → no UV chart)
    shape: jnp.ndarray  # [N] int32 shape id (-1 if miss)
    prim_kind: jnp.ndarray
    prim_id: jnp.ndarray


def _ray_spheres(o, d, center, radius):
    """Quadratic sphere intersection (src/shapes/sphere.cpp:67-124).

    Returns the nearer root in front; caller applies the [mint,maxt] clip.
    o,d: [N,3]; center: [S,3]; radius: [S] → t [N,S], hit [N,S].
    """
    oc = o[:, None, :] - center[None, :, :]  # [N,S,3]
    a = jnp.sum(d * d, axis=-1)[:, None]  # [N,1]
    b = 2.0 * jnp.sum(oc * d[:, None, :], axis=-1)  # [N,S]
    c = jnp.sum(oc * oc, axis=-1) - (radius * radius)[None, :]
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    # numerically-stable quadratic roots
    q = -0.5 * (b + jnp.sign(b) * sq)
    t0 = q / a
    t1 = c / jnp.where(jnp.abs(q) > 1e-20, q, 1e-20)
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    return tn, tf, ok


def _mt_jnp(o, d, mint, cutoff, v0, e1, e2):
    """Brute-force closest hit of rays against every triangle.

    o,d: [N,3]; mint/cutoff: [N]; v0/e1/e2: [T,3]. Returns (t, u, v, idf)
    each [N]; idf is the winning triangle id as float (−1 where no hit;
    t = cutoff there).
    """
    pvec = jnp.cross(d[:, None, :], e2[None, :, :])
    det = jnp.sum(e1[None, :, :] * pvec, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    tvec = o[:, None, :] - v0[None, :, :]
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = jnp.sum(d[:, None, :] * qvec, axis=-1) * inv_det
    t = jnp.sum(e2[None, :, :] * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) > 1e-12)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= mint[:, None])
        & (t < cutoff[:, None])
    )
    tm = jnp.where(hit, t, _BIG)
    j = jnp.argmin(tm, axis=-1)
    rows = jnp.arange(o.shape[0])
    tj = tm[rows, j]
    better = tj < cutoff
    t_out = jnp.where(better, tj, cutoff)
    u_out = jnp.where(better, u[rows, j], 0.0)
    v_out = jnp.where(better, v[rows, j], 0.0)
    idf = jnp.where(better, j.astype(jnp.float32), -1.0)
    return t_out, u_out, v_out, idf


def mt_closest_hit(o, d, mint, cutoff, v0, e1, e2):
    """Closest hit of a ray wavefront against a triangle table.

    Outputs (t, u, v, idf[N] float, −1 = miss, t = cutoff there).

    Differentiable by detach-and-replay: the sweep runs on
    `stop_gradient`-detached inputs (the winner *selection* is discrete);
    (t, u, v) are then recomputed from the live inputs at the winning
    triangle, so the backward pass is one gather + ~40 flops per lane and
    the [N, T] candidate matrix is not differentiated.
    """
    sg = jax.lax.stop_gradient
    _, _, _, idf = _mt_jnp(sg(o), sg(d), sg(mint), sg(cutoff), sg(v0), sg(e1), sg(e2))
    found = idf >= 0.0
    gid = jnp.maximum(idf, 0.0).astype(jnp.int32)
    t_r, u_r, v_r = bvh_mod.replay_tri(o, d, v0[gid], e1[gid], e2[gid])
    t = jnp.where(found, t_r, cutoff)
    u = jnp.where(found, u_r, 0.0)
    v = jnp.where(found, v_r, 0.0)
    return t, u, v, idf


def intersect(geom: Geometry, ray: Ray, any_hit: bool = False) -> Hit:
    """Closest-hit (or any-hit) of a ray wavefront against the whole scene.

    `any_hit=True` implements the shadow-ray query (BVH::rayIntersect shadowRay
    variant, bvh.h:80-81): the returned record holds *a* hit, not the nearest.
    """
    n = ray.o.shape[0]
    best = Hit(
        t=jnp.where(jnp.isinf(ray.maxt), jnp.float32(3.4e38), ray.maxt),
        prim_kind=jnp.zeros(n, jnp.int32),
        prim_id=jnp.zeros(n, jnp.int32),
        u=jnp.zeros(n, jnp.float32),
        v=jnp.zeros(n, jnp.float32),
    )

    n_tris = geom.tri_v0.shape[0]
    if geom.bvh.node_min.shape[0] > 0:
        # LBVH path for meshes of MIN_TRIS_FOR_BVH triangles or more
        # (ops/bvh.py) — static dispatch: the BVH is part of the scene
        # pytree, and build.py builds it only above that size, so jit traces
        # one branch.
        bt, bi, bu, bv, bf = bvh_mod.traverse(
            geom.bvh,
            geom.tri_v0,
            geom.tri_e1,
            geom.tri_e2,
            ray,
            best.t,
            any_hit=any_hit,
        )
        best = Hit(
            t=bt,
            prim_kind=jnp.where(bf, PRIM_TRI, best.prim_kind),
            prim_id=bi,
            u=bu,
            v=bv,
        )
    elif n_tris > 0:
        # brute-force Möller–Trumbore sweep below MIN_TRIS_FOR_BVH
        bt, bu, bv, idf = mt_closest_hit(
            ray.o, ray.d, ray.mint, best.t,
            geom.tri_v0, geom.tri_e1, geom.tri_e2,
        )
        bf = idf >= 0.0
        best = Hit(
            t=bt,
            prim_kind=jnp.where(bf, PRIM_TRI, best.prim_kind),
            prim_id=jnp.maximum(idf, 0.0).astype(jnp.int32),
            u=bu,
            v=bv,
        )

    n_sph = geom.sph_center.shape[0]
    if geom.sph_bvh.node_min.shape[0] > 0:
        # sphere LBVH for sphere-heavy scenes (ops/bvh.py traverse_spheres):
        # same asymptotics as the triangle path (M4 — the reference indexes
        # all shapes' primitives in its BVH, bvh.h:43-171)
        st, sid, sf = bvh_mod.traverse_spheres(
            geom.sph_bvh,
            geom.sph_center,
            geom.sph_radius,
            ray,
            best.t,
            any_hit=any_hit,
        )
        best = Hit(
            t=st,
            prim_kind=jnp.where(sf, PRIM_SPHERE, best.prim_kind),
            prim_id=jnp.where(sf, sid, best.prim_id),
            u=best.u,
            v=best.v,
        )
    elif n_sph > 0:
        tn, tf, ok = _ray_spheres(ray.o, ray.d, geom.sph_center, geom.sph_radius)
        # nearest root within [mint, t_best)
        t_near_ok = ok & (tn >= ray.mint[:, None]) & (tn < best.t[:, None])
        t_far_ok = ok & (tf >= ray.mint[:, None]) & (tf < best.t[:, None])
        t_cand = jnp.where(t_near_ok, tn, jnp.where(t_far_ok, tf, 3.4e38))
        j = jnp.argmin(t_cand, axis=-1)
        rows = jnp.arange(n)
        tj = t_cand[rows, j]
        better = tj < best.t
        best = Hit(
            t=jnp.where(better, tj, best.t),
            prim_kind=jnp.where(better, PRIM_SPHERE, best.prim_kind),
            prim_id=jnp.where(better, j.astype(jnp.int32), best.prim_id),
            u=best.u,
            v=best.v,
        )

    return best


def occluded(geom: Geometry, ray: Ray) -> jnp.ndarray:
    """Shadow-ray query: True where something blocks [mint, maxt]."""
    hit = intersect(geom, ray, any_hit=True)
    return hit.prim_kind != PRIM_NONE


def make_interaction(geom: Geometry, ray: Ray, hit: Hit) -> Interaction:
    """Gather per-primitive data into a shading-ready record.

    Mirrors `Mesh::setHitInformation` (mesh.cpp:141-186: barycentric
    position/normal/uv interpolation) and the sphere variant
    (sphere.cpp:87-124: normal = (p-c)/r, spherical uv).
    """
    n = ray.o.shape[0]
    is_tri = hit.prim_kind == PRIM_TRI
    is_sph = hit.prim_kind == PRIM_SPHERE
    valid = is_tri | is_sph

    # missed lanes carry t = +huge; clamp so downstream math on p stays finite
    # (inf here poisons gradients through jnp.where branches)
    t_safe = jnp.where(valid, hit.t, 1.0)
    p = ray.o + ray.d * t_safe[..., None]

    # --- triangle path (gathers are cheap relative to the sweep)
    if geom.tri_v0.shape[0] > 0:
        tid = jnp.where(is_tri, hit.prim_id, 0)
        t_e1 = geom.tri_e1[tid]
        t_e2 = geom.tri_e2[tid]
        w = 1.0 - hit.u - hit.v
        n_g_tri = normalize(cross(t_e1, t_e2))
        n0, n1, n2 = geom.tri_n0[tid], geom.tri_n1[tid], geom.tri_n2[tid]
        n_s_tri = normalize(
            n0 * w[..., None] + n1 * hit.u[..., None] + n2 * hit.v[..., None]
        )
        uv_tri = (
            geom.tri_uv0[tid] * w[..., None]
            + geom.tri_uv1[tid] * hit.u[..., None]
            + geom.tri_uv2[tid] * hit.v[..., None]
        )
        tang_tri = geom.tri_tang[tid]
        shape_tri = geom.tri_shape[tid]
    else:
        n_g_tri = jnp.zeros((n, 3), jnp.float32)
        n_s_tri = jnp.zeros((n, 3), jnp.float32)
        uv_tri = jnp.zeros((n, 2), jnp.float32)
        tang_tri = jnp.zeros((n, 4), jnp.float32)
        shape_tri = jnp.zeros(n, jnp.int32)

    # --- sphere path
    if geom.sph_center.shape[0] > 0:
        sid = jnp.where(is_sph, hit.prim_id, 0)
        c = geom.sph_center[sid]
        r = geom.sph_radius[sid]
        n_sph = (p - c) / jnp.maximum(r[..., None], 1e-20)
        n_sph = normalize(n_sph)
        # spherical uv (sphere.cpp setHitInformation)
        theta = jnp.arccos(jnp.clip(n_sph[..., 2], -1.0, 1.0))
        phi = jnp.arctan2(n_sph[..., 1], n_sph[..., 0])
        phi = jnp.where(phi < 0, phi + 2.0 * jnp.pi, phi)
        uv_sph = jnp.stack([phi / (2.0 * jnp.pi), theta / jnp.pi], axis=-1)
        shape_sph = geom.sph_shape[sid]
    else:
        n_sph = jnp.zeros((n, 3), jnp.float32)
        uv_sph = jnp.zeros((n, 2), jnp.float32)
        shape_sph = jnp.zeros(n, jnp.int32)

    n_g = jnp.where(is_tri[..., None], n_g_tri, n_sph)
    n_s = jnp.where(is_tri[..., None], n_s_tri, n_sph)
    uv = jnp.where(is_tri[..., None], uv_tri, uv_sph)
    tang = jnp.where(is_tri[..., None], tang_tri, 0.0)
    shape = jnp.where(is_tri, shape_tri, jnp.where(is_sph, shape_sph, -1))

    return Interaction(
        valid=valid,
        t=hit.t,
        p=p,
        n_s=n_s,
        n_g=n_g,
        uv=uv,
        tang=tang,
        shape=shape.astype(jnp.int32),
        prim_kind=hit.prim_kind,
        prim_id=hit.prim_id,
    )
