"""LBVH: Morton-ordered bounding volume hierarchy for large triangle meshes.

Replacement of the reference's binned-SAH BVH (include/nori/bvh.h,
src/utils/bvh.cpp:36-462, TBB task-parallel build + iterative traversal) and
of the OptiX GAS/IAS builds (OptixState.as.cpp:47-248). The design differs
deliberately (SURVEY.md §2.8 item 5, §7 phase 2):

* **Build** happens on the host at scene-compile time (like the reference's
  CPU-side BVH build on scene update, scene.cpp:187-194): primitives are
  sorted by 30-bit Morton code of their centroid and grouped into fixed-size
  leaves; a median-split binary tree over the sorted leaf order (an LBVH
  approximation of the Karras radix tree) is emitted in DFS preorder.
  A native C++ builder (`optix_renderer_tpu/native`) is used when available;
  the numpy path below is the reference implementation and fallback.

* **Traversal** is stackless and lane-vectorized: nodes carry an *escape*
  (skip) link, so each ray keeps a single int32 cursor instead of a stack —
  one gather + one AABB slab test + `LEAF_SIZE` triangle tests per step, all
  shapes static, so XLA runs the whole wavefront as wide masked vector ops
  with no per-lane stack (unlike the reference's per-thread stack,
  bvh.cpp iterative traversal).

Triangles keep their original global order — leaves index them through the
`prim` permutation so emitter area-CDFs (build.py) and `make_interaction`
gathers are untouched.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from optix_renderer_tpu.core.math import Ray

LEAF_SIZE = 4
# scenes below this triangle count use the chunked brute-force sweep
# (ops/intersect.py) — at Cornell-box scale the sweep is faster than
# pointer chasing, mirroring the reference's serial-below-32-prims cutoff
# (bvh.cpp:57).
MIN_TRIS_FOR_BVH = 257
# same cutoff idea for analytic spheres: the reference BVH indexes all
# shapes' primitives uniformly (bvh.h:43-171); here spheres get their own
# LBVH (the per-shape-type GAS split of OptixState.as.cpp:47-169) once the
# brute sweep stops being the faster option.
MIN_SPHS_FOR_BVH = 65


class Bvh(NamedTuple):
    """Flattened threaded BVH (all arrays device-resident).

    Nodes are in DFS preorder: the first child of interior node `i` is `i+1`;
    `skip[i]` is the next node when the subtree of `i` is done (escape link).
    `first[i]` is the offset of a leaf's primitives in `prim` (−1 for interior
    nodes). Every leaf owns exactly LEAF_SIZE slots in `prim`, padded with −1.

    `packed`/`leaf` are gather-optimized copies: each traversal step is
    one XLA gather per array it reads, so node
    fields are packed into ONE [Nn,8] row (min·3, max·3, skip, first — int32
    links bitcast into the float32 row) and each leaf's primitive data into
    ONE row of `leaf` (triangles: LEAF_SIZE×(v0,e1,e2, id_bits) = 40 cols;
    spheres: LEAF_SIZE×(center, radius, id_bits) = 20 cols). This cuts the
    walk from 8 gathers per step to 2 — the analog of the reference's
    32-byte cache-line node layout (include/nori/bvh.h:127-164).
    """

    node_min: jnp.ndarray  # [Nn,3]
    node_max: jnp.ndarray  # [Nn,3]
    skip: jnp.ndarray  # [Nn] int32
    first: jnp.ndarray  # [Nn] int32 (−1 for interior)
    prim: jnp.ndarray  # [n_leaves*LEAF_SIZE] int32 triangle ids (−1 pad)
    packed: jnp.ndarray  # [Nn,8] float32 packed nodes
    leaf: jnp.ndarray  # [n_leaves, C] float32 packed per-leaf primitive data


def empty_bvh() -> Bvh:
    z3 = jnp.zeros((0, 3), jnp.float32)
    zi = jnp.zeros((0,), jnp.int32)
    return Bvh(
        node_min=z3,
        node_max=z3,
        skip=zi,
        first=zi,
        prim=zi,
        packed=jnp.zeros((0, 8), jnp.float32),
        leaf=jnp.zeros((0, 40), jnp.float32),
    )


def _pack_nodes(node_min, node_max, skip, first) -> np.ndarray:
    """[Nn,8]: min(3) | max(3) | skip bits | first bits (host numpy)."""
    n_nodes = node_min.shape[0]
    packed = np.empty((n_nodes, 8), np.float32)
    packed[:, 0:3] = node_min
    packed[:, 3:6] = node_max
    packed[:, 6] = skip.astype(np.int32).view(np.float32)
    packed[:, 7] = first.astype(np.int32).view(np.float32)
    return packed


def _pack_tri_leaves(prim, v0, e1, e2, leaf_size: int) -> np.ndarray:
    """[n_leaves, leaf_size*10]: per slot v0(3) e1(3) e2(3) id_bits(1).

    Pad slots (id −1) carry e1=e2=0 so Möller–Trumbore's det==0 rejects them.
    """
    n_leaves = prim.shape[0] // leaf_size
    ids = prim.reshape(n_leaves, leaf_size)
    gid = np.maximum(ids, 0)
    slot = np.empty((n_leaves, leaf_size, 10), np.float32)
    valid = (ids >= 0)[..., None]
    slot[:, :, 0:3] = v0[gid]
    slot[:, :, 3:6] = np.where(valid, e1[gid], 0.0)
    slot[:, :, 6:9] = np.where(valid, e2[gid], 0.0)
    slot[:, :, 9] = ids.astype(np.int32).view(np.float32)
    return slot.reshape(n_leaves, leaf_size * 10)


def _pack_sphere_leaves(prim, center, radius, leaf_size: int) -> np.ndarray:
    """[n_leaves, leaf_size*5]: per slot center(3) radius(1) id_bits(1).

    Pad slots (id −1) are rejected by the walk's id mask; their radius is 0
    only to keep the arithmetic finite."""
    n_leaves = prim.shape[0] // leaf_size
    ids = prim.reshape(n_leaves, leaf_size)
    gid = np.maximum(ids, 0)
    slot = np.empty((n_leaves, leaf_size, 5), np.float32)
    slot[:, :, 0:3] = center[gid]
    slot[:, :, 3] = np.where(ids >= 0, radius[gid], 0.0)
    slot[:, :, 4] = ids.astype(np.int32).view(np.float32)
    return slot.reshape(n_leaves, leaf_size * 5)


# ---------------------------------------------------------------------------
# Host-side build (numpy reference; see native/ for the C++ fast path)
# ---------------------------------------------------------------------------


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v so they occupy every 3rd bit."""
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton3d(p01: np.ndarray) -> np.ndarray:
    """30-bit Morton code of points normalized to [0,1]^3. p01: [N,3]."""
    q = np.clip(p01 * 1024.0, 0.0, 1023.0).astype(np.uint32)
    return (
        (_expand_bits(q[:, 0]) << np.uint32(2))
        | (_expand_bits(q[:, 1]) << np.uint32(1))
        | _expand_bits(q[:, 2])
    )


def build_lbvh_host(
    v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int = LEAF_SIZE
):
    """Build the flattened threaded LBVH on the host. Returns numpy arrays
    (node_min, node_max, skip, first, prim)."""
    try:
        from optix_renderer_tpu.native import lbvh as native_lbvh
    except Exception:
        native_lbvh = None
    if native_lbvh is not None:
        out = native_lbvh.build(v0, v1, v2, leaf_size)
        if out is not None:
            return out
    return build_lbvh_numpy(v0, v1, v2, leaf_size)


def build_lbvh_numpy(
    v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, leaf_size: int = LEAF_SIZE
):
    n = v0.shape[0]
    assert n > 0
    tmin = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    tmax = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroid = 0.5 * (tmin + tmax)
    lo = centroid.min(axis=0)
    hi = centroid.max(axis=0)
    extent = np.maximum(hi - lo, 1e-12)
    codes = morton3d((centroid - lo) / extent)
    order = np.argsort(codes, kind="stable").astype(np.int32)

    n_leaves = (n + leaf_size - 1) // leaf_size
    prim = np.full(n_leaves * leaf_size, -1, np.int32)
    prim[:n] = order

    # per-leaf AABBs
    leaf_min = np.full((n_leaves, 3), np.inf, np.float32)
    leaf_max = np.full((n_leaves, 3), -np.inf, np.float32)
    leaf_of = np.repeat(np.arange(n_leaves), leaf_size)[:n]
    np.minimum.at(leaf_min, leaf_of, tmin[order])
    np.maximum.at(leaf_max, leaf_of, tmax[order])

    # Vectorized DFS-preorder median-split build over leaf ranges.
    # A node over leaf range [lo,hi) occupies preorder slot i with children
    # left=i+1 (range [lo,mid)) and right=i+2(mid−lo) (range [mid,hi)) — the
    # subtree over k leaves always has 2k−1 nodes, so indices are closed-form
    # and each level can be emitted as one numpy operation (the former
    # per-node Python loop was the scene-load bottleneck at ≥100k tris, W6).
    n_nodes = 2 * n_leaves - 1
    node_min = np.zeros((n_nodes, 3), np.float32)
    node_max = np.zeros((n_nodes, 3), np.float32)
    skip = np.zeros(n_nodes, np.int32)
    first = np.full(n_nodes, -1, np.int32)

    levels = []  # (idx, lo, hi) arrays per level, root → leaves
    idx_l = np.array([0], np.int64)
    lo_l = np.array([0], np.int64)
    hi_l = np.array([n_leaves], np.int64)
    skip[0] = n_nodes
    while len(idx_l):
        levels.append((idx_l, lo_l, hi_l))
        interior = (hi_l - lo_l) > 1
        if not interior.any():
            break
        ii, lo, hi = idx_l[interior], lo_l[interior], hi_l[interior]
        mid = (lo + hi) // 2
        li, ri = ii + 1, ii + 2 * (mid - lo)
        # left child's escape = right child; right child inherits the parent's
        skip[li] = ri
        skip[ri] = skip[ii]
        idx_l = np.concatenate([li, ri])
        lo_l = np.concatenate([lo, mid])
        hi_l = np.concatenate([mid, hi])

    # leaf nodes: every (idx, lo, hi=lo+1) across all levels
    all_idx = np.concatenate([l[0] for l in levels])
    all_lo = np.concatenate([l[1] for l in levels])
    all_hi = np.concatenate([l[2] for l in levels])
    is_leaf_node = all_hi - all_lo == 1
    leaf_nodes = all_idx[is_leaf_node]
    leaf_ranges = all_lo[is_leaf_node]
    first[leaf_nodes] = (leaf_ranges * leaf_size).astype(np.int32)
    node_min[leaf_nodes] = leaf_min[leaf_ranges]
    node_max[leaf_nodes] = leaf_max[leaf_ranges]

    # interior AABBs: deepest level first ⇒ children before parents
    for idx_l, lo_l, hi_l in reversed(levels):
        interior = (hi_l - lo_l) > 1
        if not interior.any():
            continue
        ii, lo, hi = idx_l[interior], lo_l[interior], hi_l[interior]
        mid = (lo + hi) // 2
        li, ri = ii + 1, ii + 2 * (mid - lo)
        node_min[ii] = np.minimum(node_min[li], node_min[ri])
        node_max[ii] = np.maximum(node_max[li], node_max[ri])

    return node_min, node_max, skip, first, prim


def build_bvh(v0, v1, v2, leaf_size: int = LEAF_SIZE) -> Bvh:
    """Host build → device arrays (triangle leaf packing)."""
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    node_min, node_max, skip, first, prim = build_lbvh_host(v0, v1, v2, leaf_size)
    leaf = _pack_tri_leaves(prim, v0, v1 - v0, v2 - v0, leaf_size)
    return Bvh(
        node_min=jnp.asarray(node_min),
        node_max=jnp.asarray(node_max),
        skip=jnp.asarray(skip, jnp.int32),
        first=jnp.asarray(first, jnp.int32),
        prim=jnp.asarray(prim, jnp.int32),
        packed=jnp.asarray(_pack_nodes(node_min, node_max, skip, first)),
        leaf=jnp.asarray(leaf),
    )


def build_sphere_bvh(center, radius, leaf_size: int = LEAF_SIZE) -> Bvh:
    """LBVH over analytic spheres (bvh.h:43-171 indexes all shapes' prims).

    Reuses the triangle tree builder unchanged: it derives each primitive's
    AABB from three points, and (c−r, c+r, c) spans exactly the sphere's
    AABB — so the same native/numpy code paths serve both primitive kinds.
    Leaf rows pack (center, radius, id) instead of triangle data.
    """
    c = np.asarray(center, np.float32)
    r = np.asarray(radius, np.float32)
    node_min, node_max, skip, first, prim = build_lbvh_host(
        c - r[:, None], c + r[:, None], c, leaf_size
    )
    leaf = _pack_sphere_leaves(prim, c, r, leaf_size)
    return Bvh(
        node_min=jnp.asarray(node_min),
        node_max=jnp.asarray(node_max),
        skip=jnp.asarray(skip, jnp.int32),
        first=jnp.asarray(first, jnp.int32),
        prim=jnp.asarray(prim, jnp.int32),
        packed=jnp.asarray(_pack_nodes(node_min, node_max, skip, first)),
        leaf=jnp.asarray(leaf),
    )


# ---------------------------------------------------------------------------
# Device-side traversal
# ---------------------------------------------------------------------------


def _slab(o, inv_d, bmin, bmax, tmin, tmax):
    """Ray–AABB slab test. All [N,3] / [N]; returns hit mask [N].

    Contract of BoundingBox3f::rayIntersect (include/nori/bbox.h ray-slab
    test), vectorized; inv_d is precomputed with ±inf for zero components.
    """
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    return (near <= far) & (far >= tmin) & (near <= tmax)


def _leaf_tris(o, d, v0, e1, e2):
    """Möller–Trumbore for per-lane triangle bundles.

    o,d: [N,3]; v0,e1,e2: [N,L,3] → t,u,v,hit: [N,L]. Same semantics as the
    chunked sweep in ops/intersect.py (no backface culling, inclusive edges).
    """
    dN = d[:, None, :]
    pvec = jnp.cross(dN, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    tvec = o[:, None, :] - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(dN * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    hit = (jnp.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, hit


def replay_tri(o, d, v0, e1, e2):
    """Per-lane single-triangle Möller–Trumbore (all [N,3] → t,u,v [N]).

    The differentiable replay of a traversal's winning primitive: same
    arithmetic as `_leaf_tris`, so values match the walk bit-for-bit while
    gradients flow through one gather instead of the `lax.while_loop`
    (which has no reverse-mode rule — round-3 VERDICT M2).
    """
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    return t, u, v


def traverse(
    bvh: Bvh,
    tri_v0: jnp.ndarray,
    tri_e1: jnp.ndarray,
    tri_e2: jnp.ndarray,
    ray: Ray,
    t_init: jnp.ndarray,
    any_hit: bool = False,
):
    """Closest-hit traversal of a ray wavefront through the threaded BVH.

    Returns (t, prim_id, u, v, found) each [N]. `t_init` is the initial far
    clip (ray.maxt already folded in by the caller). With `any_hit` the walk
    terminates a lane at its first confirmed hit (shadow-ray contract of
    BVH::rayIntersect shadowRay=true, bvh.h:80-81).

    Differentiable (M2): the stackless walk runs on `stop_gradient`-detached
    inputs — it only *selects* the winning primitive, a discrete decision —
    and (t, u, v) are then recomputed from the live inputs by a one-triangle
    replay at the winner, through which reverse-mode AD flows. This is the
    same detach-discrete/replay-continuous policy the reference's NEE + RR
    estimators imply (SURVEY §7 hard part 4).
    """
    sg = jax.lax.stop_gradient
    t_det, prim_id, _, _, found = _traverse_walk(
        jax.tree_util.tree_map(sg, bvh),
        sg(tri_v0), sg(tri_e1), sg(tri_e2),
        Ray(o=sg(ray.o), d=sg(ray.d), mint=sg(ray.mint), maxt=sg(ray.maxt)),
        sg(t_init),
        any_hit,
    )
    gid = jnp.maximum(prim_id, 0)
    t_r, u_r, v_r = replay_tri(ray.o, ray.d, tri_v0[gid], tri_e1[gid], tri_e2[gid])
    t = jnp.where(found, t_r, t_init)
    u = jnp.where(found, u_r, 0.0)
    v = jnp.where(found, v_r, 0.0)
    return t, prim_id, u, v, found


def _traverse_walk(
    bvh: Bvh,
    tri_v0: jnp.ndarray,
    tri_e1: jnp.ndarray,
    tri_e2: jnp.ndarray,
    ray: Ray,
    t_init: jnp.ndarray,
    any_hit: bool = False,
):
    """The raw stackless walk (non-differentiable `lax.while_loop`).

    Gather-optimized: ONE packed-node row gather + ONE packed-leaf row gather
    per step (see Bvh.packed). `tri_v0/e1/e2`
    are unused here — the leaf rows carry the triangle data — but stay in the
    signature for the differentiable replay wrapper.
    """
    del tri_v0, tri_e1, tri_e2
    n = ray.o.shape[0]
    n_nodes = bvh.packed.shape[0]
    L = LEAF_SIZE

    inv_d = 1.0 / jnp.where(jnp.abs(ray.d) > 1e-20, ray.d, 1e-20)
    rows = jnp.arange(n)

    def cond(state):
        node = state[0]
        return jnp.any(node < n_nodes)

    def body(state):
        node, best_t, best_id, best_u, best_v, found = state
        active = node < n_nodes
        nid = jnp.minimum(node, n_nodes - 1)
        nrow = bvh.packed[nid]  # [N,8] single node gather
        bmin, bmax = nrow[:, 0:3], nrow[:, 3:6]
        skip = jax.lax.bitcast_convert_type(nrow[:, 6], jnp.int32)
        fi = jax.lax.bitcast_convert_type(nrow[:, 7], jnp.int32)
        hit_box = active & _slab(ray.o, inv_d, bmin, bmax, ray.mint, best_t)
        is_leaf = fi >= 0
        do_leaf = hit_box & is_leaf

        leaf_idx = jnp.where(do_leaf, fi // L, 0)
        slot = bvh.leaf[leaf_idx].reshape(n, L, 10)  # [N,L,10] single gather
        pids = jax.lax.bitcast_convert_type(slot[..., 9], jnp.int32)
        ok = do_leaf[:, None] & (pids >= 0)
        t, u, v, h = _leaf_tris(
            ray.o, ray.d, slot[..., 0:3], slot[..., 3:6], slot[..., 6:9]
        )
        h = h & ok & (t >= ray.mint[:, None]) & (t < best_t[:, None])
        t_masked = jnp.where(h, t, jnp.float32(3.4e38))
        j = jnp.argmin(t_masked, axis=-1)
        tj = t_masked[rows, j]
        better = tj < best_t
        best_t = jnp.where(better, tj, best_t)
        best_id = jnp.where(better, pids[rows, j], best_id)
        best_u = jnp.where(better, u[rows, j], best_u)
        best_v = jnp.where(better, v[rows, j], best_v)
        found = found | better

        nxt = jnp.where(hit_box & ~is_leaf, node + 1, skip)
        nxt = jnp.where(active, nxt, node)
        if any_hit:
            nxt = jnp.where(found, n_nodes, nxt)
        return nxt, best_t, best_id, best_u, best_v, found

    state = (
        jnp.zeros(n, jnp.int32),
        t_init,
        jnp.zeros(n, jnp.int32),
        jnp.zeros(n, jnp.float32),
        jnp.zeros(n, jnp.float32),
        jnp.zeros(n, bool),
    )
    node, best_t, best_id, best_u, best_v, found = jax.lax.while_loop(
        cond, body, state
    )
    return best_t, best_id, best_u, best_v, found


def _leaf_spheres(o, d, mint, best_t, center, radius):
    """Quadratic sphere test for per-lane bundles (sphere.cpp:67-124 contract).

    o,d: [N,3]; mint,best_t: [N]; center: [N,L,3]; radius: [N,L] →
    candidate t per slot [N,L] (+huge where no valid root in [mint, best_t)).
    """
    oc = o[:, None, :] - center  # [N,L,3]
    a = jnp.sum(d * d, axis=-1)[:, None]
    b = 2.0 * jnp.sum(oc * d[:, None, :], axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - radius * radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = -0.5 * (b + jnp.sign(b) * sq)
    t0 = q / a
    t1 = c / jnp.where(jnp.abs(q) > 1e-20, q, 1e-20)
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    in_n = ok & (tn >= mint[:, None]) & (tn < best_t[:, None])
    in_f = ok & (tf >= mint[:, None]) & (tf < best_t[:, None])
    return jnp.where(in_n, tn, jnp.where(in_f, tf, jnp.float32(3.4e38)))


def replay_sphere(o, d, center, radius, t_det):
    """Differentiable one-sphere replay: recompute the root of the stable
    quadratic (sphere.cpp:67-124) that the detached walk selected. Root
    choice (near vs far) is recovered by proximity to the detached t — a
    discrete decision, so it is itself detached."""
    oc = o - center
    a = jnp.sum(d * d, axis=-1)
    b = 2.0 * jnp.sum(oc * d, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = jnp.sqrt(jnp.maximum(disc, 1e-20))  # found lanes have disc > 0
    q = -0.5 * (b + jnp.sign(b) * sq)
    t0 = q / a
    t1 = c / jnp.where(jnp.abs(q) > 1e-20, q, 1e-20)
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    pick_near = jax.lax.stop_gradient(jnp.abs(tn - t_det) <= jnp.abs(tf - t_det))
    return jnp.where(pick_near, tn, tf)


def traverse_spheres(
    bvh: Bvh,
    center: jnp.ndarray,
    radius: jnp.ndarray,
    ray: Ray,
    t_init: jnp.ndarray,
    any_hit: bool = False,
):
    """Closest-hit walk of the sphere LBVH. Returns (t, sphere_id, found).

    Same stackless escape-link walk as `traverse`; the leaf test is the
    stable-quadratic sphere intersection instead of Möller–Trumbore. Same
    detach-walk + differentiable-replay structure as `traverse` (M2).
    """
    sg = jax.lax.stop_gradient
    t_det, sid, found = _traverse_spheres_walk(
        jax.tree_util.tree_map(sg, bvh),
        sg(center), sg(radius),
        Ray(o=sg(ray.o), d=sg(ray.d), mint=sg(ray.mint), maxt=sg(ray.maxt)),
        sg(t_init),
        any_hit,
    )
    gid = jnp.maximum(sid, 0)
    t_r = replay_sphere(ray.o, ray.d, center[gid], radius[gid], t_det)
    t = jnp.where(found, t_r, t_init)
    return t, sid, found


def _traverse_spheres_walk(
    bvh: Bvh,
    center: jnp.ndarray,
    radius: jnp.ndarray,
    ray: Ray,
    t_init: jnp.ndarray,
    any_hit: bool = False,
):
    """The raw sphere-LBVH walk (non-differentiable `lax.while_loop`).

    Same 2-gather-per-step packing as `_traverse_walk`; `center`/`radius`
    stay in the signature for the differentiable replay wrapper."""
    del center, radius
    n = ray.o.shape[0]
    n_nodes = bvh.packed.shape[0]
    L = LEAF_SIZE

    inv_d = 1.0 / jnp.where(jnp.abs(ray.d) > 1e-20, ray.d, 1e-20)
    rows = jnp.arange(n)

    def cond(state):
        return jnp.any(state[0] < n_nodes)

    def body(state):
        node, best_t, best_id, found = state
        active = node < n_nodes
        nid = jnp.minimum(node, n_nodes - 1)
        nrow = bvh.packed[nid]  # [N,8]
        skip = jax.lax.bitcast_convert_type(nrow[:, 6], jnp.int32)
        fi = jax.lax.bitcast_convert_type(nrow[:, 7], jnp.int32)
        hit_box = active & _slab(
            ray.o, inv_d, nrow[:, 0:3], nrow[:, 3:6], ray.mint, best_t
        )
        is_leaf = fi >= 0
        do_leaf = hit_box & is_leaf

        leaf_idx = jnp.where(do_leaf, fi // L, 0)
        slot = bvh.leaf[leaf_idx].reshape(n, L, 5)  # [N,L,5]
        pids = jax.lax.bitcast_convert_type(slot[..., 4], jnp.int32)
        ok = do_leaf[:, None] & (pids >= 0)
        t_cand = _leaf_spheres(
            ray.o, ray.d, ray.mint, best_t, slot[..., 0:3], slot[..., 3]
        )
        t_cand = jnp.where(ok, t_cand, jnp.float32(3.4e38))
        j = jnp.argmin(t_cand, axis=-1)
        tj = t_cand[rows, j]
        better = tj < best_t
        best_t = jnp.where(better, tj, best_t)
        best_id = jnp.where(better, pids[rows, j], best_id)
        found = found | better

        nxt = jnp.where(hit_box & ~is_leaf, node + 1, skip)
        nxt = jnp.where(active, nxt, node)
        if any_hit:
            nxt = jnp.where(found, n_nodes, nxt)
        return nxt, best_t, best_id, found

    state = (
        jnp.zeros(n, jnp.int32),
        t_init,
        jnp.zeros(n, jnp.int32),
        jnp.zeros(n, bool),
    )
    node, best_t, best_id, found = jax.lax.while_loop(cond, body, state)
    return best_t, best_id, found
