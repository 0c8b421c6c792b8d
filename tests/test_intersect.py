"""Intersection: the brute-force sweep, its gradient, and the choice of path.

Scene build picks the path from the scene's shape alone: the LBVH from
`bvh.MIN_TRIS_FOR_BVH` triangles (`MIN_SPHS_FOR_BVH` spheres) up, the sweep
below. On each side of both limits `intersect()` must return the closest hit
a float64 numpy Möller–Trumbore / quadratic reference finds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from optix_renderer_tpu.core.math import Ray
from optix_renderer_tpu.ops import bvh as bvh_mod
from optix_renderer_tpu.ops.intersect import PRIM_SPHERE, PRIM_TRI, _mt_jnp, intersect, mt_closest_hit
from optix_renderer_tpu.scene.build import load_scene


def _random_case(n_rays, n_tris, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2, 2, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    v0 = rng.uniform(-2, 2, (n_tris, 3)).astype(np.float32)
    e1 = rng.normal(size=(n_tris, 3)).astype(np.float32)
    e2 = rng.normal(size=(n_tris, 3)).astype(np.float32)
    mint = np.full(n_rays, 1e-4, np.float32)
    cutoff = np.full(n_rays, 3.4e38, np.float32)
    return tuple(map(jnp.asarray, (o, d, mint, cutoff, v0, e1, e2)))


def _mt_reference(o, d, v0, e1, e2, mint, cutoff):
    """Float64 numpy Möller–Trumbore: (t, id) of the closest hit, id −1 on a miss."""
    o, d, v0, e1, e2 = (np.asarray(a, np.float64) for a in (o, d, v0, e1, e2))
    p = np.cross(d[:, None], e2[None])
    det = np.sum(e1[None] * p, -1)
    tv = o[:, None] - v0[None]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = np.sum(tv * p, -1) / det
        q = np.cross(tv, e1[None])
        v = np.sum(d[:, None] * q, -1) / det
        t = np.sum(e2[None] * q, -1) / det
    hit = (np.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
    hit &= (t >= np.asarray(mint)[:, None]) & (t < np.asarray(cutoff)[:, None])
    tm = np.where(hit, t, np.inf)
    j = np.argmin(tm, -1)
    tj = tm[np.arange(len(o)), j]
    return np.where(np.isfinite(tj), tj, np.asarray(cutoff)), np.where(np.isfinite(tj), j, -1)


def _sphere_reference(o, d, center, radius, mint):
    o, d, c, r = (np.asarray(a, np.float64) for a in (o, d, center, radius))
    oc = o[:, None] - c[None]
    b = np.sum(oc * d[:, None], -1)
    disc = b * b - (np.sum(oc * oc, -1) - r[None] ** 2)
    sq = np.sqrt(np.maximum(disc, 0))
    cand = np.stack([-b - sq, -b + sq])  # [2, N, S] near and far roots
    ok = (disc >= 0)[None] & (cand >= np.asarray(mint)[None, :, None])
    tm = np.where(ok, cand, np.inf).min(0)
    j = np.argmin(tm, -1)
    tj = tm[np.arange(len(o)), j]
    return tj, np.where(np.isfinite(tj), j, -1)


@pytest.mark.parametrize("n_rays,n_tris,seed", [(64, 7, 0), (700, 40, 1), (1100, 300, 2)])
def test_sweep_matches_float64_reference(n_rays, n_tris, seed):
    o, d, mint, cutoff, v0, e1, e2 = _random_case(n_rays, n_tris, seed)
    cutoff = jnp.full(n_rays, 1.5, jnp.float32).at[::2].set(3.4e38)
    t, _, _, idf = (np.asarray(a) for a in _mt_jnp(o, d, mint, cutoff, v0, e1, e2))
    t_ref, id_ref = _mt_reference(o, d, v0, e1, e2, mint, cutoff)
    np.testing.assert_array_equal(idf.astype(int), id_ref)
    np.testing.assert_allclose(t, t_ref, rtol=1e-4)
    # never at or beyond the cutoff; misses report the cutoff itself
    assert (t[idf >= 0] < np.asarray(cutoff)[idf >= 0]).all()
    np.testing.assert_array_equal(t[idf < 0], np.asarray(cutoff)[idf < 0])


def test_mt_grad_flows_through_custom_vjp():
    """The sweep's detach-and-replay keeps hit distances differentiable
    w.r.t. ray origins (differentiable-rendering contract)."""
    (o, d, mint, cutoff, v0, e1, e2) = _random_case(128, 16, 3)

    def loss(o):
        t, u, v, idf = mt_closest_hit(o, d, mint, cutoff, v0, e1, e2)
        return jnp.sum(jnp.where(idf >= 0, t, 0.0))

    g = jax.grad(loss)(o)
    assert np.isfinite(np.asarray(g)).all()
    assert np.abs(np.asarray(g)).sum() > 0.0


def _scene_xml(tmp_path, shapes):
    (tmp_path / "scene.xml").write_text(f"<scene>{shapes}</scene>")
    scene, _, _ = load_scene(tmp_path / "scene.xml")
    return scene


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-4, 4, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)  # aim at the soup
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=-1, keepdims=True)
    return Ray(o=jnp.asarray(o), d=jnp.asarray(d), mint=jnp.full(n, 1e-4),
               maxt=jnp.full(n, jnp.inf))


@pytest.mark.parametrize("n_tris", [bvh_mod.MIN_TRIS_FOR_BVH - 1, bvh_mod.MIN_TRIS_FOR_BVH])
def test_triangle_path_chosen_by_count(tmp_path, n_tris):
    rng = np.random.default_rng(n_tris)
    v0 = rng.uniform(-2, 2, (n_tris, 3))
    verts = np.concatenate([v0, v0 + rng.uniform(-0.5, 0.5, (n_tris, 3)),
                            v0 + rng.uniform(-0.5, 0.5, (n_tris, 3))])
    lines = ["v %.6f %.6f %.6f" % tuple(v) for v in verts]
    lines += [f"f {i + 1} {i + 1 + n_tris} {i + 1 + 2 * n_tris}" for i in range(n_tris)]
    (tmp_path / "soup.obj").write_text("\n".join(lines) + "\n")
    scene = _scene_xml(tmp_path, '<shape type="obj"><string name="filename" value="soup.obj"/></shape>')
    g = scene.geometry
    assert g.tri_v0.shape[0] == n_tris
    assert (g.bvh.node_min.shape[0] > 0) == (n_tris >= bvh_mod.MIN_TRIS_FOR_BVH)

    ray = _rays(512, 7)
    hit = intersect(g, ray)
    t_ref, id_ref = _mt_reference(ray.o, ray.d, g.tri_v0, g.tri_e1, g.tri_e2,
                                  ray.mint, np.full(512, 3.4e38))
    found = np.asarray(hit.prim_kind) == PRIM_TRI
    np.testing.assert_array_equal(found, id_ref >= 0)
    assert found.mean() > 0.3
    np.testing.assert_array_equal(np.asarray(hit.prim_id)[found], id_ref[found])
    np.testing.assert_allclose(np.asarray(hit.t)[found], t_ref[found], rtol=1e-4)


@pytest.mark.parametrize("n_sph", [bvh_mod.MIN_SPHS_FOR_BVH - 1, bvh_mod.MIN_SPHS_FOR_BVH])
def test_sphere_path_chosen_by_count(tmp_path, n_sph):
    rng = np.random.default_rng(n_sph)
    center = rng.uniform(-1.5, 1.5, (n_sph, 3))
    radius = rng.uniform(0.05, 0.3, n_sph)
    shapes = "".join(
        f'<shape type="sphere"><point name="center" value="{c[0]},{c[1]},{c[2]}"/>'
        f'<float name="radius" value="{r}"/></shape>'
        for c, r in zip(center, radius)
    )
    g = _scene_xml(tmp_path, shapes).geometry
    assert (g.sph_bvh.node_min.shape[0] > 0) == (n_sph >= bvh_mod.MIN_SPHS_FOR_BVH)

    ray = _rays(512, 8)
    hit = intersect(g, ray)
    t_ref, id_ref = _sphere_reference(ray.o, ray.d, g.sph_center, g.sph_radius, ray.mint)
    found = np.asarray(hit.prim_kind) == PRIM_SPHERE
    np.testing.assert_array_equal(found, id_ref >= 0)
    assert found.mean() > 0.2
    np.testing.assert_array_equal(np.asarray(hit.prim_id)[found], id_ref[found])
    np.testing.assert_allclose(np.asarray(hit.t)[found], t_ref[found], rtol=1e-4)
