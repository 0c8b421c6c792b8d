"""Gradient correctness: finite-difference validation (round-3 VERDICT M3).

BASELINE.json's north star demands pixel gradients that are *correct*, not
merely finite. Strategy (SURVEY §7 Phase 5 "Gradient allclose checks vs
finite differences"):

- The renderer with a FIXED seed is a deterministic function of its
  parameters; central differences of that function must match reverse-mode
  AD of the same function wherever no discrete sampling decision flips
  inside [θ−h, θ+h]. Scenes/integrators here are chosen so that no discrete
  decision *depends on* the differentiated parameters (path_mats below the
  RR depth: the only parameter-dependent branch is the |throughput|>0 lane
  kill, far from its threshold in these scenes), making FD/AD agreement
  exact up to float32 noise.
- For the detached-sampling estimators (heterogeneous delta/ratio tracking,
  ops/volume_grid.py) AD is a *score-function* estimator: it matches the
  true derivative in expectation, not per-seed — validated against the
  analytic derivative of the transmittance of a constant grid instead.

Directional derivatives are used throughout: FD needs 2 renders per
direction instead of 2 per parameter entry.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from optix_renderer_tpu.parallel.shard import apply_params, trainable_params
from optix_renderer_tpu.render.render import render_round
from optix_renderer_tpu.scene.presets import make_cornell_box, make_tessellated_cornell


def _fd_vs_ad(loss_fn, params, direction, h):
    """Directional derivative: AD <grad, dir> vs central difference."""
    grads = jax.grad(loss_fn)(params)
    ad = sum(
        float(jnp.vdot(grads[k], direction[k])) for k in direction
    )
    p_plus = {k: params[k] + h * direction.get(k, 0.0) for k in params}
    p_minus = {k: params[k] - h * direction.get(k, 0.0) for k in params}
    fd = (float(loss_fn(p_plus)) - float(loss_fn(p_minus))) / (2.0 * h)
    return ad, fd


def _image_loss(scene, config, pix):
    def loss_fn(params):
        sc = apply_params(scene, params)
        img = render_round(sc, config, pix, jnp.int32(0))
        return jnp.mean(img[0, ..., :3] ** 2)

    return loss_fn


def _check_directions(scene, config, cases, rtol):
    pix = jnp.arange(config.width * config.height, dtype=jnp.int32)
    loss_fn = _image_loss(scene, config, pix)
    params = trainable_params(scene)
    import zlib

    for key, h in cases:
        rng = np.random.default_rng(zlib.crc32(key.encode()))
        d = jnp.asarray(
            rng.standard_normal(np.asarray(params[key]).shape), jnp.float32
        )
        direction = {key: d}
        ad, fd = _fd_vs_ad(loss_fn, params, direction, h)
        assert np.isfinite(ad) and np.isfinite(fd), (key, ad, fd)
        assert abs(ad) > 1e-8, f"{key}: AD gradient vanished ({ad})"
        assert ad == pytest.approx(fd, rel=rtol), (key, ad, fd)


def test_fd_cornell_brute_force_path():
    """12-tri Cornell (brute-force sweep): emitter radiance and
    texture albedo gradients match central differences (VERDICT item 1a)."""
    scene, config, _ = make_cornell_box(
        width=32, height=24, spp=1, integrator="path_mats"
    )
    config = dataclasses.replace(config, max_depth=3)
    _check_directions(
        scene, config, [("em_radiance", 2e-2), ("tex_value", 2e-2)], rtol=2e-2
    )


@pytest.mark.heavy
def test_fd_bvh_scene():
    """≥257-tri scene routed through the LBVH walk: gradients flow through
    the detach+replay traversal and match central differences (VERDICT 1b —
    the round-3 M2 crash repro, now a correctness test)."""
    scene, config, _ = make_tessellated_cornell(
        width=32, height=24, spp=1, integrator="path_mats", nu=24, nv=12
    )
    assert scene.geometry.bvh.node_min.shape[0] > 0, "scene must use the BVH"
    config = dataclasses.replace(config, max_depth=3)
    _check_directions(
        scene, config, [("em_radiance", 2e-2), ("tex_value", 2e-2)], rtol=2e-2
    )


@pytest.mark.heavy
def test_fd_homogeneous_medium():
    """Homogeneous-medium scene (path_vol_mats): radiance gradient through
    the volumetric estimator matches central differences; σs gradient (which
    rides the reparameterized free-path sample AND the spectral weights)
    matches FD at the committed seed (VERDICT 1c)."""
    import test_heterog as th  # scene builder fixture module
    import tempfile
    from pathlib import Path

    tmp = Path(tempfile.mkdtemp(prefix="grad_homog_"))
    th._write_cube_obj(tmp / "cube.obj")
    # path_vol_mis: NEE reaches the delta point light (path_vol_mats never
    # could — BSDF/phase sampling cannot hit a delta emitter); RR starts at
    # bounce 3, so max_depth=3 keeps the estimator free of
    # parameter-dependent discrete decisions
    xml = """
<scene>
  <integrator type="path_vol_mis"/>
  <sampler type="independent"><integer name="sampleCount" value="1"/></sampler>
  <camera type="perspective">
    <float name="fov" value="35"/>
    <transform name="toWorld"><lookat target="0,0,0" origin="0,-2.5,0" up="0,0,1"/></transform>
    <integer name="width" value="24"/><integer name="height" value="24"/>
  </camera>
  <shape type="obj">
    <string name="filename" value="cube.obj"/>
    <medium type="homog">
      <color name="sigma_a" value="0.4,0.5,0.6"/>
      <color name="sigma_s" value="1.2,1.0,0.8"/>
    </medium>
  </shape>
  <emitter type="point">
    <point name="position" value="0,-2,2"/>
    <color name="power" value="400,400,400"/>
  </emitter>
</scene>
"""
    (tmp / "scene.xml").write_text(xml)
    from optix_renderer_tpu.scene.build import load_scene

    scene, config, _ = load_scene(tmp / "scene.xml")
    config = dataclasses.replace(config, max_depth=3)
    pix = jnp.arange(config.width * config.height, dtype=jnp.int32)

    # the point light's runtime brightness is its derived radiance
    # (power/4π baked at build; pointlight.cpp) — exposed by trainable_params
    _check_directions(scene, config, [("em_radiance", 2e-1)], rtol=2e-2)

    # σs directional derivative (not in trainable_params — test directly)
    def loss_sigma(sigma_s):
        sc = scene._replace(media=scene.media._replace(sigma_s=sigma_s))
        img = render_round(sc, config, pix, jnp.int32(0))
        return jnp.mean(img[0, ..., :3] ** 2)

    s0 = scene.media.sigma_s
    rng = np.random.default_rng(7)
    d = jnp.asarray(rng.standard_normal(np.asarray(s0).shape), jnp.float32)
    g = jax.grad(loss_sigma)(s0)
    ad = float(jnp.vdot(g, d))
    h = 1e-2
    fd = (float(loss_sigma(s0 + h * d)) - float(loss_sigma(s0 - h * d))) / (2 * h)
    assert np.isfinite(ad) and abs(ad) > 1e-8
    assert ad == pytest.approx(fd, rel=5e-2), (ad, fd)


def test_ratio_track_gradient_analytic():
    """Differential ratio tracking (volume_grid.ratio_track score surrogate):
    on a constant grid the mean AD derivative of T w.r.t. σ must match the
    analytic d/dc exp(−c·L) = −L·exp(−c·L). This is exactly the case a naive
    detach gets wrong (the ratio factor is σ-independent — all σ-dependence
    rides the detached Poisson sampling)."""
    import tempfile
    from pathlib import Path

    import test_heterog as th

    tmp = Path(tempfile.mkdtemp(prefix="grad_ratio_"))
    density = np.ones((8, 8, 8), np.float32)
    sigma_a, sigma_s = 0.75, 0.75  # c = σt = 1.5
    scene, config, _ = th._heterog_scene(tmp, density, sigma_a, sigma_s)
    media = scene.media
    from optix_renderer_tpu.ops import volume_grid as vg
    from optix_renderer_tpu.render import sampler as smp

    n = 8192
    med_id = jnp.zeros(n, jnp.int32)
    o = jnp.tile(jnp.array([[-2.0, 0.0, 0.0]]), (n, 1))
    d = jnp.tile(jnp.array([[1.0, 0.0, 0.0]]), (n, 1))
    dist = jnp.full(n, 10.0)
    s = smp.make_sampler(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(0), seed=3)

    def mean_T(sigma_s_val):
        m = media._replace(sigma_s=sigma_s_val)
        _, T = vg.ratio_track(m, med_id, s, o, d, dist)
        return jnp.mean(T[:, 0])

    val, grad = jax.value_and_grad(mean_T)(media.sigma_s)
    # segment length inside the unit cube ≈ 1 (trilinear interpolation ramps
    # density over the half-voxel border, so the effective optical length is
    # slightly below 1); c = σa+σs (achromatic)
    c = sigma_a + sigma_s
    assert float(val) == pytest.approx(np.exp(-c), rel=0.12)
    # self-consistent analytic check: T = exp(−c·L_eff) ⇒ dT/dc = T·ln(T)/c,
    # using the measured T so the border systematic cancels. grad is the σs
    # table [1,3]; the achromatic max contributes via its subgradient —
    # compare the summed total.
    L_eff = -np.log(float(val)) / c
    dT_true = -L_eff * float(val)
    total = float(jnp.sum(grad))
    assert total == pytest.approx(dT_true, rel=0.15), (total, dT_true)


def test_delta_track_score_weight_unit_value():
    """delta_track's w_score must be exactly 1 in the primal (it only carries
    a gradient); its mean AD derivative w.r.t. σ on a constant grid matches
    the analytic derivative of the escape probability."""
    import tempfile
    from pathlib import Path

    import test_heterog as th

    tmp = Path(tempfile.mkdtemp(prefix="grad_delta_"))
    density = np.ones((8, 8, 8), np.float32)
    sigma_a, sigma_s = 1.0, 1.0  # c = 2
    scene, config, _ = th._heterog_scene(tmp, density, sigma_a, sigma_s)
    media = scene.media
    from optix_renderer_tpu.ops import volume_grid as vg
    from optix_renderer_tpu.render import sampler as smp

    n = 8192
    med_id = jnp.zeros(n, jnp.int32)
    o = jnp.tile(jnp.array([[-2.0, 0.0, 0.0]]), (n, 1))
    d = jnp.tile(jnp.array([[1.0, 0.0, 0.0]]), (n, 1))
    t_max = jnp.full(n, 10.0)
    s = smp.make_sampler(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(0), seed=11)

    _, t_event, w = vg.delta_track(media, med_id, s, o, d, t_max)
    np.testing.assert_array_equal(np.asarray(w), 1.0)

    # escape estimator: mean(w · [escaped]) — AD grad vs analytic
    # d/dc P(escape) = d/dc exp(−c·L) with L=1
    def escape_prob(sigma_s_val):
        m = media._replace(sigma_s=sigma_s_val)
        _, t_e, w_ = vg.delta_track(m, med_id, s, o, d, t_max)
        return jnp.mean(w_ * jnp.where(jnp.isinf(t_e), 1.0, 0.0))

    val, grad = jax.value_and_grad(escape_prob)(media.sigma_s)
    c = sigma_a + sigma_s
    assert float(val) == pytest.approx(np.exp(-c), rel=0.07)
    total = float(jnp.sum(grad))
    assert total == pytest.approx(-np.exp(-c), rel=0.2), (total, -np.exp(-c))


def test_traverse_replay_matches_brute_gradients():
    """LBVH traversal gradients (detach+replay) == brute-force jnp sweep
    gradients on identical rays/triangles: d(sum t)/d(vertices) allclose."""
    from optix_renderer_tpu.core.math import Ray
    from optix_renderer_tpu.ops import bvh as bvh_mod
    from optix_renderer_tpu.ops.intersect import _mt_jnp

    rng = np.random.default_rng(5)
    n_tri = 300  # above MIN_TRIS_FOR_BVH
    v0 = rng.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (n_tri, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (n_tri, 3)).astype(np.float32)
    bvh = bvh_mod.build_bvh(v0, v0 + e1, v0 + e2)

    n = 64
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 3.0
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 1.0
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ray = Ray(
        o=jnp.asarray(o),
        d=jnp.asarray(dirs),
        mint=jnp.zeros(n),
        maxt=jnp.full(n, jnp.inf),
    )
    t_init = jnp.full(n, 3.4e38)

    def loss_bvh(v0j, e1j, e2j):
        t, _, u, v, found = bvh_mod.traverse(bvh, v0j, e1j, e2j, ray, t_init)
        tt = jnp.where(found, t, 0.0)
        return jnp.sum(tt + jnp.where(found, u + v, 0.0))

    def loss_brute(v0j, e1j, e2j):
        t, u, v, idf = _mt_jnp(
            ray.o, ray.d, ray.mint, t_init, v0j, e1j, e2j
        )
        found = idf >= 0
        return jnp.sum(
            jnp.where(found, t, 0.0) + jnp.where(found, u + v, 0.0)
        )

    args = (jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2))
    # identical winners → identical values and gradients
    assert float(loss_bvh(*args)) == pytest.approx(
        float(loss_brute(*args)), rel=1e-5
    )
    g_bvh = jax.grad(loss_bvh, argnums=(0, 1, 2))(*args)
    g_brt = jax.grad(loss_brute, argnums=(0, 1, 2))(*args)
    for gb, gr in zip(g_bvh, g_brt):
        np.testing.assert_allclose(np.asarray(gb), np.asarray(gr), rtol=1e-4, atol=1e-5)


def test_sphere_replay_gradient_fd():
    """Sphere traversal replay: d t/d(center, radius) matches FD."""
    from optix_renderer_tpu.core.math import Ray
    from optix_renderer_tpu.ops import bvh as bvh_mod

    rng = np.random.default_rng(9)
    n_sph = 80
    centers = rng.uniform(-2, 2, (n_sph, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 0.4, n_sph).astype(np.float32)
    bvh = bvh_mod.build_sphere_bvh(centers, radii)

    n = 32
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = 5.0
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 0.5
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    ray = Ray(
        o=jnp.asarray(o), d=jnp.asarray(dirs),
        mint=jnp.zeros(n), maxt=jnp.full(n, jnp.inf),
    )
    t_init = jnp.full(n, 3.4e38)

    def loss(c, r):
        t, sid, found = bvh_mod.traverse_spheres(bvh, c, r, ray, t_init)
        return jnp.sum(jnp.where(found, t, 0.0))

    c0, r0 = jnp.asarray(centers), jnp.asarray(radii)
    gc, gr = jax.grad(loss, argnums=(0, 1))(c0, r0)
    d_c = jnp.asarray(rng.standard_normal(centers.shape), jnp.float32)
    d_r = jnp.asarray(rng.standard_normal(radii.shape), jnp.float32)
    ad = float(jnp.vdot(gc, d_c) + jnp.vdot(gr, d_r))
    h = 1e-3
    fd = (
        float(loss(c0 + h * d_c, r0 + h * d_r))
        - float(loss(c0 - h * d_c, r0 - h * d_r))
    ) / (2 * h)
    assert np.isfinite(ad) and abs(ad) > 1e-6
    assert ad == pytest.approx(fd, rel=2e-2), (ad, fd)
