"""End-to-end renderer tests: furnace, determinism, sharding invariance.

Mirrors the reference's validation strategy (SURVEY.md §4): statistical
image-mean tests (the ttest scene mode, ttest.cpp:191-239) and the furnace
test (scenes/pa4/tests/test-furnace.xml analog), plus the CPU-as-reference
device-equivalence check.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from optix_renderer_tpu.scene.presets import make_cornell_box, make_furnace
from optix_renderer_tpu.render.render import render, render_round
from optix_renderer_tpu.parallel.shard import make_mesh, render_sharded


@pytest.fixture(scope="module")
def furnace():
    scene, config, _ = make_furnace(albedo=0.75, radiance=1.0, width=48, height=48)
    return scene, config


def test_furnace_path_mis(furnace):
    """Convex diffuse sphere (albedo a) in constant env L: every sphere pixel
    must equal a·L in expectation; background pixels equal L exactly."""
    scene, config = furnace
    config = dataclasses.replace(config, integrator="path_mis", max_depth=6)
    out = render(scene, config, sample_count=24)
    img = out["composite"]

    # background = direct env hit, exact
    corners = np.stack([img[0, 0], img[0, -1], img[-1, 0], img[-1, -1]])
    np.testing.assert_allclose(corners, 1.0, atol=1e-3)

    # center of the sphere: a·L
    h, w, _ = img.shape
    patch = img[h // 2 - 4 : h // 2 + 4, w // 2 - 4 : w // 2 + 4]
    mean = patch.mean()
    assert abs(mean - 0.75) < 0.02, f"furnace mean {mean}, expected 0.75"


def test_furnace_direct_integrators(furnace):
    """direct_ems/mats/mis on the furnace: single-bounce value is also a·L
    for a convex body (secondary rays escape)."""
    scene, config = furnace
    for integ in ["direct_ems", "direct_mats", "direct_mis"]:
        cfg = dataclasses.replace(config, integrator=integ)
        out = render(scene, cfg, sample_count=24)
        img = out["composite"]
        h, w, _ = img.shape
        patch = img[h // 2 - 4 : h // 2 + 4, w // 2 - 4 : w // 2 + 4]
        assert abs(patch.mean() - 0.75) < 0.03, (integ, patch.mean())


@pytest.fixture(scope="module")
def cbox():
    scene, config, _ = make_cornell_box(width=40, height=30, spp=2)
    config = dataclasses.replace(config, max_depth=4)
    return scene, config


def test_render_deterministic(cbox):
    scene, config = cbox
    a = render(scene, config, sample_count=2)["composite"]
    b = render(scene, config, sample_count=2)["composite"]
    np.testing.assert_array_equal(a, b)


def test_sharded_matches_single_device(cbox):
    """Sharding must not change the image (stateless per-lane seeding):
    the multi-device render is bit-compatible with the single-device one up
    to float accumulation order (tolerance, not exactness)."""
    scene, config = cbox
    single = render(scene, config, sample_count=2)["composite"]
    mesh = make_mesh()  # 8 virtual CPU devices → (4,2) tile×sample
    assert mesh.devices.size == 8
    sharded = render_sharded(scene, config, mesh, sample_count=2)["composite"]
    np.testing.assert_allclose(sharded, single, atol=2e-4)


def test_sharded_box_filter_path_mats_matches_single_device(cbox):
    """A classic surface scene with a box filter (the configuration a
    separate sharded kernel path used to take) goes through the same
    shard_map integrators and matches render() up to fp add order."""
    scene, config = cbox
    config = dataclasses.replace(config, rfilter="box", integrator="path_mats")
    single = render(scene, config, sample_count=2)
    sharded = render_sharded(scene, config, make_mesh(), sample_count=2)
    np.testing.assert_allclose(sharded["composite"], single["composite"], atol=2e-4)
    np.testing.assert_allclose(sharded["weights"], single["weights"], atol=1e-5)
    assert sharded["spp_done"] == 2


def test_cbox_light_visible(cbox):
    scene, config = cbox
    out = render(scene, config, sample_count=2)
    img = out["composite"]
    # light pixels should carry the emitter radiance (~17 in R)
    assert img.max() > 10.0
    # AOVs populated
    assert out["albedo"].max() > 0.1
    assert np.abs(out["normal"]).max() > 0.5


def test_aov_normal_plausible(cbox):
    """Filtered normals blend across silhouettes, so only bounds hold:
    ‖n‖ ≤ 1 + ε everywhere, and ≈1 on flat interior regions."""
    scene, config = cbox
    out = render(scene, config, sample_count=1)
    n = out["normal"]
    lens = np.linalg.norm(n, axis=-1)
    assert lens.max() <= 1.05
    hit = lens > 0.1
    assert np.median(lens[hit]) > 0.95


def test_gradients_finite(cbox):
    from optix_renderer_tpu.parallel.shard import (
        apply_params,
        sharded_train_step,
        trainable_params,
    )

    scene, config = cbox
    config = dataclasses.replace(config, max_depth=2)
    mesh = make_mesh()
    n_pix = config.width * config.height
    n_tile = mesh.devices.shape[0]
    pad = (-n_pix) % n_tile
    ids = jnp.concatenate(
        [jnp.arange(n_pix, dtype=jnp.int32), jnp.full((pad,), -(1 << 20), jnp.int32)]
    )
    target = jnp.zeros((config.height, config.width, 3))
    loss, grads = sharded_train_step(scene, config, mesh, target, ids, jnp.int32(0))
    assert np.isfinite(float(loss))
    for k, g in grads.items():
        assert bool(jnp.all(jnp.isfinite(g))), k
    # emitter radiance must have signal (the light dominates the loss)
    assert float(jnp.linalg.norm(grads["em_radiance"])) > 0
