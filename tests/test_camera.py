"""Camera rays against a float64 numpy reference (perspective.cpp:97-141).

The reference is written from the camera model, not from the matrices the
renderer builds: a sample (x, y) on the film maps to the camera-space
direction ((2x/W − 1)·tan(fov/2), (1 − 2y/H)·tan(fov/2)/aspect, 1); a thin
lens moves the origin to a polar-mapped point on the aperture and aims the
ray at the focal plane. The renderer's camera products run at full float32
precision on every device, so float32 rounding bounds the difference.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from optix_renderer_tpu.core import transform as tf
from optix_renderer_tpu.ops import camera as camera_ops
from optix_renderer_tpu.scene.data import Camera

W, H = 64, 48
NEAR, FAR = 1e-4, 1e4

CAMERAS = {
    "pinhole": dict(to_world=np.eye(4), fov=40.0, lens=0.0, focal=0.0),
    "thin-lens": dict(to_world=np.eye(4), fov=40.0, lens=0.2, focal=3.0),
    "rotated": dict(
        to_world=tf.lookat([1.0, 2.0, 3.0], [-0.5, 0.3, 0.1], [0.2, 1.0, 0.1]),
        fov=60.0, lens=0.1, focal=2.5,
    ),
}


def _reference(to_world, fov, lens, focal, pos, aperture):
    t = np.tan(np.radians(fov) / 2.0)
    x = (2.0 * pos[:, 0] / W - 1.0) * t
    y = (1.0 - 2.0 * pos[:, 1] / H) * t / (W / H)
    d = np.stack([x, y, np.ones_like(x)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    inv_z = 1.0 / d[:, 2]
    o = np.zeros_like(d)
    if lens > 0:
        r, phi = np.sqrt(aperture[:, 0]), 2.0 * np.pi * aperture[:, 1]
        o = np.stack([lens * r * np.cos(phi), lens * r * np.sin(phi), np.zeros_like(r)], -1)
        d = d * (focal / d[:, 2:3]) - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (tf.apply_point(to_world, o), tf.apply_vector(to_world, d),
            NEAR * inv_z, FAR * inv_z)


@pytest.mark.parametrize("name", list(CAMERAS))
def test_camera_rays_match_float64_reference(name):
    c = CAMERAS[name]
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 1, (1000, 2)) * np.array([W, H])
    aperture = rng.uniform(0, 1, (1000, 2))
    cam = Camera(
        to_world=jnp.asarray(c["to_world"], jnp.float32), fov=jnp.float32(c["fov"]),
        near_clip=jnp.float32(NEAR), far_clip=jnp.float32(FAR),
        lens_radius=jnp.float32(c["lens"]), focal_distance=jnp.float32(c["focal"]),
    )
    ray, weight = camera_ops.sample_ray(
        cam, W, H, jnp.asarray(pos, jnp.float32), jnp.asarray(aperture, jnp.float32)
    )
    o, d, mint, maxt = _reference(c["to_world"], c["fov"], c["lens"], c["focal"], pos, aperture)
    np.testing.assert_allclose(np.asarray(ray.d), d, atol=2e-6)
    np.testing.assert_allclose(np.asarray(ray.o), o, atol=2e-6)
    np.testing.assert_allclose(np.asarray(ray.mint), mint, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(ray.maxt), maxt, rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(weight), 1.0)
