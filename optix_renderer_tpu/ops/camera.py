"""Perspective camera ray generation with thin-lens depth of field.

Batched implementation of `PerspectiveCamera::sampleRay`
(src/cameras/perspective.cpp:97-141): sample→camera projective unproject,
optional thin-lens bend toward the focal plane, camera→world transform,
near/far interval scaled by 1/d.z. The projection matrix is derived in-jit
from raw parameters (perspective.cpp:68-95 `update()`), so resolution is a
static config value and fov/lens parameters stay differentiable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from optix_renderer_tpu.core import warp
from optix_renderer_tpu.core.math import EPSILON, PI, Ray, normalize
from optix_renderer_tpu.scene.data import Camera

# Ray geometry must not run in TF32, which a GPU may use for a float32
# product at default precision: ask for full float32 in every camera product.
_HI = jax.lax.Precision.HIGHEST


def sample_to_camera_matrix(cam: Camera, width: int, height: int) -> jnp.ndarray:
    """Inverse of (screen-shift ∘ perspective), perspective.cpp:69-95."""
    aspect = width / height
    recip = 1.0 / (cam.far_clip - cam.near_clip)
    cot = 1.0 / jnp.tan(cam.fov * (PI / 180.0) / 2.0)
    persp = jnp.array(
        [
            [1.0, 0, 0, 0],
            [0, 1.0, 0, 0],
            [0, 0, 0, 0],
            [0, 0, 1.0, 0],
        ],
        jnp.float32,
    )
    persp = persp.at[0, 0].set(cot)
    persp = persp.at[1, 1].set(cot)
    persp = persp.at[2, 2].set(cam.far_clip * recip)
    persp = persp.at[2, 3].set(-cam.near_clip * cam.far_clip * recip)
    screen = jnp.array(
        [
            [0.5, 0, 0, 0.5],
            [0, -0.5 * aspect, 0, 0.5],
            [0, 0, 1, 0],
            [0, 0, 0, 1],
        ],
        jnp.float32,
    )
    return jnp.linalg.inv(jnp.matmul(screen, persp, precision=_HI))


def _xform_point(m: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    r = jnp.matmul(p, m[:3, :3].T, precision=_HI) + m[:3, 3]
    w = jnp.matmul(p, m[3, :3], precision=_HI) + m[3, 3]
    return r / w[..., None]


def _xform_vector(m: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    return jnp.matmul(v, m[:3, :3].T, precision=_HI)


def sample_ray(
    cam: Camera,
    width: int,
    height: int,
    sample_position: jnp.ndarray,
    aperture_sample: jnp.ndarray,
) -> tuple[Ray, jnp.ndarray]:
    """sample_position: [...,2] continuous pixel coords; aperture: [...,2] in [0,1)².

    Returns (ray, importance weight [...,3]) — weight is 1 (perspective.cpp:140).
    """
    s2c = sample_to_camera_matrix(cam, width, height)
    near_p = _xform_point(
        s2c,
        jnp.stack(
            [
                sample_position[..., 0] / width,
                sample_position[..., 1] / height,
                jnp.zeros_like(sample_position[..., 0]),
            ],
            axis=-1,
        ),
    )
    d_local = normalize(near_p)
    o_local = jnp.zeros_like(d_local)

    # thin-lens DoF (perspective.cpp:113-130); branch-free blend on lensRadius
    p_lens2 = cam.lens_radius * warp.square_to_uniform_disk(aperture_sample)
    p_lens = jnp.concatenate([p_lens2, jnp.zeros_like(p_lens2[..., :1])], axis=-1)
    ft = cam.focal_distance / d_local[..., 2:3]
    p_focus = d_local * ft  # ray(ft) from origin
    d_dof = normalize(p_focus - p_lens)
    use_dof = cam.lens_radius > EPSILON
    o_local = jnp.where(use_dof, p_lens, o_local)
    d_final = jnp.where(use_dof, d_dof, d_local)

    o_world = _xform_point(cam.to_world, o_local)
    d_world = _xform_vector(cam.to_world, d_final)

    inv_z = 1.0 / d_local[..., 2]
    ray = Ray(
        o=o_world,
        d=d_world,
        mint=cam.near_clip * inv_z,
        maxt=cam.far_clip * inv_z,
    )
    weight = jnp.ones(sample_position.shape[:-1] + (3,), jnp.float32)
    return ray, weight
