"""Image-based environment map: luminance-importance sampling + eval/pdf.

Counterpart of the reference EnvMap emitter
(src/emitters/environmentmap.cpp:73-168): the per-pixel luminance DPDF
(calculateProbs, :154-168) becomes a flat CDF over the lat-long grid sampled
with `searchsorted`; eval (:118-131) is a batched nearest gather.

Deviations from the reference, deliberate and documented:
- Grid orientation: the reference builds its DPDF on a transposed
  (phi-rows × theta-cols) grid threaded through its own texture flip
  (environmentmap.cpp:76-80 + PNGTexture.cpp:147-150). We use the natural
  lat-long grid (rows = theta ∈ [0,π], cols = phi ∈ [0,2π]) — the *texel
  colors per direction* are identical, only the internal index layout differs.
- The pdf: the reference's pdf (environmentmap.cpp:106-117) omits the sin θ
  Jacobian and uses 4π instead of the exact per-pixel solid angle, making its
  sample/pdf pair inconsistent (biased MIS). We weight the DPDF by
  luminance·sinθ and return the exact solid-angle pdf
  pmf / ω_pixel with ω_pixel = (2π/W)(cos θ_r − cos θ_{r+1}),
  so χ² sample-vs-pdf agreement holds (tests/test_envmap.py).
- Within-pixel jitter: the reference returns the discrete pixel-center
  direction; we jitter uniformly inside the pixel so the sampled direction
  density matches the continuous pdf exactly.

The build-time table construction is numpy (scene compile); the sample/eval/
pdf functions are jit-traceable over ray wavefronts.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from optix_renderer_tpu.core import dpdf as dpdf_mod
from optix_renderer_tpu.core import warp
from optix_renderer_tpu.core.math import PI, INV_FOURPI


class EnvmapTables(NamedTuple):
    """Per-scene envmap data (SceneData.envmap / envmap_pick).

    img: [H,W,3] oriented lat-long radiance (radiance scale premultiplied);
         [1,1,3] for constant envmaps (reference constant-texture fallback).
    rot: [3,3] world→map rotation (PNGTexture eulerAngles, ZXZ order).
    """

    img: jnp.ndarray
    rot: jnp.ndarray


def constant_tables(radiance) -> EnvmapTables:
    return EnvmapTables(
        img=jnp.asarray(np.asarray(radiance, np.float32).reshape(1, 1, 3)),
        rot=jnp.eye(3, dtype=jnp.float32),
    )


def euler_zxz(angles_deg) -> np.ndarray:
    """PNGTexture.cpp:131-137 rotation: Rz(x)·Rx(y)·Rz(z), degrees."""
    ax, ay, az = np.radians(np.asarray(angles_deg, np.float64))

    def rz(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])

    def rx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    return (rz(ax) @ rx(ay) @ rz(az)).astype(np.float32)


def build_tables(
    image: np.ndarray, radiance, euler_deg=(0.0, 0.0, 0.0), flip_v: bool = True
) -> tuple[EnvmapTables, dpdf_mod.DiscretePDF]:
    """Orient the source image onto the natural lat-long grid and build the
    luminance·sinθ pixel DPDF.

    `flip_v` replicates the reference texture's vertical flip
    (PNGTexture.cpp:148 `h = height − v·height`): oriented row r (θ grows
    downward from +z) reads source row (H−r) mod H.
    """
    img = np.asarray(image, np.float32)
    h, w = img.shape[:2]
    if flip_v and h > 1:
        rows = (h - np.arange(h)) % h
        img = img[rows]
    img = img * np.asarray(radiance, np.float32).reshape(1, 1, 3)

    lum = img @ np.array([0.212671, 0.715160, 0.072169], np.float32)  # color.h
    theta_edges = np.linspace(0.0, np.pi, h + 1, dtype=np.float64)
    # exact per-row pixel solid angle: (2π/W)(cosθ_r − cosθ_{r+1})
    omega_row = (2.0 * np.pi / w) * (
        np.cos(theta_edges[:-1]) - np.cos(theta_edges[1:])
    )
    weights = np.abs(lum) * omega_row[:, None].astype(np.float32)
    pick = dpdf_mod.build(jnp.asarray(weights.reshape(-1), jnp.float32))
    return EnvmapTables(img=jnp.asarray(img), rot=jnp.asarray(euler_zxz(euler_deg))), pick


def _dir_to_rc(env: EnvmapTables, d: jnp.ndarray):
    """World direction → (row, col, theta) on the oriented grid."""
    h, w = env.img.shape[0], env.img.shape[1]
    # rotated into map space (PNGTexture rot * wi); full float32, never TF32
    dm = jnp.matmul(d, env.rot.T, precision=jax.lax.Precision.HIGHEST)
    theta = jnp.arccos(jnp.clip(dm[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(dm[..., 1], dm[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * PI, phi)
    r = jnp.clip((theta / PI * h).astype(jnp.int32), 0, h - 1)
    c = jnp.clip((phi / (2.0 * PI) * w).astype(jnp.int32), 0, w - 1)
    return r, c, theta


def eval_dir(env: EnvmapTables, d: jnp.ndarray) -> jnp.ndarray:
    """Radiance arriving from direction `d` (environmentmap.cpp:118-131)."""
    r, c, _ = _dir_to_rc(env, d)
    return env.img[r, c]


def _row_omega(env: EnvmapTables, r: jnp.ndarray) -> jnp.ndarray:
    h, w = env.img.shape[0], env.img.shape[1]
    t0 = r.astype(jnp.float32) / h * PI
    t1 = (r.astype(jnp.float32) + 1.0) / h * PI
    return (2.0 * PI / w) * (jnp.cos(t0) - jnp.cos(t1))


def pdf_dir(
    env: EnvmapTables, pick: dpdf_mod.DiscretePDF, d: jnp.ndarray
) -> jnp.ndarray:
    """Solid-angle pdf of `sample_dir` producing direction `d`."""
    h, w = env.img.shape[0], env.img.shape[1]
    if h == 1 and w == 1:
        return jnp.full(d.shape[:-1], INV_FOURPI)
    r, c, _ = _dir_to_rc(env, d)
    pmf = pick.pmf[r * w + c]
    return pmf / jnp.maximum(_row_omega(env, r), 1e-12)


def sample_dir(
    env: EnvmapTables,
    pick: dpdf_mod.DiscretePDF,
    u2: jnp.ndarray,
):
    """Importance-sample a direction toward the envmap.

    Returns (d [N,3] world, pdf [N], radiance [N,3]). Constant (1×1) envmaps
    fall back to uniform-sphere sampling (environmentmap.cpp:84-88).
    """
    h, w = env.img.shape[0], env.img.shape[1]
    if h == 1 and w == 1:
        d = warp.square_to_uniform_sphere(u2)
        pdf = jnp.full(d.shape[:-1], INV_FOURPI)
        return d, pdf, jnp.broadcast_to(env.img[0, 0], d.shape)

    # pick a pixel by luminance (sampleReuse frees u for within-pixel jitter)
    idx, u_re = dpdf_mod.sample_reuse(pick, u2[..., 0])
    r = idx // w
    c = idx % w
    # jitter uniformly in SOLID ANGLE inside the pixel (cosθ uniform within
    # the row's [cosθ₀,cosθ₁] band) so the continuous density is exactly
    # pmf/ω_pixel — uniform-in-θ jitter would be 1/sinθ-biased within a row
    cos0 = jnp.cos(r.astype(jnp.float32) / h * PI)
    cos1 = jnp.cos((r.astype(jnp.float32) + 1.0) / h * PI)
    ct = jnp.clip(cos0 + u_re * (cos1 - cos0), -1.0, 1.0)
    st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 0.0))
    phi = (c.astype(jnp.float32) + u2[..., 1]) / w * (2.0 * PI)
    dm = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], -1)
    # inverse rotation (rot is orthonormal: R⁻¹ = Rᵀ); full float32
    d = jnp.matmul(dm, env.rot, precision=jax.lax.Precision.HIGHEST)
    pdf = pick.pmf[idx] / jnp.maximum(_row_omega(env, r), 1e-12)
    value = env.img[r, c]
    return d, pdf, value
