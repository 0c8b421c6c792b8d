"""Math substrate: constants, vector helpers, shading frames, rays, fresnel.

Counterpart of the reference's Eigen-based L0 layer
(`include/nori/{vector,color,frame,ray,common}.h`). Everything here operates on
batched `[..., 3]` float32 arrays (struct-of-arrays), is jit/vmap/grad-safe, and
avoids data-dependent control flow (`jnp.where` instead of branches).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Reference `include/nori/common.h:56`
EPSILON = 1e-4
PI = 3.14159265358979323846
INV_PI = 1.0 / PI
INV_TWOPI = 0.5 / PI
INV_FOURPI = 0.25 / PI
SQRT_TWO = 1.41421356237309504880
INF = jnp.inf


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the last axis, keeps batch shape."""
    return jnp.sum(a * b, axis=-1)


def norm(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def squared_norm(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(a * a, axis=-1)


def normalize(a: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """Safe normalize (returns input direction scaled by rsqrt of squared norm)."""
    n2 = jnp.sum(a * a, axis=-1, keepdims=True)
    return a * jnp.where(n2 > eps, 1.0 / jnp.sqrt(jnp.maximum(n2, eps)), 0.0)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.cross(a, b)


def safe_sqrt(x: jnp.ndarray, eps: float = 1e-12) -> jnp.ndarray:
    """sqrt clamped away from 0 so gradients stay finite at the boundary.

    Needed because `grad(sqrt)` at 0 is inf and a `jnp.where` on the primal
    does NOT stop the inf flowing through the cotangent of the dead branch.
    """
    return jnp.sqrt(jnp.maximum(x, eps))


def safe_norm(a: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """‖a‖ with finite gradient at a=0 (jnp.linalg.norm NaNs there)."""
    return jnp.sqrt(jnp.sum(a * a, axis=-1) + eps)


def safe_normalize(a: jnp.ndarray, eps: float = 1e-20) -> jnp.ndarray:
    """a/‖a‖ with finite gradient at a=0 (returns ~0 there)."""
    n2 = jnp.sum(a * a, axis=-1, keepdims=True)
    return a * jax.lax.rsqrt(n2 + eps)


def luminance(c: jnp.ndarray) -> jnp.ndarray:
    """Linear-RGB luminance, matches `Color3f::getLuminance` (color.h)."""
    return c[..., 0] * 0.212671 + c[..., 1] * 0.715160 + c[..., 2] * 0.072169


def to_srgb(c: jnp.ndarray) -> jnp.ndarray:
    """Linear → sRGB, matches `Color3f::toSRGB` (color.h)."""
    return jnp.where(
        c <= 0.0031308, 12.92 * c, 1.055 * jnp.power(jnp.maximum(c, 1e-12), 1.0 / 2.4) - 0.055
    )


def from_srgb(c: jnp.ndarray) -> jnp.ndarray:
    """sRGB → linear, matches `Color3f::toLinearRGB` (color.h)."""
    return jnp.where(c <= 0.04045, c / 12.92, jnp.power((c + 0.055) / 1.055, 2.4))


# ---------------------------------------------------------------------------
# Shading frame (reference `include/nori/frame.h`)
# ---------------------------------------------------------------------------


class Frame(NamedTuple):
    """Orthonormal shading frame; all fields `[..., 3]`.

    Functional analog of `nori::Frame` (frame.h:30-150): `n` is the shading
    normal (local +z), `s`/`t` span the tangent plane.
    """

    s: jnp.ndarray
    t: jnp.ndarray
    n: jnp.ndarray


def coordinate_system(n: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Build tangent/bitangent from a unit normal, branch-free (Duff et al. 2017).

    Same contract as the reference `Frame(n)` constructor (frame.h:46-56) which
    uses `coordinateSystem` from vector.h — any consistent ONB is valid there.
    """
    sign = jnp.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    s = jnp.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], axis=-1
    )
    t = jnp.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], axis=-1)
    return s, t


def make_frame(n: jnp.ndarray) -> Frame:
    s, t = coordinate_system(n)
    return Frame(s=s, t=t, n=n)


def frame_to_local(f: Frame, v: jnp.ndarray) -> jnp.ndarray:
    """World → local (frame.h:59-62)."""
    return jnp.stack([dot(v, f.s), dot(v, f.t), dot(v, f.n)], axis=-1)


def frame_to_world(f: Frame, v: jnp.ndarray) -> jnp.ndarray:
    """Local → world (frame.h:65-67)."""
    return (
        f.s * v[..., 0:1] + f.t * v[..., 1:2] + f.n * v[..., 2:3]
    )


def cos_theta(v: jnp.ndarray) -> jnp.ndarray:
    """z-component in the local frame (frame.h:70)."""
    return v[..., 2]


def sin_theta2(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.maximum(0.0, 1.0 - v[..., 2] * v[..., 2])


def sin_theta(v: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(sin_theta2(v))


def tan_theta(v: jnp.ndarray) -> jnp.ndarray:
    """Matches `Frame::tanTheta` (frame.h:85-91)."""
    return sin_theta(v) / v[..., 2]


# ---------------------------------------------------------------------------
# Rays (reference `include/nori/ray.h`)
# ---------------------------------------------------------------------------


class Ray(NamedTuple):
    """Batched ray: origin/direction `[..., 3]`, interval `[...]`.

    Functional analog of `Ray3f` (ray.h:31-105). `dinv` (reciprocal direction,
    used by AABB slab tests, bbox.h) is computed on demand, not stored.
    """

    o: jnp.ndarray
    d: jnp.ndarray
    mint: jnp.ndarray
    maxt: jnp.ndarray


def make_ray(o: jnp.ndarray, d: jnp.ndarray, mint=EPSILON, maxt=INF) -> Ray:
    batch = o.shape[:-1]
    mint = jnp.broadcast_to(jnp.asarray(mint, o.dtype), batch)
    maxt = jnp.broadcast_to(jnp.asarray(maxt, o.dtype), batch)
    return Ray(o=o, d=d, mint=mint, maxt=maxt)


def ray_at(ray: Ray, t: jnp.ndarray) -> jnp.ndarray:
    return ray.o + ray.d * t[..., None]


# ---------------------------------------------------------------------------
# Optics helpers (reference `src/utils/common.cpp` fresnel, refract)
# ---------------------------------------------------------------------------


def fresnel_dielectric(cos_theta_i: jnp.ndarray, ext_ior, int_ior) -> jnp.ndarray:
    """Unpolarized dielectric Fresnel reflectance.

    Same contract as reference `fresnel(cosThetaI, extIOR, intIOR)`
    (common.h:275, src/utils/common.cpp): handles incidence from either side,
    returns 1.0 on total internal reflection.
    """
    ext_ior = jnp.asarray(ext_ior, jnp.float32)
    int_ior = jnp.asarray(int_ior, jnp.float32)
    entering = cos_theta_i > 0.0
    eta_i = jnp.where(entering, ext_ior, int_ior)
    eta_t = jnp.where(entering, int_ior, ext_ior)
    ci = jnp.abs(cos_theta_i)

    eta = eta_i / eta_t
    sin2_t = eta * eta * jnp.maximum(0.0, 1.0 - ci * ci)
    tir = sin2_t > 1.0
    ct = safe_sqrt(1.0 - sin2_t)

    rs = (eta_i * ci - eta_t * ct) / jnp.maximum(eta_i * ci + eta_t * ct, 1e-20)
    rp = (eta_t * ci - eta_i * ct) / jnp.maximum(eta_t * ci + eta_i * ct, 1e-20)
    f = 0.5 * (rs * rs + rp * rp)
    f = jnp.where(tir, 1.0, f)
    # Matched media: no reflection
    f = jnp.where(jnp.abs(eta_i - eta_t) < 1e-12, 0.0, f)
    return f


def reflect_local(wi: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection in the local frame (mirror.cpp:46-51)."""
    return jnp.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], axis=-1)


def spherical_direction(theta: jnp.ndarray, phi: jnp.ndarray) -> jnp.ndarray:
    """(theta, phi) → unit vector; matches `sphericalDirection` (common.h:258)."""
    st, ct = jnp.sin(theta), jnp.cos(theta)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    return jnp.stack([st * cp, st * sp, ct], axis=-1)


def spherical_coordinates(d: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Unit vector → (theta, phi) with phi in [0, 2pi); matches common.cpp."""
    theta = jnp.arccos(jnp.clip(d[..., 2], -1.0, 1.0))
    phi = jnp.arctan2(d[..., 1], d[..., 0])
    phi = jnp.where(phi < 0.0, phi + 2.0 * PI, phi)
    return theta, phi
