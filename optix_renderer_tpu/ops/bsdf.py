"""BSDF kernel: sample/eval/pdf over the tagged-union material table.

Batched, branch-free counterpart of the reference BSDF plugins
(src/bsdf/{diffuse,mirror,dielectric,microfacet,disney}.cpp, interface
bsdf.h:82-110). All directions are in the local shading frame (+z = normal);
per-lane material ids select between types via `jnp.where` — every type's
arithmetic runs for every lane, so the wavefront never diverges.

Measure semantics match the reference exactly: smooth lobes are ESolidAngle,
specular lobes are EDiscrete (eval/pdf ≡ 0, sample returns the full weight) —
path-MIS relies on this (path_mis.cpp:135-140).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from optix_renderer_tpu.core import warp
from optix_renderer_tpu.core.math import (
    INV_PI,
    PI,
    fresnel_dielectric,
    reflect_local,
    safe_normalize,
    safe_sqrt,
)
from optix_renderer_tpu.ops.texture import eval_texture
from optix_renderer_tpu.scene.data import Bsdfs, BsdfType, Textures


class BsdfSample(NamedTuple):
    wo: jnp.ndarray  # [N,3] sampled outgoing direction (local frame)
    weight: jnp.ndarray  # [N,3] f/pdf·cos (or discrete weight)
    pdf: jnp.ndarray  # [N] solid-angle pdf (0 for discrete)
    is_discrete: jnp.ndarray  # [N] bool (EDiscrete measure)
    eta: jnp.ndarray  # [N] relative IOR of the sampled event


def _cos(v):
    return v[..., 2]


# ---------------------------------------------------------------------------
# per-type eval / pdf
# ---------------------------------------------------------------------------


def _beckmann_d(m, alpha):
    """Beckmann NDF (microfacet.cpp:60-67).

    Written as exp(·)·(1/ct²)² / (πα²) instead of exp(·)/(πα²ct⁴): the latter's
    VJP squares the denominator, which underflows float32 for grazing ct and
    turns the gradient into 0/0 = NaN.
    """
    ct = jnp.maximum(_cos(m), 1e-4)
    inv_ct2 = 1.0 / (ct * ct)
    tan2 = jnp.maximum(0.0, 1.0 - ct * ct) * inv_ct2
    return (
        jnp.exp(-tan2 / (alpha * alpha)) * inv_ct2 * inv_ct2 / (PI * alpha * alpha)
    )


def _smith_g1(v, m, alpha):
    """Smith shadowing-masking G1, rational approx (microfacet.cpp:70-90)."""
    ct = _cos(v)
    tan_theta = safe_sqrt(1.0 - ct * ct) / jnp.where(
        jnp.abs(ct) > 1e-8, ct, 1e-8
    )
    a = 1.0 / jnp.maximum(alpha * jnp.abs(tan_theta), 1e-8)
    a2 = a * a
    approx = (3.535 * a + 2.181 * a2) / (1.0 + 2.276 * a + 2.577 * a2)
    g = jnp.where(a >= 1.6, 1.0, approx)
    g = jnp.where(jnp.abs(tan_theta) < 1e-8, 1.0, g)
    back = jnp.sum(m * v, axis=-1) * ct <= 0.0
    return jnp.where(back, 0.0, g)


def _microfacet_eval(kd, ks, alpha, ext_ior, int_ior, wi, wo):
    """kd/π + ks·D·F·G1G1 / (4 cosθi cosθo) (microfacet.cpp:93-106)."""
    wh = safe_normalize(wi + wo)
    d = _beckmann_d(wh, alpha)
    f = fresnel_dielectric(jnp.sum(wh * wi, axis=-1), ext_ior, int_ior)
    g = _smith_g1(wi, wh, alpha) * _smith_g1(wo, wh, alpha)
    denom = 4.0 * _cos(wi) * _cos(wo)
    spec = ks * d * f * g / jnp.where(jnp.abs(denom) > 1e-12, denom, 1e-12)
    val = kd * INV_PI + spec[..., None]
    return jnp.where((_cos(wo) > 0.0)[..., None], val, 0.0)


def _microfacet_pdf(ks, alpha, wi, wo):
    """ks·D(wh)·cosθh/(4 wo·wh) + (1-ks)·cosθo/π (microfacet.cpp:109-120)."""
    wh = safe_normalize(wi + wo)
    d = _beckmann_d(wh, alpha)
    dot_wo_wh = jnp.sum(wo * wh, axis=-1)
    part1 = ks * d * _cos(wh) / jnp.where(jnp.abs(4.0 * dot_wo_wh) > 1e-12, 4.0 * dot_wo_wh, 1e-12)
    part2 = (1.0 - ks) * _cos(wo) * INV_PI
    return jnp.where(_cos(wo) > 0.0, part1 + part2, 0.0)


def eval_bsdf(
    bsdfs: Bsdfs,
    textures: Textures,
    bsdf_id: jnp.ndarray,
    wi: jnp.ndarray,
    wo: jnp.ndarray,
    uv: jnp.ndarray,
) -> jnp.ndarray:
    """f(wi, wo) under the solid-angle measure; discrete types → 0."""
    bid = jnp.maximum(bsdf_id, 0)
    btype = bsdfs.type[bid]
    albedo = eval_texture(textures, bsdfs.albedo_tex[bid], uv)

    # diffuse (diffuse.cpp:95-103)
    diff_ok = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    f_diffuse = jnp.where(diff_ok[..., None], albedo * INV_PI, 0.0)

    f_micro = _microfacet_eval(
        bsdfs.kd[bid], bsdfs.ks[bid], bsdfs.alpha[bid],
        bsdfs.ext_ior[bid], bsdfs.int_ior[bid], wi, wo,
    )

    out = jnp.where(
        (btype == BsdfType.DIFFUSE)[..., None],
        f_diffuse,
        jnp.where(
            (btype == BsdfType.MICROFACET)[..., None],
            f_micro,
            jnp.where(
                (btype == BsdfType.DISNEY)[..., None],
                _disney_eval(bsdfs, bid, albedo, wi, wo),
                0.0,  # mirror / dielectric: discrete
            ),
        ),
    )
    return out


def pdf_bsdf(
    bsdfs: Bsdfs,
    textures: Textures,
    bsdf_id: jnp.ndarray,
    wi: jnp.ndarray,
    wo: jnp.ndarray,
    uv: jnp.ndarray,
) -> jnp.ndarray:
    bid = jnp.maximum(bsdf_id, 0)
    btype = bsdfs.type[bid]

    diff_ok = (_cos(wi) > 0.0) & (_cos(wo) > 0.0)
    p_diffuse = jnp.where(diff_ok, INV_PI * _cos(wo), 0.0)
    p_micro = _microfacet_pdf(bsdfs.ks[bid], bsdfs.alpha[bid], wi, wo)

    return jnp.where(
        btype == BsdfType.DIFFUSE,
        p_diffuse,
        jnp.where(
            btype == BsdfType.MICROFACET,
            p_micro,
            jnp.where(btype == BsdfType.DISNEY, _disney_pdf(bsdfs, bid, wi, wo), 0.0),
        ),
    )


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def sample_bsdf(
    bsdfs: Bsdfs,
    textures: Textures,
    bsdf_id: jnp.ndarray,
    wi: jnp.ndarray,
    uv: jnp.ndarray,
    u2: jnp.ndarray,
) -> BsdfSample:
    """Importance-sample the BSDF; u2 `[N,2]` uniforms.

    Per-type weights match the reference `sample()` return values:
    diffuse → albedo (diffuse.cpp), mirror → 1 (mirror.cpp:42-57),
    dielectric → 1 or 1/η² (dielectric.cpp:52-102),
    microfacet → eval/pdf·cos (microfacet.cpp:123-160).
    """
    bid = jnp.maximum(bsdf_id, 0)
    btype = bsdfs.type[bid]
    albedo = eval_texture(textures, bsdfs.albedo_tex[bid], uv)
    n = wi.shape[0]
    cos_i = _cos(wi)

    # ---- diffuse branch
    wo_diff = warp.square_to_cosine_hemisphere(u2)
    w_diff = jnp.where((cos_i > 0.0)[..., None], albedo, 0.0)

    # ---- mirror branch
    wo_mirror = reflect_local(wi)
    w_mirror = jnp.where((cos_i > 0.0)[..., None], jnp.ones((n, 3)), 0.0)

    # ---- dielectric branch (dielectric.cpp:52-102)
    int_ior = bsdfs.int_ior[bid]
    ext_ior = bsdfs.ext_ior[bid]
    fr = fresnel_dielectric(cos_i, ext_ior, int_ior)
    reflect_event = u2[..., 0] < fr
    # refraction: local-frame Snell (normal = ±z)
    entering = cos_i >= 0.0
    eta_ratio = jnp.where(entering, ext_ior / int_ior, int_ior / ext_ior)
    nz = jnp.where(entering, 1.0, -1.0)
    wi_dot_n = wi[..., 2] * nz
    # wt = -η (wi - (wi·n)n) - sqrt(1-η²(1-(wi·n)²)) n
    sqrt_term = safe_sqrt(
        1.0 - eta_ratio * eta_ratio * (1.0 - wi_dot_n * wi_dot_n)
    )
    tang = wi - jnp.stack(
        [jnp.zeros_like(nz), jnp.zeros_like(nz), wi_dot_n * nz], axis=-1
    )
    wo_refr = -eta_ratio[..., None] * tang - (sqrt_term * nz)[..., None] * jnp.stack(
        [jnp.zeros_like(nz), jnp.zeros_like(nz), jnp.ones_like(nz)], axis=-1
    )
    wo_diel = jnp.where(reflect_event[..., None], reflect_local(wi), wo_refr)
    w_refr = (1.0 / (eta_ratio * eta_ratio))[..., None] * jnp.ones((n, 3))
    w_diel = jnp.where(reflect_event[..., None], jnp.ones((n, 3)), w_refr)
    eta_diel = jnp.where(reflect_event, 1.0, eta_ratio)

    # ---- microfacet branch (microfacet.cpp:123-160)
    ks = bsdfs.ks[bid]
    alpha = bsdfs.alpha[bid]
    spec_event = u2[..., 1] < ks
    u_spec = jnp.stack([u2[..., 0], u2[..., 1] / jnp.maximum(ks, 1e-8)], axis=-1)
    u_diff = jnp.stack(
        [u2[..., 0], (u2[..., 1] - ks) / jnp.maximum(1.0 - ks, 1e-8)], axis=-1
    )
    wh = warp.square_to_beckmann(u_spec, alpha)
    wo_spec = 2.0 * jnp.sum(wi * wh, axis=-1, keepdims=True) * wh - wi
    wo_mf = jnp.where(
        spec_event[..., None], wo_spec, warp.square_to_cosine_hemisphere(u_diff)
    )
    f_mf = _microfacet_eval(
        bsdfs.kd[bid], ks, alpha, ext_ior, int_ior, wi, wo_mf
    )
    p_mf = _microfacet_pdf(ks, alpha, wi, wo_mf)
    w_mf = f_mf * (_cos(wo_mf) / jnp.maximum(p_mf, 1e-12))[..., None]
    w_mf = jnp.where(
        ((_cos(wo_mf) > 0.0) & (cos_i >= 0.0) & (p_mf > 1e-12))[..., None], w_mf, 0.0
    )

    # ---- disney branch
    wo_dis, w_dis, p_dis = _disney_sample(bsdfs, bid, albedo, wi, u2)

    is_mirror = btype == BsdfType.MIRROR
    is_diel = btype == BsdfType.DIELECTRIC
    is_micro = btype == BsdfType.MICROFACET
    is_disney = btype == BsdfType.DISNEY

    wo = jnp.where(
        is_mirror[..., None],
        wo_mirror,
        jnp.where(
            is_diel[..., None],
            wo_diel,
            jnp.where(
                is_micro[..., None],
                wo_mf,
                jnp.where(is_disney[..., None], wo_dis, wo_diff),
            ),
        ),
    )
    weight = jnp.where(
        is_mirror[..., None],
        w_mirror,
        jnp.where(
            is_diel[..., None],
            w_diel,
            jnp.where(
                is_micro[..., None],
                w_mf,
                jnp.where(is_disney[..., None], w_dis, w_diff),
            ),
        ),
    )
    is_discrete = is_mirror | is_diel
    eta = jnp.where(is_diel, eta_diel, 1.0)

    pdf_cont = jnp.where(
        is_micro,
        p_mf,
        jnp.where(
            is_disney,
            p_dis,
            jnp.where(
                (btype == BsdfType.DIFFUSE) & (cos_i > 0.0),
                INV_PI * jnp.maximum(_cos(wo), 0.0),
                0.0,
            ),
        ),
    )
    pdf = jnp.where(is_discrete, 0.0, pdf_cont)

    return BsdfSample(wo=wo, weight=weight, pdf=pdf, is_discrete=is_discrete, eta=eta)


# ---------------------------------------------------------------------------
# Disney principled BRDF (disney.cpp:32-332) — implemented in ops/disney.py
# ---------------------------------------------------------------------------


def _disney_eval(bsdfs, bid, albedo, wi, wo):
    from optix_renderer_tpu.ops.disney import disney_eval

    return disney_eval(bsdfs.disney[bid], albedo, wi, wo)


def _disney_pdf(bsdfs, bid, wi, wo):
    from optix_renderer_tpu.ops.disney import disney_pdf

    return disney_pdf(bsdfs.disney[bid], wi, wo)


def _disney_sample(bsdfs, bid, albedo, wi, u2):
    from optix_renderer_tpu.ops.disney import disney_sample

    return disney_sample(bsdfs.disney[bid], albedo, wi, u2)
