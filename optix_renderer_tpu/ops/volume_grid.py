"""Heterogeneous media: voxel-grid sampling, delta tracking, ratio tracking.

Counterpart of the reference heterogeneous medium
(src/media/heterogmedium.cpp + NanoVDB HDDA): the sparse NanoVDB tree becomes
a dense voxel grid in device memory (SURVEY.md §5.7c: "dense/paged voxel pyramid with
DDA marching"); the world↔index ray transform (heterogmedium.cpp:105-140)
becomes an axis-aligned bbox map; and the data-dependent null-collision walks
become bounded `lax.while_loop`s over the whole ray wavefront.

Extinction model (matches the reference's *sampling* math,
heterogmedium.cpp:118-129): the effective extinction is achromatic,
μ(x) = max_c(σt_c) · densityScale · density(x), with majorant
M = max_c(σt_c) · densityScale · maxDensity; scattering stays spectral via
the albedo σs_c/max_c(σt_c) applied at real collisions. The reference's
transmittance routine initializes its accumulator to 0 and is dead code in
practice (heterogmedium.cpp:152 `Color3f transmittance = 0.f`); we implement
standard unbiased ratio tracking instead.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from optix_renderer_tpu.core import rng

MAX_TRACK_STEPS = 2048


def has_volumes(media) -> bool:
    """Static: does the scene carry any voxel grids? (shape-level check)"""
    return media.vol_density.shape[0] > 0


def density_at(media, med_id: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Scaled density ρ(x) = densityScale·trilinear(density, x); 0 outside.

    The NvdbVolume::getDensity analog (NvdbVolume.h:39-41 uses interpolation
    order 2 = triquadratic; we use trilinear — a deliberate simplification,
    differences are below typical tracking noise).
    """
    mid = jnp.maximum(med_id, 0)
    d = _trilinear_at(media, med_id, p, media.vol_corners)
    return media.density_scale[mid] * d


def temperature_at(media, med_id: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Trilinear temperature lookup (NvdbVolume::getTemperature analog)."""
    return _trilinear_at(media, med_id, p, media.vol_tcorners)


def _trilinear_at(media, med_id: jnp.ndarray, p: jnp.ndarray, corners) -> jnp.ndarray:
    """Fused trilinear lookup: ONE [N,8]-row gather from the precomputed
    corner stack (scene/data.py Media.vol_corners) + an in-lane weighted dot.

    The corner stack lives in a one-voxel zero-padded index space, so voxels
    outside the grid read exactly 0 and no per-corner bounds masks are needed
    — bit-identical to 8 masked scalar gathers (the gather is the hot op of
    every delta/ratio-tracking step; its speed against a direct eight-tap
    gather on the GPU is not measured yet).
    """
    mid = jnp.maximum(med_id, 0)
    vid = jnp.maximum(media.vol_id[mid], 0)
    bmin = media.vol_bbox_min[vid]
    bmax = media.vol_bbox_max[vid]
    dims = media.vol_dims[vid].astype(jnp.float32)  # [N,3] (D,H,W)

    # continuous index coordinates, voxel centers at i+0.5
    rel = (p - bmin) / jnp.maximum(bmax - bmin, 1e-20)
    # rel → (z,y,x) index order: dims are (D,H,W) over (z,y,x)
    f = rel[..., ::-1] * dims - 0.5
    f0 = jnp.floor(f)
    w = f - f0
    i0 = f0.astype(jnp.int32)

    D = media.vol_density.shape[1]
    H = media.vol_density.shape[2]
    W = media.vol_density.shape[3]

    # base voxel in the padded space (+1 shift); i0 ∈ [−1, dim−1] is valid
    bz = jnp.clip(i0[..., 0] + 1, 0, D)
    by = jnp.clip(i0[..., 1] + 1, 0, H)
    bx = jnp.clip(i0[..., 2] + 1, 0, W)
    flat = (bz * (H + 1) + by) * (W + 1) + bx
    c8 = corners[vid, flat]  # [N, 8] — one row gather

    wz, wy, wx = w[..., 0], w[..., 1], w[..., 2]
    w8 = jnp.stack(
        [
            (1 - wz) * (1 - wy) * (1 - wx),
            (1 - wz) * (1 - wy) * wx,
            (1 - wz) * wy * (1 - wx),
            (1 - wz) * wy * wx,
            wz * (1 - wy) * (1 - wx),
            wz * (1 - wy) * wx,
            wz * wy * (1 - wx),
            wz * wy * wx,
        ],
        axis=-1,
    )
    d = jnp.sum(c8 * w8, axis=-1)
    inside = jnp.all((p >= bmin) & (p <= bmax), axis=-1)
    return jnp.where(inside, d, 0.0)


def _bbox_clip(o, d, bmin, bmax, tmin, tmax):
    """Clip [tmin,tmax] to the volume bbox; returns (t0, t1) with t0>t1 on miss."""
    inv = 1.0 / jnp.where(jnp.abs(d) > 1e-20, d, 1e-20)
    ta = (bmin - o) * inv
    tb = (bmax - o) * inv
    near = jnp.max(jnp.minimum(ta, tb), axis=-1)
    far = jnp.min(jnp.maximum(ta, tb), axis=-1)
    return jnp.maximum(near, tmin), jnp.minimum(far, tmax)


def _majorant(media, med_id):
    """M = max_c(σt_c)·densityScale·maxDensity, floored like the reference
    (heterogmedium.cpp:81 densityMax = max(0.001, ...))."""
    mid = jnp.maximum(med_id, 0)
    st_max = jnp.max(media.sigma_a[mid] + media.sigma_s[mid], axis=-1)
    dmax = jnp.maximum(media.density_scale[mid] * media.vol_majorant[jnp.maximum(media.vol_id[mid], 0)], 1e-3)
    return st_max * dmax


def _advance(active, new, old):
    """Advance the sampler only on lanes still walking: a lane then draws
    exactly the numbers its own walk needs, so its estimate does not depend
    on how long the other lanes of its wavefront walk (the loop runs until
    the last lane is done)."""
    return jax.tree_util.tree_map(lambda a, b: jnp.where(active, a, b), new, old)


def delta_track(media, med_id, s, ro, rd, t_max):
    """Woodcock/delta tracking to the next real collision.

    Returns (sampler, t_event [N], w_score [N]) with t_event = +inf where the
    walk escapes `t_max` or the volume bbox (heterogmedium.cpp:105-130
    sampleFreePath). Lanes whose medium is not heterogeneous escape
    immediately.

    w_score is a unit-valued surrogate weight whose gradient
    is the likelihood-ratio (score-function) derivative of the free-flight
    pdf w.r.t. c = maxσt·densityScale — differential delta tracking. The walk
    itself runs detached (`lax.while_loop` has no reverse rule; the event is
    a discrete decision), and since the null/real acceptance ρ̂/ρ̂max is
    c-independent, the entire c-dependence of the sampling density is
    p ∝ M^K e^{−M·Δ} (K tentative steps at majorant rate M = c·ρ̂max over the
    traversed span Δ), giving ∂c log p = K/c − ρ̂max·Δ. Multiplying w_score
    into the event weight makes E[∂(w·f)] = ∂E[f] — gradients w.r.t. σ flow
    through heterogeneous free-flight sampling without differentiating the
    walk (M2, SURVEY §7 hard part 4).
    """
    sg = jax.lax.stop_gradient
    n = ro.shape[0]
    from optix_renderer_tpu.scene.data import MediumType

    mid_live = jnp.maximum(med_id, 0)
    st_max_live = jnp.max(media.sigma_a[mid_live] + media.sigma_s[mid_live], axis=-1)
    c_live = st_max_live * media.density_scale[mid_live]

    media = jax.tree_util.tree_map(sg, media)
    ro, rd, t_max = sg(ro), sg(rd), sg(t_max)

    mid = jnp.maximum(med_id, 0)
    is_het = (med_id >= 0) & (media.type[mid] == MediumType.HETEROG)
    vid = jnp.maximum(media.vol_id[mid], 0)
    bmin = media.vol_bbox_min[vid]
    bmax = media.vol_bbox_max[vid]
    t0, t1 = _bbox_clip(ro, rd, bmin, bmax, jnp.zeros(n), t_max)
    M = _majorant(media, med_id)
    st_max = jnp.max(media.sigma_a[mid] + media.sigma_s[mid], axis=-1)

    active0 = is_het & (t0 <= t1) & (M > 1e-12)

    def cond(state):
        _, _, active, _, _, k = state
        return jnp.any(active) & (k < MAX_TRACK_STEPS)

    def body(state):
        st, t, active, t_event, K, k = state
        st_next, u1 = rng.pcg32_next_float(st)
        st_next, u2 = rng.pcg32_next_float(st_next)
        st = _advance(active, st_next, st)
        t_new = t - jnp.log(jnp.maximum(1.0 - u1, 1e-38)) / jnp.maximum(M, 1e-20)
        escaped = t_new > t1
        p = ro + rd * t_new[..., None]
        rho = density_at(media, med_id, p)
        # real collision test: μ(x)/M = σtmax·ρ / (σtmax·ρmax_scaled)
        real = (rho * st_max / jnp.maximum(M, 1e-20)) >= u2
        hit_now = active & (~escaped) & real
        t_event = jnp.where(hit_now, t_new, t_event)
        K = jnp.where(active & (~escaped), K + 1.0, K)
        active = active & (~escaped) & (~real)
        t = jnp.where(active, t_new, t)
        return st, t, active, t_event, K, k + 1

    state = (s.state, t0, active0, jnp.full(n, jnp.inf), jnp.zeros(n), jnp.int32(0))
    st, _, _, t_event, K, _ = jax.lax.while_loop(cond, body, state)

    # score surrogate: Δ = traversed span (to the event, or to bbox exit on
    # escape); value exp(0)=1 exactly, ∂c = K/c − ρ̂max·Δ
    rho_max = _majorant(media, med_id) / jnp.maximum(
        st_max * media.density_scale[mid], 1e-20
    )  # = vol_majorant with the reference's 1e-3 scaled-density floor folded in
    span = jnp.where(jnp.isfinite(t_event), t_event, t1) - t0
    score = K / jnp.maximum(sg(c_live), 1e-20) - rho_max * span
    score = jnp.where(active0, score, 0.0)
    w_score = jnp.exp((c_live - sg(c_live)) * score)
    return s._replace(state=st), t_event, w_score


def ratio_track(media, med_id, s, o, d, dist):
    """Unbiased ratio-tracking transmittance estimate over [0, dist].

    T = Π (1 − μ(x_k)/M) along majorant-sampled tentative collisions — the
    corrected form of heterogmedium.cpp:152-173 getTransmittance. Achromatic
    (see module docstring); returned as [N,3] for interface symmetry.
    Non-heterog lanes return 1.

    Differentiability (M2): the walk runs fully detached (while_loop), and a
    naive detach would ALSO kill the σ-gradient — the ratio factor
    1 − μ(x)/M = 1 − ρ̂/ρ̂max is *independent* of c = maxσt·densityScale
    because the majorant shares the factor; all c-dependence lives in the
    detached Poisson sampling (rate M = c·ρ̂max). The unbiased fix is the
    likelihood-ratio estimator: with K tentative collisions over the clipped
    segment [t0,t1], ∂c log p = K/c − ρ̂max·(t1−t0), so the return value is

        T_diff = T · exp((c − sg(c)) · sg(K/c − ρ̂max·(t1−t0)))

    whose value is exactly T and whose expected derivative E[T·∂c log p]
    equals ∂c E[T] = −∫ρ̂ · exp(−c∫ρ̂) — differential ratio tracking.
    Gradients w.r.t. the raw voxel grid are not propagated (the grid is
    scene data, not a trainable parameter); the estimator ignores the rare
    1e-3 majorant floor (heterogmedium.cpp:81), under which the factor would
    regain c-dependence.
    """
    sg = jax.lax.stop_gradient
    n = o.shape[0]
    from optix_renderer_tpu.scene.data import MediumType

    mid = jnp.maximum(med_id, 0)
    is_het = (med_id >= 0) & (media.type[mid] == MediumType.HETEROG)
    # differentiable coupling scalar (kept live; everything in-loop detached)
    st_max_live = jnp.max(media.sigma_a[mid] + media.sigma_s[mid], axis=-1)
    c_live = st_max_live * media.density_scale[mid]

    media = jax.tree_util.tree_map(sg, media)
    o, d, dist = sg(o), sg(d), sg(dist)
    vid = jnp.maximum(media.vol_id[mid], 0)
    bmin = media.vol_bbox_min[vid]
    bmax = media.vol_bbox_max[vid]
    t0, t1 = _bbox_clip(o, d, bmin, bmax, jnp.zeros(n), dist)
    M = _majorant(media, med_id)
    st_max = jnp.max(media.sigma_a[mid] + media.sigma_s[mid], axis=-1)
    active0 = is_het & (t0 <= t1) & (M > 1e-12)

    def cond(state):
        _, _, active, _, _, k = state
        return jnp.any(active) & (k < MAX_TRACK_STEPS)

    def body(state):
        st, t, active, T, K, k = state
        st_next, u1 = rng.pcg32_next_float(st)
        st = _advance(active, st_next, st)
        t_new = t - jnp.log(jnp.maximum(1.0 - u1, 1e-38)) / jnp.maximum(M, 1e-20)
        escaped = t_new > t1
        p = o + d * t_new[..., None]
        rho = density_at(media, med_id, p)
        factor = 1.0 - rho * st_max / jnp.maximum(M, 1e-20)
        inside = active & (~escaped)
        T = jnp.where(inside, T * jnp.maximum(factor, 0.0), T)
        K = jnp.where(inside, K + 1.0, K)
        active = inside & (T > 1e-6)
        t = jnp.where(active, t_new, t)
        return st, t, active, T, K, k + 1

    state = (s.state, t0, active0, jnp.ones(n), jnp.zeros(n), jnp.int32(0))
    st, _, _, T, K, _ = jax.lax.while_loop(cond, body, state)

    rho_max = _majorant(media, med_id) / jnp.maximum(
        st_max * media.density_scale[mid], 1e-20
    )
    score = K / jnp.maximum(sg(c_live), 1e-20) - rho_max * jnp.maximum(t1 - t0, 0.0)
    score = jnp.where(active0, score, 0.0)
    T = T * jnp.exp((c_live - sg(c_live)) * score)
    T = jnp.where(is_het, T, 1.0)
    return s._replace(state=st), T[..., None] * jnp.ones((n, 3))
