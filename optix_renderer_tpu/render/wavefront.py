"""Wavefront path regeneration: a persistent lane pool with between-bounce
compaction-by-refill.

Replacement of the per-thread early-out in the reference's GPU
megakernel (include/nori/optix/cuda/raygen.cpp:102-131: `prd.terminated`
breaks the per-thread path loop) and the SURVEY §7 Phase-2e wavefront
compaction step. The scan-based integrators (integrators/path.py) advance
ALL lanes through all `max_depth` bounces with masking — in a Cornell box
most lanes are dead after ~3 bounces (measured: mean path length ≈ 3 of 16),
so ~80% of trace+shade work is masked waste.

Here the wavefront never shrinks and never idles: a fixed pool of N lanes
each carries one *live* path; when a path terminates (miss, Russian
roulette, zero throughput, max depth) its radiance is splatted into the
film and the lane is immediately re-seeded with the next (pixel, sample)
work item from a global counter. Work items are pixel-major, so refill
batches are contiguous pixel runs — coherent camera rays for the traversal.

Per-path arithmetic is IDENTICAL to the scan integrators: the same sampler
stream per (pixel, sample) work item, the same draw order, the same bounce
body — only the lane↔path assignment differs, and film accumulation
commutes. `tests/test_wavefront.py` asserts scan ≡ wavefront films.

Checkpoint/resume and the adaptive sampler keep the scan path (a wavefront
snapshot mid-flight would lose in-flight paths); `render.render` dispatches.
"""

from __future__ import annotations

import time
from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from optix_renderer_tpu.core.math import EPSILON, Ray, normalize
from optix_renderer_tpu.integrators import common
from optix_renderer_tpu.ops import bsdf as bsdf_ops
from optix_renderer_tpu.ops import camera as camera_ops
from optix_renderer_tpu.ops import emitter as emitter_ops
from optix_renderer_tpu.render import film
from optix_renderer_tpu.render import sampler as smp
from optix_renderer_tpu.scene.data import RenderConfig, SceneData

# integrators with a wavefront bounce body (the scan versions stay the
# reference semantics; volumetric integrators keep the scan path)
WAVEFRONT_INTEGRATORS = ("path_mats", "path_mis")


class PathState(NamedTuple):
    """Per-lane live-path state (+ the scalar work counter).

    The wavefront analog of the reference's per-thread `RadiancePrd`
    (cuda/RadiancePrd.h: Li/throughput/albedo/normal/origin/direction/seed/
    terminated) plus the MIS carry of integrators/path.py li_path_mis.
    """

    active: jnp.ndarray  # [N] bool — lane holds a live path
    bounce: jnp.ndarray  # [N] int32 — bounces completed so far
    pos: jnp.ndarray  # [N,2] film splat position (pixel + jitter)
    ro: jnp.ndarray  # [N,3]
    rd: jnp.ndarray  # [N,3]
    cam_mint: jnp.ndarray  # [N] first-segment near clip
    cam_maxt: jnp.ndarray  # [N] first-segment far clip
    tput: jnp.ndarray  # [N,3]
    L: jnp.ndarray  # [N,3]
    albedo: jnp.ndarray  # [N,3]
    normal: jnp.ndarray  # [N,3]
    pdf_mats_prev: jnp.ndarray  # [N]
    prev_discrete: jnp.ndarray  # [N] bool
    w_mats_prev: jnp.ndarray  # [N]
    sampler: smp.Sampler
    next_work: jnp.ndarray  # [] int32 global work counter


def init_state(n: int, seed: int = 0) -> PathState:
    z = jnp.zeros
    return PathState(
        active=z(n, bool),
        bounce=z(n, jnp.int32),
        pos=z((n, 2), jnp.float32),
        ro=z((n, 3), jnp.float32),
        rd=z((n, 3), jnp.float32),
        cam_mint=z(n, jnp.float32),
        cam_maxt=z(n, jnp.float32),
        tput=jnp.ones((n, 3), jnp.float32),
        L=z((n, 3), jnp.float32),
        albedo=z((n, 3), jnp.float32),
        normal=z((n, 3), jnp.float32),
        pdf_mats_prev=z(n, jnp.float32),
        prev_discrete=z(n, bool),
        w_mats_prev=jnp.ones(n, jnp.float32),
        sampler=smp.make_sampler(jnp.zeros(n, jnp.uint32), jnp.zeros(n, jnp.uint32), seed),
        next_work=jnp.int32(0),
    )


def _where(mask, a, b):
    m = mask[..., None] if a.ndim == b.ndim == 2 else mask
    return jnp.where(m, a, b)


def _refill(
    state: PathState, scene: SceneData, config: RenderConfig, total_work: jnp.ndarray
) -> PathState:
    """Assign the next work items to free lanes and spawn camera rays.

    Work item w → pixel w % n_pix, sample round w // n_pix (pixel-major:
    a refill batch is a contiguous pixel run — coherent primary rays). The
    sampler stream per work item is exactly `render._round_layers`'s:
    make_sampler(pixel, sample) then jitter (2D) + aperture (2D) draws.
    """
    n = state.active.shape[0]
    n_pix = config.width * config.height
    free = ~state.active
    rank = jnp.cumsum(free.astype(jnp.int32)) - 1
    w_id = state.next_work + rank
    spawn = free & (w_id < total_work)

    pix = jnp.where(spawn, w_id % n_pix, 0)
    sample_idx = jnp.where(spawn, w_id // n_pix, 0)
    s = smp.make_sampler(pix.astype(jnp.uint32), sample_idx.astype(jnp.uint32),
                         seed=config.seed)
    s, jitter = smp.next_2d(s)
    s, aperture = smp.next_2d(s)
    px = (pix % config.width).astype(jnp.float32)
    py = (pix // config.width).astype(jnp.float32)
    pos = jnp.stack([px, py], axis=-1) + jitter
    ray, _w = camera_ops.sample_ray(
        scene.camera, config.width, config.height, pos, aperture
    )

    sp3 = spawn[:, None]
    z3 = jnp.zeros((n, 3), jnp.float32)
    merged_sampler = jax.tree_util.tree_map(
        lambda new, old: jnp.where(spawn, new, old), s, state.sampler
    )
    return PathState(
        active=state.active | spawn,
        bounce=jnp.where(spawn, 0, state.bounce),
        pos=jnp.where(sp3[:, :1] * jnp.ones((1, 2), bool), pos, state.pos),
        ro=jnp.where(sp3, ray.o, state.ro),
        rd=jnp.where(sp3, ray.d, state.rd),
        cam_mint=jnp.where(spawn, ray.mint, state.cam_mint),
        cam_maxt=jnp.where(spawn, ray.maxt, state.cam_maxt),
        tput=jnp.where(sp3, 1.0, state.tput),
        L=jnp.where(sp3, 0.0, state.L),
        albedo=jnp.where(sp3, 0.0, state.albedo),
        normal=jnp.where(sp3, 0.0, state.normal),
        pdf_mats_prev=jnp.where(spawn, 0.0, state.pdf_mats_prev),
        prev_discrete=jnp.where(spawn, False, state.prev_discrete),
        w_mats_prev=jnp.where(spawn, 1.0, state.w_mats_prev),
        sampler=merged_sampler,
        next_work=jnp.minimum(
            state.next_work + jnp.sum(free.astype(jnp.int32)),
            total_work + jnp.int32(n),
        ),
    )


def _bounce(state: PathState, scene: SceneData, config: RenderConfig) -> PathState:
    """One bounce for every lane — the li_path_mats / li_path_mis scan body
    (integrators/path.py) with the per-lane `bounce` counter replacing the
    scan index. Draw order per path is identical, so per-path radiance is
    bit-equal to the scan integrators."""
    mis = config.integrator == "path_mis"
    n = state.active.shape[0]
    n_lights = max(config.n_emitters, 1)
    active = state.active
    first = state.bounce == 0
    ro, rd, t, L, s = state.ro, state.rd, state.tput, state.L, state.sampler
    albedo, normal = state.albedo, state.normal

    r = Ray(
        o=ro,
        d=rd,
        mint=jnp.where(first, state.cam_mint, jnp.full(n, EPSILON)),
        maxt=jnp.where(first, state.cam_maxt, jnp.full(n, jnp.inf)),
    )
    ctx = common.trace(scene, r)

    if mis:
        # miss → envmap, MIS-weighted (li_path_mis deviation note applies)
        pdf_env_dir = emitter_ops.pdf_envmap_direction(scene, rd) / float(n_lights)
        denom_env = state.pdf_mats_prev + pdf_env_dir
        w_env = jnp.where(
            first | state.prev_discrete,
            1.0,
            jnp.where(
                denom_env > EPSILON,
                state.pdf_mats_prev / jnp.maximum(denom_env, 1e-20),
                1.0,
            ),
        )
        env = common.miss_envmap(scene, rd, active & (~ctx.its.valid))
        L = L + w_env[..., None] * t * env
    else:
        env = common.miss_envmap(scene, rd, active & (~ctx.its.valid))
        L = L + t * env
    active = active & ctx.its.valid

    a0, n0 = common.first_hit_aovs(scene, ctx)
    albedo = jnp.where(first[..., None], a0, albedo)
    normal = jnp.where(first[..., None], n0, normal)

    if mis:
        hit_em = active & (ctx.emitter_id >= 0)
        pdf_ems_here = emitter_ops.pdf_hit_emitter(
            scene, ctx.emitter_id, ro, ctx.its.p, ctx.frame.n, normalize(rd)
        ) / float(n_lights)
        denom = state.pdf_mats_prev + pdf_ems_here
        w_mats = jnp.where(
            first | state.prev_discrete,
            1.0,
            jnp.where(
                denom > EPSILON,
                state.pdf_mats_prev / jnp.maximum(denom, 1e-20),
                state.w_mats_prev,
            ),
        )
        L = L + jnp.where(
            hit_em[..., None],
            w_mats[..., None] * t * common.hit_emitter_radiance(scene, ctx, rd),
            0.0,
        )
        # Russian roulette from the first vertex (path_mis.cpp:58-71)
        s, u_rr = smp.next_1d(s)
        succ = jnp.clip(jnp.max(t, axis=-1), EPSILON, 0.99)
        die = (u_rr > succ) & active
        t = jnp.where(active[..., None], t / succ[..., None], t)
        active = active & (~die)

        # EMS (path_mis.cpp:74-106)
        wo_local = common.to_local(ctx, -normalize(rd))
        s, u_pick = smp.next_1d(s)
        em_id = common.pick_emitter(scene, u_pick)
        s, u_ems = smp.next_3d(s)
        ems_contrib, pdf_ems, pdf_mat_at_ems, _ = common.nee(
            scene, ctx, wo_local, em_id, u_ems, n_lights=n_lights, abs_cos=False
        )
        w_ems = jnp.where(
            pdf_ems + pdf_mat_at_ems > EPSILON,
            pdf_ems / jnp.maximum(pdf_ems + pdf_mat_at_ems, 1e-20),
            0.0,
        )
        # MATS (path_mis.cpp:108-133)
        s, u_mats = smp.next_2d(s)
        bs = bsdf_ops.sample_bsdf(
            scene.bsdfs, scene.textures, ctx.bsdf_id, wo_local, ctx.its.uv, u2=u_mats
        )
        w_ems = jnp.where(bs.is_discrete, 0.0, w_ems)
        L = L + jnp.where(active[..., None], w_ems[..., None] * t * ems_contrib, 0.0)
        pdf_mats_new = bs.pdf
        prev_discrete_new = bs.is_discrete
        w_mats_new = w_mats
    else:
        hit = ctx.its.valid & state.active
        L = L + jnp.where(
            hit[..., None], t * common.hit_emitter_radiance(scene, ctx, rd), 0.0
        )
        # RR after 3 bounces (path_mats.cpp:47-58)
        s, u_rr = smp.next_1d(s)
        succ = jnp.minimum(jnp.max(t, axis=-1), 0.99)
        rr_on = state.bounce >= 3
        die = rr_on & (u_rr > succ) & active
        t = jnp.where(
            (rr_on & active)[..., None], t / jnp.maximum(succ, 1e-12)[..., None], t
        )
        active = active & (~die)

        wo_local = common.to_local(ctx, -normalize(rd))
        s, u2 = smp.next_2d(s)
        bs = bsdf_ops.sample_bsdf(
            scene.bsdfs, scene.textures, ctx.bsdf_id, wo_local, ctx.its.uv, u2
        )
        pdf_mats_new = state.pdf_mats_prev
        prev_discrete_new = state.prev_discrete
        w_mats_new = state.w_mats_prev

    t = jnp.where(active[..., None], t * bs.weight, t)
    active = active & jnp.any(jnp.abs(t) > 1e-12, axis=-1)
    # max-depth cutoff: the scan just stops running bodies; here the lane
    # terminates and is recycled
    active = active & (state.bounce + 1 < config.max_depth)

    ro = jnp.where(active[..., None], ctx.its.p, ro)
    rd = jnp.where(active[..., None], common.to_world(ctx, bs.wo), rd)
    return state._replace(
        active=active,
        bounce=state.bounce + 1,
        ro=ro,
        rd=rd,
        tput=t,
        L=L,
        albedo=albedo,
        normal=normal,
        pdf_mats_prev=pdf_mats_new,
        prev_discrete=prev_discrete_new,
        w_mats_prev=w_mats_new,
        sampler=s,
    )


@partial(jax.jit, static_argnames=("config",), donate_argnums=(0, 1))
def wavefront_iter(
    acc: jnp.ndarray,  # [3,H,W,4] donated film accumulator
    state: PathState,  # donated
    scene: SceneData,
    config: RenderConfig,
    total_work: jnp.ndarray,  # [] int32 = n_pix * spp
):
    """refill → bounce → splat-terminated. Returns (acc, state, n_active)."""
    state = _refill(state, scene, config, total_work)
    was_active = state.active
    state = _bounce(state, scene, config)
    term = was_active & (~state.active)

    L = jnp.nan_to_num(state.L, nan=0.0, posinf=0.0, neginf=0.0)
    layers = jnp.stack([L, state.albedo, state.normal])
    acc = acc + film.splat(
        config.width, config.height, config.rfilter, state.pos, layers, mask=term
    )
    n_active = jnp.sum(state.active.astype(jnp.int32))
    return acc, state, n_active


def render_wavefront(
    scene: SceneData,
    config: RenderConfig,
    sample_count: int | None = None,
    n_lanes: int = 1 << 19,
    verbose: bool = False,
    preview_every_iters: int = 0,
    preview_callback=None,
    acc: jnp.ndarray | None = None,
    sync_every: int = 8,
) -> dict[str, np.ndarray]:
    """Full regeneration render. Same output contract as render.render().

    `sync_every` bounds host↔device round-trips: the (work counter, active
    count) pair is fetched once per `sync_every` iterations.
    """
    from optix_renderer_tpu.render.render import _layers_out, preprocess

    assert config.integrator in WAVEFRONT_INTEGRATORS, config.integrator
    scene = preprocess(scene, config)
    spp = sample_count if sample_count is not None else config.sample_count
    n_pix = config.width * config.height
    total = n_pix * spp
    assert total < 2**31, "work counter is int32"
    n = min(n_lanes, total)
    total_work = jnp.int32(total)

    if acc is None:
        acc = jnp.zeros((3, config.height, config.width, 4), jnp.float32)
    state = init_state(n, seed=config.seed)

    # hard bound: every refill round retires ≥1 work item per lane within
    # max_depth iterations
    max_iters = (total // n + 2) * config.max_depth + config.max_depth + 4
    t0 = time.time()
    it = 0
    while it < max_iters:
        for _ in range(sync_every):
            acc, state, n_active = wavefront_iter(acc, state, scene, config, total_work)
            it += 1
        done_work = int(state.next_work) >= total
        na = int(n_active)
        if verbose:
            spp_eq = min(int(state.next_work), total) / n_pix
            print(
                f"  wavefront iter {it}: ~{spp_eq:.1f}/{spp} spp issued, "
                f"{na} lanes live ({time.time() - t0:.1f}s)"
            )
        if preview_every_iters and preview_callback and it % preview_every_iters < sync_every:
            preview_callback(_layers_out(acc), min(int(state.next_work), total) // n_pix)
        if done_work and na == 0:
            break

    out = _layers_out(acc)
    # honest progress: if the max_iters safety bound tripped with work still
    # queued, report the spp actually completed rather than the request
    issued = min(int(state.next_work), total)
    out["spp_done"] = spp if (done_work and na == 0) else issued // n_pix
    return out
