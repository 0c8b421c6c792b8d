"""Multi-device execution: shard_map over a (tile × sample) device mesh.

The replacement for the reference's parallelism stack (SURVEY.md §2.8): TBB
tile parallel_for (render.cpp:288-347) → lane sharding over the "tile" mesh
axis; the CPU/GPU cooperative sample split (render.cpp:281,501) → the
"sample" mesh axis; mutex-guarded ImageBlock merges (block.cpp:125) → `psum`
of partial film planes, which XLA lowers to an all-reduce between the cards.
Scene tables are replicated (they are read-only per round); the film
reduction is the only collective. The cards of one host are joined all to
all, so the mesh follows the algorithm alone.

Determinism under any mesh shape: each lane's sampler is seeded by
(pixel_id, global_sample_idx) only (render/sampler.py), so device count and
layout never change the image — the property the reference gets from
per-block seeding (independent.cpp:21-60).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from optix_renderer_tpu.integrators import get_integrator
from optix_renderer_tpu.ops import camera as camera_ops
from optix_renderer_tpu.render import film
from optix_renderer_tpu.render import sampler as smp
from optix_renderer_tpu.scene.data import RenderConfig, SceneData


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Build a (tile, sample) mesh over the available devices.

    Factors the device count into the most square (tile, sample) grid with
    tile ≥ sample — tile parallelism is the dominant axis, like the
    reference's tile loop dominating its sample loop.
    """
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    n = len(devices)
    sample = 1
    for cand in range(int(np.sqrt(n)), 0, -1):
        if n % cand == 0:
            sample = cand
            break
    tile = n // sample
    dev_grid = np.asarray(devices).reshape(tile, sample)
    return Mesh(dev_grid, axis_names=("tile", "sample"))


def _lane_render(scene: SceneData, config: RenderConfig, pixel_ids, sample_idx):
    """Per-device shard body: render lanes, splat into a full-size film."""
    px = (pixel_ids % config.width).astype(jnp.float32)
    py = (pixel_ids // config.width).astype(jnp.float32)
    s = smp.make_sampler(
        pixel_ids.astype(jnp.uint32), sample_idx.astype(jnp.uint32), seed=config.seed
    )
    s, jitter = smp.next_2d(s)
    s, aperture = smp.next_2d(s)
    pos = jnp.stack([px, py], axis=-1) + jitter
    ray, _ = camera_ops.sample_ray(scene.camera, config.width, config.height, pos, aperture)
    L, albedo, normal, s = get_integrator(config.integrator)(scene, config, ray, s)
    L = jnp.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
    layers = jnp.stack([L, albedo, normal])
    return film.splat(config.width, config.height, config.rfilter, pos, layers)


def sharded_render_round(
    scene: SceneData,
    config: RenderConfig,
    mesh: Mesh,
    pixel_ids: jnp.ndarray,  # [N] — sharded over "tile"
    sample_base: jnp.ndarray,  # [] int32 — first sample round of this launch
):
    """One launch = (tile × sample) devices each render their lane/sample slice;
    partial films psum over both axes → replicated [3,H,W,4]."""

    def body(scene_rep, pix, sbase):
        si = jax.lax.axis_index("sample")
        img = _lane_render(scene_rep, config, pix, sbase + si.astype(jnp.int32))
        img = jax.lax.psum(img, ("tile", "sample"))
        return img

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P("tile"), P()),
        out_specs=P(),
        check_vma=False,
    )
    return fn(scene, pixel_ids, sample_base)


@partial(jax.jit, static_argnames=("config", "mesh"))
def _sharded_round_jit(scene, config, mesh, pixel_ids, sample_base):
    return sharded_render_round(scene, config, mesh, pixel_ids, sample_base)


@partial(jax.jit, static_argnames=("config", "mesh"), donate_argnums=(0,))
def _sharded_round_acc_jit(acc, scene, config, mesh, pixel_ids, sample_base):
    # fused accumulate (see render.py render_round_accumulate)
    return acc + sharded_render_round(scene, config, mesh, pixel_ids, sample_base)


def render_sharded(
    scene: SceneData,
    config: RenderConfig,
    mesh: Mesh | None = None,
    sample_count: int | None = None,
    verbose: bool = False,
    preview_every: int = 0,
    preview_callback=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    resume: bool = False,
) -> dict[str, np.ndarray]:
    """Full multi-device render (the distributed renderThreadMain analog).

    Carries the same orchestration contract as the single-device loop
    (render/render.py): progressive preview, accumulator checkpoints with
    resume, and a SIGINT-safe partial film. One "round" here covers
    `n_sample_dev` samples (the sample mesh axis renders them concurrently),
    so spp counters advance in that stride.
    """
    import os

    from optix_renderer_tpu.render.render import (
        _layers_out,
        _norm_ckpt_path,
        load_checkpoint,
        preprocess,
        save_checkpoint,
    )

    scene = preprocess(scene, config)
    if mesh is None:
        mesh = make_mesh()
    spp = sample_count if sample_count is not None else config.sample_count

    n_sample_dev = mesh.devices.shape[1]
    n_rounds = max(1, (spp + n_sample_dev - 1) // n_sample_dev)

    n_pix = config.width * config.height
    n_tile = mesh.devices.shape[0]
    pad = (-n_pix) % n_tile
    ids = np.concatenate(
        [np.arange(n_pix, dtype=np.int32), np.full(pad, -(1 << 20), np.int32)]
    )
    ids = jnp.asarray(ids)

    acc = jnp.zeros((3, config.height, config.width, 4), jnp.float32)
    start_round = 0
    if resume and checkpoint_path and os.path.exists(_norm_ckpt_path(checkpoint_path)):
        acc, spp_resumed = load_checkpoint(checkpoint_path, config)
        if spp_resumed % n_sample_dev != 0:
            # flooring would deterministically re-render (and double-weight)
            # samples the checkpoint already contains (advisor round-3
            # finding): a single-device checkpoint resumed with --sharded, or
            # a different device count, must be rejected, not corrupted
            raise ValueError(
                f"checkpoint holds {spp_resumed} samples, which is not a "
                f"multiple of this mesh's sample axis ({n_sample_dev}) — "
                "resume with the original device layout or finish the render "
                "single-device"
            )
        start_round = spp_resumed // n_sample_dev
        if verbose:
            print(f"  resumed at sample {spp_resumed} from {checkpoint_path}")

    spp_done = start_round * n_sample_dev
    try:
        for r in range(start_round, n_rounds):
            acc = _sharded_round_acc_jit(
                acc, scene, config, mesh, ids, jnp.int32(r * n_sample_dev)
            )
            spp_done = (r + 1) * n_sample_dev
            done_rounds = r + 1
            if verbose:
                acc.block_until_ready()
                print(f"  sample {spp_done}/{n_rounds * n_sample_dev}")
            if preview_every and preview_callback and done_rounds % preview_every == 0:
                preview_callback(_layers_out(acc), spp_done)
            if checkpoint_path and checkpoint_every and done_rounds % checkpoint_every == 0:
                save_checkpoint(checkpoint_path, acc, spp_done, config)
    except KeyboardInterrupt:
        # acc always sits on a round boundary here (the add is one dispatch),
        # so the partial film is valid and resumable
        acc.block_until_ready()
        if checkpoint_path:
            save_checkpoint(checkpoint_path, acc, spp_done, config)
        if verbose:
            print(f"  interrupted at sample {spp_done} — partial film returned")

    if checkpoint_path and spp_done >= n_rounds * n_sample_dev:
        save_checkpoint(checkpoint_path, acc, spp_done, config)
    out = _layers_out(acc)
    out["spp_done"] = spp_done
    return out


# ---------------------------------------------------------------------------
# Differentiable training step (the "train()" of this framework):
# gradient of an image loss w.r.t. material/emitter parameters, sharded.
# ---------------------------------------------------------------------------


def trainable_params(scene: SceneData):
    """The differentiable parameter pytree: material colors, emitter radiance,
    texture values — the parameters the reference edits live in its GUI and
    that BASELINE.json requires pixel gradients for."""
    return {
        "tex_value": scene.textures.value,
        "bsdf_kd": scene.bsdfs.kd,
        "bsdf_alpha": scene.bsdfs.alpha,
        "em_radiance": scene.emitters.radiance,
    }


def apply_params(scene: SceneData, params) -> SceneData:
    return scene._replace(
        textures=scene.textures._replace(value=params["tex_value"]),
        bsdfs=scene.bsdfs._replace(kd=params["bsdf_kd"], alpha=params["bsdf_alpha"]),
        emitters=scene.emitters._replace(radiance=params["em_radiance"]),
    )


@partial(jax.jit, static_argnames=("config", "mesh"))
def sharded_train_step(
    scene: SceneData,
    config: RenderConfig,
    mesh: Mesh,
    target: jnp.ndarray,  # [H,W,3] reference image
    pixel_ids: jnp.ndarray,  # [N] sharded over "tile"
    sample_base: jnp.ndarray,
):
    """loss + grads w.r.t. trainable_params, with the film psum'd over the mesh
    and parameter gradients implicitly all-reduced by the backward psum —
    the renderer analog of a DP+grad-allreduce training step.

    Jitted as one program: an eager shard_map dispatches every primitive as
    its own tiny multi-device program (measured: minutes instead of seconds
    on the multi-process CPU rehearsal)."""

    def loss_fn(params, scene_rep, pix, sbase, tgt):
        sc = apply_params(scene_rep, params)

        def body(sc_in, pix_in, sbase_in):
            si = jax.lax.axis_index("sample")
            img = _lane_render(sc_in, config, pix_in, sbase_in + si.astype(jnp.int32))
            return jax.lax.psum(img, ("tile", "sample"))

        img = shard_map(
            body,
            mesh=mesh,
            in_specs=(P(), P("tile"), P()),
            out_specs=P(),
            check_vma=False,
        )(sc, pix, sbase)
        rendered = film.to_bitmap(img)[0]
        return jnp.mean((rendered - tgt) ** 2)

    params = trainable_params(scene)
    loss, grads = jax.value_and_grad(loss_fn)(params, scene, pixel_ids, sample_base, target)
    return loss, grads
