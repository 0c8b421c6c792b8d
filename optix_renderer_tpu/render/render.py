"""Render orchestration: sample rounds × pixel chunks → accumulated layers.

Counterpart of the reference render loop (src/utils/render.cpp:232-459):
the outer loop over samples and TBB tile parallelism become jitted wavefront
rounds over pixel chunks; `ImageBlock::put` merges become partial-image sums.
Multi-device execution shards the lane axis (see parallel/shard.py).

Layer order matches ERenderLayer (integrator.h:29-39):
0 = composite, 1 = albedo, 2 = normal.
"""

from __future__ import annotations

import os
import time
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from optix_renderer_tpu.integrators import get_integrator
from optix_renderer_tpu.ops import camera as camera_ops
from optix_renderer_tpu.render import film
from optix_renderer_tpu.render import sampler as smp
from optix_renderer_tpu.scene.data import RenderConfig, SceneData

# Upper bound on rays in flight per jit call: at 2^19 lanes an 800×600
# frame is one dispatch per sample round and the scan state stays resident.
# Brute-force intersection temporaries stay bounded because the sweep runs
# only below MIN_TRIS_FOR_BVH triangles (ops/intersect.py).
MAX_LANES = 1 << 19


def preprocess(scene: SceneData, config: RenderConfig) -> SceneData:
    """Integrator preprocess hook (`Integrator::preprocess`, render.cpp:272):
    the photon mapper builds its photon map here, once per render."""
    if config.integrator == "photonmapper" and scene.photons.pos.shape[0] == 0:
        from optix_renderer_tpu.ops.photon import build_photon_map

        pm = build_photon_map(
            scene,
            photon_count=int(config.iprop("photonCount", 100_000)),
            radius=float(config.iprop("photonRadius", 0.0)),
            max_depth=config.max_depth,
            n_lights=max(config.n_emitters, 1),
            seed=config.seed,
        )
        scene = scene._replace(photons=pm)
    return scene


def _round_layers(scene, config, pixel_ids, sample_idx):
    """One sample for a chunk of pixels → (pos [N,2], layers [3,N,3]).

    Mirrors renderBlock (render.cpp:421-459): per-pixel jitter, camera ray,
    integrator Li.
    """
    px = (pixel_ids % config.width).astype(jnp.float32)
    py = (pixel_ids // config.width).astype(jnp.float32)

    s = smp.make_sampler(pixel_ids.astype(jnp.uint32), sample_idx.astype(jnp.uint32),
                         seed=config.seed)
    s, jitter = smp.next_2d(s)
    s, aperture = smp.next_2d(s)
    pos = jnp.stack([px, py], axis=-1) + jitter

    ray, _w = camera_ops.sample_ray(
        scene.camera, config.width, config.height, pos, aperture
    )
    li = get_integrator(config.integrator)
    L, albedo, normal, s = li(scene, config, ray, s)
    # guard NaN/Inf splats (a dead lane's garbage must not poison the film)
    L = jnp.nan_to_num(L, nan=0.0, posinf=0.0, neginf=0.0)
    return pos, jnp.stack([L, albedo, normal])  # [3,N,3]


@partial(jax.jit, static_argnames=("config",), donate_argnums=())
def render_round(
    scene: SceneData,
    config: RenderConfig,
    pixel_ids: jnp.ndarray,  # [N] int32 linear pixel indices
    sample_idx: jnp.ndarray,  # [] int32 current sample round
) -> jnp.ndarray:
    """One sample round → partial [3,H,W,4] image (kept for tests/API)."""
    pos, layers = _round_layers(scene, config, pixel_ids, sample_idx)
    return film.splat(config.width, config.height, config.rfilter, pos, layers)


@partial(jax.jit, static_argnames=("config",), donate_argnums=(0,))
def render_round_accumulate(
    acc: jnp.ndarray,  # [3,H,W,4] running accumulator (donated: updated in place)
    scene: SceneData,
    config: RenderConfig,
    pixel_ids: jnp.ndarray,
    sample_idx: jnp.ndarray,
) -> jnp.ndarray:
    """render_round fused with the accumulator add.

    Accumulating eagerly (`acc + render_round(...)`) would dispatch a
    separate full-image add per chunk; fusing it into the round and donating
    `acc` makes the update one in-place write in device memory.
    """
    pos, layers = _round_layers(scene, config, pixel_ids, sample_idx)
    return acc + film.splat(config.width, config.height, config.rfilter, pos, layers)


def _norm_ckpt_path(path: str) -> str:
    """np.savez appends '.npz' when the suffix is missing, so a bare path would
    save to `path.npz` while load reads the literal `path` and --resume would
    silently restart. Normalize both directions to the '.npz' name."""
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, acc, spp_done: int, config: RenderConfig) -> None:
    """Persist the running accumulator (SURVEY §5.4: 'partial-image
    accumulator snapshots are cheap')."""
    np.savez(
        _norm_ckpt_path(path),
        acc=np.asarray(acc),
        spp_done=np.int64(spp_done),
        shape_key=np.array([config.width, config.height], np.int64),
        seed=np.int64(config.seed),
    )


def load_checkpoint(path: str, config: RenderConfig):
    """Load (acc, spp_done); raises on resolution/seed mismatch (resuming a
    different render would silently corrupt the film)."""
    with np.load(_norm_ckpt_path(path)) as z:
        wh = z["shape_key"]
        if (int(wh[0]), int(wh[1])) != (config.width, config.height):
            raise ValueError(
                f"checkpoint is {wh[0]}x{wh[1]}, render is "
                f"{config.width}x{config.height}"
            )
        if int(z["seed"]) != config.seed:
            raise ValueError("checkpoint seed differs — sample streams diverge")
        return jnp.asarray(z["acc"]), int(z["spp_done"])


def _layers_out(acc) -> dict[str, np.ndarray]:
    # one bulk fetch + host-side normalization: per-layer device slices
    # would each be a separate compiled program and transfer
    a = np.asarray(acc)  # [3, H, W, 4]
    w = a[..., 3:4]
    layers = np.where(w > 1e-9, a[..., :3] / np.maximum(w, 1e-9), 0.0)
    return {
        "composite": layers[0],
        "albedo": layers[1],
        "normal": layers[2],
        "weights": a[0, ..., 3],
    }


def render(
    scene: SceneData,
    config: RenderConfig,
    sample_count: int | None = None,
    verbose: bool = False,
    preview_every: int = 0,
    preview_callback=None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    wavefront: bool = False,
) -> dict[str, np.ndarray]:
    """Full render: all sample rounds, pixel-chunked. Returns numpy layers.

    The renderThreadMain analog (render.cpp:232-419) without thread plumbing:
    outer loop = sample rounds, inner loop = pixel chunks (the tile scheduler,
    block.h:142-183 — chunk order is irrelevant since accumulation commutes).

    Progressive/interrupt/checkpoint machinery (render.cpp:285-301 interrupt
    polling, ImguiScreen progressive display, SURVEY §5.3-5.4):
    - `preview_every=k` + `preview_callback(layers_dict, spp_done)` fetches
      the partial film every k sample rounds (the GL-interop display analog);
    - `checkpoint_path` (+`checkpoint_every=k`) snapshots the accumulator;
      `resume=True` continues from an existing snapshot;
    - SIGINT between chunks saves a final checkpoint (when a path is set) and
      returns the valid partial render with `out["spp_done"] < spp` — the
      interrupt-at-block-granularity contract.
    - `wavefront`: path-regeneration mode (render/wavefront.py), opt-in;
      see the note below. Films are equal up to fp add order
      (tests/test_wavefront.py). A mid-flight wavefront snapshot would lose
      in-flight paths, so it also excludes checkpoint/resume.
    """
    from optix_renderer_tpu.render import wavefront as wf

    # The fixed-depth scan below is the default; regeneration is opt-in.
    # Measured by chip_smoke.py on one NVIDIA H100 80GB HBM3 at a 400 W power
    # limit, Cornell 800×600 path_mis depth 16, 16 spp, two runs: scan 24.5
    # and 25.2 Mpaths/s, regeneration 34.6 and 36.8 Mpaths/s. Making
    # regeneration the default (it covers path_mis/path_mats only) is a
    # change of its own, with a benchmark.
    if wavefront and config.integrator not in wf.WAVEFRONT_INTEGRATORS:
        wavefront = False
    if wavefront:
        assert checkpoint_path is None and not resume, (
            "wavefront mode has no mid-render checkpoint granularity; "
            "use wavefront=False with --checkpoint/--resume"
        )
        return wf.render_wavefront(
            scene,
            config,
            sample_count=sample_count,
            verbose=verbose,
            preview_every_iters=preview_every * 4 if preview_every else 0,
            preview_callback=preview_callback,
        )
    scene = preprocess(scene, config)
    spp = sample_count if sample_count is not None else config.sample_count
    w, h = config.width, config.height
    n_pix = w * h
    chunk = min(MAX_LANES, n_pix)
    n_chunks = (n_pix + chunk - 1) // chunk
    pad = n_chunks * chunk - n_pix
    # padded pixel ids; padding lanes point at pixel 0 but splat with the same
    # filter weights — avoided by masking them out-of-bounds (id = -1 → x<0)
    ids = np.concatenate([np.arange(n_pix, dtype=np.int32),
                          np.full(pad, -max(w, h) * 4, np.int32)])

    acc = jnp.zeros((3, h, w, 4), jnp.float32)
    start_spp = 0
    if resume and checkpoint_path and os.path.exists(_norm_ckpt_path(checkpoint_path)):
        acc, start_spp = load_checkpoint(checkpoint_path, config)
        if verbose:
            print(f"  resumed at sample {start_spp} from {checkpoint_path}")

    t0 = time.time()
    spp_done = start_spp
    at_boundary = True  # acc holds only COMPLETE sample rounds
    try:
        for s_idx in range(start_spp, spp):
            at_boundary = False
            for c in range(n_chunks):
                pix = jnp.asarray(ids[c * chunk : (c + 1) * chunk])
                acc = render_round_accumulate(
                    acc, scene, config, pix, jnp.int32(s_idx)
                )
            spp_done = s_idx + 1
            at_boundary = True
            if verbose:
                acc.block_until_ready()
                print(f"  sample {spp_done}/{spp}  ({time.time() - t0:.1f}s)")
            if preview_every and preview_callback and spp_done % preview_every == 0:
                preview_callback(_layers_out(acc), spp_done)
            if checkpoint_path and checkpoint_every and spp_done % checkpoint_every == 0:
                save_checkpoint(checkpoint_path, acc, spp_done, config)
    except KeyboardInterrupt:
        # degrade gracefully: the weighted film is valid at ANY chunk boundary
        # (to_bitmap divides by the per-pixel weight channel), so the partial
        # image is returned; a RESUME checkpoint is only written when acc sits
        # exactly on a sample-round boundary — a mid-sample snapshot would
        # double-count the finished chunks of the aborted round on resume
        # (render.cpp:285-301,567-573 interrupt contract)
        acc.block_until_ready()
        if checkpoint_path and at_boundary:
            save_checkpoint(checkpoint_path, acc, spp_done, config)
        if verbose:
            print(f"  interrupted at sample {spp_done}/{spp} — partial film returned")

    if checkpoint_path and spp_done >= spp:
        save_checkpoint(checkpoint_path, acc, spp_done, config)
    out = _layers_out(acc)
    out["spp_done"] = spp_done
    return out
