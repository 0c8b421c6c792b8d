"""Adaptive variance-guided sampling.

Counterpart of the reference adaptive sampler (src/samplers/adaptive.cpp,
"Robust Adaptive Sampling for Monte-Carlo-Based Rendering", Pajot et al.):
uniform placement for the first `initialUniform` rounds, then each round
builds a DiscretePDF over the per-pixel variance map and draws the round's
pixel budget from it; rendering stops early when the variance map stops
improving.

Deviation: the reference adapts per 4-pixel block
(block.h:30-31); here the unit is the whole image — the variance map, the
categorical draw (searchsorted over one CDF), and the splat are all single
fused device ops over the full wavefront, which is both simpler and faster
than per-block control flow. Convergence uses the same variance-difference
test (adaptive.cpp:95-128).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from optix_renderer_tpu.core import dpdf as dpdf_mod
from optix_renderer_tpu.core import rng as rng_mod
from optix_renderer_tpu.render import film as film_mod
from optix_renderer_tpu.render.render import render_round_accumulate
from optix_renderer_tpu.render.variance import variance_from_image
from optix_renderer_tpu.scene.data import RenderConfig, SceneData


@partial(jax.jit, static_argnames=("n", "seed"))
def _draw_pixels(variance: jnp.ndarray, round_idx: jnp.ndarray, n: int, seed: int = 0):
    """Categorical draw of n pixel ids ∝ variance (adaptive.cpp:152-166)."""
    d = dpdf_mod.build(variance.reshape(-1))
    lane = jnp.arange(n, dtype=jnp.uint32)
    state = rng_mod.tea(lane, round_idx.astype(jnp.uint32) ^ jnp.uint32(seed ^ 0xADA97)
                        )
    _, u = rng_mod.lcg_next_float(state)
    return dpdf_mod.sample(d, u)


def render_adaptive(
    scene: SceneData,
    config: RenderConfig,
    sample_count: int | None = None,
    verbose: bool = False,
):
    """Adaptive render: returns layer dict + variance image + samples used."""
    from optix_renderer_tpu.render.render import preprocess

    scene = preprocess(scene, config)
    spp = sample_count if sample_count is not None else config.sample_count
    w, h = config.width, config.height
    n_pix = w * h
    all_ids = jnp.arange(n_pix, dtype=jnp.int32)

    acc = jnp.zeros((3, h, w, 4), jnp.float32)
    # convergence state mirrors adaptive.cpp:70-90: old variance starts at
    # zero (not None) and the norm guard starts high-but-finite, so the
    # variance-difference test is armed from the *second* adaptive round —
    # previously old_norm=inf meant the stop could never fire until round 3+
    old_var = np.zeros((h, w), np.float32)
    old_norm = 1.0e4
    samples_placed = 0
    var_img = jnp.zeros((h, w), jnp.float32)

    for r in range(spp):
        if r < config.adaptive_uniform_rounds:
            ids = all_ids
        else:
            var_img = variance_from_image(acc[0])
            var_np = np.asarray(var_img)
            if var_np.max() - var_np.min() <= 1e-12:
                break  # flat variance → converged (adaptive.cpp:96-102)
            # scale-free comparison: unit-norm the map (Eigen .normalize(),
            # adaptive.cpp:104) so the stop doesn't depend on radiance scale
            var_unit = var_np / max(float(np.linalg.norm(var_np)), 1e-20)
            var_diff = float(np.abs(var_unit - old_var).sum())
            if var_diff > old_norm:
                break  # variance stopped improving (adaptive.cpp:118-123)
            old_norm = var_diff
            old_var = var_unit
            ids = _draw_pixels(var_img, jnp.int32(r), n_pix, config.seed).astype(
                jnp.int32
            )
        if r < config.adaptive_uniform_rounds:
            sample_idx = jnp.int32(r)
        else:
            # duplicate pixels within one adaptive round need distinct RNG
            # streams: per-lane virtual sample index
            sample_idx = jnp.int32(r) * n_pix + jnp.arange(n_pix, dtype=jnp.int32)
        acc = render_round_accumulate(acc, scene, config, ids, sample_idx)
        samples_placed += n_pix
        if verbose:
            print(f"  adaptive round {r + 1}/{spp}")

    layers = np.asarray(film_mod.to_bitmap(acc))
    return {
        "composite": layers[0],
        "albedo": layers[1],
        "normal": layers[2],
        "weights": np.asarray(acc[0, ..., 3]),
        "variance": np.asarray(variance_from_image(acc[0])),
        "samples_placed": samples_placed,
    }
