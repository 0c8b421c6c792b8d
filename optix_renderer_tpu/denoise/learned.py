"""Learned denoiser: small residual CNN over RGB+albedo+normal AOVs.

Replacement of the reference's OptiX AI denoiser
(include/nori/optix/OptixState.denoiser.cpp:15-152 — HDR model with
RGB+albedo+normal inputs, invoked on the accumulated frame): the same
3-buffer interface (integrator.h:29-39 ERenderLayer), but the model is ours —
a 4-layer conv net predicting a residual over the noisy radiance, trained on
self-rendered noisy/clean pairs with optax. Convolutions are NHWC
`lax.conv_general_dilated`, which XLA hands to cuDNN on the GPU.

The non-learned cross-bilateral filter (denoise/bilateral.py, the analog of
src/denoiser/simple.cpp) remains the fallback when no checkpoint exists.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# (in_ch, out_ch) per layer; input = RGB(3)+albedo(3)+normal(3)
_LAYERS = ((9, 32), (32, 32), (32, 16), (16, 3))
_KSIZE = 3


def init_params(seed: int = 0):
    """He-initialized conv stack parameters as a flat dict of arrays."""
    key = jax.random.PRNGKey(seed)
    params = {}
    for i, (cin, cout) in enumerate(_LAYERS):
        key, k = jax.random.split(key)
        scale = np.sqrt(2.0 / (cin * _KSIZE * _KSIZE))
        params[f"w{i}"] = jax.random.normal(k, (_KSIZE, _KSIZE, cin, cout)) * scale
        params[f"b{i}"] = jnp.zeros((cout,))
    return params


def _conv(x, w, b):
    # default precision: a GPU may run these in TF32 (about three decimal
    # digits). The net's output is an estimate trained to a tolerance far
    # looser than that (its tests compare against a noisy-input baseline,
    # tests/test_denoiser.py), so full float32 would buy nothing here.
    y = jax.lax.conv_general_dilated(
        x, w, window_strides=(1, 1), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return y + b


def apply(params, rgb, albedo, normal):
    """Denoise a batch: rgb/albedo/normal [B,H,W,3] (or [H,W,3]) → [.,H,W,3].

    HDR radiance is log-compressed before the net and re-expanded after —
    the standard trick the OptiX HDR model hides behind `computeIntensity`
    (OptixState.denoiser.cpp:123-135).
    """
    squeeze = rgb.ndim == 3
    if squeeze:
        rgb, albedo, normal = rgb[None], albedo[None], normal[None]
    lum = jnp.log1p(jnp.maximum(rgb, 0.0))
    x = jnp.concatenate([lum, albedo, normal], axis=-1)
    n_layers = len(_LAYERS)
    for i in range(n_layers):
        x = _conv(x, params[f"w{i}"], params[f"b{i}"])
        if i < n_layers - 1:
            x = jax.nn.relu(x)
    out = jnp.expm1(jnp.maximum(lum + x, 0.0))  # residual in log space
    return out[0] if squeeze else out


def loss_fn(params, rgb, albedo, normal, clean):
    pred = apply(params, rgb, albedo, normal)
    # log-space L1: robust to fireflies (HDR outliers dominate L2)
    return jnp.mean(jnp.abs(jnp.log1p(jnp.maximum(pred, 0.0))
                            - jnp.log1p(jnp.maximum(clean, 0.0))))


def train(
    pairs,  # list of dicts: rgb/albedo/normal/clean, each [H,W,3] numpy
    steps: int = 200,
    lr: float = 2e-3,
    seed: int = 0,
    verbose: bool = False,
):
    """Adam training loop over full-frame pairs. Returns (params, losses)."""
    import optax

    params = init_params(seed)
    opt = optax.adam(lr)
    opt_state = opt.init(params)

    rgb = jnp.stack([jnp.asarray(p["rgb"]) for p in pairs])
    alb = jnp.stack([jnp.asarray(p["albedo"]) for p in pairs])
    nrm = jnp.stack([jnp.asarray(p["normal"]) for p in pairs])
    cln = jnp.stack([jnp.asarray(p["clean"]) for p in pairs])

    @jax.jit
    def step(params, opt_state):
        l, g = jax.value_and_grad(loss_fn)(params, rgb, alb, nrm, cln)
        updates, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(params, updates), opt_state, l

    losses = []
    for i in range(steps):
        params, opt_state, l = step(params, opt_state)
        losses.append(float(l))
        if verbose and (i % 20 == 0 or i == steps - 1):
            print(f"  denoiser step {i}: loss {float(l):.5f}")
    return params, losses


# -- checkpointing (SURVEY.md §5.4: "orbax-style for learned denoiser params";
#    a flat npz keeps the artifact dependency-free and inspectable) ----------


def _norm_ckpt_path(path: str) -> str:
    # np.savez appends '.npz' when missing; keep save/load symmetric
    return path if str(path).endswith(".npz") else str(path) + ".npz"


def save_checkpoint(path: str, params) -> None:
    np.savez(_norm_ckpt_path(path), **{k: np.asarray(v) for k, v in params.items()})


def load_checkpoint(path: str):
    with np.load(_norm_ckpt_path(path)) as z:
        return {k: jnp.asarray(z[k]) for k in z.files}


def render_training_pairs(scene, config, spps=(2, 4), clean_spp=256, seeds=(0, 1)):
    """Self-render noisy/clean AOV pairs from one scene at several spp."""
    import dataclasses

    from optix_renderer_tpu.render.render import render

    clean = render(scene, dataclasses.replace(config, seed=1234),
                   sample_count=clean_spp)
    pairs = []
    for spp in spps:
        for seed in seeds:
            noisy = render(scene, dataclasses.replace(config, seed=seed),
                           sample_count=spp)
            pairs.append(dict(rgb=noisy["composite"], albedo=noisy["albedo"],
                              normal=noisy["normal"], clean=clean["composite"]))
    return pairs
