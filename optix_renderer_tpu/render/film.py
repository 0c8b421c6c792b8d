"""Film: reconstruction-filtered sample splatting into weighted image planes.

Counterpart of the reference `ImageBlock` + `ReconstructionFilter`
(include/nori/block.h:49-129, src/cameras/rfilter.cpp:28-210): each sample at a
continuous position splats into its filter-support neighborhood; channel 4
accumulates filter weight; `to_bitmap` divides it out (block.cpp:76-91).
Mutex-guarded block merges become pure scatter-adds.
"""

from __future__ import annotations

import jax.numpy as jnp

# filter radii per type (rfilter.cpp defaults)
FILTER_RADIUS = {"gaussian": 2.0, "mitchell": 2.0, "tent": 1.0, "box": 0.5}


def _filter_eval(name: str, x: jnp.ndarray) -> jnp.ndarray:
    """1D filter kernels, matching src/cameras/rfilter.cpp."""
    ax = jnp.abs(x)
    if name == "gaussian":
        # GaussianFilter: radius 2, stddev 0.5 (rfilter.cpp:34-52)
        stddev = 0.5
        radius = 2.0
        alpha = -1.0 / (2.0 * stddev * stddev)
        return jnp.maximum(
            0.0, jnp.exp(alpha * ax * ax) - jnp.exp(alpha * radius * radius)
        )
    if name == "mitchell":
        # Mitchell-Netravali B=C=1/3 (rfilter.cpp:60-93)
        B = C = 1.0 / 3.0
        x2 = ax * ax
        x3 = x2 * ax
        inner = (
            (12.0 - 9.0 * B - 6.0 * C) * x3
            + (-18.0 + 12.0 * B + 6.0 * C) * x2
            + (6.0 - 2.0 * B)
        ) * (1.0 / 6.0)
        outer = (
            (-B - 6.0 * C) * x3
            + (6.0 * B + 30.0 * C) * x2
            + (-12.0 * B - 48.0 * C) * ax
            + (8.0 * B + 24.0 * C)
        ) * (1.0 / 6.0)
        return jnp.where(ax < 1.0, inner, jnp.where(ax < 2.0, outer, 0.0))
    if name == "tent":
        return jnp.maximum(0.0, 1.0 - ax)
    if name == "box":
        return jnp.where(ax <= 0.5, 1.0, 0.0)
    raise ValueError(f"unknown rfilter '{name}'")


def splat(
    width: int,
    height: int,
    rfilter: str,
    pos: jnp.ndarray,  # [N,2] continuous pixel coordinates
    layers: jnp.ndarray,  # [K,N,3] per-sample values (composite/albedo/normal)
    mask: jnp.ndarray | None = None,  # [N] bool — False lanes contribute 0
) -> jnp.ndarray:
    """Scatter-add filtered samples → [K,H,W,4] (rgb·w, w).

    `mask` suppresses lanes by zeroing their filter weight while KEEPING their
    in-bounds scatter position: funnelling masked lanes to one clipped pixel
    (the out-of-bounds trick used for padding lanes) would make every masked
    lane collide on that pixel's scatter-add — the wavefront renderer masks
    most lanes per iteration.
    """
    radius = FILTER_RADIUS[rfilter]
    support = int(2 * radius + 0.999)  # pixels per axis covered by the kernel
    k, n, _ = layers.shape

    px = pos[:, 0] - 0.5
    py = pos[:, 1] - 0.5
    x0 = jnp.floor(px - radius + 1.0).astype(jnp.int32)
    y0 = jnp.floor(py - radius + 1.0).astype(jnp.int32)

    img = jnp.zeros((k, height, width, 4), jnp.float32)
    for dy in range(support):
        for dx in range(support):
            ix = x0 + dx
            iy = y0 + dy
            wx = _filter_eval(rfilter, px - ix.astype(jnp.float32))
            wy = _filter_eval(rfilter, py - iy.astype(jnp.float32))
            w = wx * wy
            inside = (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
            if mask is not None:
                inside = inside & mask
            w = jnp.where(inside, w, 0.0)
            ixc = jnp.clip(ix, 0, width - 1)
            iyc = jnp.clip(iy, 0, height - 1)
            vals = jnp.concatenate(
                [layers * w[None, :, None], jnp.broadcast_to(w, (k, n))[..., None]],
                axis=-1,
            )  # [K,N,4]
            img = img.at[:, iyc, ixc].add(vals)
    return img


def to_bitmap(img: jnp.ndarray) -> jnp.ndarray:
    """[..,H,W,4] weighted → [..,H,W,3] normalized (block.cpp:76-91)."""
    w = img[..., 3:4]
    return jnp.where(w > 1e-9, img[..., :3] / jnp.maximum(w, 1e-9), 0.0)
