"""Discrete probability distributions as arrays (CDF + searchsorted).

Counterpart of the reference `DiscretePDF` (include/nori/dpdf.h:55-206):
`append/normalize` become a single vectorized build; `sample`/`sampleReuse`
become `searchsorted` over the CDF — an XLA-native binary search that batches
over whole ray wavefronts. Used for emitter picking (scene.cpp:179-184),
mesh area sampling (mesh.cpp:15-46), envmap importance sampling
(environmentmap.cpp:73-131) and adaptive-sampler pixel selection (adaptive.cpp).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class DiscretePDF(NamedTuple):
    """Normalized discrete distribution over `n` entries.

    pmf: [n] probabilities (sum to 1 unless all-zero input).
    cdf: [n] inclusive cumulative sum of pmf.
    sum_before_normalize: [] original total weight (reference m_sum).
    """

    pmf: jnp.ndarray
    cdf: jnp.ndarray
    sum_before_normalize: jnp.ndarray


def build(weights: jnp.ndarray) -> DiscretePDF:
    """Build from non-negative weights (append + normalize, dpdf.h:74-124)."""
    w = jnp.maximum(jnp.asarray(weights, jnp.float32), 0.0)
    total = jnp.sum(w)
    inv = jnp.where(total > 0, 1.0 / jnp.maximum(total, 1e-38), 0.0)
    pmf = w * inv
    cdf = jnp.cumsum(pmf)
    return DiscretePDF(pmf=pmf, cdf=cdf, sum_before_normalize=total)


def sample(d: DiscretePDF, u: jnp.ndarray) -> jnp.ndarray:
    """Draw indices for uniform samples `u` (any batch shape) — dpdf.h:140-152."""
    idx = jnp.searchsorted(d.cdf, u, side="right")
    return jnp.clip(idx, 0, d.pmf.shape[0] - 1).astype(jnp.int32)


def sample_reuse(d: DiscretePDF, u: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sample an index and rescale `u` for reuse (dpdf.h:166-180)."""
    idx = sample(d, u)
    lo = jnp.where(idx > 0, d.cdf[jnp.maximum(idx - 1, 0)], 0.0)
    p = jnp.maximum(d.pmf[idx], 1e-38)
    return idx, jnp.clip((u - lo) / p, 0.0, 1.0 - 1e-7)


def pdf_of(d: DiscretePDF, idx: jnp.ndarray) -> jnp.ndarray:
    return d.pmf[idx]
