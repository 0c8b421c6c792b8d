"""Test configuration: force a hermetic 8-virtual-device CPU platform.

Mirrors the reference's approach of using the CPU path as the reference
implementation for the accelerator path (SURVEY.md §4): tests run on CPU with
8 virtual devices so sharding (shard_map) is exercised without GPU hardware.
`python chip_smoke.py` runs the same code on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the suite is compile-dominated on CPU; repeat
# runs hit the cache.
from optix_renderer_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache(min_compile_secs=1.0)

import pytest  # noqa: E402


def pytest_collection_modifyitems(config, items):
    """Everything not marked `heavy` is the fast tier: `pytest -m fast`
    (the full suite is compile-dominated on CPU; the fast tier keeps a
    fast warm-cache signal)."""
    for item in items:
        if "heavy" not in item.keywords:
            item.add_marker(pytest.mark.fast)
