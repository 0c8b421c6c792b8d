"""Benchmark suite on one NVIDIA GPU.

Prints one JSON line per configuration, then a headline line (Cornell
path-MIS throughput). Every line names the card it ran on: `device_kind`
and the power limit `nvidia-smi` reports. Without a GPU it fails.

- cornell_path_mis:   800×600 Cornell box, path_mis, depth 16, box filter
                      (BASELINE.json config 2)
- mesh100k_path_mis:  Cornell with ~100k-triangle tessellated spheres (the
                      LBVH walk, ops/bvh.py), 400×300, depth 8
- mesh100k_primary:   primary-ray closest hits per second on that mesh
- cornell_sharded_1chip: the Cornell box through render_sharded on a
                      one-device mesh
- heterog_path_vol:   procedural 64³ smoke (scene/presets.py
                      make_procedural_smoke), path_vol_mis, 400×300

Throughput counts camera paths (pixels × spp) per second, wall clock around
render() after one warm-up render of the same shapes; render() returns host
arrays, so the film fetch is inside the timing.

    python bench.py
"""

from __future__ import annotations

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from optix_renderer_tpu.utils.gpu import query_cards, require_gpu


def _card() -> dict:
    d = jax.devices()[0]
    name, limit = query_cards()[1][0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "count": len(jax.devices()), "card": name, "power_limit": limit}


def _timed_render(scene, config, spp: int, render_fn=None) -> float:
    """Mpaths/s of one render of `spp` samples after a warm-up render."""
    from optix_renderer_tpu.render.render import render

    render_fn = render_fn or render
    render_fn(scene, config, sample_count=min(spp, 2))  # compile
    t0 = time.perf_counter()
    render_fn(scene, config, sample_count=spp)
    return config.width * config.height * spp / (time.perf_counter() - t0) / 1e6


def _cornell():
    from optix_renderer_tpu.scene.presets import make_cornell_box

    scene, config, _ = make_cornell_box(width=800, height=600, spp=1, integrator="path_mis")
    return scene, dataclasses.replace(config, max_depth=16, rfilter="box")


def bench_cornell(spp: int = 64) -> dict:
    scene, config = _cornell()
    return {"value": _timed_render(scene, config, spp), "unit": "Mpaths/s", "spp": spp}


def bench_mesh100k() -> tuple[dict, dict]:
    from optix_renderer_tpu.ops import camera as camera_ops
    from optix_renderer_tpu.ops.intersect import intersect
    from optix_renderer_tpu.scene.presets import make_tessellated_cornell

    scene, config, _ = make_tessellated_cornell(width=400, height=300, spp=1,
                                                integrator="path_mis")
    config = dataclasses.replace(config, max_depth=8)
    n_tris = int(scene.geometry.tri_v0.shape[0])
    path = {"value": _timed_render(scene, config, 4), "unit": "Mpaths/s", "spp": 4,
            "tris": n_tris}

    n, reps = 1 << 17, 5
    pos = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (n, 2)) * [800, 600], jnp.float32)
    ray, _ = camera_ops.sample_ray(scene.camera, 800, 600, pos, jnp.zeros((n, 2)))
    hit_t = jax.jit(lambda g, r: intersect(g, r).t)
    hit_t(scene.geometry, ray).block_until_ready()  # compile
    t0 = time.perf_counter()
    for _ in range(reps):
        hit_t(scene.geometry, ray).block_until_ready()
    primary = {"value": n * reps / (time.perf_counter() - t0) / 1e6, "unit": "Mrays/s",
               "tris": n_tris}
    return path, primary


def bench_sharded_1chip(spp: int = 64) -> dict:
    from optix_renderer_tpu.parallel.shard import make_mesh, render_sharded

    scene, config = _cornell()
    mesh = make_mesh(n_devices=1)

    def run(scene, config, sample_count):
        return render_sharded(scene, config, mesh, sample_count=sample_count)

    return {"value": _timed_render(scene, config, spp, run), "unit": "Mpaths/s", "spp": spp}


def bench_heterog(spp: int = 4) -> dict:
    from optix_renderer_tpu.scene.presets import make_procedural_smoke

    scene, config, _ = make_procedural_smoke(width=400, height=300, spp=spp, max_depth=8)
    return {"value": _timed_render(scene, config, spp), "unit": "Mpaths/s", "spp": spp}


def main():
    require_gpu(jax.devices())
    from optix_renderer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = _card()
    results = {"cornell_path_mis": bench_cornell()}
    results["mesh100k_path_mis"], results["mesh100k_primary"] = bench_mesh100k()
    results["cornell_sharded_1chip"] = bench_sharded_1chip()
    results["heterog_path_vol"] = bench_heterog()
    for name, r in results.items():
        print(json.dumps({"config": name, **r, "device": card}))
    print(json.dumps({"metric": "cornell_path_mis_throughput",
                      "value": results["cornell_path_mis"]["value"],
                      "unit": "Mpaths/s", "device": card}))


if __name__ == "__main__":
    main()
