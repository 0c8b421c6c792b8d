"""Multi-host rehearsal worker: one process of an N-process CPU-backend run.

Launched N times (once per simulated host) by `tests/test_multihost.py` or by
hand:

    python -m optix_renderer_tpu.parallel.mh_worker \
        --coordinator localhost:9876 --num-processes 2 --process-id 0 \
        --local-devices 4 --out /tmp/mh0.npz

Each process joins the distributed runtime with `--local-devices` virtual CPU
devices (gloo collectives — the stand-in for the network between hosts), builds the global
(tile × sample) mesh, renders the procedural Cornell box, runs one sharded
differentiable train step, and (process 0) writes the film + grads + scaling
JSON for the test to verify against a single-process render.

This rehearses the exact code path a real multi-host run takes
(multihost.py) — the device platform is the only substitution.
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--out", default="")
    ap.add_argument("--scaling", action="store_true", help="also run measure_scaling")
    args = ap.parse_args()

    from optix_renderer_tpu.parallel.multihost import init_distributed

    init_distributed(
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        local_cpu_devices=args.local_devices,
    )

    import numpy as np
    import jax
    import jax.numpy as jnp

    from optix_renderer_tpu.parallel.multihost import (
        make_multihost_mesh,
        measure_scaling,
        render_multihost,
        stage_global,
        stage_replicated_tree,
    )
    from optix_renderer_tpu.parallel.shard import sharded_train_step
    from optix_renderer_tpu.parallel.multihost import _tile_padded_pixel_ids
    from jax.sharding import PartitionSpec as P
    from optix_renderer_tpu.scene.presets import make_cornell_box

    assert jax.process_count() == args.num_processes
    assert jax.local_device_count() == args.local_devices

    scene, config, _ = make_cornell_box(width=16, height=12, spp=4, integrator="path_mis")
    config = dataclasses.replace(config, max_depth=3)

    mesh = make_multihost_mesh()
    print(f"[mh_worker {args.process_id}] mesh {mesh.devices.shape}, rendering", flush=True)
    out = render_multihost(scene, config, mesh, sample_count=4)
    print(f"[mh_worker {args.process_id}] render done", flush=True)

    # one differentiable train step across hosts: parameter grads are psum'd
    # between hosts by the backward pass of the film reduction
    scene_g = stage_replicated_tree(mesh, scene)
    ids_g = stage_global(
        mesh, P("tile"), _tile_padded_pixel_ids(config, mesh.devices.shape[0])
    )
    target = stage_global(
        mesh, P(), np.zeros((config.height, config.width, 3), np.float32)
    )
    loss, grads = sharded_train_step(scene_g, config, mesh, target, ids_g, np.int32(0))
    loss = float(np.asarray(loss.addressable_data(0)))
    print(f"[mh_worker {args.process_id}] train step done", flush=True)
    grad_finite = all(
        bool(np.all(np.isfinite(np.asarray(g.addressable_data(0)))))
        for g in jax.tree.leaves(grads)
    )

    scaling = None
    if args.scaling:
        scaling = measure_scaling(scene, config, spp=4, repeats=2)

    if args.out and jax.process_index() == 0:
        np.savez(
            args.out,
            composite=out["composite"],
            albedo=out["albedo"],
            normal=out["normal"],
            loss=np.float64(loss),
            grad_finite=np.bool_(grad_finite),
            n_devices=np.int64(mesh.devices.size),
            n_processes=np.int64(jax.process_count()),
        )
        if scaling is not None:
            with open(args.out + ".scaling.json", "w") as f:
                json.dump(scaling, f, indent=1)
    print(
        f"[mh_worker {args.process_id}] ok: mesh={mesh.devices.shape} "
        f"loss={loss:.6g} grads_finite={grad_finite}",
        flush=True,
    )


if __name__ == "__main__":
    main()
