"""Multi-host (multi-process) execution.

The reference's only cross-device cooperation is the CPU/GPU sample split
inside one process (src/utils/render.cpp:281,501) with a weighted composite
(render.cpp:725-747). Its generalization here (SURVEY.md §2.8 item 3,
§5.8) is a *multi-controller* JAX program: every host runs this same code,
`jax.distributed.initialize` forms the global runtime, and one global
(tile × sample) mesh spans all hosts' devices.

Topology-aware mesh: the **tile axis spans hosts** (each host owns a
contiguous slab of pixel lanes — zero communication during a round) and the
**sample axis stays within a host**. The only collective between hosts is
the per-launch `psum` of the partial film — the distributed replacement for
the reference's mutex-guarded ImageBlock merge (block.cpp:125) and its
per-device sample-count weighting.

Determinism: lanes are seeded by (pixel_id, sample_idx) alone
(render/sampler.py), so the image is invariant to host count and mesh layout
— only the float reduction order of the final psum differs.

Usage (same command on every host):

    python -m optix_renderer_tpu.cli render scene.xml \
        --distributed --coordinator HOST0:9876 \
        --num-processes 4 --process-id $RANK

The coordinator address, process count and process id are always given
explicitly. A local CPU rehearsal (N processes × K virtual devices each) is
`tests/test_multihost.py`.
"""

from __future__ import annotations

import json
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from optix_renderer_tpu.scene.data import RenderConfig, SceneData


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_cpu_devices: int | None = None,
) -> None:
    """Join the multi-controller runtime.

    With no arguments, defers to JAX's environment auto-detection (a
    cluster launcher that JAX recognises).
    `local_cpu_devices` forces the CPU platform with that many virtual local
    devices and gloo collectives — the hardware-free rehearsal mode.
    """
    if local_cpu_devices is not None:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", int(local_cpu_devices))
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        # rehearsals run on starved CI hosts: reuse compiled programs across
        # worker launches (cache keys include the device topology, so this is
        # safe across mesh shapes)
        from optix_renderer_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache(min_compile_secs=1.0)
    if coordinator is None and num_processes is None:
        jax.distributed.initialize()
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )


def make_multihost_mesh(sample_axis: int | None = None) -> Mesh:
    """Global (tile, sample) mesh with hosts grouped along the tile axis.

    Devices are grouped by owning process so each host's devices are
    contiguous in the tile axis — tile-sharded pixel slabs never cross
    hosts, and the sample axis (which psums every launch) stays on one host.
    """
    n_local = jax.local_device_count()
    n_proc = jax.process_count()
    if sample_axis is None:
        # largest sample axis that divides the local device count, capped at
        # the most-square split (tile parallelism dominates, like the
        # reference's tile loop dominating its sample loop)
        sample_axis = 1
        for cand in range(int(np.sqrt(n_local)), 0, -1):
            if n_local % cand == 0:
                sample_axis = cand
                break
    local_tile = n_local // sample_axis
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    dev_grid = np.asarray(devs).reshape(n_proc * local_tile, sample_axis)
    return Mesh(dev_grid, axis_names=("tile", "sample"))


# ---------------------------------------------------------------------------
# Global-array staging: every jit input in a multi-controller program must be
# a global jax.Array (or plain numpy, which jit treats as replicated). Scene
# tables are identical on every host, so replication is a local device_put.
# ---------------------------------------------------------------------------


def stage_global(mesh: Mesh, spec: P, arr: np.ndarray) -> jax.Array:
    """Assemble a global array from identical per-host full copies."""
    sharding = NamedSharding(mesh, spec)
    arr = np.asarray(arr)
    return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])


def stage_replicated_tree(mesh: Mesh, tree):
    """Replicate a pytree of arrays across the whole mesh."""
    return jax.tree.map(lambda a: stage_global(mesh, P(), np.asarray(a)), tree)


def _tile_padded_pixel_ids(config: RenderConfig, n_tile: int) -> np.ndarray:
    n_pix = config.width * config.height
    pad = (-n_pix) % n_tile
    return np.concatenate(
        [np.arange(n_pix, dtype=np.int32), np.full(pad, -(1 << 20), np.int32)]
    )


def render_multihost(
    scene: SceneData,
    config: RenderConfig,
    mesh: Mesh | None = None,
    sample_count: int | None = None,
    verbose: bool = False,
) -> dict[str, np.ndarray]:
    """Full multi-host render. Every process calls this with the same scene;
    the returned layers are identical on every process (replicated psum).

    Orchestration (checkpoints/preview) stays with the caller on process 0 —
    the accumulator is replicated, so any single process can snapshot it.
    """
    from optix_renderer_tpu.render.render import _layers_out, preprocess
    from optix_renderer_tpu.parallel.shard import _sharded_round_acc_jit

    scene = preprocess(scene, config)
    if mesh is None:
        mesh = make_multihost_mesh()
    spp = sample_count if sample_count is not None else config.sample_count
    n_tile, n_sample = mesh.devices.shape
    n_rounds = max(1, (spp + n_sample - 1) // n_sample)

    scene_g = stage_replicated_tree(mesh, scene)
    ids_g = stage_global(mesh, P("tile"), _tile_padded_pixel_ids(config, n_tile))
    acc = stage_global(
        mesh, P(), np.zeros((3, config.height, config.width, 4), np.float32)
    )

    for r in range(n_rounds):
        # sample_base as numpy: uncommitted scalars replicate implicitly
        acc = _sharded_round_acc_jit(
            acc, scene_g, config, mesh, ids_g, np.int32(r * n_sample)
        )
        if verbose and jax.process_index() == 0:
            acc.block_until_ready()
            print(f"  sample {(r + 1) * n_sample}/{n_rounds * n_sample}")

    # the film is replicated; every process can read its local shard
    acc_local = np.asarray(acc.addressable_data(0))
    out = _layers_out(jnp.asarray(acc_local))
    out["spp_done"] = n_rounds * n_sample
    return out


# ---------------------------------------------------------------------------
# Scaling-efficiency harness: paths/s on one device vs the full mesh.
# ---------------------------------------------------------------------------


def measure_scaling(
    scene: SceneData,
    config: RenderConfig,
    spp: int = 4,
    repeats: int = 3,
    out_path: str | None = None,
) -> dict:
    """Measure rays/s on a single device vs the full global mesh.

    Efficiency = (full-mesh paths/s) / (single-device paths/s × n_devices).
    Runs on whatever topology is live: 1 host today, N hosts when the same
    command is launched per-host under `init_distributed`. Process 0 writes
    the JSON artifact.
    """
    from optix_renderer_tpu.render.render import preprocess
    from optix_renderer_tpu.parallel.shard import _sharded_round_acc_jit

    scene = preprocess(scene, config)
    n_pix = config.width * config.height
    results = {}

    def _bench(mesh: Mesh) -> float:
        n_tile, n_sample = mesh.devices.shape
        scene_g = stage_replicated_tree(mesh, scene)
        ids_g = stage_global(mesh, P("tile"), _tile_padded_pixel_ids(config, n_tile))
        zero = np.zeros((3, config.height, config.width, 4), np.float32)
        n_rounds = max(1, spp // n_sample)

        def run():
            acc = stage_global(mesh, P(), zero)
            for r in range(n_rounds):
                acc = _sharded_round_acc_jit(
                    acc, scene_g, config, mesh, ids_g, np.int32(r * n_sample)
                )
            acc.block_until_ready()

        run()  # compile
        best = np.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            run()
            best = min(best, time.perf_counter() - t0)
        return (n_pix * n_rounds * n_sample) / best

    # single device (local) — the per-chip baseline
    single_mesh = Mesh(
        np.asarray(jax.local_devices()[:1]).reshape(1, 1), ("tile", "sample")
    )
    # in a multi-process run every process must participate in every
    # collective program; the single-device baseline is process-local and
    # runs identically (and concurrently) on each process.
    paths_1 = _bench(single_mesh)

    full_mesh = make_multihost_mesh()
    n_dev = full_mesh.devices.size
    paths_n = _bench(full_mesh) if n_dev > 1 else paths_1

    results = {
        "n_devices": int(n_dev),
        "n_processes": int(jax.process_count()),
        "paths_per_s_1dev": float(paths_1),
        "paths_per_s_full": float(paths_n),
        "scaling_efficiency": float(paths_n / (paths_1 * n_dev)),
        "config": {
            "width": config.width,
            "height": config.height,
            "spp": spp,
            "integrator": config.integrator,
        },
    }
    if out_path and jax.process_index() == 0:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
    return results
