"""Smoke test of the renderer on NVIDIA GPUs: the main path, once, at full size.

    python chip_smoke.py               # eight phases on one card
    python chip_smoke.py --four-cards  # render_sharded over four cards, only

Every phase runs in this one process: a second JAX process could not get the
card's memory. A phase that fails raises, so the script exits non-zero and
never prints its last line, the JSON object
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}`.
Without a GPU it stops before rendering anything. Timings are wall clock
around work that ends in a host fetch, after one warm-up, and every timing
line names the card and its power limit.

Reference renders run on the CPU device of this same process, at the same
(pixel, sample) seeds, so each comparison holds the card to the plain XLA:CPU
result of the same program.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

PHASES = ("device", "cornell", "golden", "mesh", "heterog", "cli", "grad", "sharded")
FOUR_CARD_PHASES = ("sharded4",)

# Cornell box, BASELINE.json config 2: 800×600, path_mis, depth 16, box
# filter; 16 spp (cut from 512 to fit the run's time limit).
CORNELL = dict(width=800, height=600, integrator="path_mis", max_depth=16, rfilter="box")
CORNELL_SPP = 16
SUBSET = 1 << 14  # pixels in a card-vs-CPU comparison
# The goldens were rendered by XLA:CPU. On the card a few of their 8-spp
# paths branch differently (see below), and each such path moves the pixels
# of one filter footprint (4x4 for their gaussian filter), so the test's
# max-drift bound of 1e-3 holds per pixel on this share of pixels instead of
# on all of them: 0.5% of 64x48 is 15 pixels, one to four footprints. The
# phase prints the drifting pixels' clusters to show where they sit.
GOLDEN_SHARE = 0.995
MESH_RAYS = 1 << 17  # primary rays in the LBVH-vs-brute-force check
CLI_SIZE = (800, 600)

# Card-vs-CPU films. fp association differs between XLA:GPU and XLA:CPU, so
# a few paths take another branch (a Russian-roulette or dielectric choice
# at a threshold) and land far apart; every other pixel agrees to float
# rounding. So the check is a share of pixels within a relative bound.
PIXEL_RTOL, PIXEL_ATOL, PIXEL_SHARE = 1e-3, 1e-4, 0.99


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only render_sharded on a four-card mesh against render()",
    )
    args = ap.parse_args(argv)
    args.phases = FOUR_CARD_PHASES if args.four_cards else PHASES
    args.count = 4 if args.four_cards else 1
    return args


def film_agreement(a, b, rtol: float, atol: float) -> float:
    """Share of pixels whose every channel agrees within atol + rtol·|b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    close = np.abs(a - b) <= atol + rtol * np.abs(b)
    if close.ndim > 1:  # last axis holds a pixel's channels
        close = close.reshape(-1, close.shape[-1]).all(axis=1)
    return float(close.mean())


def check_films(name: str, a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL, min_share=PIXEL_SHARE) -> str:
    """Raise unless `a` and `b` have one shape, are finite, and agree on at
    least `min_share` of pixels; returns a one-line summary."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise AssertionError(f"{name}: shapes differ, {a.shape} vs {b.shape}")
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        raise AssertionError(f"{name}: non-finite values")
    share = film_agreement(a, b, rtol, atol)
    mean_rel = float(np.abs(a - b).mean() / max(np.abs(b).mean(), 1e-12))
    msg = (f"{name}: {share:.5f} of pixels within rtol {rtol:g} atol {atol:g} "
           f"(need {min_share}), mean relative difference {mean_rel:.3e}")
    if share < min_share:
        raise AssertionError(msg)
    return msg


def drift_clusters(mask) -> list[tuple[int, int, int]]:
    """8-connected clusters of the True pixels of a 2-D mask, largest first:
    (pixels, rows spanned, columns spanned) each."""
    from scipy import ndimage

    labels, _ = ndimage.label(mask, structure=np.ones((3, 3)))
    clusters = [(int((labels[sl] == i).sum()), sl[0].stop - sl[0].start, sl[1].stop - sl[1].start)
                for i, sl in enumerate(ndimage.find_objects(labels), start=1)]
    return sorted(clusters, reverse=True)


class Card:
    """What every timing line names: the card and its power limit."""

    label = "card not read"


def timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def report_time(what: str, seconds: float, paths: int | None = None) -> None:
    rate = f", {paths / seconds / 1e6:.3f} Mpaths/s" if paths else ""
    print(f"  time {what}: {seconds:.3f} s{rate} [{Card.label}]", flush=True)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(ctx) -> None:
    import jax

    from optix_renderer_tpu.utils.gpu import query_cards

    devs = jax.devices()
    print(f"  device_kind {devs[0].device_kind}, count {len(devs)}, "
          f"jax {jax.__version__}")
    smi, cards = query_cards()
    for line in smi.splitlines():
        print(line)
    Card.label = f"{cards[0][0]}, power limit {cards[0][1]}"


def _shape(config) -> str:
    return f"{config.width}x{config.height} {config.integrator} depth {config.max_depth}"


def _cornell(spp=CORNELL_SPP, **over):
    import dataclasses

    from optix_renderer_tpu.scene.presets import make_cornell_box

    scene, config, _ = make_cornell_box(
        width=CORNELL["width"], height=CORNELL["height"], spp=spp,
        integrator=CORNELL["integrator"],
    )
    cfg = dict(max_depth=CORNELL["max_depth"], rfilter=CORNELL["rfilter"], sample_count=spp)
    cfg.update(over)
    return scene, dataclasses.replace(config, **cfg)


def subset_vs_cpu(name, scene, config, cpu, seed=0) -> str:
    """One sample of a fixed random pixel subset through `render_round`, on
    the card and on the CPU device, compared pixel by pixel."""
    import jax
    import jax.numpy as jnp

    from optix_renderer_tpu.render.film import to_bitmap
    from optix_renderer_tpu.render.render import render_round

    n_pix = config.width * config.height
    ids = np.sort(np.random.default_rng(seed).choice(n_pix, min(SUBSET, n_pix), replace=False))
    ids = ids.astype(np.int32)
    films = []
    for dev in (jax.devices()[0], cpu):
        sc, pix, s0 = jax.device_put((scene, jnp.asarray(ids), jnp.int32(0)), dev)
        films.append(np.asarray(to_bitmap(render_round(sc, config, pix, s0))))
    # box filter: every sample lands in its own pixel; compare those pixels
    gpu, ref = (f[:, ids // config.width, ids % config.width] for f in films)
    return check_films(name, gpu[0], ref[0])


def phase_cornell(ctx) -> None:
    from optix_renderer_tpu.render.render import render

    scene, config = _cornell()
    n_paths = config.width * config.height * CORNELL_SPP
    films = {}
    for mode, wavefront in (("scan", False), ("wavefront", True)):
        # compile; 2 spp already fills the regeneration lane pool
        render(scene, config, sample_count=2, wavefront=wavefront)
        out, dt = timed(lambda: render(scene, config, sample_count=CORNELL_SPP, wavefront=wavefront))
        report_time(f"cornell {_shape(config)} {CORNELL_SPP} spp, {mode}", dt, n_paths)
        assert out["spp_done"] == CORNELL_SPP, out["spp_done"]
        films[mode] = out["composite"]
    print("  A " + check_films("scan vs wavefront", films["wavefront"], films["scan"]))
    print("  B " + subset_vs_cpu("card vs CPU, 16k-pixel subset", scene, config, ctx["cpu"]))
    ctx["cornell"] = (scene, config)


def phase_golden(ctx) -> None:
    import tools.gen_golden as gg

    from optix_renderer_tpu.render.render import render
    from optix_renderer_tpu.utils import imageio as iio

    for name, scene, config, spp in gg.configs():
        ref = iio.read_exr(str(gg.GOLDEN / f"{name}.exr"))[..., :3]
        out = render(scene, config, sample_count=spp)["composite"]
        # the golden test's own metric (tests/test_golden.py), per pixel
        err = (np.abs(out - ref) / (np.abs(ref) + 1e-2)).max(axis=-1)
        within = float((err < 1e-3).mean())
        clusters = " ".join(f"{n}px/{r}x{c}" for n, r, c in drift_clusters(err >= 1e-3))
        print(f"  {name}: max golden drift {err.max():.3e}, "
              f"{within:.5f} of pixels under 1e-3 (need {GOLDEN_SHARE}); "
              f"drifting pixels' clusters (pixels/rows x columns): {clusters or 'none'}")
        assert np.isfinite(out).all(), name
        assert within >= GOLDEN_SHARE, f"{name}: golden drift on {1 - within:.4f} of pixels"


def brute_closest_hit(geom, ray, ray_chunk=8192, tri_chunk=4096):
    """Plain reference for the LBVH: every ray against every triangle, in
    chunks so the [rays, triangles] tables stay small."""
    import jax
    import jax.numpy as jnp

    from optix_renderer_tpu.ops.intersect import _mt_jnp

    n_tri = geom.tri_v0.shape[0]
    pad = -n_tri % tri_chunk
    # padding triangles are degenerate (zero edges) and never hit
    tris = [jnp.pad(a, ((0, pad), (0, 0))).reshape(-1, tri_chunk, 3)
            for a in (geom.tri_v0, geom.tri_e1, geom.tri_e2)]
    starts = jnp.arange(tris[0].shape[0], dtype=jnp.int32) * tri_chunk

    def one_chunk(rays):
        o, d, mint, maxt = rays

        def step(best, xs):
            t_best, id_best = best
            v0, e1, e2, base = xs
            t, _, _, idf = _mt_jnp(o, d, mint, t_best, v0, e1, e2)
            hit = idf >= 0
            return (jnp.where(hit, t, t_best),
                    jnp.where(hit, base + idf.astype(jnp.int32), id_best)), None

        init = (maxt, jnp.full(o.shape[0], -1, jnp.int32))
        (t, idx), _ = jax.lax.scan(step, init, (*tris, starts))
        return t, idx

    n = ray.o.shape[0]
    maxt = jnp.where(jnp.isinf(ray.maxt), jnp.float32(3.4e38), ray.maxt)
    rays = tuple(a.reshape(n // ray_chunk, ray_chunk, *a.shape[1:])
                 for a in (ray.o, ray.d, ray.mint, maxt))
    t, idx = jax.lax.map(one_chunk, rays)
    return t.reshape(n), idx.reshape(n)


def phase_mesh(ctx) -> None:
    import dataclasses

    import jax
    import jax.numpy as jnp

    from optix_renderer_tpu.ops import camera as camera_ops
    from optix_renderer_tpu.ops.intersect import PRIM_TRI, intersect
    from optix_renderer_tpu.render.render import render
    from optix_renderer_tpu.scene.presets import make_tessellated_cornell

    scene, config, _ = make_tessellated_cornell(width=400, height=300, spp=4)
    config = dataclasses.replace(config, max_depth=8)
    n_tri = int(scene.geometry.tri_v0.shape[0])
    assert scene.geometry.bvh.node_min.shape[0] > 0, "mesh must take the LBVH"

    n = MESH_RAYS
    rng = np.random.default_rng(1)
    pos = jnp.asarray(rng.uniform(0, 1, (n, 2)) * np.array([800, 600]), jnp.float32)
    ray, _ = camera_ops.sample_ray(scene.camera, 800, 600, pos, jnp.zeros((n, 2)))

    @jax.jit
    def lbvh(geom, ray):
        hit = intersect(geom, ray)
        return hit.t, jnp.where(hit.prim_kind == PRIM_TRI, hit.prim_id, -1)

    t_b, id_b = (np.asarray(a) for a in lbvh(scene.geometry, ray))
    t_r, id_r = (np.asarray(a) for a in jax.jit(brute_closest_hit)(scene.geometry, ray))
    same = (id_b == id_r) & (np.abs(t_b - t_r) <= 1e-4 * np.maximum(1.0, np.abs(t_r)))
    share = float(same.mean())
    print(f"  LBVH vs brute force on {n_tri} triangles, {n} primary rays: "
          f"{share:.5f} agree on (t, prim_id), {float((id_r >= 0).mean()):.3f} hit")
    assert share >= 0.999, share

    render(scene, config, sample_count=1)  # compile
    out, dt = timed(lambda: render(scene, config, sample_count=4))
    report_time(f"tessellated cornell {n_tri} tris {_shape(config)} 4 spp", dt,
                config.width * config.height * 4)
    assert np.isfinite(out["composite"]).all()


def phase_heterog(ctx) -> None:
    from optix_renderer_tpu.render.render import render
    from optix_renderer_tpu.scene.presets import make_procedural_smoke

    scene, config, _ = make_procedural_smoke(width=400, height=300, spp=1, max_depth=8)
    assert config.integrator == "path_vol_mis", config.integrator
    render(scene, config, sample_count=1)  # compile
    out, dt = timed(lambda: render(scene, config, sample_count=1))
    report_time(f"procedural smoke 64^3 {_shape(config)} 1 spp", dt,
                config.width * config.height)
    assert np.isfinite(out["composite"]).all() and out["composite"].max() > 0
    print("  " + subset_vs_cpu("card vs CPU, 16k-pixel subset", scene, config, ctx["cpu"]))


def phase_cli(ctx) -> None:
    from optix_renderer_tpu import cli
    from optix_renderer_tpu.scene.presets import write_cornell_xml
    from optix_renderer_tpu.utils import imageio as iio

    with tempfile.TemporaryDirectory() as d:
        xml = write_cornell_xml(Path(d), *CLI_SIZE, spp=4)
        rc, dt = timed(lambda: cli.main(["render", str(xml)]))
        assert rc == 0, rc
        exr, png = iio.read_exr(Path(d) / "cbox.exr"), iio.read_png(Path(d) / "cbox.png")
    w, h = CLI_SIZE
    report_time(f"CLI render {w}x{h} path_mis 4 spp, compile included", dt)
    assert exr.shape == (h, w, 3) and np.isfinite(exr).all() and exr.max() > 0
    assert png.shape == (h, w, 3) and png.max() > 0
    print(f"  EXR {exr.shape} mean {exr.mean():.4f}; PNG {png.shape} mean {png.mean():.2f}")


def phase_grad(ctx) -> None:
    import jax
    import jax.numpy as jnp

    from optix_renderer_tpu.render.film import to_bitmap
    from optix_renderer_tpu.render.render import render_round

    scene, config = _cornell(spp=1, width=128, height=96, max_depth=6)
    ids = jnp.arange(128 * 96, dtype=jnp.int32)

    def loss(albedo, scene, ids):
        sc = scene._replace(textures=scene.textures._replace(value=albedo))
        img = to_bitmap(render_round(sc, config, ids, jnp.int32(0)))[0]
        return jnp.mean(img ** 2)

    grad = jax.jit(jax.grad(loss))
    grads = []
    for dev in (jax.devices()[0], ctx["cpu"]):
        sc, pix = jax.device_put((scene, ids), dev)
        grads.append(np.asarray(grad(sc.textures.value, sc, pix)))
    g_gpu, g_cpu = grads
    rel = float(np.linalg.norm(g_gpu - g_cpu) / np.linalg.norm(g_cpu))
    print(f"  d(loss)/d(albedo) over {g_cpu.shape[0]} textures: card vs CPU "
          f"relative difference {rel:.3e} (|g| {np.linalg.norm(g_cpu):.4e})")
    assert np.isfinite(g_gpu).all() and np.linalg.norm(g_cpu) > 0
    assert rel < 1e-2, rel


def phase_sharded(ctx, n_devices=1, spp=2) -> None:
    from optix_renderer_tpu.parallel.shard import make_mesh, render_sharded
    from optix_renderer_tpu.render.render import render

    scene, config = ctx.get("cornell") or _cornell()
    mesh = make_mesh(n_devices)
    assert mesh.devices.size == n_devices, mesh
    n_paths = config.width * config.height * spp
    outs = {}
    for name, fn in (("render", lambda: render(scene, config, sample_count=spp)),
                     (f"render_sharded {n_devices} card(s)",
                      lambda: render_sharded(scene, config, mesh, sample_count=spp))):
        fn()  # compile
        out, dt = timed(fn)
        report_time(f"cornell {_shape(config)} {spp} spp, {name}", dt, n_paths)
        assert out["spp_done"] == spp, out["spp_done"]
        outs[name] = out["composite"]
    single, sharded = outs.values()
    print("  " + check_films(f"{n_devices}-card sharded vs render()", sharded, single))


def phase_sharded4(ctx) -> None:
    phase_sharded(ctx, n_devices=4, spp=8)


def main(argv=None) -> int:
    args = parse_args(argv)
    plat = os.environ.get("JAX_PLATFORMS")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"  # the reference device
    import jax

    from optix_renderer_tpu.utils.compile_cache import enable_compile_cache
    from optix_renderer_tpu.utils.gpu import require_gpu

    require_gpu(jax.devices(), args.count)

    enable_compile_cache()
    ctx = {"cpu": jax.devices("cpu")[0]}
    phases = ("device",) + tuple(p for p in args.phases if p != "device")
    t_all = time.perf_counter()
    for name in phases:
        print(f"[{name}]", flush=True)
        _, dt = timed(lambda: globals()[f"phase_{name}"](ctx))
        print(f"[{name}] passed in {dt:.1f} s", flush=True)
    print(f"all phases passed in {time.perf_counter() - t_all:.1f} s [{Card.label}]")
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
