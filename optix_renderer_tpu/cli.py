"""Command-line interface: render scenes, tonemap EXRs, run warp tests.

Counterpart of the reference executables (CMakeLists.txt:27,147,175):
- `render` = the headless `nori scene.xml` path (src/utils/main.cpp:81-104):
  renders, writes `<scene>.exr` (+ `_variance.exr` for adaptive samplers,
  render.cpp:390-415) and a tonemapped PNG;
- `tonemap` = the `tonemapper` EXR→PNG batch converter (hdrToLdr.cpp:22-40);
- `warptest` = the χ² warp validation suite, headless (warptest.cpp:439-561).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path


def _maybe_init_distributed(args) -> bool:
    """Join the multi-controller runtime when --distributed is set.

    Must run before any other JAX use. Returns True when distributed.
    """
    if not getattr(args, "distributed", False):
        return False
    from optix_renderer_tpu.parallel.multihost import init_distributed

    init_distributed(
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
        local_cpu_devices=args.local_cpu_devices,
    )
    return True


def cmd_render(args) -> int:
    distributed = _maybe_init_distributed(args)

    from optix_renderer_tpu.scene.build import load_scene
    from optix_renderer_tpu.scene.parser import load_from_xml
    from optix_renderer_tpu.utils import imageio as iio

    # <test> roots execute their statistical test instead of rendering —
    # exactly how the reference runs ttest/chi2test scene objects on load
    # (ttest.cpp:81-95, main.cpp `nori scene_with_test.xml`)
    root = load_from_xml(args.scene)
    if root.tag == "test":
        from optix_renderer_tpu.validation import run_xml_test

        report = run_xml_test(root)
        return 0 if report.ok else 1

    scene, config, _ = load_scene(args.scene)
    overrides = {}
    if args.spp:
        overrides["sample_count"] = args.spp
    if args.size:
        w, h = (int(x) for x in args.size.lower().split("x"))
        overrides["width"], overrides["height"] = w, h
    if args.integrator:
        overrides["integrator"] = args.integrator
    if args.depth:
        overrides["max_depth"] = args.depth
    if overrides:
        config = dataclasses.replace(config, **overrides)

    if args.resume and not args.checkpoint:
        print("warning: --resume has no effect without --checkpoint")

    out_base = Path(args.output) if args.output else Path(args.scene).with_suffix("")
    print(
        f"Rendering {args.scene}: {config.width}x{config.height} @ "
        f"{config.sample_count}spp, integrator={config.integrator}"
        + (" [adaptive]" if config.adaptive else "")
    )
    preview_cb = None
    if args.preview_every:
        # progressive preview: periodic partial-film PNG (the GL display
        # path of ImguiScreen.cpp:252-316 as a file-based live view)
        def preview_cb(layers, spp_done):
            iio.write_png(str(out_base) + "_preview.png", layers["composite"])
            if args.verbose:
                print(f"  preview @ {spp_done}spp → {out_base}_preview.png")

    t0 = time.time()
    if config.adaptive and not args.no_adaptive and (distributed or args.sharded or args.serve):
        # adaptive sampling is single-device only (render/adaptive.py); the
        # sharded/distributed/serve loops use uniform rounds — say so instead
        # of silently ignoring the scene's <sampler type="adaptive">
        print(
            "warning: adaptive sampler is ignored under "
            "--sharded/--distributed/--serve (uniform sampling used)"
        )
    if args.serve:
        # live view + edit loop (the ImguiScreen analog, serve.py)
        from optix_renderer_tpu.serve import serve_render

        out = serve_render(scene, config, port=args.port, host=args.host)
    elif distributed:
        import jax

        from optix_renderer_tpu.parallel.multihost import render_multihost

        out = render_multihost(scene, config, verbose=args.verbose)
        if jax.process_index() != 0:
            # the film is replicated; only process 0 writes artifacts
            return 0
    elif args.sharded:
        from optix_renderer_tpu.parallel.shard import render_sharded

        out = render_sharded(
            scene,
            config,
            verbose=args.verbose,
            preview_every=args.preview_every,
            preview_callback=preview_cb,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
        )
    elif config.adaptive and not args.no_adaptive:
        from optix_renderer_tpu.render.adaptive import render_adaptive

        out = render_adaptive(scene, config, verbose=args.verbose)
    else:
        from optix_renderer_tpu.render.render import render

        out = render(
            scene,
            config,
            verbose=args.verbose,
            preview_every=args.preview_every,
            preview_callback=preview_cb,
            checkpoint_path=args.checkpoint,
            checkpoint_every=args.checkpoint_every,
            resume=args.resume,
        )
    dt = time.time() - t0

    exr_path = out_base.with_suffix(".exr")
    iio.write_exr(exr_path, out["composite"])
    iio.write_png(out_base.with_suffix(".png"), out["composite"])
    if "variance" in out:
        var = out["variance"]
        iio.write_exr(
            str(out_base) + "_variance.exr",
            var[..., None].repeat(3, axis=-1),
        )
    # scene-attached denoiser (<denoiser type="simple">, W3) runs without a
    # CLI flag; --denoise overrides the scene's choice
    scene_denoise = {"simple": "bilateral"}.get(config.denoiser, config.denoiser)
    denoise_mode = args.denoise or (scene_denoise or None)
    if denoise_mode:
        import os

        import numpy as np
        import jax.numpy as jnp

        mode = denoise_mode
        if mode == "learned":
            from optix_renderer_tpu.denoise import learned

            ckpt = learned._norm_ckpt_path(args.denoiser_ckpt)
            if not os.path.exists(ckpt):
                # the bilateral filter is the documented fallback when no
                # trained checkpoint exists (denoise/learned.py docstring)
                print(
                    f"warning: denoiser checkpoint {ckpt} not found — "
                    "falling back to bilateral (train one with "
                    "`train-denoiser`)"
                )
                mode = "bilateral"
        if mode == "learned":
            # OptiX-AI-denoiser replacement (OptixState.denoiser.cpp:15-152):
            # RGB+albedo+normal in → RGB out, params from a trained checkpoint
            from optix_renderer_tpu.denoise import learned

            params = learned.load_checkpoint(args.denoiser_ckpt)
            den = learned.apply(
                params,
                jnp.asarray(out["composite"]),
                jnp.asarray(out["albedo"]),
                jnp.asarray(out["normal"]),
            )
        else:
            from optix_renderer_tpu.denoise.bilateral import denoise_bilateral
            from optix_renderer_tpu.render.variance import variance_from_image

            film = np.concatenate(
                [out["composite"], out["weights"][..., None]], axis=-1
            )
            # scene <denoiser> properties (simple.cpp:29-82) when present
            den = denoise_bilateral(
                jnp.asarray(out["composite"]),
                jnp.asarray(variance_from_image(jnp.asarray(film))),
                sigma_d=float(config.dprop("sigma_d", 1.0)),
                sigma_vr=float(config.dprop("sigma_vr", 0.6)),
                inner_range=min(int(config.dprop("range", 1)), 3),
            )
        iio.write_exr(str(out_base) + "_denoised.exr", np.asarray(den))
        iio.write_png(str(out_base) + "_denoised.png", np.asarray(den))

    n_paths = config.width * config.height * config.sample_count
    print(
        f"Done in {dt:.1f}s ({n_paths / dt / 1e6:.2f} Mpaths/s) → {exr_path}"
    )
    return 0


def cmd_train_denoiser(args) -> int:
    """Train the learned denoiser on self-rendered noisy/clean pairs
    (Phase-5 deliverable; replaces OptixState.denoiser.cpp's pretrained
    OptiX model with a checkpoint we own). Trains across MULTIPLE scenes
    (repeat --scene) so the model generalizes past one lighting setup;
    default = the procedural Cornell box."""
    from optix_renderer_tpu.denoise import learned
    from optix_renderer_tpu.scene.presets import make_cornell_box

    scenes = []
    if args.scene:
        from optix_renderer_tpu.scene.build import load_scene

        for path in args.scene:
            scene, config, _ = load_scene(path)
            config = dataclasses.replace(
                config, width=args.size, height=args.size * 3 // 4
            )
            scenes.append((path, scene, config))
    else:
        scene, config, _ = make_cornell_box(
            width=args.size, height=args.size * 3 // 4, spp=1
        )
        scenes.append(("cornell(builtin)", scene, config))

    pairs = []
    for name, scene, config in scenes:
        print(f"rendering training pairs from {name}…")
        pairs += learned.render_training_pairs(
            scene, config, spps=(2, 4), clean_spp=args.clean_spp
        )
    print(f"training on {len(pairs)} pairs, {args.steps} steps…")
    params, losses = learned.train(pairs, steps=args.steps, verbose=True)
    learned.save_checkpoint(args.output, params)
    print(f"loss {losses[0]:.5f} → {losses[-1]:.5f}; saved {args.output}")
    return 0


def cmd_scaling(args) -> int:
    """Scaling-efficiency harness: rays/s on one device vs the full mesh,
    JSON out.
    Run per-host with the --distributed flags on real multi-host topologies."""
    _maybe_init_distributed(args)

    import dataclasses as dc

    from optix_renderer_tpu.parallel.multihost import measure_scaling

    if args.scene:
        from optix_renderer_tpu.scene.build import load_scene

        scene, config, _ = load_scene(args.scene)
    else:
        from optix_renderer_tpu.scene.presets import make_cornell_box

        scene, config, _ = make_cornell_box(
            width=args.size, height=args.size * 3 // 4, spp=args.spp
        )
    config = dc.replace(config, sample_count=args.spp)
    res = measure_scaling(scene, config, spp=args.spp, out_path=args.output)
    print(json.dumps(res, indent=1))
    return 0


def cmd_tonemap(args) -> int:
    import numpy as np

    from optix_renderer_tpu.utils import imageio as iio

    for f in args.files:
        img = iio.read_exr(f)[..., :3] * args.exposure
        out = Path(f).with_suffix(".png")
        iio.write_png(out, img)
        print(f"{f} → {out}")
    return 0


def cmd_test(args) -> int:
    from optix_renderer_tpu.validation import run_xml_test

    report = run_xml_test(args.scene, sample_scale=args.sample_scale)
    return 0 if report.ok else 1


def cmd_warptest(args) -> int:
    """Headless χ² suite over every warp (warptest.cpp without the GUI)."""
    from optix_renderer_tpu.core import warp
    from optix_renderer_tpu.utils.hypothesis import chi2_sphere_test

    cases = [
        ("uniform_sphere", warp.square_to_uniform_sphere, warp.square_to_uniform_sphere_pdf, {}),
        ("uniform_hemisphere", warp.square_to_uniform_hemisphere, warp.square_to_uniform_hemisphere_pdf, {}),
        ("cosine_hemisphere", warp.square_to_cosine_hemisphere, warp.square_to_cosine_hemisphere_pdf, {}),
        ("beckmann a=0.3", lambda u: warp.square_to_beckmann(u, 0.3), lambda d: warp.square_to_beckmann_pdf(d, 0.3), {"theta_res": 20}),
        ("hg g=0.5", lambda u: warp.square_to_henyey_greenstein(u, 0.5), lambda d: warp.square_to_henyey_greenstein_pdf(d, 0.5), {}),
        ("schlick k=0.5", lambda u: warp.square_to_schlick(u, 0.5), lambda d: warp.square_to_schlick_pdf(d, 0.5), {}),
        ("sphere_cap c=0.5", lambda u: warp.square_to_uniform_sphere_cap(u, 0.5), lambda d: warp.square_to_uniform_sphere_cap_pdf(d, 0.5), {"theta_res": 20}),
    ]
    failures = 0
    for name, sample_fn, pdf_fn, kw in cases:
        ok, msg = chi2_sphere_test(sample_fn, pdf_fn, **kw)
        print(f"{'PASS' if ok else 'FAIL'}  {name:24s} {msg}")
        failures += 0 if ok else 1
    return 1 if failures else 0


def _add_distributed_flags(sp) -> None:
    """Multi-host flags (parallel/multihost.py). Same command on every host,
    with the coordinator address, process count and process id given
    explicitly."""
    sp.add_argument(
        "--distributed", action="store_true",
        help="multi-host execution via jax.distributed",
    )
    sp.add_argument("--coordinator", help="process-0 address, e.g. host0:9876")
    sp.add_argument("--num-processes", type=int)
    sp.add_argument("--process-id", type=int)
    sp.add_argument(
        "--local-cpu-devices", type=int,
        help="rehearsal mode: CPU platform with N virtual local devices",
    )


def main(argv=None) -> int:
    # persistent compile cache — the NVRTC PTX-cache analog
    # (OptixState.rtc.cpp:172-208)
    from optix_renderer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(
        prog="optix_renderer_tpu", description=__doc__.split("\n")[0]
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene XML")
    pr.add_argument("scene")
    pr.add_argument("-o", "--output", help="output basename (default: scene name)")
    pr.add_argument("--spp", type=int, help="override sample count")
    pr.add_argument("--size", help="override resolution, e.g. 800x600")
    pr.add_argument("--integrator", help="override integrator")
    pr.add_argument("--depth", type=int, help="max path depth")
    pr.add_argument("--sharded", action="store_true", help="use all devices")
    pr.add_argument(
        "--denoise",
        nargs="?",
        const="bilateral",
        choices=["bilateral", "learned"],
        default=None,
        help="denoise pass: bilateral (simple.cpp) or learned (AI-denoiser analog)",
    )
    pr.add_argument(
        "--denoiser-ckpt",
        default="denoiser.npz",
        help="checkpoint for --denoise=learned",
    )
    pr.add_argument("--no-adaptive", action="store_true")
    pr.add_argument(
        "--preview-every", type=int, default=0, metavar="K",
        help="write a progressive preview PNG every K sample rounds",
    )
    pr.add_argument(
        "--checkpoint", metavar="PATH",
        help="accumulator snapshot path (also written on SIGINT at a round boundary)",
    )
    pr.add_argument(
        "--checkpoint-every", type=int, default=8, metavar="K",
        help="snapshot every K sample rounds (with --checkpoint)",
    )
    pr.add_argument(
        "--resume", action="store_true",
        help="continue from --checkpoint if it exists",
    )
    pr.add_argument(
        "--serve", action="store_true",
        help="live-view web server with pause/resume and live property edits",
    )
    pr.add_argument("--port", type=int, default=8000, help="port for --serve")
    pr.add_argument(
        "--host", default="127.0.0.1",
        help="bind address for --serve (loopback by default; the server is "
        "unauthenticated — use 0.0.0.0 only on trusted networks)",
    )
    pr.add_argument("-v", "--verbose", action="store_true")
    _add_distributed_flags(pr)
    pr.set_defaults(fn=cmd_render)

    ps = sub.add_parser(
        "scaling", help="measure 1-device vs full-mesh scaling efficiency"
    )
    ps.add_argument("--scene", help="scene XML (default: built-in Cornell box)")
    ps.add_argument("--spp", type=int, default=4)
    ps.add_argument("--size", type=int, default=256)
    ps.add_argument("-o", "--output", default="scaling.json")
    _add_distributed_flags(ps)
    ps.set_defaults(fn=cmd_scaling)

    pd = sub.add_parser(
        "train-denoiser", help="train the learned denoiser on self-rendered pairs"
    )
    pd.add_argument(
        "--scene", action="append",
        help="scene XML, repeatable (default: the built-in Cornell box)",
    )
    pd.add_argument("-o", "--output", default="denoiser.npz")
    pd.add_argument("--steps", type=int, default=300)
    pd.add_argument("--size", type=int, default=128)
    pd.add_argument("--clean-spp", type=int, default=256)
    pd.set_defaults(fn=cmd_train_denoiser)

    pt = sub.add_parser("tonemap", help="EXR → PNG")
    pt.add_argument("files", nargs="+")
    pt.add_argument("--exposure", type=float, default=1.0)
    pt.set_defaults(fn=cmd_tonemap)

    pw = sub.add_parser("warptest", help="chi^2 warp validation suite")
    pw.set_defaults(fn=cmd_warptest)

    px = sub.add_parser(
        "test", help="run a <test type=ttest|chi2test> XML (ttest.cpp/chi2test.cpp)"
    )
    px.add_argument("scene")
    px.add_argument(
        "--sample-scale", type=float, default=1.0,
        help="scale all sample counts (fast tier)",
    )
    px.set_defaults(fn=cmd_test)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
