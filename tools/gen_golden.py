"""Generate the golden-image regression suite (tests/golden/*.exr).

Fixed-seed renders of the preset scene matrix through the XLA integrators
on CPU — the committed analog of the reference's golden
`scenes/` EXRs (SURVEY §4.3). tests/test_golden.py re-renders and asserts
drift < 1e-3. Regenerate ONLY for intentional estimator changes:

    PYTHONPATH=. python tools/gen_golden.py
"""
import dataclasses
from pathlib import Path

GOLDEN = Path(__file__).resolve().parent.parent / "tests" / "golden"


def configs():
    from optix_renderer_tpu.scene.presets import (
        make_absorbing_sphere,
        make_cornell_box,
    )

    for integ in ("path_mats", "path_mis", "direct_mis", "normals"):
        scene, config, _ = make_cornell_box(width=64, height=48, spp=1,
                                            integrator=integ)
        config = dataclasses.replace(config, max_depth=4, rfilter="gaussian")
        yield f"cbox_{integ}", scene, config, 8
    scene, config, _ = make_absorbing_sphere(width=48, height=48, spp=1,
                                             integrator="path_vol_mis")
    config = dataclasses.replace(config, max_depth=6)
    yield "absorb_vol_mis", scene, config, 8


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    from optix_renderer_tpu.render.render import render
    from optix_renderer_tpu.utils import imageio as iio
    from optix_renderer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(min_compile_secs=1.0)

    GOLDEN.mkdir(exist_ok=True)
    for name, scene, config, spp in configs():
        out = render(scene, config, sample_count=spp)
        path = GOLDEN / f"{name}.exr"
        iio.write_exr(path, out["composite"])
        print(f"{name}: mean={out['composite'].mean():.5f} → {path}")


if __name__ == "__main__":
    main()
