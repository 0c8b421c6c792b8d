"""Golden-image self-regression: fixed-seed renders vs committed EXRs.

The own-render analog of the reference's golden `scenes/` suite (SURVEY
§4.3): any silent estimator/sampler/kernel drift fails here with a pixel
diff, not a statistics shift. Goldens are generated by tools/gen_golden.py
through the XLA integrators and committed; the renders are
deterministic per (pixel, sample) seed, so the tolerance only absorbs
cross-platform FP association noise.
"""

from pathlib import Path

import numpy as np
import pytest

GOLDEN = Path(__file__).resolve().parent / "golden"


def _cases():
    import tools.gen_golden as gg

    return list(gg.configs())


@pytest.mark.heavy
def test_golden_images_unchanged():
    from optix_renderer_tpu.render.render import render
    from optix_renderer_tpu.utils import imageio as iio

    assert GOLDEN.exists(), "run tools/gen_golden.py to create the suite"
    for name, scene, config, spp in _cases():
        ref = iio.read_exr(str(GOLDEN / f"{name}.exr"))[..., :3]
        out = render(scene, config, sample_count=spp)["composite"]
        err = np.max(np.abs(out - ref) / (np.abs(ref) + 1e-2))
        assert err < 1e-3, f"{name}: golden drift {err:.2e}"
