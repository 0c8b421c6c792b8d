"""chip_smoke.py's logic, which needs no GPU: the platform check and the
card line (utils/gpu.py), the film comparison, the choice of phases and the
cache rule."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import chip_smoke as cs
from optix_renderer_tpu.utils import compile_cache, gpu

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize(
    "platform,n,count",
    [("cpu", 8, 1), ("gpu", 1, 4)],
    ids=["cpu-refused", "too-few-gpus"],
)
def test_require_gpu_refuses(platform, n, count):
    with pytest.raises(SystemExit):
        gpu.require_gpu([SimpleNamespace(platform=platform)] * n, count)


def test_require_gpu_refuses_this_cpu_backend():
    import jax

    with pytest.raises(SystemExit, match="needs a GPU"):
        gpu.require_gpu(jax.devices())


def test_require_gpu_accepts_gpus():
    gpu.require_gpu([SimpleNamespace(platform="gpu")] * 4, 4)


def _film(seed=0):
    return np.random.default_rng(seed).uniform(0.1, 2.0, (48, 64, 3)).astype(np.float32)


def _diverge(share):
    def f(a):
        a = a.copy()
        flat = a.reshape(-1, 3)
        flat[: int(share * len(flat))] += 1.0  # a few paths took another branch
        return a
    return f


@pytest.mark.parametrize(
    "mutate,ok",
    [
        (lambda a: a, True),
        (lambda a: a * (1.0 + 1e-5), True),
        (_diverge(0.005), True),
        (_diverge(0.05), False),
        (lambda a: a * 1.01, False),
        (lambda a: np.where(np.arange(a.size).reshape(a.shape) == 7, np.nan, a), False),
        (lambda a: a[:-1], False),
    ],
    ids=["identical", "rounding", "few-diverged", "many-diverged", "perturbed", "nan", "shape"],
)
def test_check_films(mutate, ok):
    ref = _film()
    if ok:
        assert "of pixels within" in cs.check_films("t", mutate(ref), ref)
    else:
        with pytest.raises(AssertionError):
            cs.check_films("t", mutate(ref), ref)


def test_film_agreement_counts_pixels_not_channels():
    ref = np.ones((10, 3))
    a = ref.copy()
    a[0, 2] = 5.0  # one channel of one pixel
    assert cs.film_agreement(a, ref, 1e-3, 0.0) == pytest.approx(0.9)


@pytest.mark.parametrize(
    "points,clusters",
    [
        ([], []),
        ([(1, 1), (2, 2), (2, 3)], [(3, 2, 3)]),
        ([(0, 0), (0, 1), (5, 5), (9, 0), (9, 1), (10, 1)], [(3, 2, 2), (2, 1, 2), (1, 1, 1)]),
    ],
    ids=["none", "one-diagonal", "three"],
)
def test_drift_clusters(points, clusters):
    mask = np.zeros((12, 8), bool)
    for y, x in points:
        mask[y, x] = True
    assert cs.drift_clusters(mask) == clusters


@pytest.mark.parametrize(
    "text,cards",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W\n", [("NVIDIA H100 80GB HBM3", "700.00 W")]),
        ("NVIDIA H100 80GB HBM3, 400.00 W\n" * 4, [("NVIDIA H100 80GB HBM3", "400.00 W")] * 4),
    ],
    ids=["one-card", "four-cards"],
)
def test_parse_smi(text, cards):
    assert gpu.parse_smi(text) == cards


def test_parse_smi_rejects_other_output():
    with pytest.raises(ValueError):
        gpu.parse_smi("No devices were found")


@pytest.mark.parametrize(
    "argv,phases,count",
    [([], cs.PHASES, 1), (["--four-cards"], ("sharded4",), 4)],
    ids=["one-card", "four-cards"],
)
def test_phase_selection(argv, phases, count):
    args = cs.parse_args(argv)
    assert tuple(args.phases) == tuple(phases)
    assert args.count == count
    for name in args.phases:
        assert callable(getattr(cs, f"phase_{name}"))


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert compile_cache.cache_dir() == str(tmp_path / "c")


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache.cache_dir() == str(REPO / ".jax_cache")
    assert compile_cache.cache_dir() == compile_cache.cache_dir()


def test_procedural_density_is_seeded():
    from optix_renderer_tpu.scene.presets import procedural_density

    a, b = procedural_density(16, seed=3), procedural_density(16, seed=3)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (16, 16, 16) and a.dtype == np.float32
    assert a.max() == pytest.approx(1.0) and a.min() >= 0.0
    assert not np.array_equal(a, procedural_density(16, seed=4))


def test_script_alone_on_cpu_fails_without_result(tmp_path):
    """Alone in a directory and without a GPU, the script exits non-zero
    and prints no result line."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    for line in r.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
