"""Heterogeneous media: grid sampling, delta/ratio tracking, render parity.

Validation strategy mirrors SURVEY.md §4: the analytic homogeneous medium is
the reference implementation for the voxel-grid trackers — on a *constant*
density grid, delta tracking and ratio tracking must reproduce the analytic
exponential statistics, and a full heterog render must match the equivalent
homog render.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from optix_renderer_tpu.ops import medium as medium_ops
from optix_renderer_tpu.ops import volume_grid as vg
from optix_renderer_tpu.render import sampler as smp
from optix_renderer_tpu.scene.build import load_scene
from optix_renderer_tpu.scene.data import MediumType


SIGMA_T = 4.0  # achromatic extinction for the constant-density tests


def _heterog_scene(tmp_path, density, sigma_a=1.5, sigma_s=2.5, extra=""):
    """Cube [-0.5,0.5]^3 with a heterog medium from an npz grid."""
    np.savez(
        tmp_path / "vol.npz",
        density=density,
        bbox_min=np.array([-0.5, -0.5, -0.5], np.float32),
        bbox_max=np.array([0.5, 0.5, 0.5], np.float32),
    )
    # unit cube mesh (12 tris), no BSDF → pass-through medium boundary
    _write_cube_obj(tmp_path / "cube.obj")
    xml = f"""
<scene>
  <integrator type="path_vol_mis"/>
  <sampler type="independent"><integer name="sampleCount" value="4"/></sampler>
  <camera type="perspective">
    <float name="fov" value="35"/>
    <transform name="toWorld"><lookat target="0,0,0" origin="0,-2.5,0" up="0,0,1"/></transform>
    <integer name="width" value="48"/><integer name="height" value="48"/>
  </camera>
  <shape type="obj">
    <string name="filename" value="cube.obj"/>
    <medium type="heterog">
      <color name="sigma_a" value="{sigma_a},{sigma_a},{sigma_a}"/>
      <color name="sigma_s" value="{sigma_s},{sigma_s},{sigma_s}"/>
      <volume type="volume"><string name="filename" value="vol.npz"/></volume>
    </medium>
  </shape>
  {extra}
  <emitter type="point">
    <point name="position" value="0,-2,2"/>
    <color name="power" value="400,400,400"/>
  </emitter>
</scene>
"""
    f = tmp_path / "scene.xml"
    f.write_text(xml)
    return load_scene(f)


def _write_cube_obj(path):
    v = [
        (-0.5, -0.5, -0.5), (0.5, -0.5, -0.5), (0.5, 0.5, -0.5), (-0.5, 0.5, -0.5),
        (-0.5, -0.5, 0.5), (0.5, -0.5, 0.5), (0.5, 0.5, 0.5), (-0.5, 0.5, 0.5),
    ]
    # outward winding — medium entering/exit tests follow the geometric
    # normal, as in the reference (dot(wi, n_g) sign, path_vol_mis.cpp:70-77)
    faces = [
        (1, 3, 2), (1, 4, 3), (5, 6, 7), (5, 7, 8),
        (1, 6, 5), (1, 2, 6), (2, 7, 6), (2, 3, 7),
        (3, 8, 7), (3, 4, 8), (4, 5, 8), (4, 1, 5),
    ]
    with open(path, "w") as f:
        for p in v:
            f.write("v %f %f %f\n" % p)
        for fc in faces:
            f.write("f %d %d %d\n" % fc)


@pytest.fixture(scope="module")
def const_scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("heterog")
    density = np.ones((16, 16, 16), np.float32)
    return _heterog_scene(tmp, density, sigma_a=SIGMA_T / 2, sigma_s=SIGMA_T / 2)


def test_density_trilinear(const_scene):
    scene, config, _ = const_scene
    med_id = jnp.zeros(64, jnp.int32)
    # constant grid → density 1 strictly inside, 0 outside
    p_in = jnp.asarray(np.random.default_rng(0).uniform(-0.4, 0.4, (64, 3)), jnp.float32)
    d = np.asarray(vg.density_at(scene.media, med_id, p_in))
    np.testing.assert_allclose(d, 1.0, atol=1e-5)
    p_out = p_in + jnp.array([2.0, 0.0, 0.0])
    d_out = np.asarray(vg.density_at(scene.media, med_id, p_out))
    np.testing.assert_allclose(d_out, 0.0, atol=1e-7)


def test_delta_tracking_matches_analytic(const_scene):
    scene, config, _ = const_scene
    n = 8192
    med_id = jnp.zeros(n, jnp.int32)
    s = smp.make_sampler(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(3))
    ro = jnp.tile(jnp.array([0.0, -0.5, 0.0]), (n, 1))
    rd = jnp.tile(jnp.array([0.0, 1.0, 0.0]), (n, 1))
    t_max = jnp.full(n, 1.0)
    s, t_event, _w_score = vg.delta_track(scene.media, med_id, s, ro, rd, t_max)
    te = np.asarray(t_event)
    # escape probability through L=1 of σt=4: exp(-4)
    p_escape = float(np.mean(~np.isfinite(te)))
    assert abs(p_escape - np.exp(-SIGMA_T)) < 0.01
    # conditional mean of truncated exponential on [0,1]
    col = te[np.isfinite(te)]
    m_expect = 1.0 / SIGMA_T - np.exp(-SIGMA_T) / (1 - np.exp(-SIGMA_T))
    assert abs(col.mean() - m_expect) < 0.01


def test_ratio_tracking_matches_analytic(const_scene):
    scene, config, _ = const_scene
    n = 8192
    med_id = jnp.zeros(n, jnp.int32)
    s = smp.make_sampler(jnp.arange(n, dtype=jnp.uint32), jnp.uint32(9))
    o = jnp.tile(jnp.array([0.0, -0.5, 0.0]), (n, 1))
    d = jnp.tile(jnp.array([0.0, 1.0, 0.0]), (n, 1))
    dist = jnp.full(n, 0.6)
    s, tr = medium_ops.transmittance_est(scene.media, med_id, s, o, d, dist)
    tr = np.asarray(tr)[:, 0]
    expected = np.exp(-SIGMA_T * 0.6)
    assert abs(tr.mean() - expected) / expected < 0.05
    # unbiasedness sanity: estimator is within [0,1]
    assert tr.min() >= 0.0 and tr.max() <= 1.0 + 1e-6


def test_heterog_render_matches_homog(tmp_path):
    """Constant-density heterog cube == homog cube (same σ), path_vol_mats."""
    from optix_renderer_tpu.render.render import render

    density = np.ones((8, 8, 8), np.float32)
    scene_h, config, _ = _heterog_scene(tmp_path, density, sigma_a=1.0, sigma_s=3.0)
    out_het = render(scene_h, dataclasses.replace(config, max_depth=8), sample_count=24)

    # same scene, homog medium
    xml = (tmp_path / "scene.xml").read_text().replace(
        '<medium type="heterog">',
        '<medium type="homog">',
    )
    xml = xml.replace(
        '<volume type="volume"><string name="filename" value="vol.npz"/></volume>', ""
    )
    f2 = tmp_path / "scene_homog.xml"
    f2.write_text(xml)
    scene_g, config_g, _ = load_scene(f2)
    out_hom = render(scene_g, dataclasses.replace(config_g, max_depth=8), sample_count=24)

    m_het = float(out_het["composite"].mean())
    m_hom = float(out_hom["composite"].mean())
    assert m_het > 0
    assert abs(m_het - m_hom) / m_hom < 0.1, (m_het, m_hom)


def test_lane_estimate_independent_of_its_batch():
    """A pixel's heterogeneous-medium estimate depends on its own
    (pixel, sample) stream only, not on which other lanes share its
    wavefront: the tracking loops run until the batch's longest walk ends,
    and a lane that is done must not draw further numbers."""
    from optix_renderer_tpu.render.film import to_bitmap
    from optix_renderer_tpu.render.render import render_round
    from optix_renderer_tpu.scene.presets import make_procedural_smoke

    scene, config, _ = make_procedural_smoke(width=24, height=18, grid=16, max_depth=4)
    n_pix = config.width * config.height
    full = np.asarray(to_bitmap(render_round(
        scene, config, jnp.arange(n_pix, dtype=jnp.int32), jnp.int32(0))))
    ids = np.arange(0, n_pix, 7, dtype=np.int32)
    part = np.asarray(to_bitmap(render_round(scene, config, jnp.asarray(ids), jnp.int32(0))))
    ys, xs = ids // config.width, ids % config.width
    assert full[0].max() > 0
    np.testing.assert_allclose(part[:, ys, xs], full[:, ys, xs], rtol=1e-5, atol=1e-6)
