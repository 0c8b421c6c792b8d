"""Tests for image I/O, OBJ loading, XML parsing, and scene compilation."""

import numpy as np
import pytest

from optix_renderer_tpu.scene.parser import load_from_string
from optix_renderer_tpu.scene.build import build_scene
from optix_renderer_tpu.scene.obj import load_obj
from optix_renderer_tpu.utils import imageio as iio


def test_exr_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((13, 17, 3)).astype(np.float32) * 10.0
    p = tmp_path / "t.exr"
    iio.write_exr(p, img)
    back = iio.read_exr(p)
    np.testing.assert_array_equal(back, img)


def test_exr_rgba_roundtrip(tmp_path):
    img = np.random.default_rng(1).random((5, 7, 4)).astype(np.float32)
    p = tmp_path / "t4.exr"
    iio.write_exr(p, img)
    np.testing.assert_array_equal(iio.read_exr(p), img)


def test_png_roundtrip(tmp_path):
    img = np.clip(np.random.default_rng(2).random((8, 8, 3)), 0, 1).astype(np.float32)
    p = tmp_path / "t.png"
    iio.write_png(p, img, tonemap=False)
    back = iio.read_image(p)
    np.testing.assert_allclose(back, img, atol=1 / 255)


def test_obj_loader_quads_and_dedup(tmp_path):
    obj = tmp_path / "q.obj"
    obj.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "vn 0 0 1\n"
        "f 1//1 2//1 3//1 4//1\n"
    )
    m = load_obj(obj)
    assert m["F"].shape == (2, 3)  # quad → 2 tris
    assert m["V"].shape == (4, 3)  # corners deduped
    # quad split order (obj.cpp:134-139): (v1,v2,v3) + (v4,v1,v3)
    np.testing.assert_array_equal(m["F"][1], [3, 0, 2])
    np.testing.assert_allclose(m["N"], [[0, 0, 1]] * 4)


def test_obj_transform_applied(tmp_path):
    from optix_renderer_tpu.core import transform as tf

    obj = tmp_path / "t.obj"
    obj.write_text("v 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\n")
    m = load_obj(obj, tf.translate([10, 0, 0]))
    np.testing.assert_allclose(m["V"][0], [11, 0, 0])


def test_parser_full_grammar():
    xml = """
    <scene>
      <integrator type="path_mis"/>
      <camera type="perspective">
        <float name="fov" value="30"/>
        <integer name="width" value="64"/>
        <integer name="height" value="48"/>
        <transform name="toWorld">
          <scale value="-1,1,1"/>
          <lookat target="0, 0.8, 4.4" origin="0, 0.9, 5.4" up="0, 1, 0"/>
        </transform>
      </camera>
      <sampler type="independent"><integer name="sampleCount" value="7"/></sampler>
      <shape type="sphere">
        <point name="center" value="1 2 3"/>
        <float name="radius" value="0.5"/>
        <bsdf type="diffuse"><color name="albedo" value="0.5 0.4 0.3"/></bsdf>
        <emitter type="area"><color name="radiance" value="2 2 2"/></emitter>
      </shape>
      <emitter type="point">
        <color name="power" value="10 10 10"/>
        <point name="position" value="0 1 0"/>
      </emitter>
    </scene>
    """
    root = load_from_string(xml)
    scene, config, extras = build_scene(root)
    assert config.width == 64 and config.height == 48
    assert config.sample_count == 7
    assert config.integrator == "path_mis"
    assert config.n_spheres == 1
    assert config.n_emitters == 2
    # sphere area emitter got geometry info
    em = scene.emitters
    assert int(em.sphere_id[0]) == 0
    assert abs(float(em.area[0]) - 4 * np.pi * 0.25) < 1e-4
    # point light radiance = power/4π
    np.testing.assert_allclose(
        np.asarray(em.radiance[1]), 10.0 / (4 * np.pi), rtol=1e-5
    )


def test_parser_rejects_bad_tags():
    with pytest.raises(ValueError):
        load_from_string("<scene><bogus/></scene>")
    with pytest.raises(ValueError):
        load_from_string("<scene><translate value='1 2 3'/></scene>")


def test_reference_scene_parses(tmp_path):
    """A Cornell box XML in the reference suite's layout (cbox_path_mis.xml:
    OBJ walls, two spheres, one area light, 512 spp) compiles."""
    from optix_renderer_tpu.scene.build import load_scene
    from optix_renderer_tpu.scene.presets import write_cornell_xml

    scene, config, _ = load_scene(write_cornell_xml(tmp_path))
    assert config.n_tris == 12
    assert config.n_spheres == 2
    assert config.n_emitters == 1
    assert config.sample_count == 512
    assert config.integrator == "path_mis"


def test_rfilter_child_parsed_and_changes_film(tmp_path):
    """<rfilter> on the camera reaches RenderConfig (round-3 W2) and a
    mitchell splat measurably differs from the gaussian default."""
    import dataclasses

    import numpy as np
    import jax.numpy as jnp

    from optix_renderer_tpu.scene.build import load_scene
    from optix_renderer_tpu.render.render import render_round

    xml = """
<scene>
  <integrator type="normals"/>
  <camera type="perspective">
    <integer name="width" value="24"/><integer name="height" value="18"/>
    <float name="fov" value="40"/>
    <rfilter type="mitchell"/>
  </camera>
  <shape type="sphere">
    <point name="center" value="0,0,3"/>
    <float name="radius" value="1"/>
  </shape>
</scene>
"""
    f = tmp_path / "s.xml"
    f.write_text(xml)
    scene, config, _ = load_scene(f)
    assert config.rfilter == "mitchell"

    pix = jnp.arange(24 * 18, dtype=jnp.int32)
    img_m = np.asarray(render_round(scene, config, pix, jnp.int32(0)))
    cfg_g = dataclasses.replace(config, rfilter="gaussian")
    img_g = np.asarray(render_round(scene, cfg_g, pix, jnp.int32(0)))
    # the sphere must actually be in view (camera looks along +z): the
    # filters must differ in the RADIANCE channels, not merely the weights
    assert np.abs(img_m[0, ..., :3]).max() > 0
    assert not np.allclose(img_m[0, ..., :3], img_g[0, ..., :3])


def test_denoiser_child_parsed(tmp_path):
    """Scene-level <denoiser type="simple"> lands in RenderConfig with its
    properties (round-3 W3; scene.h denoiser attach)."""
    from optix_renderer_tpu.scene.build import load_scene

    xml = """
<scene>
  <integrator type="normals"/>
  <camera type="perspective">
    <integer name="width" value="8"/><integer name="height" value="8"/>
  </camera>
  <denoiser type="simple">
    <float name="sigma_d" value="6.0"/>
    <float name="sigma_vr" value="1.5"/>
    <integer name="range" value="7"/>
  </denoiser>
</scene>
"""
    f = tmp_path / "s.xml"
    f.write_text(xml)
    _, config, _ = load_scene(f)
    assert config.denoiser == "simple"
    assert config.dprop("sigma_d") == 6.0
    assert config.dprop("sigma_vr") == 1.5
    assert config.dprop("range") == 7
