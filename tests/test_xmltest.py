"""Executable <test> scenes — the reference's validation suite, run for real.

Each case writes a <test> XML in the reference's grammar (the ttest and
chi2test scenes of its pa3/pa4 suites) with references known in closed form
or by quadrature here, loads it through the repo's parser and executes the
statistical test, mirroring `nori scene_with_test.xml` (ttest.cpp:81-95,
chi2test.cpp:76-89). Sample counts are kept small for CI.

Scene references: a diffuse sphere of albedo a under a constant environment
L, seen by a camera whose every ray hits it, has mean radiance a·L at every
pixel — the body is convex, so each bounce escapes to the environment.
"""

import numpy as np
import pytest

from optix_renderer_tpu.scene.presets import _uv_sphere_obj
from optix_renderer_tpu.validation import run_xml_test

ALBEDO = 0.5  # sphere albedo; luminance of (a, a, a) under L = 1 is a
SPHERE = (
    '<shape type="sphere"><point name="center" value="0,0,0"/>'
    '<float name="radius" value="1"/>'
    f'<bsdf type="diffuse"><color name="albedo" value="{ALBEDO},{ALBEDO},{ALBEDO}"/></bsdf>'
    "</shape>"
)
# (alpha, kd) per microfacet BSDF, and the incidence angles tested
MICROFACETS = ((0.3, 0.2), (0.6, 0.0))
ANGLES = (0.0, 30.0, 60.0)


def _mesh(name):
    return (
        f'<shape type="obj"><string name="filename" value="{name}.obj"/>'
        f'<bsdf type="diffuse"><color name="albedo" value="{ALBEDO},{ALBEDO},{ALBEDO}"/></bsdf>'
        "</shape>"
    )


def _scene(integrator, shape):
    # 10° field of view at distance 4: every camera ray hits the unit sphere
    return f"""
  <scene>
    <integrator type="{integrator}"/>
    <camera type="perspective">
      <float name="fov" value="10"/>
      <transform name="toWorld"><lookat origin="0,0,4" target="0,0,0" up="0,1,0"/></transform>
      <integer name="width" value="16"/><integer name="height" value="16"/>
    </camera>
    {shape}
    <emitter type="envmap"><color name="radiance" value="1,1,1"/></emitter>
  </scene>"""


def _scene_test(scenes, sample_count=4096):
    refs = ", ".join([str(ALBEDO)] * len(scenes))
    return (
        '<test type="ttest">\n'
        '  <float name="significanceLevel" value="0.01"/>\n'
        f'  <integer name="sampleCount" value="{sample_count}"/>\n'
        f'  <string name="references" value="{refs}"/>\n'
        + "".join(scenes)
        + "\n</test>\n"
    )


def _fresnel(ci, eta_i, eta_t):
    """Unpolarized dielectric Fresnel reflectance (float64, no TIR here)."""
    st2 = (eta_i / eta_t) ** 2 * np.maximum(0.0, 1.0 - ci * ci)
    ct = np.sqrt(np.maximum(0.0, 1.0 - st2))
    rs = (eta_i * ci - eta_t * ct) / (eta_i * ci + eta_t * ct)
    rp = (eta_t * ci - eta_i * ct) / (eta_t * ci + eta_i * ct)
    return np.where(st2 > 1.0, 1.0, 0.5 * (rs * rs + rp * rp))


def _smith_g1(v, m, alpha):
    ct = v[..., 2]
    tan = np.sqrt(np.maximum(0.0, 1.0 - ct * ct)) / ct
    a = 1.0 / (alpha * np.maximum(tan, 1e-12))
    g = np.where(a >= 1.6, 1.0, (3.535 * a + 2.181 * a * a) / (1 + 2.276 * a + 2.577 * a * a))
    return np.where(np.sum(v * m, axis=-1) * ct <= 0.0, 0.0, g)


def microfacet_albedo(theta_deg, alpha, kd, ext_ior=1.0, int_ior=1.5, n=400):
    """∫ f(wi, wo) cosθo dωo of the reference's Beckmann microfacet BSDF
    (microfacet.cpp:93-106), by Gauss–Legendre quadrature in float64."""
    th = np.radians(theta_deg)
    wi = np.array([np.sin(th), 0.0, np.cos(th)])
    x, w = np.polynomial.legendre.leggauss(n)
    ct, ph = 0.5 * (x + 1.0), np.pi * (x + 1.0)
    c, p = np.meshgrid(ct, ph, indexing="ij")
    weight = np.outer(0.5 * w, np.pi * w)
    st = np.sqrt(1.0 - c * c)
    wo = np.stack([st * np.cos(p), st * np.sin(p), c], axis=-1)
    wh = wi + wo
    wh /= np.linalg.norm(wh, axis=-1, keepdims=True)
    cth = wh[..., 2]
    d = np.exp(-(1.0 - cth**2) / (cth**2 * alpha**2)) / (np.pi * alpha**2 * cth**4)
    f = _fresnel(np.sum(wh * wi, axis=-1), ext_ior, int_ior)
    g = _smith_g1(wi, wh, alpha) * _smith_g1(wo, wh, alpha)
    ks = 1.0 - kd
    fr = kd / np.pi + ks * d * f * g / (4.0 * wi[2] * c)
    return float(np.sum(fr * c * weight))


def _microfacet_xml(kind="ttest", extra=""):
    bsdfs = "".join(
        f'<bsdf type="microfacet"><float name="alpha" value="{a}"/>'
        f'<color name="kd" value="{kd},{kd},{kd}"/>'
        '<float name="extIOR" value="1.0"/><float name="intIOR" value="1.5"/></bsdf>\n'
        for a, kd in MICROFACETS
    )
    return f'<test type="{kind}">\n{extra}{bsdfs}</test>\n'


def _microfacet_ttest():
    refs = [microfacet_albedo(t, a, kd) for a, kd in MICROFACETS for t in ANGLES]
    extra = (
        '<float name="significanceLevel" value="0.01"/>\n'
        '<integer name="sampleCount" value="100000"/>\n'
        f'<string name="angles" value="{", ".join(map(str, ANGLES))}"/>\n'
        f'<string name="references" value="{", ".join(f"{r:.8f}" for r in refs)}"/>\n'
    )
    return _microfacet_xml("ttest", extra)


CASES = {
    "ttest-microfacet": lambda d: _microfacet_ttest(),
    "test-direct": lambda d: _scene_test(
        [_scene(i, SPHERE) for i in ("direct_ems", "direct_mats", "direct_mis")]
    ),
    "test-furnace": lambda d: _scene_test(
        [_scene(i, SPHERE) for i in ("path_mis", "path_mats")]
    ),
    # 2·48·23 = 2208 triangles: the LBVH path
    "test-mesh-furnace": lambda d: (
        _uv_sphere_obj(d, "ball", (0, 0, 0), 1.0, nu=48, nv=24),
        _scene_test([_scene("path_mis", _mesh("ball"))]),
    )[1],
    # 2·12·7 = 168 triangles: the brute-force sweep
    "test-mesh": lambda d: (
        _uv_sphere_obj(d, "ball", (0, 0, 0), 1.0, nu=12, nv=8),
        _scene_test([_scene(i, _mesh("ball")) for i in ("path_mats", "direct_mis")]),
    )[1],
}


def _write(tmp_path, name):
    f = tmp_path / f"{name}.xml"
    f.write_text(CASES[name](tmp_path))
    return f


def test_microfacet_quadrature_reference():
    """The quadrature reference: a pure diffuse BSDF integrates to kd, and
    a rough specular lobe at normal incidence reflects about the Fresnel
    reflectance ((1.5 − 1)/(1.5 + 1))² = 0.04."""
    assert microfacet_albedo(30.0, 0.3, 1.0) == pytest.approx(1.0, abs=1e-6)
    assert microfacet_albedo(0.0, 0.3, 0.0) == pytest.approx(0.04, abs=5e-3)


@pytest.mark.parametrize("name", list(CASES))
def test_reference_ttest_scenes(name, tmp_path):
    report = run_xml_test(_write(tmp_path, name), verbose=False)
    assert report.ok, "\n".join(report.messages)
    assert report.total > 0


def test_reference_chi2_microfacet(tmp_path):
    f = tmp_path / "chi2test-microfacet.xml"
    f.write_text(_microfacet_xml("chi2test", '<integer name="testCount" value="3"/>\n'))
    report = run_xml_test(f, verbose=False, sample_scale=0.1)
    assert report.ok, "\n".join(report.messages)
    assert report.total == 3 * len(MICROFACETS)


def test_unknown_test_type_raises(tmp_path):
    f = tmp_path / "bad.xml"
    f.write_text('<test type="nosuch"/>')
    with pytest.raises(ValueError):
        run_xml_test(f, verbose=False)


def test_render_cli_dispatches_test_root(tmp_path, capsys):
    """`render foo.xml` on a <test> root must EXECUTE the test (the round-1
    silent-normals-render bug)."""
    from optix_renderer_tpu import cli

    rc = cli.main(["render", str(_write(tmp_path, "ttest-microfacet"))])
    out = capsys.readouterr().out
    assert "Passed" in out and "ttest" in out
    assert rc == 0
