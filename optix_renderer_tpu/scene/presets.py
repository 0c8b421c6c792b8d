"""Procedural test scenes built through the public scene API.

Self-contained counterparts of the reference's golden scene suite (scenes/):
a Cornell-box-style interior with mirror + glass spheres and an area light,
a furnace sphere, etc. Geometry is constructed programmatically (our own
coordinates), so benchmarks and the graft entry point need no external files.
"""

from __future__ import annotations

import numpy as np
from pathlib import Path

from optix_renderer_tpu.scene.build import build_scene
from optix_renderer_tpu.scene.parser import SceneNode


def _write_obj(path, verts, faces) -> None:
    lines = ["v %f %f %f" % tuple(v) for v in verts]
    lines += ["f " + " ".join(str(i) for i in f) for f in faces]
    Path(path).write_text("\n".join(lines) + "\n")


def _quad_obj(tmpdir, name, verts):
    """Write a one-quad OBJ (two triangles) to tmpdir; returns filename."""
    _write_obj(Path(tmpdir) / f"{name}.obj", verts, [(1, 2, 3, 4)])
    return f"{name}.obj"


def _scene_dir() -> Path:
    import tempfile

    return Path(tempfile.mkdtemp(prefix="optix_scene_"))


# Cornell box interior [-1,1]×[0,2]×[-1,1]: wall quads (inward-facing
# windings) with their diffuse albedo, and the ceiling light
_CORNELL_WALLS = {
    "floor": ([(-1, 0, -1), (-1, 0, 1), (1, 0, 1), (1, 0, -1)], (0.725, 0.71, 0.68)),
    "ceiling": ([(-1, 2, -1), (1, 2, -1), (1, 2, 1), (-1, 2, 1)], (0.725, 0.71, 0.68)),
    "back": ([(-1, 0, -1), (1, 0, -1), (1, 2, -1), (-1, 2, -1)], (0.725, 0.71, 0.68)),
    "left": ([(-1, 0, -1), (-1, 2, -1), (-1, 2, 1), (-1, 0, 1)], (0.63, 0.065, 0.05)),
    "right": ([(1, 0, -1), (1, 0, 1), (1, 2, 1), (1, 2, -1)], (0.14, 0.45, 0.091)),
}
_CORNELL_LIGHT = [(-0.4, 1.99, -0.4), (0.4, 1.99, -0.4), (0.4, 1.99, 0.4), (-0.4, 1.99, 0.4)]


def _cornell_walls_xml(tmp: Path) -> str:
    """OBJ files for the walls and the light in `tmp`, and their XML."""
    shapes = []
    for name, (verts, albedo) in _CORNELL_WALLS.items():
        _quad_obj(tmp, name, verts)
        shapes.append(
            f'  <shape type="obj"><string name="filename" value="{name}.obj"/>\n'
            f'    <bsdf type="diffuse"><color name="albedo" value="{",".join(map(str, albedo))}"/>'
            "</bsdf></shape>"
        )
    _quad_obj(tmp, "light", _CORNELL_LIGHT)
    shapes.append(
        '  <shape type="obj"><string name="filename" value="light.obj"/>\n'
        '    <bsdf type="diffuse"><color name="albedo" value="0.8,0.8,0.8"/></bsdf>\n'
        '    <emitter type="area"><color name="radiance" value="17,12,8"/></emitter></shape>'
    )
    return "\n".join(shapes)


def _cornell_xml(walls: str, objects: str, width, height, spp, integrator) -> str:
    return f"""<scene>
  <integrator type="{integrator}"/>
  <sampler type="independent"><integer name="sampleCount" value="{spp}"/></sampler>
  <camera type="perspective">
    <float name="fov" value="40"/>
    <transform name="toWorld"><lookat target="0,1,0" origin="0,1,4.3" up="0,1,0"/></transform>
    <integer name="width" value="{width}"/><integer name="height" value="{height}"/>
  </camera>
{walls}
{objects}
</scene>
"""


def write_cornell_xml(tmpdir, width: int = 800, height: int = 600, spp: int = 512,
                      integrator: str = "path_mis") -> Path:
    """Write the Cornell box as scene XML in the reference's grammar (OBJ
    walls, a mirror and a glass sphere, an area light in the ceiling) to
    `tmpdir`, as a user would hand it to the CLI; returns the XML path."""
    tmp = Path(tmpdir)
    spheres = """  <shape type="sphere"><point name="center" value="-0.45,0.35,-0.35"/>
    <float name="radius" value="0.35"/><bsdf type="mirror"/></shape>
  <shape type="sphere"><point name="center" value="0.45,0.35,0.4"/>
    <float name="radius" value="0.35"/><bsdf type="dielectric"/></shape>"""
    xml = tmp / "cbox.xml"
    xml.write_text(_cornell_xml(_cornell_walls_xml(tmp), spheres, width, height, spp, integrator))
    return xml


def make_cornell_box(
    width: int = 800,
    height: int = 600,
    spp: int = 32,
    integrator: str = "path_mis",
):
    """The Cornell box of `write_cornell_xml`, loaded: interior box with
    red/green side walls, two spheres (mirror + dielectric) and a
    rectangular area light in the ceiling."""
    from optix_renderer_tpu.scene.build import load_scene

    return load_scene(write_cornell_xml(_scene_dir(), width, height, spp, integrator))


def make_absorbing_sphere(
    sigma_a=0.5,
    radius=1.0,
    width=64,
    height=64,
    spp=8,
    integrator="path_vol_mis",
):
    """Pass-through sphere filled with a purely absorbing homogeneous medium in
    a constant L=1 environment. The analytic center-pixel value is
    exp(−σa·2r) — the Beer–Lambert validation for free-path/transmittance
    (contract of homogmedium.cpp:61-73)."""
    root = SceneNode(tag="scene", type="scene")
    root.children.append(SceneNode(tag="integrator", type=integrator))
    cam = SceneNode(tag="camera", type="perspective")
    cam.props.set("width", width)
    cam.props.set("height", height)
    cam.props.set("fov", 30.0)
    from optix_renderer_tpu.core import transform as tf

    cam.props.set("toWorld", tf.lookat([0, 0, 6], [0, 0, 0], [0, 1, 0]))
    root.children.append(cam)
    samp = SceneNode(tag="sampler", type="independent")
    samp.props.set("sampleCount", spp)
    root.children.append(samp)

    sh = SceneNode(tag="shape", type="sphere")
    sh.props.set("center", np.zeros(3, np.float32))
    sh.props.set("radius", float(radius))
    med = SceneNode(tag="medium", type="homog")
    med.props.set("sigma_a", np.full(3, sigma_a, np.float32))
    med.props.set("sigma_s", np.zeros(3, np.float32))
    sh.children.append(med)
    root.children.append(sh)

    em = SceneNode(tag="emitter", type="envmap")
    em.props.set("radiance", np.ones(3, np.float32))
    root.children.append(em)

    return build_scene(root)


def make_furnace(albedo=0.75, radiance=1.0, width=128, height=128, spp=16,
                 integrator="path_mis"):
    """Furnace test: diffuse sphere inside a constant environment.

    For albedo a and env radiance L, the exact pixel value on the sphere is
    L·(1-a)⁻¹·... — for a closed furnace every path returns L·aᵏ with NEE →
    expected radiance L/(1-a) scaled appropriately; with a constant envmap and
    single bounce accumulation the analytic check lives in the tests
    (mirrors scenes/pa4/tests/test-furnace.xml).
    """
    root = SceneNode(tag="scene", type="scene")
    root.children.append(SceneNode(tag="integrator", type=integrator))
    cam = SceneNode(tag="camera", type="perspective")
    cam.props.set("width", width)
    cam.props.set("height", height)
    cam.props.set("fov", 30.0)
    from optix_renderer_tpu.core import transform as tf

    cam.props.set("toWorld", tf.lookat([0, 0, 4], [0, 0, 0], [0, 1, 0]))
    root.children.append(cam)
    samp = SceneNode(tag="sampler", type="independent")
    samp.props.set("sampleCount", spp)
    root.children.append(samp)

    sh = SceneNode(tag="shape", type="sphere")
    sh.props.set("center", np.zeros(3, np.float32))
    sh.props.set("radius", 1.0)
    b = SceneNode(tag="bsdf", type="diffuse")
    b.props.set("albedo", np.full(3, albedo, np.float32))
    sh.children.append(b)
    root.children.append(sh)

    em = SceneNode(tag="emitter", type="envmap")
    em.props.set("radiance", np.full(3, radiance, np.float32))
    root.children.append(em)

    return build_scene(root)


def _uv_sphere_obj(tmpdir, name, center, radius, nu=200, nv=125):
    """Write a UV-sphere OBJ with 2·nu·(nv−1) outward-facing triangles;
    returns filename."""
    import numpy as _np

    th = _np.linspace(0.0, _np.pi, nv + 1)
    ph = _np.linspace(0.0, 2.0 * _np.pi, nu, endpoint=False)
    tt, pp = _np.meshgrid(th, ph, indexing="ij")  # [nv+1, nu]
    x = center[0] + radius * _np.sin(tt) * _np.cos(pp)
    y = center[1] + radius * _np.cos(tt)
    z = center[2] + radius * _np.sin(tt) * _np.sin(pp)
    verts = _np.stack([x, y, z], -1).reshape(-1, 3)

    def vid(i, j):
        return i * nu + (j % nu) + 1  # 1-based OBJ ids

    faces = []
    for i in range(nv):
        for j in range(nu):
            a, b, c, d = vid(i, j), vid(i + 1, j), vid(i + 1, j + 1), vid(i, j + 1)
            # counter-clockwise seen from outside: outward geometric normals
            if i > 0:
                faces.append((a, d, b))
            if i < nv - 1:
                faces.append((b, d, c))
    lines = ["v %f %f %f" % tuple(v) for v in verts]
    lines += ["f %d %d %d" % f for f in faces]
    fname = f"{name}.obj"
    (Path(tmpdir) / fname).write_text("\n".join(lines) + "\n")
    return fname


def make_tessellated_cornell(
    width: int = 800,
    height: int = 600,
    spp: int = 8,
    integrator: str = "path_mis",
    nu: int = 200,
    nv: int = 126,
):
    """Cornell box with the two analytic spheres replaced by dense UV-sphere
    meshes (2·2·nu·(nv−1) ≈ 100k triangles at defaults) — exercises the LBVH
    path (ops/bvh.py) the way the reference's ajax/sponza scenes exercise its
    SAH BVH (scenes/pa1)."""
    from optix_renderer_tpu.scene.build import load_scene

    tmp = _scene_dir()
    _uv_sphere_obj(tmp, "ball_l", (-0.45, 0.35, -0.35), 0.35, nu=nu, nv=nv)
    _uv_sphere_obj(tmp, "ball_r", (0.45, 0.35, 0.4), 0.35, nu=nu, nv=nv)
    balls = """  <shape type="obj"><string name="filename" value="ball_l.obj"/><bsdf type="mirror"/></shape>
  <shape type="obj"><string name="filename" value="ball_r.obj"/>
    <bsdf type="diffuse"><color name="albedo" value="0.3,0.4,0.7"/></bsdf></shape>"""
    xml = tmp / "cbox_tessellated.xml"
    xml.write_text(_cornell_xml(_cornell_walls_xml(tmp), balls, width, height, spp, integrator))
    return load_scene(xml)


_CUBE_V = [(x, y, z) for z in (-0.5, 0.5) for y in (-0.5, 0.5) for x in (-0.5, 0.5)]
# outward winding (medium boundaries follow the geometric normal)
_CUBE_F = [(1, 3, 4), (1, 4, 2), (5, 6, 8), (5, 8, 7), (1, 2, 6), (1, 6, 5),
           (2, 4, 8), (2, 8, 6), (4, 3, 7), (4, 7, 8), (3, 1, 5), (3, 5, 7)]


def procedural_density(n: int = 64, seed: int = 0) -> np.ndarray:
    """Seeded smoke-like density on an n³ grid: a sum of Gaussian blobs,
    scaled to a maximum of 1."""
    rng = np.random.default_rng(seed)
    z, y, x = np.meshgrid(*(np.linspace(-1.0, 1.0, n),) * 3, indexing="ij")
    d = np.zeros((n, n, n))
    for _ in range(12):
        c = rng.uniform(-0.5, 0.5, 3)
        s = rng.uniform(0.15, 0.35)
        d += rng.uniform(0.5, 1.0) * np.exp(
            -((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2) / (2 * s * s))
    return (d / d.max()).astype(np.float32)


def make_procedural_smoke(
    width: int = 400,
    height: int = 300,
    spp: int = 1,
    max_depth: int = 8,
    grid: int = 64,
    seed: int = 0,
    integrator: str = "path_vol_mis",
):
    """Heterogeneous medium from a seeded procedural density grid (written
    as `.npz`, the format the volume loader reads) in a unit cube over a
    diffuse floor, lit by a point light: the flagship volume scene without
    any external asset."""
    import dataclasses

    from optix_renderer_tpu.scene.build import load_scene

    tmp = _scene_dir()
    np.savez(tmp / "smoke.npz", density=procedural_density(grid, seed),
             bbox_min=np.full(3, -0.5, np.float32), bbox_max=np.full(3, 0.5, np.float32))
    _write_obj(tmp / "cube.obj", _CUBE_V, _CUBE_F)
    _quad_obj(tmp, "floor", [(-3, -3, -0.51), (3, -3, -0.51), (3, 3, -0.51), (-3, 3, -0.51)])
    (tmp / "smoke.xml").write_text(f"""<scene>
  <integrator type="{integrator}"/>
  <sampler type="independent"><integer name="sampleCount" value="{spp}"/></sampler>
  <camera type="perspective">
    <float name="fov" value="40"/>
    <transform name="toWorld"><lookat target="0,0,0" origin="0,-3,1" up="0,0,1"/></transform>
    <integer name="width" value="{width}"/><integer name="height" value="{height}"/>
    <rfilter type="box"/>
  </camera>
  <shape type="obj">
    <string name="filename" value="cube.obj"/>
    <medium type="heterog">
      <color name="sigma_a" value="1,1,1"/>
      <color name="sigma_s" value="6,6,6"/>
      <volume type="volume"><string name="filename" value="smoke.npz"/></volume>
    </medium>
  </shape>
  <shape type="obj">
    <string name="filename" value="floor.obj"/>
    <bsdf type="diffuse"><color name="albedo" value="0.6,0.6,0.6"/></bsdf>
  </shape>
  <emitter type="point">
    <point name="position" value="1,-2,2.5"/>
    <color name="power" value="300,300,300"/>
  </emitter>
</scene>
""")
    scene, config, extras = load_scene(tmp / "smoke.xml")
    return scene, dataclasses.replace(config, max_depth=max_depth), extras
