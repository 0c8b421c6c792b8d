"""Scene compiler: SceneNode tree → flat SceneData pytree + RenderConfig.

The analog of the reference's cloneAndInit/update pass (scene.cpp:59-202) plus
its GPU scene lowering (OptixState.render.cpp:19-85 + SBT packing): validates
the tree, instantiates defaults (sampler, vacuum medium, gaussian rfilter —
scene.cpp:87-145), bakes toWorld transforms into world-space geometry, builds
the emitter-pick DPDF (scene.cpp:179-184) and per-area-light triangle CDFs
(mesh.cpp:15-46), and packs every plugin into tagged-union tables.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import jax.numpy as jnp

from optix_renderer_tpu.core import dpdf as dpdf_mod
from optix_renderer_tpu.core import transform as tf
from optix_renderer_tpu.ops import bvh as bvh_mod
from optix_renderer_tpu.ops import envmap as envmap_mod
from optix_renderer_tpu.ops import photon as photon_mod
from optix_renderer_tpu.scene import obj as obj_mod
from optix_renderer_tpu.scene.data import (
    Bsdfs,
    BsdfType,
    Camera,
    Emitters,
    EmitterGeom,
    EmitterType,
    Geometry,
    Media,
    MediumType,
    PhaseType,
    RenderConfig,
    SceneData,
    Shapes,
    TextureType,
    Textures,
)
from optix_renderer_tpu.scene.parser import SceneNode, load_from_xml


class SceneBuildError(Exception):
    pass


def _j(x, dtype=jnp.float32):
    return jnp.asarray(np.asarray(x), dtype)


def _col(rows, key, dtype=np.float32, width=None):
    if not rows:
        shape = (0,) if width is None else (0, width)
        return _j(np.zeros(shape, dtype), jnp.int32 if dtype == np.int32 else jnp.float32)
    vals = [r[key] for r in rows]
    arr = np.stack(vals) if width else np.asarray(vals, dtype)
    return _j(arr, jnp.int32 if dtype == np.int32 else jnp.float32)


class _Builder:
    def __init__(self, root: SceneNode):
        if root.tag not in ("scene", "test"):
            raise SceneBuildError(f"root must be <scene> or <test>, got <{root.tag}>")
        self.root = root
        self.origin = Path(root.origin or ".")

        # accumulating tables
        self.tri_v = []  # per-shape (v0,v1,v2) arrays
        self.tri_n = []
        self.tri_uv = []
        self.tri_shape = []
        self.spheres = []  # (center, radius, shape_id)
        self.shape_rows = []  # dict rows
        self.bsdf_rows = []
        self.tex_rows = []
        self.em_rows = []
        self.med_rows = []
        self.images = []  # list of (h, w, data) float32 linear
        self.volumes = []  # list of volume_io.VolumeGrid (heterog media)
        self.envmap_source = None  # dict(image, euler) for image-based envmaps
        self.tri_count = 0

    # -- volumes -----------------------------------------------------------

    def build_volume(self, node: SceneNode) -> int:
        """<volume type="volume"> child of a heterog medium
        (NvdbVolume, NvdbVolume.h:14-86): loads .vdb/.npz/.npy (the
        reference's .nvdb cache format is not read — scene/volume_io.py
        raises with a conversion hint; no reference scene ships one)."""
        from optix_renderer_tpu.scene import volume_io

        fname = self.origin / node.props.get_string("filename")
        self.volumes.append(volume_io.load_volume(fname))
        return len(self.volumes) - 1

    # -- textures ----------------------------------------------------------

    def add_const_texture(self, value) -> int:
        self.tex_rows.append(
            dict(
                type=TextureType.CONST,
                value=np.asarray(value, np.float32).reshape(3),
                value2=np.zeros(3, np.float32),
                scale_uv=np.ones(2, np.float32),
                shift_uv=np.zeros(2, np.float32),
                image_id=-1,
            )
        )
        return len(self.tex_rows) - 1

    def build_texture(self, node: SceneNode) -> int:
        t = node.type
        p = node.props
        if t in ("constant_color", "constant_float"):
            v = p.get_color("value", np.full(3, 0.5, np.float32)) if t == "constant_color" else np.full(
                3, p.get_float("value", 0.5), np.float32
            )
            return self.add_const_texture(v)
        if t in ("checkerboard_color", "checkerboard_float"):
            if t == "checkerboard_color":
                v1 = p.get_color("value1", np.zeros(3, np.float32))
                v2 = p.get_color("value2", np.ones(3, np.float32))
            else:
                v1 = np.full(3, p.get_float("value1", 0.0), np.float32)
                v2 = np.full(3, p.get_float("value2", 1.0), np.float32)
            delta = np.asarray(p.props.get("delta", np.zeros(2)), np.float32).reshape(-1)[:2]
            scale = np.asarray(p.props.get("scale", np.ones(2)), np.float32).reshape(-1)[:2]
            self.tex_rows.append(
                dict(
                    type=TextureType.CHECKER,
                    value=v1.reshape(3),
                    value2=v2.reshape(3),
                    scale_uv=scale,
                    shift_uv=delta,
                    image_id=-1,
                )
            )
            return len(self.tex_rows) - 1
        if t == "png_texture":
            return self.build_png_texture(node)
        raise SceneBuildError(f"unsupported texture type '{t}'")

    def build_png_texture(self, node: SceneNode) -> int:
        from optix_renderer_tpu.utils import imageio as iio

        p = node.props
        fname = self.origin / p.get_string("filename")
        srgb = p.get_boolean("sRGB", True)
        scale_uv = np.asarray(p.props.get("scale", np.ones(2)), np.float32).reshape(-1)[:2]
        img = iio.read_image(str(fname))  # [h,w,3] float32 in [0,1]
        if srgb:
            img = iio.srgb_to_linear(img)
        self.images.append(img.astype(np.float32))
        self.tex_rows.append(
            dict(
                type=TextureType.IMAGE,
                value=np.ones(3, np.float32),
                value2=np.zeros(3, np.float32),
                scale_uv=scale_uv,
                shift_uv=np.zeros(2, np.float32),
                image_id=len(self.images) - 1,
            )
        )
        return len(self.tex_rows) - 1

    # -- bsdfs -------------------------------------------------------------

    def build_bsdf(self, node: SceneNode | None) -> int:
        """Lower a <bsdf> to a table row. None → default diffuse(0.5)."""
        row = dict(
            type=BsdfType.DIFFUSE,
            albedo_tex=-1,
            int_ior=1.5046,
            ext_ior=1.000277,
            alpha=0.1,
            kd=np.full(3, 0.5, np.float32),
            ks=0.5,
            disney=np.zeros(10, np.float32),
        )
        if node is None:
            row["albedo_tex"] = self.add_const_texture([0.5, 0.5, 0.5])
            self.bsdf_rows.append(row)
            return len(self.bsdf_rows) - 1

        p = node.props
        t = node.type
        # albedo: property or child texture named 'albedo' (diffuse.cpp:32-40)
        tex_child = node.child("texture")
        if t in ("diffuse", "disney"):
            if tex_child is not None and tex_child.name in ("albedo", ""):
                row["albedo_tex"] = self.build_texture(tex_child)
            else:
                row["albedo_tex"] = self.add_const_texture(
                    p.get_color("albedo", np.full(3, 0.5, np.float32))
                )
        if t == "diffuse":
            row["type"] = BsdfType.DIFFUSE
        elif t == "mirror":
            row["type"] = BsdfType.MIRROR
        elif t == "dielectric":
            row["type"] = BsdfType.DIELECTRIC
            row["int_ior"] = p.get_float("intIOR", 1.5046)
            row["ext_ior"] = p.get_float("extIOR", 1.000277)
        elif t == "microfacet":
            row["type"] = BsdfType.MICROFACET
            row["alpha"] = p.get_float("alpha", 0.1)
            row["int_ior"] = p.get_float("intIOR", 1.5046)
            row["ext_ior"] = p.get_float("extIOR", 1.000277)
            kd = p.get_color("kd", np.full(3, 0.5, np.float32))
            row["kd"] = kd
            row["ks"] = 1.0 - float(kd.max())  # microfacet.cpp:55
        elif t == "disney":
            row["type"] = BsdfType.DISNEY
            # disney.cpp:32-41 (clamped to [0,1])
            names = [
                "metallic", "subsurface", "specular", "roughness", "specularTint",
                "anisotropic", "sheen", "sheenTint", "clearcoat", "clearcoatGloss",
            ]
            defaults = [0.0, 0.0, 0.5, 0.5, 0.0, 0.0, 0.0, 0.5, 0.0, 1.0]
            row["disney"] = np.clip(
                np.array(
                    [p.get_float(n, d) for n, d in zip(names, defaults)], np.float32
                ),
                0.0,
                1.0,
            )
        else:
            raise SceneBuildError(f"unsupported bsdf type '{t}'")
        self.bsdf_rows.append(row)
        return len(self.bsdf_rows) - 1

    # -- media -------------------------------------------------------------

    def build_medium(self, node: SceneNode) -> int:
        p = node.props
        # medium.cpp:13-16 + homogmedium derived properties
        sa = p.get_color("sigma_a", np.full(3, 0.5, np.float32)) * p.get_float(
            "sigma_a_intensity", 1.0
        )
        ss = p.get_color("sigma_s", np.zeros(3, np.float32)) * p.get_float(
            "sigma_s_intensity", 1.0
        )
        row = dict(
            type=MediumType.VACUUM,
            sigma_a=np.asarray(sa, np.float32),
            sigma_s=np.asarray(ss, np.float32),
            phase_type=PhaseType.ISO,
            phase_g=0.0,
            emitter=-1,
            vol_id=-1,
            density_scale=1.0,
            temperature_scale=0.0,
        )
        if node.type == "vacuum":
            row["type"] = MediumType.VACUUM
        elif node.type == "homog":
            row["type"] = MediumType.HOMOG
            density = p.get_float("density", 1.0)
            row["sigma_a"] = row["sigma_a"] * density
            row["sigma_s"] = row["sigma_s"] * density
        elif node.type == "heterog":
            # heterogmedium.cpp:47-51 + NvdbVolume child
            row["type"] = MediumType.HETEROG
            row["density_scale"] = p.get_float("densityScale", 1.0)
            row["temperature_scale"] = p.get_float("temperatureScale", 0.0)
            vol_node = node.child("volume")
            if vol_node is None:
                raise SceneBuildError("heterog medium requires a <volume> child")
            row["vol_id"] = self.build_volume(vol_node)
        else:
            raise SceneBuildError(f"unsupported medium type '{node.type}'")

        ph = node.child("phase")
        if ph is not None:
            if ph.type == "isophase":
                row["phase_type"] = PhaseType.ISO
            elif ph.type == "anisophase":
                row["phase_type"] = PhaseType.HG
                row["phase_g"] = ph.props.get_float("g", 0.0)
            elif ph.type == "schlick":
                row["phase_type"] = PhaseType.SCHLICK
                # schlickphase.cpp: k derived from g: k = 1.55g - 0.55g^3
                g = ph.props.get_float("g", 0.0)
                row["phase_g"] = 1.55 * g - 0.55 * g**3
            else:
                raise SceneBuildError(f"unsupported phase '{ph.type}'")

        self.med_rows.append(row)
        med_id = len(self.med_rows) - 1

        em = node.child("emitter")
        if em is not None:
            em_id = self.build_emitter(em, shape_id=-1, medium_id=med_id)
            self.med_rows[med_id]["emitter"] = em_id
        return med_id

    # -- emitters ----------------------------------------------------------

    def build_emitter(
        self, node: SceneNode, shape_id: int = -1, medium_id: int = -1
    ) -> int:
        p = node.props
        row = dict(
            type=EmitterType.POINT,
            radiance=np.zeros(3, np.float32),
            position=np.zeros(3, np.float32),
            power=np.zeros(3, np.float32),
            direction=np.array([0, 0, 1], np.float32),
            cos_falloff_start=1.0,
            cos_falloff_end=1.0,
            angular_radius=0.0,
            shape=shape_id,
            geom_kind=EmitterGeom.NONE,
            tri_offset=0,
            tri_count=0,
            area=0.0,
            sphere_id=-1,
            light_prob=p.get_float("lightWeight", 1.0),
            bbox_min=np.zeros(3, np.float32),
            bbox_extent=np.ones(3, np.float32),
            volume=1.0,
            medium=medium_id,
        )
        t = node.type
        if t == "point":
            row["power"] = p.get_color("power")
            row["position"] = p.get_point("position")
            # radiance = power / 4pi (pointlight.cpp update)
            row["radiance"] = row["power"] / (4.0 * math.pi)
        elif t == "spot":
            row["type"] = EmitterType.SPOT
            row["position"] = p.get_point("position", np.zeros(3, np.float32))
            d = p.get_vector("direction", np.zeros(3, np.float32))
            row["direction"] = d / max(np.linalg.norm(d), 1e-20)
            row["power"] = p.get_color("power", np.zeros(3, np.float32))
            # spotlight.cpp:53-70: angles in degrees
            falloff_start = p.get_float("falloffstart")
            total_width = p.get_float("totalwidth")
            row["cos_falloff_start"] = math.cos(math.radians(falloff_start))
            row["cos_falloff_end"] = math.cos(math.radians(total_width))
        elif t == "area":
            row["type"] = EmitterType.AREA
            row["radiance"] = p.get_color("radiance")
        elif t == "volumelight":
            row["type"] = EmitterType.VOLUME
            row["radiance"] = p.get_color("radiance", np.zeros(3, np.float32))
        elif t == "directional":
            row["type"] = EmitterType.DIRECTIONAL
            d = p.get_vector("direction", np.array([0, 0, 1], np.float32))
            row["direction"] = d / max(np.linalg.norm(d), 1e-20)
            row["radiance"] = p.get_color("radiance", np.zeros(3, np.float32))
            row["angular_radius"] = math.radians(p.get_float("angle", 1.0))
        elif t == "envmap":
            row["type"] = EmitterType.ENVMAP
            row["radiance"] = p.get_color("radiance", np.ones(3, np.float32))
            # image-based map: the texture child is NOT lowered into the
            # shared texture stack (a 4k envmap would pad every scene texture
            # to 4k) — it feeds the dedicated lat-long tables (ops/envmap.py,
            # environmentmap.cpp:12-18 constant fallback otherwise).
            tex_child = node.child("texture")
            if tex_child is not None:
                tp = tex_child.props
                if tex_child.type in ("png_texture",):
                    from optix_renderer_tpu.utils import imageio as iio

                    fname = self.origin / tp.get_string("filename")
                    img = iio.read_image(str(fname))
                    # PNGTexture.cpp:26 sRGB default (name != "normal");
                    # HDR formats are already linear
                    if tp.get_boolean(
                        "sRGB", True
                    ) and fname.suffix.lower() not in (".hdr", ".exr"):
                        img = iio.srgb_to_linear(img)
                    img = img * tp.get_float("intensity", 1.0)
                    euler = np.asarray(
                        tp.props.get("eulerAngles", np.zeros(3)), np.float32
                    ).reshape(-1)[:3]
                    self.envmap_source = dict(image=img, euler=tuple(euler))
                elif tex_child.type in ("constant_color", "constant_float"):
                    v = (
                        tp.get_color("value", np.full(3, 0.5, np.float32))
                        if tex_child.type == "constant_color"
                        else np.full(3, tp.get_float("value", 0.5), np.float32)
                    )
                    row["radiance"] = row["radiance"] * v
                else:
                    raise SceneBuildError(
                        f"unsupported envmap texture '{tex_child.type}'"
                    )
        else:
            raise SceneBuildError(f"unsupported emitter type '{t}'")
        self.em_rows.append(row)
        return len(self.em_rows) - 1

    # -- shapes ------------------------------------------------------------

    def build_shape(self, node: SceneNode):
        p = node.props
        shape_id = len(self.shape_rows)
        row = dict(
            bsdf=-1, emitter=-1, interior_medium=-1, exterior_medium=-1, normal_tex=-1
        )

        if node.type == "obj":
            to_world = p.get_transform("toWorld", tf.identity())
            mesh = obj_mod.load_obj(self.origin / p.get_string("filename"), to_world)
            self._append_mesh(mesh, shape_id)
        elif node.type == "sphere":
            center = p.get_point("center", np.zeros(3, np.float32))
            radius = p.get_float("radius", 1.0)
            self.spheres.append((center, radius, shape_id))
        else:
            raise SceneBuildError(f"unsupported shape type '{node.type}'")

        # children: bsdf, emitter, medium(s), normal-map texture (shape.h:104-140)
        # a shape with a medium and no bsdf is a pass-through boundary —
        # NO default diffuse (shape.cpp cloneAndInit: default only without medium)
        bsdf_node = node.child("bsdf")
        if bsdf_node is not None or not node.children_of("medium"):
            row["bsdf"] = self.build_bsdf(bsdf_node)
        else:
            row["bsdf"] = -1
        em_node = node.child("emitter")
        if em_node is not None:
            row["emitter"] = self.build_emitter(em_node, shape_id=shape_id)
        for med in node.children_of("medium"):
            mid = self.build_medium(med)
            if med.name == "exterior":
                row["exterior_medium"] = mid
            else:
                row["interior_medium"] = mid
        tex_node = node.child("texture")
        if tex_node is not None and tex_node.name == "normal":
            row["normal_tex"] = self.build_texture(tex_node)

        self.shape_rows.append(row)

    def _append_mesh(self, mesh: dict, shape_id: int):
        V, F = mesh["V"], mesh["F"]
        v0, v1, v2 = V[F[:, 0]], V[F[:, 1]], V[F[:, 2]]
        # geometric normal fallback when no shading normals (mesh.cpp:160-172)
        gn = np.cross(v1 - v0, v2 - v0)
        gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-20)
        if "N" in mesh:
            N = mesh["N"]
            n0, n1, n2 = N[F[:, 0]], N[F[:, 1]], N[F[:, 2]]
            # zero-length shading normals → geometric
            for arr in (n0, n1, n2):
                bad = np.linalg.norm(arr, axis=-1) < 1e-8
                arr[bad] = gn[bad]
        else:
            n0 = n1 = n2 = gn
        if "UV" in mesh:
            UV = mesh["UV"]
            uv0, uv1, uv2 = UV[F[:, 0]], UV[F[:, 1]], UV[F[:, 2]]
        else:
            uv0 = uv1 = uv2 = np.zeros((len(F), 2), np.float32)
        self.tri_v.append((v0, v1, v2))
        self.tri_n.append((n0, n1, n2))
        self.tri_uv.append((uv0, uv1, uv2))
        self.tri_shape.append(np.full(len(F), shape_id, np.int32))
        self.tri_count += len(F)

    def bsdf_texture_tables(self) -> tuple[Bsdfs, Textures]:
        """Finish the BSDF + texture tables (shared by full scene builds and
        standalone BSDF tables for ttest/chi2test scene objects)."""
        col = _col
        if not self.bsdf_rows:
            self.build_bsdf(None)
        bsdfs = Bsdfs(
            type=col(self.bsdf_rows, "type", np.int32),
            albedo_tex=col(self.bsdf_rows, "albedo_tex", np.int32),
            int_ior=col(self.bsdf_rows, "int_ior"),
            ext_ior=col(self.bsdf_rows, "ext_ior"),
            alpha=col(self.bsdf_rows, "alpha"),
            kd=col(self.bsdf_rows, "kd", width=3),
            ks=col(self.bsdf_rows, "ks"),
            disney=col(self.bsdf_rows, "disney", width=10),
        )

        if not self.tex_rows:
            self.add_const_texture([0.5, 0.5, 0.5])
        if self.images:
            hmax = max(im.shape[0] for im in self.images)
            wmax = max(im.shape[1] for im in self.images)
            image_data = np.zeros((len(self.images), hmax, wmax, 3), np.float32)
            image_hw = np.zeros((len(self.images), 2), np.int32)
            for i, im in enumerate(self.images):
                image_data[i, : im.shape[0], : im.shape[1]] = im
                image_hw[i] = im.shape[:2]
        else:
            image_data = np.zeros((1, 1, 1, 3), np.float32)
            image_hw = np.ones((1, 2), np.int32)
        textures = Textures(
            type=col(self.tex_rows, "type", np.int32),
            value=col(self.tex_rows, "value", width=3),
            value2=col(self.tex_rows, "value2", width=3),
            scale_uv=col(self.tex_rows, "scale_uv", width=2),
            shift_uv=col(self.tex_rows, "shift_uv", width=2),
            image_id=col(self.tex_rows, "image_id", np.int32),
            image_data=_j(image_data),
            image_hw=_j(image_hw, jnp.int32),
        )
        return bsdfs, textures

    # -- top level ---------------------------------------------------------

    def build(self) -> tuple[SceneData, RenderConfig, dict]:
        root = self.root
        integrator = root.child("integrator")
        camera = root.child("camera")
        sampler = root.child("sampler")

        for sh in root.children_of("shape"):
            self.build_shape(sh)
        # scene-level emitters (point/spot/directional/envmap)
        for em in root.children_of("emitter"):
            self.build_emitter(em)
        # scene-level ambient medium
        ambient_medium = -1
        for med in root.children_of("medium"):
            ambient_medium = self.build_medium(med)

        n_real_emitters = len(self.em_rows)

        # Pad every table to ≥1 row so batched gathers always have a valid
        # target (dummy rows are never selected: shapes gate on hit validity,
        # the dummy emitter has zero radiance/power).
        if not self.shape_rows:
            self.shape_rows.append(
                dict(bsdf=self.build_bsdf(None), emitter=-1, interior_medium=-1,
                     exterior_medium=-1, normal_tex=-1)
            )
        if not self.em_rows:
            self.em_rows.append(
                dict(
                    type=EmitterType.POINT,
                    radiance=np.zeros(3, np.float32),
                    position=np.zeros(3, np.float32),
                    power=np.zeros(3, np.float32),
                    direction=np.array([0, 0, 1], np.float32),
                    cos_falloff_start=1.0,
                    cos_falloff_end=1.0,
                    angular_radius=0.0,
                    shape=-1,
                    geom_kind=EmitterGeom.NONE,
                    tri_offset=0,
                    tri_count=0,
                    area=0.0,
                    sphere_id=-1,
                    light_prob=1.0,
                    bbox_min=np.zeros(3, np.float32),
                    bbox_extent=np.ones(3, np.float32),
                    volume=1.0,
                    medium=-1,
                )
            )

        # ---- geometry concat
        if self.tri_count:
            cat = lambda xs, i: np.concatenate([x[i] for x in xs], 0).astype(np.float32)
            tri_v0, tri_v1, tri_v2 = (cat(self.tri_v, i) for i in range(3))
            tri_n0, tri_n1, tri_n2 = (cat(self.tri_n, i) for i in range(3))
            tri_uv0, tri_uv1, tri_uv2 = (cat(self.tri_uv, i) for i in range(3))
            tri_shape = np.concatenate(self.tri_shape)
        else:
            tri_v0 = tri_v1 = tri_v2 = np.zeros((0, 3), np.float32)
            tri_n0 = tri_n1 = tri_n2 = np.zeros((0, 3), np.float32)
            tri_uv0 = tri_uv1 = tri_uv2 = np.zeros((0, 2), np.float32)
            tri_shape = np.zeros(0, np.int32)

        if self.spheres:
            sph_center = np.stack([s[0] for s in self.spheres]).astype(np.float32)
            sph_radius = np.array([s[1] for s in self.spheres], np.float32)
            sph_shape = np.array([s[2] for s in self.spheres], np.int32)
        else:
            sph_center = np.zeros((0, 3), np.float32)
            sph_radius = np.zeros(0, np.float32)
            sph_shape = np.zeros(0, np.int32)

        # Acceleration choice (scene.cpp:187-194 BVH rebuild analog): the
        # LBVH from MIN_TRIS_FOR_BVH triangles up; smaller meshes take the
        # brute-force sweep (ops/intersect.py).
        if len(tri_v0) >= bvh_mod.MIN_TRIS_FOR_BVH:
            bvh = bvh_mod.build_bvh(tri_v0, tri_v1, tri_v2)
        else:
            bvh = bvh_mod.empty_bvh()
        if len(sph_center) >= bvh_mod.MIN_SPHS_FOR_BVH:
            sph_bvh = bvh_mod.build_sphere_bvh(sph_center, sph_radius)
        else:
            sph_bvh = bvh_mod.empty_bvh()

        # UV-aligned tangent dp/du per triangle (mesh.cpp:176-185): solves
        # [e1 e2] = [duv1 duv2]·[T B] for T; zero tangent marks a degenerate
        # UV chart and shading falls back to the Duff ONB.
        duv1 = tri_uv1 - tri_uv0
        duv2 = tri_uv2 - tri_uv0
        uv_det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
        safe_det = np.where(np.abs(uv_det) > 1e-12, uv_det, 1.0)
        tri_tang = (
            (tri_v1 - tri_v0) * duv2[:, 1:2] - (tri_v2 - tri_v0) * duv1[:, 1:2]
        ) / safe_det[:, None]
        tri_tang = np.where(np.abs(uv_det)[:, None] > 1e-12, tri_tang, 0.0)
        # 4th component = UV handedness (glTF tangent.w convention): mirrored
        # UV charts (det<0) flip the bitangent so tangent-space normal maps
        # keep their authored green-channel orientation — matches the
        # reference's dp/du–dp/dv frame that solves for B explicitly
        # (mesh.cpp:176-185)
        tri_tang = np.concatenate(
            [tri_tang, np.sign(safe_det)[:, None]], axis=1
        )

        geometry = Geometry(
            tri_v0=_j(tri_v0),
            tri_e1=_j(tri_v1 - tri_v0),
            tri_e2=_j(tri_v2 - tri_v0),
            tri_n0=_j(tri_n0), tri_n1=_j(tri_n1), tri_n2=_j(tri_n2),
            tri_uv0=_j(tri_uv0), tri_uv1=_j(tri_uv1), tri_uv2=_j(tri_uv2),
            tri_tang=_j(tri_tang.astype(np.float32)),
            tri_shape=_j(tri_shape, jnp.int32),
            sph_center=_j(sph_center),
            sph_radius=_j(sph_radius),
            sph_shape=_j(sph_shape, jnp.int32),
            bvh=bvh,
            sph_bvh=sph_bvh,
        )

        # shape offsets into the global triangle array (for emitter CDFs)
        tri_offsets = {}
        off = 0
        for arr in self.tri_shape:
            if len(arr):
                tri_offsets[int(arr[0])] = off
                off += len(arr)

        # ---- emitter sampling tables
        n_em = len(self.em_rows)
        max_t = 1
        for row in self.em_rows:
            sid = row["shape"]
            if sid >= 0:
                if sid in tri_offsets:
                    count = int(np.sum(tri_shape == sid))
                    max_t = max(max_t, count)
        em_tri_cdf = np.ones((max(n_em, 1), max_t), np.float32)
        for ei, row in enumerate(self.em_rows):
            sid = row["shape"]
            if sid < 0:
                continue
            if sid in tri_offsets:
                offv = tri_offsets[sid]
                mask = tri_shape == sid
                count = int(mask.sum())
                a = 0.5 * np.linalg.norm(
                    np.cross(
                        tri_v1[mask] - tri_v0[mask], tri_v2[mask] - tri_v0[mask]
                    ),
                    axis=-1,
                )
                total = float(a.sum())
                cdf = np.cumsum(a / max(total, 1e-20))
                em_tri_cdf[ei, :count] = cdf
                em_tri_cdf[ei, count:] = 1.0
                row.update(
                    geom_kind=EmitterGeom.MESH,
                    tri_offset=offv,
                    tri_count=count,
                    area=total,
                )
            else:
                # sphere shape
                sph_idx = [i for i, s in enumerate(self.spheres) if s[2] == sid]
                if sph_idx:
                    i = sph_idx[0]
                    r = self.spheres[i][1]
                    row.update(
                        geom_kind=EmitterGeom.SPHERE,
                        sphere_id=i,
                        area=4.0 * math.pi * r * r,
                    )

        # ---- volume-emitter tables (volumelight.cpp:47-79): resolve the
        # governing shape (direct child, or the shape carrying the emitter's
        # medium), then bbox/volume per Shape::sampleVolume semantics
        # (shape.cpp:97-106 bbox-uniform, sphere.cpp:139-143 exact ball)
        for row in self.em_rows:
            if row["type"] != EmitterType.VOLUME:
                continue
            sid = row["shape"]
            if sid < 0 and row.get("medium", -1) >= 0:
                for si, srow in enumerate(self.shape_rows):
                    if srow["interior_medium"] == row["medium"]:
                        sid = si
                        break
            if sid < 0:
                raise SceneBuildError(
                    "volumelight requires a shape with an attached medium "
                    "(volumelight.cpp:21-22)"
                )
            row["shape"] = sid
            sph_idx = [i for i, sp in enumerate(self.spheres) if sp[2] == sid]
            if sph_idx:
                i = sph_idx[0]
                c, r = self.spheres[i][0], self.spheres[i][1]
                row.update(
                    geom_kind=EmitterGeom.SPHERE,
                    sphere_id=i,
                    bbox_min=np.asarray(c - r, np.float32),
                    bbox_extent=np.full(3, 2.0 * r, np.float32),
                    volume=4.0 / 3.0 * math.pi * r**3,
                )
            else:
                mask = tri_shape == sid
                if not mask.any():
                    raise SceneBuildError("volumelight shape has no geometry")
                pts = np.concatenate([tri_v0[mask], tri_v1[mask], tri_v2[mask]], 0)
                bmin = pts.min(axis=0)
                bmax = pts.max(axis=0)
                row.update(
                    geom_kind=EmitterGeom.MESH,
                    bbox_min=bmin.astype(np.float32),
                    bbox_extent=(bmax - bmin).astype(np.float32),
                    volume=float(np.prod(np.maximum(bmax - bmin, 1e-20))),
                )

        col = _col

        emitters = Emitters(
            type=col(self.em_rows, "type", np.int32),
            radiance=col(self.em_rows, "radiance", width=3),
            position=col(self.em_rows, "position", width=3),
            power=col(self.em_rows, "power", width=3),
            direction=col(self.em_rows, "direction", width=3),
            cos_falloff_start=col(self.em_rows, "cos_falloff_start"),
            cos_falloff_end=col(self.em_rows, "cos_falloff_end"),
            angular_radius=col(self.em_rows, "angular_radius"),
            shape=col(self.em_rows, "shape", np.int32),
            geom_kind=col(self.em_rows, "geom_kind", np.int32),
            tri_offset=col(self.em_rows, "tri_offset", np.int32),
            tri_count=col(self.em_rows, "tri_count", np.int32),
            tri_cdf=_j(em_tri_cdf[: n_em or 0].reshape(n_em, max_t) if n_em else np.ones((0, 1), np.float32)),
            area=col(self.em_rows, "area"),
            sphere_id=col(self.em_rows, "sphere_id", np.int32),
            light_prob=col(self.em_rows, "light_prob"),
            bbox_min=col(self.em_rows, "bbox_min", width=3),
            bbox_extent=col(self.em_rows, "bbox_extent", width=3),
            volume=col(self.em_rows, "volume"),
        )

        # emitter-pick DPDF over lightProb (scene.cpp:179-184)
        if n_em:
            pick = dpdf_mod.build(_j([r["light_prob"] for r in self.em_rows]))
        else:
            pick = dpdf_mod.build(jnp.ones(1))

        envmap_emitter = -1
        for i, r in enumerate(self.em_rows):
            if r["type"] == EmitterType.ENVMAP:
                envmap_emitter = i

        shapes = Shapes(
            bsdf=col(self.shape_rows, "bsdf", np.int32),
            emitter=col(self.shape_rows, "emitter", np.int32),
            interior_medium=col(self.shape_rows, "interior_medium", np.int32),
            exterior_medium=col(self.shape_rows, "exterior_medium", np.int32),
            normal_tex=col(self.shape_rows, "normal_tex", np.int32),
        )

        bsdfs, textures = self.bsdf_texture_tables()

        if not self.med_rows:
            # default vacuum (scene.cpp cloneAndInit instantiates one)
            self.med_rows.append(
                dict(
                    type=MediumType.VACUUM,
                    sigma_a=np.zeros(3, np.float32),
                    sigma_s=np.zeros(3, np.float32),
                    phase_type=PhaseType.ISO,
                    phase_g=0.0,
                            emitter=-1,
                    vol_id=-1,
                    density_scale=1.0,
                    temperature_scale=0.0,
                )
            )
        # volume stack: pad all grids to a common [D,H,W]
        if self.volumes:
            dmax = max(v.density.shape[0] for v in self.volumes)
            hmax = max(v.density.shape[1] for v in self.volumes)
            wmax = max(v.density.shape[2] for v in self.volumes)
            nv = len(self.volumes)
            vol_density = np.zeros((nv, dmax, hmax, wmax), np.float32)
            vol_temperature = np.zeros((nv, dmax, hmax, wmax), np.float32)
            vol_dims = np.zeros((nv, 3), np.int32)
            vol_bbox_min = np.zeros((nv, 3), np.float32)
            vol_bbox_max = np.ones((nv, 3), np.float32)
            vol_majorant = np.zeros(nv, np.float32)
            for i, v in enumerate(self.volumes):
                d, h, w = v.density.shape
                vol_density[i, :d, :h, :w] = v.density
                if v.temperature is not None:
                    vol_temperature[i, :d, :h, :w] = v.temperature
                vol_dims[i] = (d, h, w)
                vol_bbox_min[i] = v.bbox_min
                vol_bbox_max[i] = v.bbox_max
                vol_majorant[i] = float(v.density.max())
        else:
            vol_density = np.zeros((0, 1, 1, 1), np.float32)
            vol_temperature = np.zeros((0, 1, 1, 1), np.float32)
            vol_dims = np.zeros((0, 3), np.int32)
            vol_bbox_min = np.zeros((0, 3), np.float32)
            vol_bbox_max = np.zeros((0, 3), np.float32)
            vol_majorant = np.zeros(0, np.float32)

        def corner_stack(g):
            """[V,D,H,W] → [V,(D+1)(H+1)(W+1),8]: per base voxel (in a
            one-voxel zero-padded index space) the 8 cell-corner values, for
            the fused single-gather trilinear lookup (scene/data.py Media)."""
            V, D, H, W = g.shape
            if V == 0:
                return np.zeros((0, (D + 1) * (H + 1) * (W + 1), 8), np.float32)
            P = np.zeros((V, D + 2, H + 2, W + 2), np.float32)
            P[:, 1 : D + 1, 1 : H + 1, 1 : W + 1] = g
            out = np.empty((V, (D + 1) * (H + 1) * (W + 1), 8), np.float32)
            k = 0
            for dz in (0, 1):
                for dy in (0, 1):
                    for dx in (0, 1):
                        out[..., k] = P[
                            :, dz : dz + D + 1, dy : dy + H + 1,
                            dx : dx + W + 1,
                        ].reshape(V, -1)
                        k += 1
            return out

        media = Media(
            type=col(self.med_rows, "type", np.int32),
            sigma_a=col(self.med_rows, "sigma_a", width=3),
            sigma_s=col(self.med_rows, "sigma_s", width=3),
            phase_type=col(self.med_rows, "phase_type", np.int32),
            phase_g=col(self.med_rows, "phase_g"),
            emitter=col(self.med_rows, "emitter", np.int32),
            vol_id=col(self.med_rows, "vol_id", np.int32),
            density_scale=col(self.med_rows, "density_scale"),
            temperature_scale=col(self.med_rows, "temperature_scale"),
            vol_density=_j(vol_density),
            vol_temperature=_j(vol_temperature),
            vol_dims=_j(vol_dims, jnp.int32),
            vol_bbox_min=_j(vol_bbox_min),
            vol_bbox_max=_j(vol_bbox_max),
            vol_majorant=_j(vol_majorant),
            vol_corners=_j(corner_stack(vol_density)),
            vol_tcorners=_j(corner_stack(vol_temperature)),
        )

        # ---- camera (perspective.cpp:10-96)
        if camera is None:
            camera = SceneNode(tag="camera", type="perspective")
        cp = camera.props
        width = cp.get_integer("width", 1280)
        height = cp.get_integer("height", 720)
        fov = cp.get_float("fov", 30.0)
        near = cp.get_float("nearClip", 1e-4)
        far = cp.get_float("farClip", 1e4)
        focal_distance = cp.get_float("focalDistance", 10.0)
        fstop = cp.get_float("fstop", 0.0)
        lens_radius = cp.get_float("lensRadius", 0.0)
        if fstop != 0.0:
            lens_radius = focal_distance / fstop
        cam_to_world = cp.get_transform("toWorld", tf.identity())

        # reconstruction filter child (rfilter.cpp:28-210; the reference
        # attaches it to the camera, perspective.cpp addChild) — round-3 W2:
        # parse it into RenderConfig so <rfilter type="mitchell"> etc. are
        # honored by the splat instead of silently rendering gaussian
        rf_node = camera.child("rfilter")
        rfilter = "gaussian"
        if rf_node is not None:
            if rf_node.type not in ("gaussian", "mitchell", "tent", "box"):
                raise SceneBuildError(f"unknown rfilter type '{rf_node.type}'")
            rfilter = rf_node.type

        cam = Camera(
            to_world=_j(cam_to_world),
            fov=_j(fov),
            near_clip=_j(near),
            far_clip=_j(far),
            lens_radius=_j(lens_radius),
            focal_distance=_j(focal_distance),
        )

        # ---- config
        sample_count = 1
        if sampler is not None:
            sample_count = sampler.props.get_integer("sampleCount", 1)
        integ_name = integrator.type if integrator is not None else "normals"

        iprops = ()
        if integrator is not None:
            iprops = tuple(
                (k, v)
                for k, v in integrator.props.props.items()
                if isinstance(v, (int, float, bool, str))
            )
        # scene-level denoiser child (scene.h:41-201 attaches the denoiser to
        # the scene; scenes/project/denoiser/denoiser-test.xml) — round-3 W3:
        # record it so render paths run the pass without a CLI flag
        den_node = self.root.child("denoiser")
        denoiser = ""
        dprops = ()
        if den_node is not None:
            denoiser = den_node.type or "simple"
            dprops = tuple(
                (k, v)
                for k, v in den_node.props.props.items()
                if isinstance(v, (int, float, bool, str))
            )

        config = RenderConfig(
            width=width,
            height=height,
            sample_count=sample_count,
            integrator=integ_name,
            iprops=iprops,
            rfilter=rfilter,
            denoiser=denoiser,
            dprops=dprops,
            sampler=(sampler.type if sampler is not None else "independent"),
            adaptive=(sampler is not None and sampler.type == "adaptive"),
            n_tris=int(self.tri_count),
            n_spheres=len(self.spheres),
            n_emitters=n_real_emitters,
            shadow_segments=(
                integrator.props.get_integer("shadowSegments", 8)
                if integrator is not None
                else 8
            ),
        )

        # envmap tables: oriented lat-long grid + luminance·sinθ pixel DPDF
        # (environmentmap.cpp:154-168 calculateProbs analog, ops/envmap.py)
        if envmap_emitter >= 0 and self.envmap_source is not None:
            env_tables, envmap_pick = envmap_mod.build_tables(
                self.envmap_source["image"],
                self.em_rows[envmap_emitter]["radiance"],
                self.envmap_source["euler"],
            )
        else:
            rad = (
                self.em_rows[envmap_emitter]["radiance"]
                if envmap_emitter >= 0
                else np.zeros(3, np.float32)
            )
            env_tables = envmap_mod.constant_tables(rad)
            envmap_pick = dpdf_mod.build(jnp.ones(1))

        scene = SceneData(
            geometry=geometry,
            shapes=shapes,
            bsdfs=bsdfs,
            textures=textures,
            emitters=emitters,
            media=media,
            camera=cam,
            emitter_pick=pick,
            envmap_emitter=_j(envmap_emitter, jnp.int32),
            envmap=env_tables,
            envmap_pick=envmap_pick,
            ambient_medium=_j(ambient_medium, jnp.int32),
            photons=photon_mod.empty_photon_map(),
        )
        extras = {"integrator_props": integrator.props if integrator else None}
        return scene, config, extras


def build_scene(root: SceneNode) -> tuple[SceneData, RenderConfig, dict]:
    return _Builder(root).build()


def load_scene(filename) -> tuple[SceneData, RenderConfig, dict]:
    """XML file → (SceneData, RenderConfig, extras). The `loadScene` analog
    (render.cpp:118-178) minus thread management (renders are explicit calls)."""
    return build_scene(load_from_xml(filename))


def build_bsdf_table(nodes, origin="."):
    """Standalone BSDF table from a list of <bsdf> SceneNodes — used by the
    ttest/chi2test runners (ttest.cpp:128-134, chi2test.cpp:118-124 addChild).
    Returns (Bsdfs, Textures); row i corresponds to nodes[i]."""
    root = SceneNode(tag="scene", type="", origin=str(origin))
    b = _Builder(root)
    for n in nodes:
        b.build_bsdf(n)
    return b.bsdf_texture_tables()
