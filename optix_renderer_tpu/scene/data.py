"""Flat scene representation: tagged-union struct-of-arrays pytrees.

This is the render-time scene. It deliberately adopts the *data model the
reference itself lowers to for its GPU path* — POD tagged unions per plugin
kind (`include/nori/optix/cuda_shared/{BsdfData,EmitterData,MediumData,
GeometryData}.h`) — rather than the C++ class hierarchy. All fields are
device arrays; together with `RenderConfig` (static, hashable) a scene fully
describes a render and is a valid jit/grad input.

Geometry is pre-transformed to world space at build time (the reference bakes
toWorld into vertices at OBJ load, obj.cpp:104-110, and uses identity instance
transforms in its IAS, OptixState.as.cpp:177-248 — same design).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp

from optix_renderer_tpu.core.dpdf import DiscretePDF
from optix_renderer_tpu.ops.bvh import Bvh
from optix_renderer_tpu.ops.envmap import EnvmapTables
from optix_renderer_tpu.ops.photon import PhotonMap


class BsdfType:
    """Mirrors BsdfData.h:11-75 tag values (+ phase slots for media)."""

    DIFFUSE = 0
    MIRROR = 1
    DIELECTRIC = 2
    MICROFACET = 3
    DISNEY = 4
    COUNT = 5


class EmitterType:
    """Mirrors EmitterData.h:11-69."""

    POINT = 0
    SPOT = 1
    AREA = 2
    ENVMAP = 3
    DIRECTIONAL = 4
    VOLUME = 5
    COUNT = 6


class MediumType:
    VACUUM = 0
    HOMOG = 1
    HETEROG = 2


class PhaseType:
    ISO = 0
    HG = 1
    SCHLICK = 2


class TextureType:
    CONST = 0
    CHECKER = 1
    IMAGE = 2


class EmitterGeom:
    NONE = 0
    MESH = 1
    SPHERE = 2


class Geometry(NamedTuple):
    """World-space triangle soup + analytic spheres (GeometryData.h analog).

    Triangles are stored as v0/edge1/edge2 for Möller–Trumbore; per-corner
    shading normals and UVs for barycentric interpolation
    (mesh.cpp:141-186 `setHitInformation` contract).
    """

    tri_v0: jnp.ndarray  # [T,3]
    tri_e1: jnp.ndarray  # [T,3] = v1 - v0
    tri_e2: jnp.ndarray  # [T,3] = v2 - v0
    tri_n0: jnp.ndarray  # [T,3] shading normals
    tri_n1: jnp.ndarray
    tri_n2: jnp.ndarray
    tri_uv0: jnp.ndarray  # [T,2]
    tri_uv1: jnp.ndarray
    tri_uv2: jnp.ndarray
    # UV-aligned tangent dp/du per triangle (mesh.cpp:176-185 TBN), zero where
    # the UV parameterization is degenerate → shading falls back to a Duff ONB
    tri_tang: jnp.ndarray  # [T,4] (xyz = dp/du, w = UV handedness ±1)
    tri_shape: jnp.ndarray  # [T] int32 shape id
    sph_center: jnp.ndarray  # [S,3]
    sph_radius: jnp.ndarray  # [S]
    sph_shape: jnp.ndarray  # [S] int32 shape id
    # LBVH over the triangle soup (ops/bvh.py); empty → brute-force sweep.
    # The BVH analog of the reference's Scene-owned BVH (scene.h:41-201) and
    # OptiX GAS/IAS (OptixState.as.cpp) — built at scene compile, traversed
    # by a stackless threaded walk.
    bvh: Bvh
    # LBVH over the analytic spheres (the per-shape-type GAS split of
    # OptixState.as.cpp:47-169; the reference CPU BVH indexes all shapes'
    # primitives in one tree, bvh.h:43-171). Empty → brute-force sweep.
    sph_bvh: Bvh


class Shapes(NamedTuple):
    """Per-shape attachment table (shape.h:104-237: bsdf/emitter/medium links)."""

    bsdf: jnp.ndarray  # [N] int32 bsdf id
    emitter: jnp.ndarray  # [N] int32 emitter id or -1
    interior_medium: jnp.ndarray  # [N] int32 medium id or -1
    exterior_medium: jnp.ndarray  # [N] int32 medium id or -1
    normal_tex: jnp.ndarray  # [N] int32 texture id or -1 (tangent-space normal map)


class Bsdfs(NamedTuple):
    """Tagged-union BSDF table (BsdfData.h:11-75).

    Color slots are texture ids (constants become constant textures, the same
    normalization the reference performs in Diffuse::cloneAndInit).
    disney: [B,10] = baseColor handled via albedo_tex; params are
    (metallic, subsurface, specular, roughness, specularTint, anisotropic,
     sheen, sheenTint, clearcoat, clearcoatGloss) — disney.cpp:32-41.
    """

    type: jnp.ndarray  # [B] int32
    albedo_tex: jnp.ndarray  # [B] int32 texture id (diffuse albedo / disney baseColor)
    int_ior: jnp.ndarray  # [B]
    ext_ior: jnp.ndarray  # [B]
    alpha: jnp.ndarray  # [B] microfacet roughness
    kd: jnp.ndarray  # [B,3] microfacet diffuse base color
    ks: jnp.ndarray  # [B] = 1 - max(kd) (microfacet.cpp:55)
    disney: jnp.ndarray  # [B,10]


class Textures(NamedTuple):
    """Tagged-union texture table (texture.h / consttexture / checkerboard / PNG).

    Image texels live in one padded stack `image_data [I,Hmax,Wmax,3]` with
    per-image true sizes — lookups are gathers, wrap modes applied in-kernel.
    """

    type: jnp.ndarray  # [X] int32
    value: jnp.ndarray  # [X,3] const value / checker color1
    value2: jnp.ndarray  # [X,3] checker color2
    scale_uv: jnp.ndarray  # [X,2] checkerboard scale (checkerboard.cpp)
    shift_uv: jnp.ndarray  # [X,2] checkerboard delta/shift
    image_id: jnp.ndarray  # [X] int32 index into image_data or -1
    image_data: jnp.ndarray  # [I,Hmax,Wmax,3] float32 linear RGB
    image_hw: jnp.ndarray  # [I,2] int32 true (h,w)


class Emitters(NamedTuple):
    """Tagged-union emitter table (EmitterData.h:11-69) + sampling tables.

    Mesh-area emitters carry a padded per-triangle area CDF so area sampling
    (arealight.cpp:75-127 via mesh.cpp:15-46 DiscretePDF) is a searchsorted.
    """

    type: jnp.ndarray  # [E] int32
    radiance: jnp.ndarray  # [E,3] (area/volume/envmap-scale)
    position: jnp.ndarray  # [E,3] (point/spot)
    power: jnp.ndarray  # [E,3] (point/spot)
    direction: jnp.ndarray  # [E,3] (spot/directional)
    cos_falloff_start: jnp.ndarray  # [E] (spot, spotlight.cpp:53-70)
    cos_falloff_end: jnp.ndarray  # [E]
    angular_radius: jnp.ndarray  # [E] directional (directionalLight.cpp:90-136)
    shape: jnp.ndarray  # [E] attached shape id or -1
    geom_kind: jnp.ndarray  # [E] EmitterGeom
    tri_offset: jnp.ndarray  # [E] first global triangle of the attached mesh
    tri_count: jnp.ndarray  # [E]
    tri_cdf: jnp.ndarray  # [E, MAXT] normalized area CDF (padded with 1s)
    area: jnp.ndarray  # [E] total surface area (or sphere area)
    sphere_id: jnp.ndarray  # [E] global sphere index for sphere-shaped emitters
    light_prob: jnp.ndarray  # [E] emitter-pick weight (emitter.h:151)
    # volume-emitter sampling tables (volumelight.cpp:47-79 via
    # Shape::sampleVolume, shape.cpp:97-106: bbox-uniform for meshes,
    # exact ball for spheres; pdf = 1/volume)
    bbox_min: jnp.ndarray  # [E,3] attached-shape bbox
    bbox_extent: jnp.ndarray  # [E,3]
    volume: jnp.ndarray  # [E] shape volume (bbox volume / (4/3)πr³)


class Media(NamedTuple):
    """Media + phase functions (medium.h:26-90, homogmedium.cpp,
    heterogmedium.cpp).

    Heterogeneous media reference a dense voxel-grid stack (the NanoVDB-grid
    analog, NvdbVolume.h:14-86): grids are padded to a common [D,H,W] so
    lookups are plain gathers; per-volume true dims + world bboxes drive the
    index transform (the worldToIndexF analog, heterogmedium.cpp:105-140).
    """

    type: jnp.ndarray  # [M] int32 MediumType
    sigma_a: jnp.ndarray  # [M,3]
    sigma_s: jnp.ndarray  # [M,3]
    phase_type: jnp.ndarray  # [M] int32 PhaseType
    phase_g: jnp.ndarray  # [M] HG g / Schlick k
    emitter: jnp.ndarray  # [M] emitter id or -1 (volume emitter attachment)
    # heterogeneous-medium fields (heterogmedium.cpp:47-51 params)
    vol_id: jnp.ndarray  # [M] int32 index into the volume stack or -1
    density_scale: jnp.ndarray  # [M]
    temperature_scale: jnp.ndarray  # [M]
    # volume stack (empty [0,...] when the scene has no heterog media)
    vol_density: jnp.ndarray  # [V,D,H,W] float32
    vol_temperature: jnp.ndarray  # [V,D,H,W] float32 (zeros when absent)
    vol_dims: jnp.ndarray  # [V,3] int32 true (D,H,W)
    vol_bbox_min: jnp.ndarray  # [V,3] world-space bbox
    vol_bbox_max: jnp.ndarray  # [V,3]
    vol_majorant: jnp.ndarray  # [V] max unscaled density
    # fused trilinear-corner stacks: row i holds the 8 cell-corner values of
    # base voxel i in a one-voxel ZERO-PADDED index space (strides
    # (D+1)(H+1)(W+1)), so a lookup is ONE [N,8]-row gather + an in-lane dot
    # (the hot op of delta/ratio tracking, heterogmedium.cpp:105-174 analog)
    # None defaults (NOT empty jnp arrays: a module-level array literal would
    # initialize the JAX backend at import time, breaking multi-process
    # workers that must configure device counts first)
    vol_corners: jnp.ndarray | None = None  # [V, (D+1)(H+1)(W+1), 8]
    vol_tcorners: jnp.ndarray | None = None  # [V, ..., 8] temperature


class Camera(NamedTuple):
    """Perspective camera with thin-lens DoF (perspective.cpp:68-130).

    Only raw parameters are stored; the sample→camera projection is derived
    in-jit from these plus the static RenderConfig width/height, so resolution
    changes don't invalidate the scene and fov/lens are differentiable.
    """

    to_world: jnp.ndarray  # [4,4]
    fov: jnp.ndarray  # [] horizontal fov in degrees
    near_clip: jnp.ndarray  # []
    far_clip: jnp.ndarray  # []
    lens_radius: jnp.ndarray  # []
    focal_distance: jnp.ndarray  # []


class SceneData(NamedTuple):
    """Everything the render kernels read. A single pytree — jit/grad input."""

    geometry: Geometry
    shapes: Shapes
    bsdfs: Bsdfs
    textures: Textures
    emitters: Emitters
    media: Media
    camera: Camera
    emitter_pick: DiscretePDF  # scene.cpp:179-184 lightProb-weighted DPDF
    envmap_emitter: jnp.ndarray  # [] int32 emitter id or -1
    # image-based envmap (ops/envmap.py; environmentmap.cpp:73-168):
    # oriented lat-long radiance grid + luminance·sinθ pixel DPDF
    envmap: EnvmapTables
    envmap_pick: DiscretePDF
    ambient_medium: jnp.ndarray  # [] int32 medium id or -1
    # photon map (ops/photon.py), populated by render() when the integrator
    # is "photonmapper" (the Integrator::preprocess analog, render.cpp:272);
    # empty otherwise.
    photons: PhotonMap


@dataclass(frozen=True)
class RenderConfig:
    """Static render parameters — hashable, passed as a jit static arg.

    The analog of the reference's XML-root scene attributes + OptixRenderer
    config (sampleCount etc.); changing any of these retraces, which is the
    analog of the reference's NVRTC bound-value specialization.
    """

    width: int = 1280
    height: int = 720
    sample_count: int = 8
    integrator: str = "normals"
    max_depth: int = 16
    rr_min_depth: int = 0  # reference path_mis applies RR from the first bounce
    sampler: str = "independent"
    seed: int = 0
    # reconstruction filter (rfilter.cpp): gaussian/mitchell/tent/box
    rfilter: str = "gaussian"
    # adaptive sampler knobs (adaptive.cpp:18-22)
    adaptive: bool = False
    adaptive_uniform_rounds: int = 4
    # static unroll bound for shadow-ray boundary crossings through media
    # (path_vol_mis.cpp:26-46 traceShadowray's unbounded while-loop); scenes
    # with deeper medium nesting should raise it via XML/CLI override
    shadow_segments: int = 8
    # counts (static shapes of the tables)
    n_tris: int = 0
    n_spheres: int = 0
    n_emitters: int = 0
    # integrator-specific scalar properties as a frozen (key, value) tuple
    # (e.g. av's "length", photonmapper's "photonCount")
    iprops: tuple = ()
    # scene-attached denoiser (<denoiser type="simple">, scene.h:41-201):
    # "" = none; "simple" = cross-bilateral (simple.cpp); "learned" = CNN
    denoiser: str = ""
    # denoiser properties (sigma_d, sigma_vr, range — simple.cpp:29-82)
    dprops: tuple = ()

    def dprop(self, key, default=None):
        for k, v in self.dprops:
            if k == key:
                return v
        return default

    def iprop(self, key, default=None):
        for k, v in self.iprops:
            if k == key:
                return v
        return default
