"""Scene compiler: parsed scene records -> flat tensors on the render device.

Port of tpu_pbrt/scene/compiler.py::compile_scene, reduced to the
directive set the port renders:

- shapes: every shape the reference tessellates ("trianglemesh",
  "plymesh", "sphere", "disk", "cylinder", "cone", "paraboloid",
  "hyperboloid", "heightfield2", "loopsubdiv" and "curve", with the
  reference's grid sizes), one world-space triangle soup with shading
  normals and uvs; object instances expanded by baking each use's
  transform into its shapes; an unknown shape name is skipped with the
  reference's warning; an animated transform (motion blur over an open
  shutter) bakes a second, shutter-end keyframe of the vertices
  (tri_verts1), which rays lerp linearly at their time, as the reference
  does (pbrt decomposes and slerps), under a BVH over the union of both
  keyframes' bounds and the 64-row cubic-in-time treelet features; an
  animated camera takes its shutter-start keyframe, with a warning;
- materials: "matte", "plastic", "metal", "glass", "mirror", "uber",
  "substrate", "translucent", "disney" (its parameters in d_* columns),
  "hair" (h_* columns; the per-triangle dpdu shading tangent tri_tanT),
  "fourier" (the scene's one .bsdf table, mat["_fourier"]), "subsurface"
  and "kdsubsurface" (a sub_id per row and one baked radial profile per
  material and channel in dev["bssrdf"]) and "mix" (its two sub-materials appended
  as real rows of the table, resolved per lane at shading time), and
  "none" (a null interface: rays pass through it); constant parameters
  fold as the reference folds them, every other texture gets an id in
  a structurally deduplicated registry and goes to
  core/texture_eval.py (the mip atlas and the compiled evaluators),
  with the per-triangle dpdu/dpdv table the ray-differential footprint
  needs; a bump map is parsed and not applied, as in the reference;
- participating media: `MakeNamedMedium` "homogeneous" and "grid" (or
  "heterogeneous") rows with presets and scale, the shapes'
  `MediumInterface` as per-triangle inside/outside medium ids, and the
  camera's medium;
- lights: "diffuse" area lights (one row per emissive triangle, as pbrt
  makes one DiffuseAreaLight per Triangle), "point", "spot" and
  "distant" lights, "goniometric" and "projection" lights (their maps in
  one shared light atlas), and "infinite" environment lights (an HDR
  lat-long map with its 2D importance distribution; with several, every
  one gets a row and the last map is the scene's, as in the reference),
  with the spatial (default), power or uniform light-pick strategy;
- cameras "perspective", "orthographic", "environment" and "realistic",
  the pixel filters of core/filters.py, film "image" (any other name
  warns and takes it), any accelerator name (the BVH is built for all),
  every sampler the reference dispatches ("zerotwosequence" and its
  aliases, "random", "stratified", "halton", "sobol"), and the
  integrators of integrators.PORTED ("path", "directlighting",
  "whitted", "ao", "volpath", "bdpt", "sppm", "mlt") and any
  registered with integrators.register_integrator.

Any other integrator raises PbrtError naming the available ones. The
substitutions are the reference's own, each with its warning where the
reference gives one: an area light of any name is diffuse, a scene
without geometry gets one degenerate far-away triangle, an unknown
lightsamplestrategy picks lights by power, a map
that cannot be read becomes a constant map, an unknown shape is
skipped, an unknown light is ignored, an unknown camera becomes
"perspective" and an unknown filter box(0.5), and "maxmindist" or an
unknown sampler the (0,2)-sequence, and an unknown medium type an empty
medium row. The host-side work (tessellation, BVH build, leaf ordering,
light rows, the treelet pack, the light distributions, the media rows)
is the reference's numpy code, so the uploaded tables are bit-identical
to the reference's (tests/test_torch_scene.py and
tests/test_torch_shapes.py pin that through scene/bridge.py).
"""

from __future__ import annotations

import copy
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tpu_pbrt_torch.accel.build import build_bvh, triangle_bounds
from tpu_pbrt_torch.cameras import make_camera
from tpu_pbrt_torch.config import cfg, resolve_device
from tpu_pbrt_torch.core import bxdf
from tpu_pbrt_torch.core.film import Film, make_film
from tpu_pbrt_torch.core.filters import make_filter
from tpu_pbrt_torch.core import media as md
from tpu_pbrt_torch.core.lights_dev import (
    LIGHT_AREA,
    LIGHT_DISTANT,
    LIGHT_GONIO,
    LIGHT_INFINITE,
    LIGHT_POINT,
    LIGHT_PROJECTION,
    LIGHT_SPOT,
    SpatialLightDistribution,
)
from tpu_pbrt_torch.core.sampling import Distribution1D, Distribution2D
from tpu_pbrt_torch.core.spectrum import luminance
from tpu_pbrt_torch.integrators import check_ported
from tpu_pbrt_torch.utils.error import Error, Warning
from tpu_pbrt_torch.utils.fileutil import resolve_filename


@dataclass
class SamplerSpec:
    name: str
    spp: int
    params: Any


@dataclass
class CompiledScene:
    """Host handle + the device tables every kernel consumes."""

    dev: Dict[str, Any]
    film: Film
    camera: Any  # CompiledCamera
    sampler: SamplerSpec
    integrator_name: str
    integrator_params: Any
    n_tris: int
    n_lights: int
    world_min: np.ndarray
    world_max: np.ndarray
    world_center: np.ndarray
    world_radius: float
    device: torch.device
    light_distribution_name: str = "spatial"
    light_distr: Optional[Distribution1D] = None
    spatial_distr: Any = None
    has_envmap: bool = False
    #: the medium the camera sits in (-1: vacuum)
    camera_medium_id: int = -1
    #: the scene holds null-interface (MAT_NONE) surfaces: shadow rays
    #: walk through them (integrators/common.py::unoccluded_tr)
    has_null_materials: bool = False
    #: the compiled texture evaluators (core/texture_eval.TextureTable;
    #: None when every parameter folded to a constant)
    tex_eval: Any = None
    #: the material slots that carry a texture id on some row
    tex_used: frozenset = frozenset()
    #: slot -> the texture ids that slot's column holds
    tex_slot_ids: Optional[Dict[str, tuple]] = None


def _rgb(v) -> np.ndarray:
    a = np.asarray(v, np.float64).reshape(-1)
    if a.size == 1:
        return np.full(3, float(a[0]))
    return a[:3]


def _fold_const(node, default):
    """Try to reduce a texture node to a constant; returns (value, folded)
    (the reference's folding: plain values, const nodes, and scale/mix
    nodes of constants)."""
    if node is None:
        return default, True
    if isinstance(node, tuple):
        tag = node[0]
        if tag in ("const", "constf"):
            return node[1], True
        if tag == "scale":
            a, fa = _fold_const(node[1], 1.0)
            b, fb = _fold_const(node[2], 1.0)
            if fa and fb:
                return np.asarray(a) * np.asarray(b), True
        if tag == "mix":
            a, fa = _fold_const(node[1], 0.0)
            b, fb = _fold_const(node[2], 1.0)
            t, ft = _fold_const(node[3], 0.5)
            if fa and fb and ft:
                return np.asarray(a) * (1 - np.asarray(t)) + np.asarray(b) * np.asarray(t), True
        return default, False
    # a plain value (float or rgb array) captured directly by TextureParams
    return node, True


def _tess_mesh(params, scene_dir):
    idx = params.find_int("indices")
    P = params.find_point3("P")
    if idx is None or P is None:
        Error("Vertex indices and positions \"P\" must be provided with triangle mesh.")
    idx = np.asarray(idx, np.int64).reshape(-1, 3)
    P = np.asarray(P, np.float64).reshape(-1, 3)
    N = params.find_normal("N")
    uv = params.find_point2("uv")
    if uv is None:
        uv = params.find_point2("st")
        if uv is None:
            fuv = params.find_float("uv")
            if fuv is None:
                fuv = params.find_float("st")
            uv = np.asarray(fuv, np.float64).reshape(-1, 2) if fuv is not None else None
    verts = P[idx]
    normals = np.asarray(N, np.float64).reshape(-1, 3)[idx] if N is not None else None
    uvs = np.asarray(uv, np.float64).reshape(-1, 2)[idx] if uv is not None else None
    return verts, normals, uvs


def _tess_ply(params, scene_dir):
    """plymesh: the file's triangles as a triangle mesh (pbrt-v3's
    plymesh.cpp builds a TriangleMesh), read by scene/plyreader.py, whose
    keys are vertices, normals, uvs and indices."""
    from tpu_pbrt_torch.scene.plyreader import read_ply

    path = resolve_filename(params.find_one_string("filename", ""), scene_dir)
    if not os.path.exists(path):
        Error(f"PLY file \"{path}\" not found.")
    mesh = read_ply(path)
    idx = mesh["indices"].reshape(-1, 3)
    verts = mesh["vertices"][idx]
    normals = mesh["normals"][idx] if mesh.get("normals") is not None else None
    uvs = mesh["uvs"][idx] if mesh.get("uvs") is not None else None
    return verts, normals, uvs


def _grid_to_tris(n_u, n_v, wrap_u=False):
    """Vertex index triples of an (n_v+1, n_u+1) grid of points."""
    tris = []
    for v in range(n_v):
        for u in range(n_u):
            u1 = (u + 1) % (n_u + 1) if wrap_u else u + 1
            a = v * (n_u + 1) + u
            b = v * (n_u + 1) + u1
            c = (v + 1) * (n_u + 1) + u1
            d = (v + 1) * (n_u + 1) + u
            tris.append((a, b, c))
            tris.append((a, c, d))
    return np.asarray(tris, np.int64)


def _tess_param_surface(point_fn, normal_fn, u_max, v_range, n_u, n_v):
    """Tessellate a parametric surface: point_fn(u, v) -> (..., 3), u in
    [0, u_max] (phi), v in v_range."""
    us = np.linspace(0.0, u_max, n_u + 1)
    vs = np.linspace(v_range[0], v_range[1], n_v + 1)
    uu, vv = np.meshgrid(us, vs)  # (n_v+1, n_u+1)
    pts = point_fn(uu, vv)
    nrm = normal_fn(uu, vv) if normal_fn is not None else None
    idx = _grid_to_tris(n_u, n_v)
    verts = pts.reshape(-1, 3)[idx]
    normals = nrm.reshape(-1, 3)[idx] if nrm is not None else None
    v_den = v_range[1] - v_range[0]
    if abs(v_den) < 1e-9:
        v_den = 1e-9
    uvn = np.stack([uu / max(u_max, 1e-9), (vv - v_range[0]) / v_den], axis=-1)
    uvs = uvn.reshape(-1, 2)[idx]
    return verts, normals, uvs


def _tess_sphere(params, scene_dir):
    """pbrt's Sphere (radius, zmin, zmax, phimax) as a 64 x 32 grid in
    (phi, theta) with normals p / r."""
    r = params.find_one_float("radius", 1.0)
    zmin = params.find_one_float("zmin", -r)
    zmax = params.find_one_float("zmax", r)
    phimax = math.radians(params.find_one_float("phimax", 360.0))
    theta_min = math.acos(np.clip(zmin / r, -1, 1))
    theta_max = math.acos(np.clip(zmax / r, -1, 1))
    n_u, n_v = 64, 32

    def pt(u, v):
        return np.stack([r * np.sin(v) * np.cos(u), r * np.sin(v) * np.sin(u), r * np.cos(v)],
                        axis=-1)

    def nrm(u, v):
        return pt(u, v) / r

    return _tess_param_surface(pt, nrm, phimax, (theta_min, theta_max), n_u, n_v)


def _tess_disk(params, scene_dir):
    """pbrt's Disk (height, radius, innerradius, phimax) as a 64 x 1 grid
    in (phi, radius), normal +z."""
    h = params.find_one_float("height", 0.0)
    r = params.find_one_float("radius", 1.0)
    ri = params.find_one_float("innerradius", 0.0)
    phimax = math.radians(params.find_one_float("phimax", 360.0))

    def pt(u, v):
        rad = ri + (r - ri) * v
        return np.stack([rad * np.cos(u), rad * np.sin(u), np.full_like(u, h)], axis=-1)

    def nrm(u, v):
        return np.broadcast_to(np.array([0.0, 0.0, 1.0]), u.shape + (3,))

    return _tess_param_surface(pt, nrm, phimax, (0.0, 1.0), 64, 1)


def _tess_cylinder(params, scene_dir):
    """pbrt's Cylinder (radius, zmin, zmax, phimax) as a 64 x 8 grid."""
    r = params.find_one_float("radius", 1.0)
    zmin = params.find_one_float("zmin", -1.0)
    zmax = params.find_one_float("zmax", 1.0)
    phimax = math.radians(params.find_one_float("phimax", 360.0))

    def pt(u, v):
        return np.stack([r * np.cos(u), r * np.sin(u), v], axis=-1)

    def nrm(u, v):
        return np.stack([np.cos(u), np.sin(u), np.zeros_like(u)], axis=-1)

    return _tess_param_surface(pt, nrm, phimax, (zmin, zmax), 64, 8)


def _tess_cone(params, scene_dir):
    """pbrt's Cone (radius, height, phimax) as a 64 x 16 grid that stops
    just short of the apex; geometric normals."""
    r = params.find_one_float("radius", 1.0)
    h = params.find_one_float("height", 1.0)
    phimax = math.radians(params.find_one_float("phimax", 360.0))

    def pt(u, v):
        rad = r * (1.0 - v / h)
        return np.stack([rad * np.cos(u), rad * np.sin(u), v], axis=-1)

    return _tess_param_surface(pt, None, phimax, (0.0, h * (1 - 1e-6)), 64, 16)


def _tess_paraboloid(params, scene_dir):
    """pbrt's Paraboloid (radius, zmin, zmax, phimax) as a 64 x 16 grid."""
    r = params.find_one_float("radius", 1.0)
    zmin = params.find_one_float("zmin", 0.0)
    zmax = params.find_one_float("zmax", 1.0)
    phimax = math.radians(params.find_one_float("phimax", 360.0))

    def pt(u, v):
        rad = r * np.sqrt(np.maximum(v, 0.0) / zmax)
        return np.stack([rad * np.cos(u), rad * np.sin(u), v], axis=-1)

    return _tess_param_surface(pt, None, phimax, (zmin, zmax), 64, 16)


def _tess_hyperboloid(params, scene_dir):
    """pbrt's Hyperboloid (p1, p2, phimax): the segment p1-p2 swept about
    the z axis, a 64 x 16 grid."""
    p1 = np.asarray(params.find_one_point3("p1", [0.0, 0.0, 0.0]), np.float64)
    p2 = np.asarray(params.find_one_point3("p2", [1.0, 1.0, 1.0]), np.float64)
    phimax = math.radians(params.find_one_float("phimax", 360.0))

    def pt(u, v):
        p = p1[None, None] * (1 - v[..., None]) + p2[None, None] * v[..., None]
        xr = np.cos(u) * p[..., 0] - np.sin(u) * p[..., 1]
        yr = np.sin(u) * p[..., 0] + np.cos(u) * p[..., 1]
        return np.stack([xr, yr, p[..., 2]], axis=-1)

    return _tess_param_surface(pt, None, phimax, (0.0, 1.0), 64, 16)


def _tess_heightfield(params, scene_dir):
    """pbrt's Heightfield (nu x nv heights Pz over the unit square) as two
    triangles per grid cell, uv the (x, y) position."""
    nu = params.find_one_int("nu", -1)
    nv = params.find_one_int("nv", -1)
    z = params.find_float("Pz")
    if nu <= 0 or nv <= 0 or z is None:
        Error("heightfield2 requires nu, nv, Pz")
    z = np.asarray(z, np.float64).reshape(nv, nu)
    xx, yy = np.meshgrid(np.linspace(0, 1, nu), np.linspace(0, 1, nv))
    pts = np.stack([xx, yy, z], axis=-1)
    idx = _grid_to_tris(nu - 1, nv - 1)
    uv = np.stack([xx, yy], axis=-1).reshape(-1, 2)
    return pts.reshape(-1, 3)[idx], None, uv[idx]


def _tess_loopsubdiv(params, scene_dir):
    """pbrt's LoopSubdiv: the control mesh subdivided `levels` times
    (shapes/loopsubdiv.py), limit positions and normals."""
    from tpu_pbrt_torch.shapes.loopsubdiv import loop_subdivide

    levels = params.find_one_int("levels", params.find_one_int("nlevels", 3))
    idx = params.find_int("indices")
    P = params.find_point3("P")
    if idx is None or P is None:
        Error("loopsubdiv requires indices and P")
    verts, normals = loop_subdivide(
        np.asarray(P, np.float64).reshape(-1, 3), np.asarray(idx, np.int64).reshape(-1, 3), levels
    )
    return verts, normals, None


def _tess_curve(params, scene_dir):
    """pbrt's Curve (cubic Bezier segments sharing their end points) as
    flat ribbons: 16 quads per segment across a side vector perpendicular
    to the tangent, the width interpolated from width0 to width1; uv is
    (along the curve, across it)."""
    cps = params.find_point3("P")
    if cps is None:
        Error("curve requires control points P")
    cps = np.asarray(cps, np.float64).reshape(-1, 3)
    if len(cps) < 4:
        Error("curve requires at least 4 control points")
    w0 = params.find_one_float("width0", params.find_one_float("width", 1.0))
    w1 = params.find_one_float("width1", params.find_one_float("width", 1.0))
    n_seg_pts = 16
    n_curves = max((len(cps) - 1) // 3, 1)
    # every segment at once, with the reference's per-segment arithmetic
    # (the same elementwise operations in the same order: bit-identical)
    idx = 3 * np.arange(n_curves)[:, None] + np.arange(4)[None, :]
    p0, p1, p2, p3 = (cps[idx[:, i]][:, None, :] for i in range(4))  # (C, 1, 3)
    t = np.linspace(0.0, 1.0, n_seg_pts + 1)[None, :, None]  # (1, n+1, 1)
    b = ((1 - t) ** 3 * p0 + 3 * (1 - t) ** 2 * t * p1 + 3 * (1 - t) * t * t * p2
         + t ** 3 * p3)
    tan = 3 * (1 - t) ** 2 * (p1 - p0) + 6 * (1 - t) * t * (p2 - p1) + 3 * t * t * (p3 - p2)
    tan /= np.maximum(np.linalg.norm(tan, axis=-1, keepdims=True), 1e-12)
    # side = tangent x reference axis, with a second axis where the
    # tangent turns parallel to the first
    axis = np.argmin(np.abs(tan[:, 0]), axis=-1)
    ref = np.eye(3)[axis][:, None, :]
    side = np.cross(tan, ref)
    nrm = np.linalg.norm(side, axis=-1, keepdims=True)
    alt = np.eye(3)[(axis + 1) % 3][:, None, :]
    side = np.where(nrm < 1e-6, np.cross(tan, alt), side)
    side /= np.maximum(np.linalg.norm(side, axis=-1, keepdims=True), 1e-12)
    u_glob = (np.arange(n_curves)[:, None] + t[:, :, 0]) / n_curves  # (C, n+1)
    half_w = 0.5 * ((1 - u_glob) * w0 + u_glob * w1)[..., None]
    lo, hi = b - side * half_w, b + side * half_w  # the ribbon's two edges
    a0, a1, b0_, b1_ = lo[:, :-1], hi[:, :-1], lo[:, 1:], hi[:, 1:]
    verts = np.stack([np.stack([a0, a1, b1_], 2), np.stack([a0, b1_, b0_], 2)], 2)
    ua, ub = u_glob[:, :-1], u_glob[:, 1:]
    zero, one = np.zeros_like(ua), np.ones_like(ua)
    uv1 = np.stack([np.stack([ua, zero], -1), np.stack([ua, one], -1), np.stack([ub, one], -1)], 2)
    uv2 = np.stack([np.stack([ua, zero], -1), np.stack([ub, one], -1), np.stack([ub, zero], -1)], 2)
    uvs = np.stack([uv1, uv2], 2)
    return verts.reshape(-1, 3, 3), None, uvs.reshape(-1, 3, 2)


#: shape type -> tessellator (ShapeRecord params, scene dir -> verts, normals, uvs)
_TESSELLATORS = {
    "trianglemesh": _tess_mesh,
    "plymesh": _tess_ply,
    "curve": _tess_curve,
    "sphere": _tess_sphere,
    "disk": _tess_disk,
    "cylinder": _tess_cylinder,
    "cone": _tess_cone,
    "paraboloid": _tess_paraboloid,
    "hyperboloid": _tess_hyperboloid,
    "heightfield2": _tess_heightfield,
    "loopsubdiv": _tess_loopsubdiv,
}


def tessellate_shape(rec) -> Optional[tuple]:
    """(verts, normals, uvs) of a ShapeRecord in object space, or None
    (with the reference's warning) for a shape name it does not know."""
    fn = _TESSELLATORS.get(rec.type)
    if fn is None:
        Warning(f'Shape "{rec.type}" unknown or not yet tessellatable; skipping.')
        return None
    return fn(rec.params, rec.scene_dir)


def _geometric_normals(verts: np.ndarray) -> np.ndarray:
    e1 = verts[:, 1] - verts[:, 0]
    e2 = verts[:, 2] - verts[:, 0]
    n = np.cross(e1, e2)
    ln = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.maximum(ln, 1e-20)
    return np.repeat(n[:, None, :], 3, axis=1)


#: the materials lower_materials lowers, with their type enum values
#: (a mix row is typed matte: its shading falls back to a diffuse blend
#: only past the static nesting depth of bxdf.resolve_mix)
_MAT_ENUM = {"none": bxdf.MAT_NONE, "matte": bxdf.MAT_MATTE, "plastic": bxdf.MAT_PLASTIC,
             "metal": bxdf.MAT_METAL, "glass": bxdf.MAT_GLASS, "mirror": bxdf.MAT_MIRROR,
             "uber": bxdf.MAT_UBER, "substrate": bxdf.MAT_SUBSTRATE,
             "translucent": bxdf.MAT_TRANSLUCENT, "mix": bxdf.MAT_MATTE,
             "disney": bxdf.MAT_DISNEY, "hair": bxdf.MAT_HAIR, "fourier": bxdf.MAT_FOURIER,
             "subsurface": bxdf.MAT_SUBSURFACE, "kdsubsurface": bxdf.MAT_SUBSURFACE}

#: the disney parameter slots, added to the table only when a scene uses
#: the material (every other scene's gather stays as it was)
_DISNEY_SLOTS = ("d_metallic", "d_spectint", "d_aniso", "d_sheen", "d_sheentint",
                 "d_clearcoat", "d_ccgloss", "d_strans", "d_flat", "d_dtrans")


def _ensure_disney_slots(tab, m):
    if "d_metallic" not in tab:
        for slot in _DISNEY_SLOTS:
            tab[slot] = np.zeros(m, np.float32)
        tab["d_thin"] = np.zeros(m, np.int32)


def _ensure_hair_slots(tab, m):
    if "h_beta_m" not in tab:
        tab["h_sigma_a"] = np.zeros((m, 3), np.float32)
        tab["h_beta_m"] = np.full(m, 0.3, np.float32)
        tab["h_beta_n"] = np.full(m, 0.3, np.float32)
        tab["h_alpha"] = np.full(m, 2.0, np.float32)


def _hair_sigma_a_from_reflectance(c, beta_n):
    """HairBSDF::SigmaAFromReflectance (hair.cpp)."""
    denom = (5.969 - 0.215 * beta_n + 2.532 * beta_n**2 - 10.73 * beta_n**3
             + 5.574 * beta_n**4 + 0.245 * beta_n**5)
    return (np.log(np.maximum(np.asarray(c, np.float64), 1e-4)) / denom) ** 2


#: classic measured subsurface media (Jensen, Marschner, Levoy & Hanrahan,
#: "A Practical Model for Subsurface Light Transport", SIGGRAPH 2001,
#: table 1): name -> (sigma_prime_s, sigma_a) in 1/mm, the reference's
#: rows of pbrt's GetMediumScatteringProperties catalog
_SSS_PRESETS = {
    "Skimmilk": ([0.70, 1.22, 1.90], [0.0014, 0.0025, 0.0142]),
    "Wholemilk": ([2.55, 3.21, 3.77], [0.0011, 0.0024, 0.014]),
    "Skin1": ([0.74, 0.88, 1.01], [0.032, 0.17, 0.48]),
    "Skin2": ([1.09, 1.59, 1.79], [0.013, 0.070, 0.145]),
    "Marble": ([2.19, 2.62, 3.00], [0.0021, 0.0041, 0.0071]),
    "Ketchup": ([0.18, 0.07, 0.03], [0.061, 0.97, 1.45]),
    "Cream": ([7.38, 5.47, 3.15], [0.0002, 0.0028, 0.0163]),
    "Spectralon": ([11.6, 20.4, 14.9], [0.00, 0.00, 0.00]),
}

#: material slot -> its texture-id column, and the name tex_used gives it
TEX_SLOTS = (("kd_tex", "kd"), ("ks_tex", "ks"), ("sigma_tex", "sigma"),
             ("rough_tex", "rough"), ("opacity_tex", "opacity"))


def lower_materials(mat_records: List, tex_registry, scene_dir: str = ".") -> Dict[str, Any]:
    """MaterialRecords -> the SoA material table (bxdf.MAT_COLUMNS) with
    the reference's defaults and constant folding. tex_registry(node)
    gives a non-constant texture its id (the reference's registry).

    A fourier material reads its `bsdffile` (relative to scene_dir) into
    the table's one "_fourier" entry (one table per scene, as in the
    reference); a subsurface or kdsubsurface row gets a "sub_id" and its
    medium (sigma_s, sigma_a, g, eta) goes to "_sss_rows", which
    compile_scene bakes into the BSSRDF profiles. Every substitution
    warns as the reference's does.

    A mix row's two sub-materials are appended as real rows of the same
    table and the mix row records (mix_a, mix_b, mix_amt); shading
    resolves a mix lane to one sub-row by a sampler draw before the
    gather (bxdf.resolve_mix). Nested mixes expand recursively. The mix
    columns exist only when a scene has a mix (their presence is the
    flag, as in the reference)."""
    mat_records = list(mat_records)
    mix_sub: Dict[int, tuple] = {}
    i_scan = 0
    while i_scan < len(mat_records):
        rec = mat_records[i_scan]
        if rec.type == "mix":
            m1 = rec.params.get("material1")
            m2 = rec.params.get("material2")
            if m1 is not None and m2 is not None:
                ia = len(mat_records)
                mat_records.append(m1)
                ib = len(mat_records)
                mat_records.append(m2)
                mix_sub[i_scan] = (ia, ib)
        i_scan += 1
    m = len(mat_records)
    tab = {
        "type": np.zeros(m, np.int32),
        "kd": np.zeros((m, 3), np.float32),
        "ks": np.zeros((m, 3), np.float32),
        "kr": np.zeros((m, 3), np.float32),
        "kt": np.zeros((m, 3), np.float32),
        "eta": np.ones((m, 3), np.float32),
        "k": np.zeros((m, 3), np.float32),
        "rough_u": np.zeros(m, np.float32),
        "rough_v": np.zeros(m, np.float32),
        "sigma": np.zeros(m, np.float32),
        "opacity": np.ones((m, 3), np.float32),
        "remap": np.ones(m, np.int32),
        "mix_a": np.full(m, -1, np.int32),
        "mix_b": np.full(m, -1, np.int32),
        "mix_amt": np.full(m, 0.5, np.float32),
        "sub_id": np.full(m, -1, np.int32),
        "kd_tex": np.full(m, -1, np.int32),
        "ks_tex": np.full(m, -1, np.int32),
        "sigma_tex": np.full(m, -1, np.int32),
        "rough_tex": np.full(m, -1, np.int32),
        "opacity_tex": np.full(m, -1, np.int32),
        "bump_tex": np.full(m, -1, np.int32),
    }

    #: (sigma_s, sigma_a, g, eta) of each subsurface material, in sub_id order
    sss_rows: List[tuple] = []

    for i, rec in enumerate(mat_records):
        t = rec.type
        # (the material factory has already turned an unknown name into matte)
        tab["type"][i] = _MAT_ENUM.get(t, bxdf.MAT_MATTE)
        p = rec.params

        def spec(key, default, slot, tex_slot=None):
            val, folded = _fold_const(p.get(key), default)
            if not folded:
                tid = tex_registry(p.get(key))
                if tex_slot is not None:
                    tab[tex_slot][i] = tid
                val = default  # the default lies beneath the texture lookup
            tab[slot][i] = _rgb(val)

        def flt(key, default, slot, tex_slot=None):
            val, folded = _fold_const(p.get(key), default)
            if not folded:
                tid = tex_registry(p.get(key))
                if tex_slot is not None:
                    tab[tex_slot][i] = tid
                val = default
            tab[slot][i] = float(np.asarray(val, np.float64).reshape(-1).mean())

        if t == "matte":
            spec("Kd", 0.5, "kd", "kd_tex")
            flt("sigma", 0.0, "sigma", "sigma_tex")
        elif t == "plastic":
            spec("Kd", 0.25, "kd", "kd_tex")
            spec("Ks", 0.25, "ks", "ks_tex")
            flt("roughness", 0.1, "rough_u", "rough_tex")
            tab["rough_v"][i] = tab["rough_u"][i]
            tab["remap"][i] = int(p.get("remaproughness", True))
        elif t == "metal":
            spec("eta", 1.0, "eta")
            spec("k", 1.0, "k")
            flt("roughness", 0.01, "rough_u", "rough_tex")
            tab["rough_v"][i] = tab["rough_u"][i]
            if p.get("uroughness") is not None:
                flt("uroughness", 0.01, "rough_u")
            if p.get("vroughness") is not None:
                flt("vroughness", 0.01, "rough_v")
            tab["remap"][i] = int(p.get("remaproughness", True))
        elif t == "none":
            pass  # the row keeps the defaults: a null interface
        elif t == "glass":
            spec("Kr", 1.0, "kr")
            spec("Kt", 1.0, "kt")
            flt("eta", 1.5, "eta")
            # nonzero uroughness or vroughness selects the microfacet lobes;
            # vroughness defaults to 0 on its own (glass.cpp)
            flt("uroughness", 0.0, "rough_u", "rough_tex")
            flt("vroughness", 0.0, "rough_v")
            tab["remap"][i] = int(p.get("remaproughness", True))
            tab["eta"][i] = tab["eta"][i][:1].repeat(3)
        elif t == "mirror":
            spec("Kr", 0.9, "kr")
        elif t == "uber":
            spec("Kd", 0.25, "kd", "kd_tex")
            spec("Ks", 0.25, "ks", "ks_tex")
            spec("Kr", 0.0, "kr")
            spec("Kt", 0.0, "kt")
            flt("roughness", 0.1, "rough_u", "rough_tex")
            tab["rough_v"][i] = tab["rough_u"][i]
            if p.get("uroughness") is not None:
                flt("uroughness", 0.1, "rough_u")
            if p.get("vroughness") is not None:
                flt("vroughness", 0.1, "rough_v")
            flt("eta", 1.5, "eta")
            tab["eta"][i] = tab["eta"][i][:1].repeat(3)
            spec("opacity", 1.0, "opacity", "opacity_tex")
            tab["remap"][i] = int(p.get("remaproughness", True))
        elif t == "substrate":
            spec("Kd", 0.5, "kd", "kd_tex")
            spec("Ks", 0.5, "ks", "ks_tex")
            flt("uroughness", 0.1, "rough_u", "rough_tex")
            flt("vroughness", 0.1, "rough_v")
            tab["remap"][i] = int(p.get("remaproughness", True))
        elif t == "translucent":
            spec("Kd", 0.25, "kd", "kd_tex")
            spec("Ks", 0.25, "ks", "ks_tex")
            spec("reflect", 0.5, "kr")
            spec("transmit", 0.5, "kt")
            flt("roughness", 0.1, "rough_u", "rough_tex")
            tab["rough_v"][i] = tab["rough_u"][i]
            tab["remap"][i] = int(p.get("remaproughness", True))
        elif t == "disney":
            # the Disney 2015 lobe set (disney.cpp): its parameters in the
            # d_* slots; the shared slots carry color, roughness and eta
            _ensure_disney_slots(tab, m)
            spec("color", 0.5, "kd", "kd_tex")
            flt("roughness", 0.5, "rough_u", "rough_tex")
            tab["rough_v"][i] = tab["rough_u"][i]
            flt("eta", 1.5, "eta")
            tab["eta"][i] = tab["eta"][i][:1].repeat(3)
            tab["remap"][i] = 0
            for key, slot, dflt in (
                ("metallic", "d_metallic", 0.0), ("speculartint", "d_spectint", 0.0),
                ("anisotropic", "d_aniso", 0.0), ("sheen", "d_sheen", 0.0),
                ("sheentint", "d_sheentint", 0.5), ("clearcoat", "d_clearcoat", 0.0),
                ("clearcoatgloss", "d_ccgloss", 1.0), ("spectrans", "d_strans", 0.0),
                ("flatness", "d_flat", 0.0), ("difftrans", "d_dtrans", 1.0),
            ):
                flt(key, dflt, slot)
            thin, _ = _fold_const(p.get("thin"), False)
            tab["d_thin"][i] = 1 if thin else 0
            sd, _ = _fold_const(p.get("scatterdistance"), 0.0)
            if np.any(np.asarray(sd, np.float64) > 0):
                Warning("disney scatterdistance > 0 (subsurface) is not supported; shading "
                        "as the solid Disney BSDF")
        elif t == "hair":
            # Chiang et al.'s HairBSDF (hair.cpp): sigma_a resolves in
            # HairMaterial::ComputeScatteringFunctions' order
            _ensure_hair_slots(tab, m)
            bn, _ = _fold_const(p.get("beta_n"), 0.3)
            bn = float(np.asarray(bn, np.float64).reshape(-1).mean())
            if p.get("sigma_a") is not None:
                sa, _ = _fold_const(p.get("sigma_a"), 1.3)
                sa = _rgb(sa)
            elif p.get("color") is not None:
                col, _ = _fold_const(p.get("color"), 0.5)
                sa = _hair_sigma_a_from_reflectance(_rgb(col), bn)
            else:
                eu, _ = _fold_const(p.get("eumelanin"), 1.3)
                ph, _ = _fold_const(p.get("pheomelanin"), 0.0)
                eu = float(np.asarray(eu, np.float64).reshape(-1).mean())
                ph = float(np.asarray(ph, np.float64).reshape(-1).mean())
                # the eumelanin and pheomelanin absorption spectra
                sa = eu * np.array([0.419, 0.697, 1.37]) + ph * np.array([0.187, 0.4, 1.05])
            tab["h_sigma_a"][i] = np.asarray(sa, np.float32)
            flt("beta_m", 0.3, "h_beta_m")
            tab["h_beta_n"][i] = bn
            flt("alpha", 2.0, "h_alpha")
            flt("eta", 1.55, "eta")
            tab["eta"][i] = tab["eta"][i][:1].repeat(3)
            # the colour of integrators that store only a diffuse albedo
            tab["kd"][i] = np.exp(-np.asarray(sa, np.float64) * 0.5)
        elif t == "fourier":
            # the tabulated FourierBSDF when its .bsdf file loads
            # (core/fourierbsdf.py); a loud 0.5 diffuse fallback otherwise
            fn, _ = _fold_const(p.get("bsdffile"), "")
            prev = tab.get("_fourier")
            tab_obj = None
            if fn and prev is not None and prev[1] == str(fn):
                tab_obj = prev[0]  # the same file: reuse it
            elif fn and prev is not None:
                Warning("multiple distinct fourier bsdffiles in one scene are not supported; "
                        "reusing the first table")
                tab_obj = prev[0]
            elif fn:
                from tpu_pbrt_torch.core.fourierbsdf import read_bsdf_file

                try:
                    tab_obj = read_bsdf_file(resolve_filename(str(fn), scene_dir))
                    tab["_fourier"] = (tab_obj, str(fn))
                except Exception as e:  # noqa: BLE001 - any unreadable file falls back
                    Warning(f'fourier: could not read "{fn}" ({e}); '
                            "SUBSTITUTING a 0.5 diffuse BSDF")
            else:
                Warning('fourier material without "bsdffile"; SUBSTITUTING a 0.5 diffuse BSDF')
            if tab_obj is None:
                tab["type"][i] = bxdf.MAT_MATTE
            tab["kd"][i] = 0.5
        elif t in ("subsurface", "kdsubsurface"):
            # BSSRDF transport (core/bssrdf.py): the surface is the smooth
            # Fresnel interface (glass kr / kt; gather_mat remaps the type),
            # the medium's beam-diffusion profile is baked per channel in
            # compile_scene, and `path` runs the Sample_Sp probe wave
            spec("Kr", 1.0, "kr")
            spec("Kt", 1.0, "kt")
            flt("eta", 1.33, "eta")
            tab["eta"][i] = tab["eta"][i][:1].repeat(3)
            eta_v = float(tab["eta"][i][0])
            g_v = 0.0
            if t == "subsurface":
                g_v = float(_fold_const(p.get("g"), 0.0)[0])
                preset = str(p.get("preset") or "")
                if preset and preset in _SSS_PRESETS:
                    sig_sp, sig_a = (np.asarray(v, np.float64) for v in _SSS_PRESETS[preset])
                elif preset:
                    Warning(f'subsurface: unknown medium preset "{preset}"; '
                            "using the sigma_a/sigma_prime_s parameters")
                    preset = ""
                if not preset:
                    sa, fold_a = _fold_const(p.get("sigma_a"), np.array([0.0011, 0.0024, 0.014]))
                    ss_, fold_s = _fold_const(p.get("sigma_s"), np.array([2.55, 3.21, 3.77]))
                    if not (fold_a and fold_s):
                        Warning("subsurface: textured sigma_a/sigma_prime_s are not supported "
                                "(the diffusion profile bakes per material); using constants")
                    sig_a = _rgb(sa).astype(np.float64)
                    sig_sp = _rgb(ss_).astype(np.float64)
                scale = float(_fold_const(p.get("scale"), 1.0)[0])
                sig_a = sig_a * scale
                sigma_s = sig_sp * scale / max(1.0 - g_v, 1e-3)
            else:
                from tpu_pbrt_torch.core.bssrdf import subsurface_from_diffuse

                kd_v, _ = _fold_const(p.get("Kd"), 0.5)
                mfp_v, _ = _fold_const(p.get("mfp"), 1.0)
                sigma_s, sig_a = subsurface_from_diffuse(_rgb(kd_v), _rgb(mfp_v), g_v, eta_v)
            ur, _ = _fold_const(p.get("uroughness"), 0.0)
            if np.max(np.asarray(ur, np.float64)) > 0:
                Warning("subsurface: rough interface not supported; using the smooth "
                        "specular interface")
            tab["sub_id"][i] = len(sss_rows)
            sss_rows.append((sigma_s, sig_a, g_v, eta_v))
            # the albedo of integrators without the probe wave (bdpt, sppm,
            # mlt shade the interface only, as in the reference)
            tab["kd"][i] = 0.5
        else:  # mix (mixmat.cpp): sub-rows ia/ib, resolved by `amount`
            amt, folded = _fold_const(p.get("amount"), 0.5)
            a = _rgb(amt)
            if not folded:
                Warning("mix: textured `amount` is not supported; using "
                        "its constant fallback for the selection probability")
            if a.min() != a.max():
                Warning("mix: colored `amount` selects by its channel MEAN "
                        "(per-channel mix weights are approximated)")
            if i in mix_sub:
                ia, ib = mix_sub[i]
                tab["mix_a"][i] = ia
                tab["mix_b"][i] = ib
                tab["mix_amt"][i] = float(np.clip(a.mean(), 0.0, 1.0))
            # the row's own parameters: a diffuse blend, used only past
            # the static nesting depth of the resolution
            m1 = p.get("material1")
            m2 = p.get("material2")
            kd1, _ = _fold_const(m1.params.get("Kd") if m1 else None, 0.5)
            kd2, _ = _fold_const(m2.params.get("Kd") if m2 else None, 0.5)
            tab["kd"][i] = _rgb(kd1) * a + _rgb(kd2) * (1 - a)
    if not (tab["mix_a"] >= 0).any():
        del tab["mix_a"], tab["mix_b"], tab["mix_amt"]
    if sss_rows:
        tab["_sss_rows"] = sss_rows
    else:
        del tab["sub_id"]
    return tab


def bake_bssrdf(sss_rows) -> "Any":
    """Each subsurface material's per-channel beam-diffusion profile
    (core/bssrdf.py: the albedo is constant per material, so bssrdf.cpp's
    (rho, r) spline table collapses to one radial profile per (material,
    channel)), as a BakedBSSRDF of numpy arrays."""
    from tpu_pbrt_torch.core.bssrdf import N_RADII, BakedBSSRDF, bake_profile

    M = len(sss_rows)
    b_radii = np.zeros((M, 3, N_RADII), np.float32)
    b_prof = np.zeros((M, 3, N_RADII), np.float32)
    b_cdf = np.zeros((M, 3, N_RADII), np.float32)
    b_rho = np.zeros((M, 3), np.float32)
    b_rmax = np.zeros((M, 3), np.float32)
    b_eta = np.zeros((M,), np.float32)
    for mrow, (sigma_s, sigma_a, g_v, eta_v) in enumerate(sss_rows):
        b_eta[mrow] = eta_v
        for c in range(3):
            ra, pr, cd, re, rm = bake_profile(
                float(np.asarray(sigma_s).reshape(-1)[c]),
                float(np.asarray(sigma_a).reshape(-1)[c]), g_v, eta_v)
            b_radii[mrow, c], b_prof[mrow, c], b_cdf[mrow, c] = ra, pr, cd
            b_rho[mrow, c], b_rmax[mrow, c] = re, rm
    return BakedBSSRDF(radii=b_radii, profile=b_prof, cdf=b_cdf, rho_eff=b_rho, r_max=b_rmax,
                       eta=b_eta)


def _read_envmap(path: str, L) -> np.ndarray:
    """The infinite light's map scaled by L, or the reference's constant
    4x8 map (with its warning) when the file cannot be read."""
    from tpu_pbrt_torch.utils import imageio

    try:
        return (imageio.read_image(path) * L[None, None]).astype(np.float32)
    except Exception as e:  # noqa: BLE001 - the reference substitutes on any failure
        Warning(f'could not read environment map "{path}": {e}; using constant')
        return np.full((4, 8, 3), L, np.float32)


def _read_light_map(fn: str, scene_dir: str) -> np.ndarray:
    """A goniometric or projection light's map as (h, w, 3) f32: the file,
    or the reference's constant 1x1 map (with its warning) when there is
    none or it cannot be read."""
    from tpu_pbrt_torch.utils import imageio

    img = None
    if fn:
        try:
            img = np.asarray(imageio.read_image(resolve_filename(fn, scene_dir)), np.float32)
        except Exception as e:  # noqa: BLE001 - the reference substitutes on any failure
            Warning(f'could not read light map "{fn}": {e}; using constant')
    if img is None:
        img = np.ones((1, 1, 3), np.float32)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    return np.ascontiguousarray(img[..., :3], np.float32)


def compile_scene(api, device=None) -> CompiledScene:
    """Compile the API's world into tables on `device` (default: the API's
    device, which defaults to CUDA; see config.resolve_device)."""
    device = resolve_device(device) if device is not None else getattr(
        api, "device", None) or resolve_device(None)
    ro = api.render_options
    opts = api.options
    check_ported(ro.integrator_name)
    if ro.camera_to_world.is_animated():
        # the reference builds its camera from the shutter-start keyframe
        Warning("the camera transform is animated: rendering with its shutter-start "
                "keyframe (the end keyframe is ignored)")

    # -- film / filter / camera / sampler --------------------------------
    filt = make_filter(ro.filter_name, ro.filter_params)
    film = make_film(ro.film_name, ro.film_params, filt, opts)
    shutter = (
        ro.camera_params.find_one_float("shutteropen", 0.0),
        ro.camera_params.find_one_float("shutterclose", 1.0),
    )
    camera = make_camera(
        ro.camera_name, ro.camera_params, ro.camera_to_world[0],
        film.full_resolution, shutter, film_diag=film.diagonal,
        scene_dir=getattr(api, "scene_dir", "."), device=device,
    )
    spp = ro.sampler_params.find_one_int("pixelsamples", 16)
    if getattr(opts, "quick_render", False):
        spp = max(1, spp // 4)
    sampler = SamplerSpec(ro.sampler_name, spp, ro.sampler_params)

    # -- gather shapes (object instances expanded: each use bakes its
    # transform into a copy of every shape record of the instance) -------
    shape_list = list(ro.shapes)
    for use in ro.instance_uses:
        for rec in ro.instances.get(use.name, []):
            r2 = copy.copy(rec)
            r2.object_to_world = type(rec.object_to_world)(
                [use.instance_to_world[i] * rec.object_to_world[i] for i in range(2)])
            shape_list.append(r2)

    all_verts, all_normals, all_uvs = [], [], []
    all_verts1 = []  # the shutter-end keyframe of every shape
    any_motion = False
    all_mat, all_light = [], []
    mat_records: List = []
    mat_index: Dict[int, int] = {}
    light_rows: List[dict] = []
    light_atlas_chunks: List[np.ndarray] = []  # goniometric/projection maps

    shape_tri_counts: List = []  # (ShapeRecord, n_tris), for the medium interfaces

    def mat_id_for(mrec):
        if mrec is None:
            from tpu_pbrt_torch.scene.api import MaterialRecord

            mrec = MaterialRecord("none", {})
        key = id(mrec)
        if key not in mat_index:
            mat_index[key] = len(mat_records)
            mat_records.append(mrec)
        return mat_index[key]

    for rec in shape_list:
        tess = tessellate_shape(rec)
        if tess is None:
            continue
        verts, normals, uvs = tess
        o2w = rec.object_to_world[0]
        o2w1 = rec.object_to_world[1]
        wverts = o2w.apply_point(verts.reshape(-1, 3)).reshape(-1, 3, 3)
        # the shutter-end keyframe: vertices lerp LINEARLY in the ray's
        # time, as in the reference (pbrt's AnimatedTransform decomposes
        # and slerps, which differs for large rotations)
        if not np.allclose(o2w.m, o2w1.m):
            wverts1 = o2w1.apply_point(verts.reshape(-1, 3)).reshape(-1, 3, 3)
            any_motion = True
        else:
            wverts1 = wverts
        if normals is not None:
            wn = o2w.apply_normal(normals.reshape(-1, 3)).reshape(-1, 3, 3)
            ln = np.linalg.norm(wn, axis=-1, keepdims=True)
            wn = wn / np.maximum(ln, 1e-20)
        else:
            wn = _geometric_normals(wverts)
        if rec.reverse_orientation ^ o2w.swaps_handedness():
            wn = -wn
        if uvs is None:
            uvs = np.zeros((len(wverts), 3, 2))
            uvs[:, 1, 0] = 1.0
            uvs[:, 2] = [1.0, 1.0]
        mid = mat_id_for(rec.material)
        n_t = len(wverts)
        base = sum(len(v) for v in all_verts)
        shape_tri_counts.append((rec, n_t))
        all_verts.append(wverts)
        all_verts1.append(wverts1)
        all_normals.append(wn)
        all_uvs.append(uvs)
        all_mat.append(np.full(n_t, mid, np.int32))
        lids = np.full(n_t, -1, np.int32)
        if rec.area_light is not None:
            # one diffuse area light per triangle, whatever the light's
            # name (pbrt has no other area light)
            L = _rgb(rec.area_light.find_one_spectrum("L", np.array([1.0, 1.0, 1.0])))
            sc = _rgb(rec.area_light.find_one_spectrum("scale", np.array([1.0, 1.0, 1.0])))
            two = rec.area_light.find_one_bool("twosided", False)
            e1 = wverts[:, 1] - wverts[:, 0]
            e2 = wverts[:, 2] - wverts[:, 0]
            areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1)
            for k in range(n_t):
                lids[k] = len(light_rows)
                light_rows.append(dict(
                    type=LIGHT_AREA, p=np.zeros(3), L=L * sc, dir=np.zeros(3), cos0=0,
                    cos1=0, tri=base + k, twosided=int(two), area=float(areas[k]),
                ))
        all_light.append(lids)

    # motion blur is on only where something moves AND the shutter is open
    any_motion = any_motion and shutter[1] > shutter[0]
    if all_verts:
        verts = np.concatenate(all_verts).astype(np.float64)
        verts1 = np.concatenate(all_verts1).astype(np.float64) if any_motion else None
        normals = np.concatenate(all_normals).astype(np.float32)
        uvs = np.concatenate(all_uvs).astype(np.float32)
        mat_ids = np.concatenate(all_mat)
        light_ids = np.concatenate(all_light)
    else:
        # no geometry: one degenerate far-away triangle of a null material
        # keeps every table non-empty, as in the reference
        from tpu_pbrt_torch.scene.api import MaterialRecord

        verts = np.full((1, 3, 3), 1e30)
        verts1 = None
        normals = np.zeros((1, 3, 3), np.float32)
        normals[:, :, 2] = 1.0
        uvs = np.zeros((1, 3, 2), np.float32)
        mat_ids = np.zeros(1, np.int32)
        light_ids = np.full(1, -1, np.int32)
        mat_records.append(MaterialRecord("none", {}))

    # -- world bounds (the union over the shutter where anything moves) -----
    vb = verts if verts1 is None else np.concatenate([verts, verts1])
    finite = np.abs(vb).max(axis=(1, 2)) < 1e29
    if finite.any():
        wmin = vb[finite].min(axis=(0, 1))
        wmax = vb[finite].max(axis=(0, 1))
    else:
        wmin = np.full(3, -1.0)
        wmax = np.full(3, 1.0)
    wcenter = 0.5 * (wmin + wmax)
    wradius = float(np.linalg.norm(wmax - wcenter)) + 1e-6

    # -- BVH (each triangle's bounds the union over both keyframes) and
    # leaf order ------------------------------------------------------------
    bmin, bmax = triangle_bounds(verts)
    if verts1 is not None:
        bmin1, bmax1 = triangle_bounds(verts1)
        bmin = np.minimum(bmin, bmin1)
        bmax = np.maximum(bmax, bmax1)
    # every accelerator name builds the BVH (pbrt's "kdtree" included);
    # only "bvh" reads its split method
    bvh = build_bvh(bmin, bmax, method=ro.accelerator_params.find_one_string(
        "splitmethod", "auto") if ro.accelerator_name == "bvh" else "auto")
    order = bvh.prim_order
    verts = verts[order]
    if verts1 is not None:
        verts1 = verts1[order]
    normals = normals[order]
    uvs = uvs[order]
    mat_ids = mat_ids[order]
    light_ids = light_ids[order]
    inv_order = np.empty_like(order)
    inv_order[order] = np.arange(len(order))
    for row in light_rows:
        row["tri"] = int(inv_order[row["tri"]])

    # -- non-area lights ---------------------------------------------------
    envmap = env_distr = None
    env_w2l = np.eye(4, dtype=np.float32)
    for lrec in ro.lights:
        l2w = lrec.light_to_world
        p = lrec.params
        sc = _rgb(p.find_one_spectrum("scale", np.array([1.0, 1.0, 1.0])))
        if lrec.type == "point":
            I = _rgb(p.find_one_spectrum("I", np.array([1.0, 1.0, 1.0]))) * sc
            pos = l2w.apply_point(p.find_one_point3("from", [0.0, 0.0, 0.0]))
            light_rows.append(dict(type=LIGHT_POINT, p=pos, L=I, dir=np.zeros(3), cos0=0,
                                   cos1=0, tri=-1, twosided=0, area=0.0))
        elif lrec.type == "spot":
            I = _rgb(p.find_one_spectrum("I", np.array([1.0, 1.0, 1.0]))) * sc
            cone = p.find_one_float("coneangle", 30.0)
            delta = p.find_one_float("conedeltaangle", 5.0)
            frm = np.asarray(p.find_one_point3("from", [0, 0, 0]), np.float64)
            to = np.asarray(p.find_one_point3("to", [0, 0, 1]), np.float64)
            pos = l2w.apply_point(frm)
            d = l2w.apply_point(to) - pos
            d = d / max(np.linalg.norm(d), 1e-20)
            # cos0: where the falloff starts; cos1: the cone's total width
            light_rows.append(dict(type=LIGHT_SPOT, p=pos, L=I, dir=d,
                                   cos0=math.cos(math.radians(cone - delta)),
                                   cos1=math.cos(math.radians(cone)),
                                   tri=-1, twosided=0, area=0.0))
        elif lrec.type == "distant":
            L = _rgb(p.find_one_spectrum("L", np.array([1.0, 1.0, 1.0]))) * sc
            frm = np.asarray(p.find_one_point3("from", [0, 0, 0]), np.float64)
            to = np.asarray(p.find_one_point3("to", [0, 0, 1]), np.float64)
            d = l2w.apply_vector(frm - to)
            d = d / max(np.linalg.norm(d), 1e-20)  # the direction TOWARD the light
            light_rows.append(dict(type=LIGHT_DISTANT, p=np.zeros(3), L=L, dir=d, cos0=0,
                                   cos1=0, tri=-1, twosided=0, area=0.0))
        elif lrec.type in ("infinite", "exinfinite"):
            # every infinite light gets a row; the last one's map is the
            # scene's environment (the reference keeps one map)
            L = _rgb(p.find_one_spectrum("L", np.array([1.0, 1.0, 1.0]))) * sc
            fn = p.find_one_string("mapname", "")
            if fn:
                envmap = _read_envmap(resolve_filename(fn, lrec.scene_dir), L)
            else:
                envmap = np.full((4, 8, 3), L, np.float32)
            # importance over luminance x sin(theta) (infinite.cpp)
            hgt = envmap.shape[0]
            theta = (np.arange(hgt) + 0.5) / hgt * np.pi
            env_distr = Distribution2D.build_numpy(luminance(envmap) * np.sin(theta)[:, None])
            env_w2l = np.asarray(l2w.inverse().m, np.float32)
            # the row carries L = 1: the radiance lives in the map
            light_rows.append(dict(type=LIGHT_INFINITE, p=wcenter, L=np.ones(3),
                                   dir=np.zeros(3), cos0=0, cos1=0, tri=-1, twosided=0,
                                   area=0.0))
        elif lrec.type in ("projection", "goniometric"):
            # a point light whose intensity an image modulates by direction
            # (goniometric.cpp: a lat-long diagram; projection.cpp: a
            # picture projected through a fov frustum); the image goes into
            # the shared light atlas, the world-to-light rotation rides the row
            I = _rgb(p.find_one_spectrum("I", np.array([1.0, 1.0, 1.0]))) * sc
            pos = l2w.apply_point([0.0, 0.0, 0.0])
            img = _read_light_map(p.find_one_string("mapname", ""), lrec.scene_dir)
            off = sum(ch.shape[0] for ch in light_atlas_chunks)
            light_atlas_chunks.append(img.reshape(-1, 3))
            w2l_rot = np.asarray(l2w.inverse().m, np.float64)[:3, :3]
            row = dict(p=pos, L=I, dir=np.zeros(3), tri=-1, twosided=0, area=0.0,
                       w2l=w2l_rot.reshape(-1),
                       img=np.array([off, img.shape[1], img.shape[0]], np.int64))
            if lrec.type == "goniometric":
                light_rows.append(dict(row, type=LIGHT_GONIO, cos0=0, cos1=0))
            else:
                # the map spans the [-1, 1] frustum of the short axis at
                # tan(fov / 2); cos0 / cos1 carry tan(fov / 2) and the aspect
                fov = p.find_one_float("fov", 45.0)
                light_rows.append(dict(row, type=LIGHT_PROJECTION,
                                       cos0=math.tan(math.radians(fov) / 2.0),
                                       cos1=img.shape[1] / img.shape[0]))
        else:
            Warning(f'LightSource "{lrec.type}" unknown.')

    # -- media (medium.cpp, media/{homogeneous,grid}.cpp) ---------------------
    medium_ids, media = lower_media(ro.named_media)
    # per-triangle MediumInterface ids, in the BVH's leaf order
    med_in = np.full(len(verts), -1, np.int32)
    med_out = np.full(len(verts), -1, np.int32)
    tri_base = 0
    for rec, n_t in shape_tri_counts:
        med_in[tri_base: tri_base + n_t] = medium_ids.get(rec.inside_medium, -1)
        med_out[tri_base: tri_base + n_t] = medium_ids.get(rec.outside_medium, -1)
        tri_base += n_t
    med_in = med_in[order]
    med_out = med_out[order]
    camera_medium_id = medium_ids.get(ro.camera_medium, -1)

    n_lights = len(light_rows)
    if n_lights == 0:
        Warning("No light sources defined in scene; rendering a black image.")
        light_rows.append(dict(type=LIGHT_POINT, p=np.zeros(3), L=np.zeros(3), dir=np.zeros(3),
                               cos0=0, cos1=0, tri=-1, twosided=0, area=0.0))
    for r in light_rows:
        r.setdefault("w2l", np.eye(3).reshape(-1))
        r.setdefault("img", np.array([-1, 0, 0], np.int64))
    lt = {
        "type": np.array([r["type"] for r in light_rows], np.int32),
        "p": np.array([r["p"] for r in light_rows], np.float32),
        "L": np.array([r["L"] for r in light_rows], np.float32),
        "dir": np.array([r["dir"] for r in light_rows], np.float32),
        "cos0": np.array([r["cos0"] for r in light_rows], np.float32),
        "cos1": np.array([r["cos1"] for r in light_rows], np.float32),
        "tri": np.array([r["tri"] for r in light_rows], np.int32),
        "twosided": np.array([r["twosided"] for r in light_rows], np.int32),
        "area": np.array([r["area"] for r in light_rows], np.float32),
        "w2l": np.array([r["w2l"] for r in light_rows], np.float32),
        "img": np.array([r["img"] for r in light_rows], np.int32),
    }
    light_atlas = (np.concatenate(light_atlas_chunks, 0) if light_atlas_chunks
                   else np.zeros((1, 3), np.float32))
    # per-light triangle vertices (area rows; zeros elsewhere)
    lt_tri = np.asarray([r["tri"] for r in light_rows], np.int64)
    lv = np.asarray(verts, np.float32)[np.clip(lt_tri, 0, len(verts) - 1)]
    lv[lt_tri < 0] = 0.0
    lt["tri_v"] = lv
    if verts1 is not None:
        # light sampling takes the shutter-start keyframe (the reference's
        # approximation; pbrt samples lights at the reference point's time)
        lv1 = np.asarray(verts1, np.float32)[np.clip(lt_tri, 0, len(verts) - 1)]
        moving = (lt_tri >= 0) & (np.abs(lv1 - lv).max(axis=(1, 2)) > 1e-7)
        if np.any(moving):
            Warning(f"{int(moving.sum())} area light(s) sit on ANIMATED shapes: direct-light "
                    "sampling uses the shutter-start keyframe (approximation; MIS pdfs likewise)")

    # power-weighted pick distribution (lightdistrib.cpp PowerLightDistribution)
    power = np.zeros(max(n_lights, 1))
    for i, r in enumerate(light_rows[: max(n_lights, 1)]):
        lum_v = float(luminance(np.asarray(r["L"], np.float64)))
        if r["type"] == LIGHT_AREA:
            power[i] = lum_v * r["area"] * np.pi * (2.0 if r["twosided"] else 1.0)
        elif r["type"] == LIGHT_INFINITE:
            # the row's L is 1: the power is the map's mean luminance
            env_lum = float(np.mean(luminance(envmap.astype(np.float64))))
            power[i] = env_lum * np.pi * wradius * wradius * 4
        elif r["type"] == LIGHT_DISTANT:
            power[i] = lum_v * np.pi * wradius * wradius
        elif r["type"] in (LIGHT_GONIO, LIGHT_PROJECTION):
            off, iw, ih = (int(v) for v in r["img"])
            mean_lum = float(np.mean(luminance(light_atlas[off: off + iw * ih].astype(np.float64))))
            power[i] = lum_v * mean_lum * 4 * np.pi
        else:
            power[i] = lum_v * 4 * np.pi
    light_distr = Distribution1D.build(
        power if power.sum() > 0 else np.ones_like(power), device
    )

    # -- spatial light distribution: dense per-voxel CDFs, importance at the
    # voxel centers (the reference's simplification of pbrt's lazy hash)
    spatial_distr = None
    # an unknown strategy name picks lights by power (WavefrontIntegrator)
    strategy = ro.integrator_params.find_one_string("lightsamplestrategy", "spatial")
    if n_lights > 1 and strategy == "spatial" and n_lights <= 4096:
        sd = spatial_tables(light_rows, verts, wmin, wmax, power)
        spatial_distr = SpatialLightDistribution(
            cdf=torch.from_numpy(sd["cdf"]).to(device),
            mean_pmf=torch.from_numpy(sd["mean_pmf"]).to(device),
            lo=torch.from_numpy(sd["lo"]).to(device),
            inv_cs=torch.from_numpy(sd["inv_cs"]).to(device),
            res=sd["res"],
        )

    # -- materials: non-constant textures get ids in a registry that
    # dedups them by structure, then become evaluators and one mip atlas
    # (core/texture_eval.py)
    deferred_textures: List = []
    tex_ids: Dict[str, int] = {}

    def tex_registry(node):
        key = repr(node)
        tid = tex_ids.get(key)
        if tid is None:
            tid = len(deferred_textures)
            tex_ids[key] = tid
            deferred_textures.append(node)
        return tid

    mtab = lower_materials(mat_records, tex_registry, getattr(api, "scene_dir", "."))
    sss_rows = mtab.pop("_sss_rows", None)
    if "_fourier" in mtab:
        mtab["_fourier"] = mtab["_fourier"][0]  # the table (the file name keyed its reuse)
    if any(rec.params.get("bumpmap") is not None for rec in mat_records):
        Warning("bump textures are parsed but not applied (no shading-normal perturbation)")
    tex_eval = tex_atlas = None
    tex_used = set()
    if deferred_textures:
        from tpu_pbrt_torch.core.texture_eval import build_texture_table

        tex_atlas, tex_eval = build_texture_table(deferred_textures)
        tex_used = {name for slot, name in TEX_SLOTS if (mtab[slot] >= 0).any()}
    tex_slot_ids = {name: tuple(int(v) for v in np.unique(mtab[slot][mtab[slot] >= 0]))
                    for slot, name in TEX_SLOTS}

    # -- device upload -------------------------------------------------------
    from tpu_pbrt_torch.accel.wide import pad_tri_verts

    tab = {
        "tri_verts": pad_tri_verts(verts),
        **({"tri_verts1": pad_tri_verts(verts1)} if verts1 is not None else {}),
        "tri_normals": normals,
        "tri_uvs": uvs,
        "tri_mat": mat_ids.astype(np.int32),
        "tri_light": light_ids.astype(np.int32),
        "mat": mtab,
        "light": lt,
        "tri_med_in": med_in,
        "tri_med_out": med_out,
        "media": media,
        "world_center": np.asarray(wcenter, np.float32),
        "world_radius": np.float32(wradius),
        "n_lights": np.int32(n_lights),
    }
    if sss_rows:
        tab["bssrdf"] = bake_bssrdf(sss_rows)
    if len(mtab["type"]) < 4096 and n_lights < 4095:
        # (16, T) lane-major shading rows [n0 n1 n2 | uv0 uv1 uv2 | mat*4096 + light+1],
        # where the ids fit the exact-f32 packing (else make_interaction
        # gathers the four tables)
        pack = (
            np.asarray(mat_ids, np.int64) * 4096 + np.asarray(light_ids, np.int64) + 1
        ).astype(np.float32)[:, None]
        tab["tri_sh16"] = np.concatenate(
            [normals.reshape(len(normals), 9), uvs.reshape(len(uvs), 6), pack], axis=1
        ).T.copy()

    from tpu_pbrt_torch.accel.mxu import (BRUTE_MAX_TRIS, tri_feature_weights,
                                          tri_feature_weights_motion)

    # the reference's selection order: the binary and wide walkers win over
    # the brute product; the packet walker applies above BRUTE_MAX_TRIS;
    # the walkers trace the shutter-start keyframe
    accel_kind = cfg.bvh
    if verts1 is not None and accel_kind in ("binary", "wide"):
        Warning("motion blur is only supported on the stream/brute accel paths; this "
                f"{accel_kind}-walker render is STATIC at shutter start")
    if accel_kind == "binary":
        from tpu_pbrt_torch.accel.traverse import bvh_as_device_dict

        tab["bvh"] = bvh_as_device_dict(bvh)
    elif accel_kind == "wide":
        from tpu_pbrt_torch.accel.wide import build_wide_numpy

        tab["wbvh"] = build_wide_numpy(bvh)
    elif len(verts) <= BRUTE_MAX_TRIS:
        tab["bfeat"] = {
            "feat": (tri_feature_weights(verts, wcenter) if verts1 is None
                     else tri_feature_weights_motion(verts, verts1, wcenter)),
            "center": np.asarray(wcenter, np.float32),
        }
    elif accel_kind == "packet":
        from tpu_pbrt_torch.accel.treelet import build_treelet_pack_numpy

        if verts1 is not None:
            Warning("motion blur is only supported on the stream/brute accel paths; this "
                    "packet-walker render is STATIC at shutter start")
        tab["tpack"] = build_treelet_pack_numpy(verts, bvh)
    else:
        from tpu_pbrt_torch.accel.stream import STREAM_LEAF_TRIS
        from tpu_pbrt_torch.accel.treelet import build_treelet_pack_numpy

        leaf_tris = int(cfg.leaf_tris if cfg.leaf_tris is not None else STREAM_LEAF_TRIS)
        tab["tstream"] = build_treelet_pack_numpy(verts, bvh, leaf_tris=leaf_tris,
                                                  tri_verts1=verts1)
        # the lane-major (9, T) vertex tables of _finalize_hits' winner fetch
        T9 = tab["tri_verts"].shape[0]
        tab["tri_verts9T"] = tab["tri_verts"].reshape(T9, 9).T.copy()
        if verts1 is not None:
            tab["tri_verts1_9T"] = tab["tri_verts1"].reshape(T9, 9).T.copy()

    if "h_beta_m" in mtab or tex_atlas is not None:
        # the uv-parameterization derivatives per triangle (triangle.cpp
        # dpdu/dpdv): hair shades in the frame of the normalized dpdu
        # (tri_tanT, (3, T)); textures take both raw vectors for the
        # ray-differential footprint (tri_difT, (8, T): dpdu (3), dpdv
        # (3), padding (2)); each lane-major, built only when used
        duv02 = uvs[:, 0] - uvs[:, 2]
        duv12 = uvs[:, 1] - uvs[:, 2]
        dp02 = verts[:, 0] - verts[:, 2]
        dp12 = verts[:, 1] - verts[:, 2]
        det = duv02[:, 0] * duv12[:, 1] - duv02[:, 1] * duv12[:, 0]
        safe = np.abs(det) > 1e-12
        inv = 1.0 / np.where(safe, det, 1.0)
        dpdu_raw = (duv12[:, 1:2] * dp02 - duv02[:, 1:2] * dp12) * inv[:, None]
        dpdv_raw = (-duv12[:, 0:1] * dp02 + duv02[:, 0:1] * dp12) * inv[:, None]
        dpdu_raw = np.where(safe[:, None], dpdu_raw, 0.0)
        dpdv_raw = np.where(safe[:, None], dpdv_raw, 0.0)
        if "h_beta_m" in mtab:
            ln = np.linalg.norm(dpdu_raw, axis=-1, keepdims=True)
            dpdu_n = np.where(ln > 1e-12, dpdu_raw / np.maximum(ln, 1e-20), 0.0)
            tab["tri_tanT"] = np.asarray(dpdu_n.T.copy(), np.float32)
        if tex_atlas is not None:
            tab["tri_difT"] = np.concatenate(
                [dpdu_raw.T, dpdv_raw.T, np.zeros((2, len(verts)))], axis=0).astype(np.float32)
    if tex_atlas is not None:
        tab["tex_atlas"] = np.asarray(tex_atlas, np.float32)
    if light_atlas_chunks:
        tab["light_atlas"] = light_atlas
    if envmap is not None:
        tab["envmap"] = envmap
        tab["env_distr"] = env_distr
        tab["env_w2l"] = np.ascontiguousarray(env_w2l[:3, :3])

    from tpu_pbrt_torch.scene.bridge import upload

    return CompiledScene(
        dev=upload(tab, device),
        film=film,
        camera=camera,
        sampler=sampler,
        integrator_name=ro.integrator_name,
        integrator_params=ro.integrator_params,
        n_tris=len(verts),
        n_lights=n_lights,
        world_min=wmin,
        world_max=wmax,
        world_center=wcenter,
        world_radius=wradius,
        device=device,
        light_distribution_name=strategy,
        light_distr=light_distr,
        spatial_distr=spatial_distr,
        has_envmap=envmap is not None,
        camera_medium_id=camera_medium_id,
        has_null_materials=bool(np.any(mtab["type"][mat_ids] == bxdf.MAT_NONE)),
        tex_eval=tex_eval,
        tex_used=frozenset(tex_used),
        tex_slot_ids=tex_slot_ids,
    )


def lower_media(named_media) -> tuple:
    """MakeNamedMedium records -> ({name: row id, "": -1}, the medium
    table's fields as numpy arrays (md.medium_table_numpy)): the
    reference's defaults, presets, scale and grid placement (p0/p1 into
    world_to_medium; sigma_t_max the grid's majorant). One density grid:
    a second one replaces the first, with the reference's warning."""
    medium_ids: Dict[str, int] = {"": -1}
    rows = []
    density = None
    w2m = np.eye(4, dtype=np.float32)
    sigma_t_max = 0.0
    for name, mrec in named_media.items():
        p = mrec.params
        scale = p.find_one_float("scale", 1.0)
        g = p.find_one_float("g", 0.0)
        preset = p.find_one_string("preset", "")
        sig_a_d = np.array([0.0011, 0.0024, 0.014])
        sig_s_d = np.array([2.55, 3.21, 3.77])
        if preset:
            if preset in md.MEDIUM_PRESETS:
                sig_s_d, sig_a_d = md.MEDIUM_PRESETS[preset]
            else:
                Warning(f'Material preset "{preset}" not found; using defaults')
        sig_a = _rgb(p.find_one_spectrum("sigma_a", sig_a_d)) * scale
        sig_s = _rgb(p.find_one_spectrum("sigma_s", sig_s_d)) * scale
        if mrec.type == "homogeneous":
            rows.append(dict(type=md.MEDIUM_HOMOGENEOUS, sa=sig_a, ss=sig_s, g=g, grid=-1))
        elif mrec.type in ("heterogeneous", "grid"):
            nx = p.find_one_int("nx", 1)
            ny = p.find_one_int("ny", 1)
            nz = p.find_one_int("nz", 1)
            dvals = p.find_float("density")
            if dvals is None or len(dvals) != nx * ny * nz:
                Error('GridDensityMedium requires nx*ny*nz "density" values')
            if density is not None:
                Warning("multiple grid media: only one density grid supported; last wins")
            density = np.asarray(dvals, np.float32).reshape(nz, ny, nx)
            # medium space [0,1]^3 maps onto the p0-p1 box
            p0 = np.asarray(p.find_one_point3("p0", [0.0, 0.0, 0.0]))
            p1 = np.asarray(p.find_one_point3("p1", [1.0, 1.0, 1.0]))
            m2w = mrec.medium_to_world.m @ np.block(
                [[np.diag(p1 - p0), p0[:, None]], [np.zeros((1, 3)), np.ones((1, 1))]])
            w2m = np.linalg.inv(m2w).astype(np.float32)
            sigma_t_max = float((sig_a + sig_s).max() * density.max())
            rows.append(dict(type=md.MEDIUM_GRID, sa=sig_a, ss=sig_s, g=g, grid=0))
        else:
            Warning(f'Medium "{mrec.type}" unknown; ignored.')
            rows.append(dict(type=md.MEDIUM_HOMOGENEOUS, sa=sig_a * 0, ss=sig_s * 0, g=0.0,
                             grid=-1))
        medium_ids[name] = len(rows) - 1
    return medium_ids, md.medium_table_numpy(rows, density, w2m, sigma_t_max)


def spatial_tables(light_rows, verts, wmin, wmax, power) -> dict:
    """SpatialLightDistribution tables (numpy), the reference's build:
    point, spot and image-light rows fall off with the squared distance
    to each voxel center (a spot also by its clipped cone factor), area
    rows by their luminance x area over the squared distance, distant and
    infinite rows take their power share everywhere."""
    res = (8, 8, 8)
    lo_g = wmin - 1e-3
    hi_g = wmax + 1e-3
    cs_g = np.maximum((hi_g - lo_g) / np.asarray(res), 1e-6)
    gx, gy, gz = res
    ii, jj, kk = np.meshgrid(np.arange(gx), np.arange(gy), np.arange(gz), indexing="ij")
    centers = lo_g + (np.stack([ii, jj, kk], -1).reshape(-1, 3, order="F") + 0.5) * cs_g
    V = centers.shape[0]
    L = len(light_rows)
    imp = np.zeros((V, L), np.float64)
    for i, r in enumerate(light_rows):
        t = r["type"]
        if t in (LIGHT_POINT, LIGHT_SPOT, LIGHT_GONIO, LIGHT_PROJECTION):
            lum_v = float(luminance(np.asarray(r["L"], np.float64)))
            d2 = np.maximum(((centers - r["p"]) ** 2).sum(-1), 1e-6)
            base = lum_v / d2
            if t == LIGHT_SPOT:
                # the cone's clipped falloff toward the voxel center
                toc = centers - r["p"]
                toc /= np.maximum(np.linalg.norm(toc, axis=-1, keepdims=True), 1e-12)
                cosw = toc @ np.asarray(r["dir"])
                base = base * np.clip(
                    (cosw - r["cos1"]) / max(r["cos0"] - r["cos1"], 1e-6), 0.05, 1.0)
            imp[:, i] = base
        elif t != LIGHT_AREA:  # distant and environment: position-independent
            imp[:, i] = power[i] / max(power.sum(), 1e-12)
    area_rows = [i for i, r in enumerate(light_rows) if r["type"] == LIGHT_AREA]
    if area_rows:
        tri_ids = np.asarray([light_rows[i]["tri"] for i in area_rows])
        cent = np.asarray(verts, np.float64).mean(axis=1)[tri_ids]
        lum_a = np.asarray(
            [float(luminance(np.asarray(light_rows[i]["L"], np.float64))) for i in area_rows]
        )
        area_a = np.asarray([light_rows[i]["area"] for i in area_rows])
        d2 = np.maximum(((centers[:, None, :] - cent[None, :, :]) ** 2).sum(-1), 1e-6)
        imp[:, area_rows] = lum_a * area_a / d2
    row_sum = imp.sum(-1, keepdims=True)
    imp = np.where(row_sum > 0, imp / np.maximum(row_sum, 1e-30), 1.0 / L)
    cdf = np.cumsum(imp, -1).astype(np.float32)
    cdf[:, -1] = 1.0
    return {
        "cdf": cdf,
        "mean_pmf": imp.mean(0).astype(np.float32),
        "lo": np.asarray(lo_g, np.float32),
        "inv_cs": np.asarray(1.0 / cs_g, np.float32),
        "res": res,
    }
