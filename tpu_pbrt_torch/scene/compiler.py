"""Scene compiler: parsed scene records -> flat tensors on the render device.

Port of tpu_pbrt/scene/compiler.py::compile_scene, reduced to the
directive set the port renders:

- shapes: every shape the reference tessellates ("trianglemesh",
  "plymesh", "sphere", "disk", "cylinder", "cone", "paraboloid",
  "hyperboloid", "heightfield2", "loopsubdiv" and "curve", with the
  reference's grid sizes), one world-space triangle soup with shading
  normals and uvs; object instances expanded by baking each use's
  transform into its shapes; an unknown shape name is skipped with the
  reference's warning;
- materials: "matte", "plastic", "metal", "glass", "mirror", "uber",
  "substrate", "translucent" and "mix" (its two sub-materials appended
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
  the pixel filters of core/filters.py, film "image", accelerator "bvh",
  every sampler the reference dispatches ("zerotwosequence" and its
  aliases, "random", "stratified", "halton", "sobol"), and the
  integrators of integrators.PORTED ("path", "directlighting",
  "whitted", "ao", "volpath", "bdpt", "sppm", "mlt").

Anything else raises PbrtError naming what is not ported yet. The
substitutions are the reference's own, each with its warning: a map
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
from tpu_pbrt_torch.utils.error import Error, PbrtError, Warning
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


def _not_ported(what: str):
    raise PbrtError(f"{what} is not ported to tpu_pbrt_torch yet")


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
    verts_all, uvs_all = [], []
    n_curves = (len(cps) - 1) // 3
    for ci in range(max(n_curves, 1)):
        p0, p1, p2, p3 = cps[3 * ci: 3 * ci + 4]
        t = np.linspace(0.0, 1.0, n_seg_pts + 1)[:, None]
        b = ((1 - t) ** 3 * p0 + 3 * (1 - t) ** 2 * t * p1 + 3 * (1 - t) * t * t * p2
             + t ** 3 * p3)
        tan = 3 * (1 - t) ** 2 * (p1 - p0) + 6 * (1 - t) * t * (p2 - p1) + 3 * t * t * (p3 - p2)
        tan /= np.maximum(np.linalg.norm(tan, axis=-1, keepdims=True), 1e-12)
        # side = tangent x reference axis, with a second axis where the
        # tangent turns parallel to the first
        ref = np.eye(3)[np.argmin(np.abs(tan[0]))]
        side = np.cross(tan, ref)
        nrm = np.linalg.norm(side, axis=-1, keepdims=True)
        alt = np.eye(3)[(np.argmin(np.abs(tan[0])) + 1) % 3]
        side = np.where(nrm < 1e-6, np.cross(tan, alt), side)
        side /= np.maximum(np.linalg.norm(side, axis=-1, keepdims=True), 1e-12)
        u_glob = (ci + t[:, 0]) / max(n_curves, 1)
        half_w = 0.5 * ((1 - u_glob) * w0 + u_glob * w1)[:, None]
        pts = np.stack([b - side * half_w, b + side * half_w], axis=1)  # (n+1, 2, 3)
        for k in range(n_seg_pts):
            a0, a1 = pts[k, 0], pts[k, 1]
            b0_, b1_ = pts[k + 1, 0], pts[k + 1, 1]
            verts_all += [[a0, a1, b1_], [a0, b1_, b0_]]
            ua, ub = u_glob[k], u_glob[k + 1]
            uvs_all += [[[ua, 0], [ua, 1], [ub, 1]], [[ua, 0], [ub, 1], [ub, 0]]]
    return np.asarray(verts_all, np.float64), None, np.asarray(uvs_all, np.float64)


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
             "translucent": bxdf.MAT_TRANSLUCENT, "mix": bxdf.MAT_MATTE}

#: material slot -> its texture-id column, and the name tex_used gives it
TEX_SLOTS = (("kd_tex", "kd"), ("ks_tex", "ks"), ("sigma_tex", "sigma"),
             ("rough_tex", "rough"), ("opacity_tex", "opacity"))


def lower_materials(mat_records: List, tex_registry) -> Dict[str, np.ndarray]:
    """MaterialRecords -> the SoA material table (bxdf.MAT_COLUMNS) with
    the reference's defaults and constant folding. tex_registry(node)
    gives a non-constant texture its id (the reference's registry).

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
        "kd_tex": np.full(m, -1, np.int32),
        "ks_tex": np.full(m, -1, np.int32),
        "sigma_tex": np.full(m, -1, np.int32),
        "rough_tex": np.full(m, -1, np.int32),
        "opacity_tex": np.full(m, -1, np.int32),
        "bump_tex": np.full(m, -1, np.int32),
    }

    for i, rec in enumerate(mat_records):
        t = rec.type
        if t not in _MAT_ENUM:
            _not_ported(f'Material "{t}" (ported: {", ".join(map(repr, _MAT_ENUM))})')
        tab["type"][i] = _MAT_ENUM[t]
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
    return tab


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


def _check_directives(api, ro):
    check_ported(ro.integrator_name)
    if ro.film_name != "image":
        _not_ported(f'Film "{ro.film_name}" (ported: "image")')
    if ro.accelerator_name != "bvh":
        _not_ported(f'Accelerator "{ro.accelerator_name}" (ported: "bvh")')
    if api.render_options.camera_to_world.is_animated():
        _not_ported("an animated camera transform (motion blur)")


def compile_scene(api, device=None) -> CompiledScene:
    """Compile the API's world into tables on `device` (default: the API's
    device, which defaults to CUDA; see config.resolve_device)."""
    device = resolve_device(device) if device is not None else getattr(
        api, "device", None) or resolve_device(None)
    ro = api.render_options
    opts = api.options
    _check_directives(api, ro)

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
        if not np.allclose(o2w.m, rec.object_to_world[1].m):
            _not_ported("animated shape transforms (motion blur)")
        wverts = o2w.apply_point(verts.reshape(-1, 3)).reshape(-1, 3, 3)
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
        all_normals.append(wn)
        all_uvs.append(uvs)
        all_mat.append(np.full(n_t, mid, np.int32))
        lids = np.full(n_t, -1, np.int32)
        if rec.area_light is not None:
            if rec.area_light_name != "diffuse":
                _not_ported(f'AreaLightSource "{rec.area_light_name}" (ported: "diffuse")')
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

    if not all_verts:
        _not_ported("a scene without geometry")
    verts = np.concatenate(all_verts).astype(np.float64)
    normals = np.concatenate(all_normals).astype(np.float32)
    uvs = np.concatenate(all_uvs).astype(np.float32)
    mat_ids = np.concatenate(all_mat)
    light_ids = np.concatenate(all_light)

    # -- world bounds ------------------------------------------------------
    finite = np.abs(verts).max(axis=(1, 2)) < 1e29
    if finite.any():
        wmin = verts[finite].min(axis=(0, 1))
        wmax = verts[finite].max(axis=(0, 1))
    else:
        wmin = np.full(3, -1.0)
        wmax = np.full(3, 1.0)
    wcenter = 0.5 * (wmin + wmax)
    wradius = float(np.linalg.norm(wmax - wcenter)) + 1e-6

    # -- BVH and leaf order -------------------------------------------------
    bmin, bmax = triangle_bounds(verts)
    bvh = build_bvh(bmin, bmax, method=ro.accelerator_params.find_one_string(
        "splitmethod", "auto"))
    order = bvh.prim_order
    verts = verts[order]
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
    strategy = ro.integrator_params.find_one_string("lightsamplestrategy", "spatial")
    if strategy not in ("spatial", "power", "uniform"):
        _not_ported(f'lightsamplestrategy "{strategy}"')
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

    mtab = lower_materials(mat_records, tex_registry)
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

    from tpu_pbrt_torch.accel.mxu import BRUTE_MAX_TRIS, tri_feature_weights

    if len(verts) <= BRUTE_MAX_TRIS:
        tab["bfeat"] = {
            "feat": tri_feature_weights(verts, wcenter),
            "center": np.asarray(wcenter, np.float32),
        }
    else:
        from tpu_pbrt_torch.accel.stream import STREAM_LEAF_TRIS
        from tpu_pbrt_torch.accel.treelet import build_treelet_pack_numpy

        leaf_tris = int(cfg.leaf_tris if cfg.leaf_tris is not None else STREAM_LEAF_TRIS)
        tab["tstream"] = build_treelet_pack_numpy(verts, bvh, leaf_tris=leaf_tris)
        T9 = tab["tri_verts"].shape[0]
        tab["tri_verts9T"] = tab["tri_verts"].reshape(T9, 9).T.copy()

    if tex_atlas is not None:
        # the uv-parameterization derivatives per triangle (triangle.cpp
        # dpdu/dpdv) for the ray-differential footprint, lane-major
        # (8, T): dpdu (3), dpdv (3), padding (2)
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
        tab["tri_difT"] = np.concatenate(
            [dpdu_raw.T, dpdv_raw.T, np.zeros((2, len(verts)))], axis=0).astype(np.float32)
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
