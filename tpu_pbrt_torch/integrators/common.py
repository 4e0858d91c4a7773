"""Shared wavefront-integrator machinery (port of tpu_pbrt/integrators/common.py).

- Scene::Intersect / IntersectP dispatch to the stream tracer (or the
  brute feature product for scenes of at most BRUTE_MAX_TRIS triangles),
  and the fused camera+shadow closest hit of the 2R wave layout;
- SurfaceInteraction construction from a Hit, and the material at a hit
  (`textured_mat`: the mix resolution, the row gather and every textured
  slot's evaluation, with the camera hits' ray-differential footprint of
  `texture_footprint` driving the mip filter);
- the chunk plan and the render loop on one device: the image x spp
  work domain is cut into chunks of camera rays; each chunk drains
  through the integrator's persistent pool (`pool_chunk`) or runs its
  fixed batch (`li`) to completion, and deposits into the film; the loop
  checkpoints at a cadence, resumes from a checkpoint, stops at a time
  box, and writes the image.

Every sampler dimension is a pure function of (px, py, s, dimension
salt), so the port draws the reference's sample streams.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from tpu_pbrt_torch.accel.traverse import Hit
from tpu_pbrt_torch.cameras import generate_rays
from tpu_pbrt_torch.config import cfg
from tpu_pbrt_torch.core import bxdf
from tpu_pbrt_torch.core import lights_dev as ld
from tpu_pbrt_torch.core.sampling import (
    _sobol_raw_bits,
    hash_u32,
    normalize_sampler_name,
    power_heuristic,
    sample_1d,
    sample_2d,
    sobol_2d,
    sobol_interval_to_index,
    sobol_resolution_log2,
)
from tpu_pbrt_torch.core.vecmath import (
    coordinate_system,
    cross,
    dot,
    face_forward,
    normalize,
    offset_ray_origin,
    to_local,
    to_world,
)

# dimension salts (one stream per logical sampler dimension; bounce-shifted)
DIM_FILM_X = 0
DIM_LENS = 2
DIM_TIME = 3
DIM_LIGHT_PICK = 4
DIM_LIGHT_UV = 5
DIM_BSDF_LOBE = 7
DIM_BSDF_UV = 8
DIM_RR = 10
DIM_MIX = 11
DIMS_PER_BOUNCE = 16

#: the largest Sobol' film offset inside a pixel
_JITTER_MAX = float(np.float32(0.9999999))
#: camera rays per dispatch on the CPU (the reference's CPU default)
CPU_CHUNK = 1 << 17
#: camera rays per dispatch on a GPU (the reference's accelerator default)
GPU_CHUNK = 1 << 20


def scene_intersect(dev, o, d, t_max) -> Hit:
    """Scene::Intersect over the acceleration structure the compiler chose."""
    if "tstream" in dev:
        from tpu_pbrt_torch.accel.stream import stream_intersect

        return stream_intersect(dev["tstream"], dev["tri_verts"], o, d, t_max,
                                tv9T=dev.get("tri_verts9T"))
    from tpu_pbrt_torch.accel.mxu import brute_feature_intersect

    bf = dev["bfeat"]
    return brute_feature_intersect(
        bf["feat"], bf["center"], bf["feat"].shape[1] // 4, o, d, t_max
    )


def scene_intersect_fused(dev, o, d, t_max, n_cam: int):
    """Fused camera+shadow closest hit: the full Hit for the first n_cam
    rays, bare prim ids for the tail (queued shadow rays only need
    prim >= 0)."""
    if "tstream" in dev:
        from tpu_pbrt_torch.accel.stream import stream_intersect_split

        return stream_intersect_split(dev["tstream"], dev["tri_verts"], o, d, t_max, n_cam,
                                      tv9T=dev.get("tri_verts9T"))
    hit = scene_intersect(dev, o, d, t_max)
    return Hit(*(None if a is None else a[:n_cam] for a in hit)), hit.prim[n_cam:]


def scene_intersect_p(dev, o, d, t_max):
    """Scene::IntersectP, the shadow-ray predicate: the stream tracer's
    any-hit traversal, or the brute product's closest hit tested for a
    hit (as the reference does)."""
    if "tstream" in dev:
        from tpu_pbrt_torch.accel.stream import stream_intersect_p

        return stream_intersect_p(dev["tstream"], o, d, t_max)
    return scene_intersect(dev, o, d, t_max).prim >= 0


def unoccluded_tr(dev, o, d, dist, cur_med, px, py, s, salt, segments: int = 1):
    """VisibilityTester::Unoccluded/Tr: is the light sample visible, and
    with what transmittance? The ray stops at 0.999 of `dist` (dist <= 0:
    no test, the lane starts dead); cur_med (R,) is each ray's medium
    (-1: vacuum), None to skip the transmittance.

    segments == 1 (a scene without null interfaces): one any-hit ray, and
    the current medium's Tr on the unoccluded lanes. segments > 1: the
    walk through null-material (MAT_NONE) surfaces, as pbrt's Tr walk:
    up to `segments` closest-hit segments, each with its medium's Tr
    (salt + 7k), the medium flipped at each null crossing by the side of
    the triangle's geometric normal and the ray re-offset there; a real
    material occludes, and a lane still crossing after the last segment
    counts as occluded, as in the reference. A lane that is no longer
    walking traces no further segment, and the walk stops once none is
    (one host read per segment): neither changes a result.
    Returns (visible (R,), tr (R, 3))."""
    from tpu_pbrt_torch.accel import stream
    from tpu_pbrt_torch.core import media as md

    shape = o.shape[:-1]
    tr = torch.ones(shape + (3,), dtype=torch.float32, device=o.device)
    remaining = torch.broadcast_to(
        torch.as_tensor(dist, dtype=torch.float32, device=o.device), shape) * 0.999
    mt = dev.get("media") if cur_med is not None else None
    none = torch.full(shape, -1, dtype=torch.int32, device=o.device)

    if segments == 1:
        occluded = scene_intersect_p(dev, o, d, remaining)
        if mt is not None:
            med = torch.where(~occluded, torch.broadcast_to(cur_med, shape), none)
            tr = md.medium_tr(mt, med, o, d, remaining, px, py, s, salt)
        return ~occluded, tr

    med = torch.broadcast_to(cur_med, shape) if cur_med is not None else none
    oo = o
    visible = torch.zeros(shape, dtype=torch.bool, device=o.device)
    active = torch.ones(shape, dtype=torch.bool, device=o.device)
    for k in range(segments):
        if k:
            stream.WAVES.add_loop_read()
            if not bool(active.any()):
                break
        hit = scene_intersect(dev, oo, d,
                              torch.where(active, remaining, torch.full_like(remaining, -1.0)))
        hit_any = active & (hit.prim >= 0)
        prim = hit.prim.clamp(min=0).long()
        # tri_mat holds material-table rows; the null test is on their type
        is_null = hit_any & (dev["mat"]["type"][dev["tri_mat"][prim].long()] == bxdf.MAT_NONE)
        seg_len = torch.where(hit_any, hit.t, remaining)
        if mt is not None:
            tr_seg = md.medium_tr(mt, torch.where(active, med, none), oo, d, seg_len,
                                  px, py, s, salt + 7 * k)
            tr = torch.where(active[..., None], tr * tr_seg, tr)
        visible = visible | (active & ~hit_any)
        # step past the null interfaces, flipping the medium at the crossing
        tv = dev["tri_verts"][prim]
        ng = normalize(cross(tv[..., 1, :] - tv[..., 0, :], tv[..., 2, :] - tv[..., 0, :]))
        going_in = dot(d, ng) < 0.0
        new_med = torch.where(going_in, dev["tri_med_in"][prim], dev["tri_med_out"][prim])
        med = torch.where(is_null, new_med, med)
        p_hit = oo + hit.t[..., None] * d
        oo = torch.where(is_null[..., None], offset_ray_origin(p_hit, ng, d), oo)
        remaining = torch.where(is_null, remaining - hit.t, remaining)
        active = is_null
    return visible, tr


@dataclass
class RenderResult:
    image: np.ndarray
    film_state: Any
    seconds: float
    rays_traced: int
    mray_per_sec: float
    spp: int
    completed_fraction: float = 1.0
    stats: Dict[str, Any] = field(default_factory=dict)


class Interaction:
    """SoA surface interaction for a ray batch."""

    __slots__ = ("p", "ng", "ns", "ss", "ts", "uv", "mat", "light", "wo", "valid")

    def __init__(self, p, ng, ns, ss, ts, uv, mat, light, wo, valid):
        self.p = p
        self.ng = ng
        self.ns = ns
        self.ss = ss  # shading tangent
        self.ts = ts  # shading bitangent
        self.uv = uv
        self.mat = mat
        self.light = light
        self.wo = wo
        self.valid = valid


def make_interaction(dev, hit: Hit, o, d) -> Interaction:
    """Hit records -> surface interaction (barycentric interpolation of the
    position, shading normal and uv; geometric normal faced to the
    shading normal; an orthonormal shading frame)."""
    prim = hit.prim.clamp(min=0).long()
    tv = hit.tv if hit.tv is not None else dev["tri_verts"][prim]
    if "tri_sh16" in dev:
        sh = dev["tri_sh16"][:, prim]  # (16, R): normals, uvs, packed ids
        shT = sh.T
        tn = shT[..., 0:9].reshape(shT.shape[:-1] + (3, 3))
        tuv = shT[..., 9:15].reshape(shT.shape[:-1] + (3, 2))
        packed = sh[15].to(torch.int32)
        mat_id = packed // 4096
        light_id = packed % 4096 - 1
    else:  # ids past the packing: four gathers
        tn = dev["tri_normals"][prim]
        tuv = dev["tri_uvs"][prim]
        mat_id = dev["tri_mat"][prim]
        light_id = dev["tri_light"][prim]
    b0 = hit.b0
    b1 = hit.b1
    b2 = 1.0 - b0 - b1
    p = (b0[..., None] * tv[..., 0, :] + b1[..., None] * tv[..., 1, :]
         + b2[..., None] * tv[..., 2, :])
    e1 = tv[..., 1, :] - tv[..., 0, :]
    e2 = tv[..., 2, :] - tv[..., 0, :]
    ng = normalize(cross(e1, e2))
    ns = (b0[..., None] * tn[..., 0, :] + b1[..., None] * tn[..., 1, :]
          + b2[..., None] * tn[..., 2, :])
    ns_len = torch.sqrt(dot(ns, ns))[..., None]
    ns = torch.where(ns_len > 1e-12, ns / torch.clamp(ns_len, min=1e-20), ng)
    ng = face_forward(ng, ns)
    uv = (b0[..., None] * tuv[..., 0, :] + b1[..., None] * tuv[..., 1, :]
          + b2[..., None] * tuv[..., 2, :])
    ss, ts = coordinate_system(ns)
    return Interaction(p=p, ng=ng, ns=ns, ss=ss, ts=ts, uv=uv, mat=mat_id,
                       light=light_id, wo=-d, valid=hit.prim >= 0)


def texture_footprint(dev, it_prim, p_hit, ng, o, d, dox, ddx, doy, ddy):
    """SurfaceInteraction::ComputeDifferentials (interaction.cpp) -> the
    uv differentials for MIPMap::Lookup: the two pixel-offset rays meet
    the tangent plane at the hit, and the 2x2 least-squares solve against
    the triangle's dpdu/dpdv (dev["tri_difT"]) gives duv/dx and duv/dy.
    Returns (R, 4) [dudx, dvdx, dudy, dvdy], clamped to +-0.5, 0 where
    undefined (the level-0 fallback)."""
    prim = it_prim.long().clamp(min=0)
    rows = dev["tri_difT"][:, prim]  # (8, R)
    dpdu = rows[0:3].transpose(0, 1)
    dpdv = rows[3:6].transpose(0, 1)
    n = ng
    denom0 = dot(d, n)

    def plane_hit(do_, dd_):
        d_off = d + dd_
        o_off = o + do_
        den = dot(d_off, n)
        t = dot(p_hit - o_off, n) / torch.where(torch.abs(den) < 1e-9, torch.ones_like(den), den)
        return o_off + t[..., None] * d_off - p_hit

    dpdx = plane_hit(dox, ddx)
    dpdy = plane_hit(doy, ddy)
    a00 = dot(dpdu, dpdu)
    a01 = dot(dpdu, dpdv)
    a11 = dot(dpdv, dpdv)
    det = a00 * a11 - a01 * a01
    ok = (torch.abs(det) > 1e-18) & (torch.abs(denom0) > 1e-9)
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))

    def solve(dp):
        b0 = dot(dp, dpdu)
        b1 = dot(dp, dpdv)
        return (a11 * b0 - a01 * b1) * inv, (a00 * b1 - a01 * b0) * inv

    dudx, dvdx = solve(dpdx)
    dudy, dvdy = solve(dpdy)
    duv = torch.stack([dudx, dvdx, dudy, dvdy], dim=-1)
    good = (ok & torch.isfinite(duv).all(dim=-1))[..., None]
    # grazing footprints beyond half the texture take the coarsest level anyway
    return torch.where(good, torch.clamp(duv, -0.5, 0.5), torch.zeros_like(duv))


def _mean3(x):
    """The reference's jnp.mean over an rgb axis: the sum, then / 3."""
    s = (x[..., 0] + x[..., 1]) + x[..., 2]
    return s / torch.full_like(s, 3.0)


def textured_mat(dev, mid, uv, p, tex_eval, tex_used, width=None, u_mix=None,
                 slot_ids=None) -> bxdf.MatParams:
    """Material::ComputeScatteringFunctions' texture step (material.cpp):
    resolve mix lanes to one sub-material (bxdf.resolve_mix, with the draw
    u_mix), gather the constant-folded rows, then overwrite each slot that
    carries a texture id with its evaluator's value at (uv, p) (width:
    the optional (R, 4) footprint of a camera hit, for the mip filter).
    tex_used is the scene's static set of textured slots; slot_ids the
    texture ids each slot can hold."""
    mid = bxdf.resolve_mix(dev["mat"], mid, u_mix)
    mp = bxdf.gather_mat(dev["mat"], mid)
    if tex_eval is None or "tex_atlas" not in dev or not tex_used:
        return mp
    mt = dev["mat"]
    atlas = dev["tex_atlas"]
    slot_ids = slot_ids or {}
    idx = mid.long().clamp(0, mt["type"].shape[0] - 1)

    def ev(slot, name):
        tid = mt[slot][idx]
        return tid, tex_eval(atlas, tid, uv, p, width, slot_ids.get(name))

    kw = {}
    with torch.profiler.record_function("textured_mat"):
        for slot, name in (("kd_tex", "kd"), ("ks_tex", "ks"), ("opacity_tex", "opacity")):
            if name in tex_used:
                tid, v = ev(slot, name)
                kw[name] = torch.where((tid >= 0)[..., None], v, getattr(mp, name))
        if "sigma" in tex_used:
            tid, v = ev("sigma_tex", "sigma")
            kw["sigma"] = torch.where(tid >= 0, _mean3(v), mp.sigma)
        if "rough" in tex_used:
            # roughness feeds the GGX alphas through the remap: the
            # override recomputes ax / ay as gather_mat derives them, and
            # rough_raw, which gates the rough-glass lobes
            tid, v = ev("rough_tex", "rough")
            r = _mean3(v)
            remap = mt["remap"][idx]
            a_t = torch.where(remap > 0, bxdf.tr_roughness_to_alpha(r), torch.clamp(r, min=1e-3))
            on = tid >= 0
            kw["ax"] = torch.where(on, a_t, mp.ax)
            kw["ay"] = torch.where(on, a_t, mp.ay)
            kw["rough_raw"] = torch.where(on, r, mp.rough_raw)
    return mp._replace(**kw)


def estimate_direct(dev, light_distr, it: Interaction, mp, px, py, s, bounce: int,
                    light_idx=None, salt_extra: int = 0, vis_segments: int = 1,
                    sampler=("random", 1)):
    """pbrt EstimateDirect with MIS: the light-sampling half (one any-hit
    shadow ray, or the walk through null interfaces with vis_segments >
    1) and the BSDF-sampling half (one closest-hit ray).

    light_idx None: UniformSampleOneLight (a light picked through
    light_distr, its pick pmf folded into the pdf); light_idx (R,): that
    light row (UniformSampleAllLights loops it over every row; the BSDF
    half then counts only that light and undoes the uniform pick pmf).
    The expression order is the reference's. Returns (R, 3)."""
    salt = bounce * DIMS_PER_BOUNCE + salt_extra
    skind, spp = sampler
    # ---- light-sampling half ----------------------------------------
    u_pick = sample_1d(skind, spp, px, py, s, salt + DIM_LIGHT_PICK)
    u1, u2 = sample_2d(skind, spp, px, py, s, salt + DIM_LIGHT_UV)
    if light_idx is None:
        ls = ld.sample_one_light(dev, light_distr, it.p, u_pick, u1, u2)
    else:
        ls = ld.sample_light_rows(dev, light_idx, it.p, u1, u2)
    wi_l = to_local(ls.wi, it.ss, it.ts, it.ns)
    wo_l = to_local(it.wo, it.ss, it.ts, it.ns)
    f, bsdf_pdf = bxdf.bsdf_eval(mp, wo_l, wi_l)
    f = f * torch.abs(dot(ls.wi, it.ns))[..., None]
    do_light = (it.valid & (ls.pdf > 0.0) & (f.amax(dim=-1) > 0.0)
                & (ls.li.amax(dim=-1) > 0.0))
    o_s = offset_ray_origin(it.p, it.ng, ls.wi)
    visible, _ = unoccluded_tr(dev, o_s, ls.wi,
                               torch.where(do_light, ls.dist, torch.full_like(ls.dist, -1.0)),
                               None, px, py, s, salt + DIM_LIGHT_UV + 300, segments=vis_segments)
    vis = do_light & visible
    w_light = torch.where(ls.is_delta, torch.ones_like(ls.pdf),
                          power_heuristic(1.0, ls.pdf, 1.0, bsdf_pdf))
    contrib_l = f * ls.li * (w_light / torch.clamp(ls.pdf, min=1e-20))[..., None]
    L = torch.where(vis[..., None], contrib_l, torch.zeros_like(contrib_l))

    # ---- BSDF-sampling half (non-delta lights: area and infinite) ---
    ul = sample_1d(skind, spp, px, py, s, salt + DIM_BSDF_LOBE + 200)
    ub1, ub2 = sample_2d(skind, spp, px, py, s, salt + DIM_BSDF_UV + 200)
    bs = bxdf.bsdf_sample(mp, wo_l, ul, ub1, ub2)
    wi_w = to_world(bs.wi, it.ss, it.ts, it.ns)
    f_b = bs.f * torch.abs(dot(wi_w, it.ns))[..., None]
    do_b = it.valid & ~bs.is_specular & (bs.pdf > 0.0) & (f_b.amax(dim=-1) > 0.0)
    o_b = offset_ray_origin(it.p, it.ng, wi_w)
    hit_b = scene_intersect(dev, o_b, wi_w, float("inf"))
    hit_light = dev["tri_light"][hit_b.prim.clamp(min=0).long()]
    hit_emissive = (hit_b.prim >= 0) & (hit_light >= 0)
    if light_idx is not None:
        # restricted to one light: only hits on that light's triangles count
        hit_emissive = hit_emissive & (hit_light == light_idx)
    it_b = make_interaction(dev, hit_b, o_b, wi_w)
    le_b = ld.emitted_radiance(
        dev, torch.where(hit_emissive, hit_light, torch.full_like(hit_light, -1)), -wi_w, it_b.ng)
    # the light-sampling pdf of this direction for MIS: the pick pmf is
    # included for one light and undone for a fixed row, as in the
    # light half's convention
    lpdf_area = ld.emitted_pdf(dev, None if light_idx is not None else light_distr,
                               it.p, it_b.p, hit_light, it_b.ng)
    n_l = dev["light"]["type"].shape[0]
    if light_idx is not None:
        lpdf_area = lpdf_area * n_l
    zero = torch.zeros_like(lpdf_area)
    if "envmap" in dev:
        le_env = ld.env_lookup(dev, wi_w)
        lpdf_env = ld.infinite_pdf(dev, None if light_idx is not None else light_distr, wi_w,
                                   ref_p=it.p)
        miss = hit_b.prim < 0
        if light_idx is not None:
            lpdf_env = lpdf_env * n_l
            is_env_row = dev["light"]["type"][light_idx.clamp(min=0).long()] == ld.LIGHT_INFINITE
            miss = miss & is_env_row
        le_b = torch.where(miss[..., None], le_env, le_b)
        lpdf = torch.where(miss, lpdf_env, torch.where(hit_emissive, lpdf_area, zero))
        got_light = miss | hit_emissive
    else:
        lpdf = torch.where(hit_emissive, lpdf_area, zero)
        got_light = hit_emissive
    w_b = power_heuristic(1.0, bs.pdf, 1.0, lpdf)
    contrib_b = f_b * le_b * (w_b / torch.clamp(bs.pdf, min=1e-20))[..., None]
    return L + torch.where((do_b & got_light & (lpdf > 0.0))[..., None], contrib_b,
                           torch.zeros_like(contrib_b))


@dataclass
class ChunkPlan:
    """The chunked decomposition of one render's work domain on one
    device, and the dispatch of one chunk (the reference's ChunkPlan
    without the mesh and the jit cache).

    ``dispatch(state, c)`` renders chunk ``c`` into the film accumulator
    ``state`` (in place) and returns its accounting: ``(rays, live lane
    waves, waves, truncated, counters)`` through the pool, ``(rays,
    nonfinite count or None)`` through the fixed batch. The (film state,
    chunk cursor, rays, counters) a caller carries between dispatches is
    exactly the checkpoint's payload."""

    scene: Any
    film: Any
    chunk: int
    n_chunks: int
    spp: int
    total: int
    npix: int
    bounds: tuple  # film sample bounds (x0, x1, y0, y1)
    pool: int
    use_regen: bool
    fingerprint: str
    #: which flush/expand program the stream tracer runs: "fused" (the
    #: hand-written kernels, on CUDA) or "plain" (their plain versions,
    #: on the CPU; the reference calls this mode "jnp")
    tracer: str
    _dispatch: Callable = field(repr=False, default=None)

    def start(self, c: int):
        """Chunk c's first work item as (pixel, sample): int32-safe."""
        return divmod(c * self.chunk, self.spp)

    def dispatch(self, state, c: int):
        return self._dispatch(state, c)


def _fixed_batch_nonfinite(valid, L):
    """The film firewall's scrub count for a fixed-batch chunk (valid work
    items whose radiance is NaN/Inf), or None with telemetry killed."""
    from tpu_pbrt_torch.obs.counters import enabled

    if not enabled():
        return None
    from tpu_pbrt_torch.core.film import nonfinite_mask

    return (nonfinite_mask(L) & valid).sum(dtype=torch.int32)


class WavefrontIntegrator:
    """Base class: the chunk plan and the render loop."""

    def __init__(self, params, scene, options):
        self.params = params
        self.scene = scene
        self.options = options
        strategy = scene.light_distribution_name
        if strategy == "uniform":
            self.light_distr = None
        elif strategy == "spatial" and scene.spatial_distr is not None:
            self.light_distr = scene.spatial_distr
        else:
            self.light_distr = scene.light_distr
        # shadow rays walk through null-interface (MAT_NONE) surfaces only
        # in scenes that have them
        self.vis_segments = 4 if scene.has_null_materials else 1
        # the compiled texture evaluators (None when every slot folded)
        self.tex_eval = getattr(scene, "tex_eval", None)
        self.tex_used = getattr(scene, "tex_used", frozenset())
        self.tex_slot_ids = getattr(scene, "tex_slot_ids", None) or {}
        self.skind = normalize_sampler_name(scene.sampler.name)
        self.spp = int(scene.sampler.spp)
        self._prepare_sampler()

    def _prepare_sampler(self):
        """The Sobol' sampler's pixel grid for this scene (self._sobol_m,
        the log2 of its side); downgrades to the (0,2)-sequence, with a
        warning, when spp * 4^m would overflow the 32-bit global index."""
        self._sobol_m = 0
        if self.skind != "sobol":
            return
        m = sobol_resolution_log2(self.scene.film.full_resolution)
        self._sobol_m = m
        if self.spp << (2 * m) >= (1 << 31):
            from tpu_pbrt_torch.utils.error import Warning as _W

            _W("sobol: spp * 4^ceil(log2(res)) exceeds the 32-bit global "
               "index range; SUBSTITUTING the (0,2)-sequence sampler")
            self.skind = "02"

    def u1d(self, px, py, s, salt):
        return sample_1d(self.skind, self.spp, px, py, s, salt)

    def u2d(self, px, py, s, salt):
        return sample_2d(self.skind, self.spp, px, py, s, salt)

    def _regen_enabled(self) -> bool:
        """Whether this integrator renders through the persistent pool
        (PathIntegrator overrides; everything else keeps the fixed batch)."""
        return False

    def film_jitter(self, px, py, s):
        """In-pixel film sample offset of sample s of pixel (px, py), a pure
        function of the work item (the pool recomputes it at deposit
        time): under Sobol' the global sequence's dims 0/1 at the index
        that lands the sample in its pixel (sobol.cpp), else the
        per-pixel scrambled (0,2)-sequence."""
        if self.skind == "sobol":
            m = self._sobol_m
            gi = sobol_interval_to_index(m, s, px, py)
            sc = float(np.float32((1 << m) * 2.3283064365386963e-10))

            def offset(dim, p):
                v = _sobol_raw_bits(gi, dim).to(torch.float32) * sc - p.to(torch.float32)
                return torch.clamp(v, 0.0, _JITTER_MAX)

            return offset(0, px), offset(1, py)
        return sobol_2d(s, hash_u32(px, py, 0x11), hash_u32(px, py, 0x22))

    def work_to_rays(self, cam, spp, x0, y0, w, npix, start_pix, start_s, k):
        """Flat work offsets k (R,) -> camera rays. The range start is
        carried as (start_pix, start_s) so the arithmetic stays in int32.
        Shared by the fixed batch and the pool's regeneration, so both
        derive the same (px, py, s) and sample streams for a work item."""
        s_tot = start_s + k
        pix = start_pix + torch.div(s_tot, spp, rounding_mode="floor")
        s = s_tot % spp
        valid = pix < npix
        px = x0 + pix % w
        py = y0 + torch.div(pix, w, rounding_mode="floor")
        fx, fy = self.film_jitter(px, py, s)
        p_film = torch.stack(
            [px.to(torch.float32) + fx, py.to(torch.float32) + fy], dim=-1
        )
        u_lens = torch.stack(list(self.u2d(px, py, s, DIM_LENS)), dim=-1)
        o, d, wt = generate_rays(cam, p_film, u_lens)
        return valid, px, py, s, p_film, o, d, wt

    def mat_at(self, dev, it, width=None, u_mix=None) -> bxdf.MatParams:
        """Textured material parameters at a surface interaction; width is
        the optional (R, 4) ray-differential footprint (camera hits), u_mix
        the optional mix-material draw (bxdf.resolve_mix)."""
        return textured_mat(dev, it.mat, it.uv, it.p, self.tex_eval, self.tex_used, width,
                            u_mix, self.tex_slot_ids)

    def li(self, dev, o, d, px, py, s):
        raise NotImplementedError

    def pool_chunk(self, dev, fs, start_pix, start_s, n_work, pool, film=None, cam=None):
        raise NotImplementedError

    def prepare_chunks(self, scene=None, chunk: Optional[int] = None) -> ChunkPlan:
        """The chunk decomposition of the work domain (pixel-major, spp
        consecutive samples per pixel) and its dispatch. The chunk is, in
        order: the `chunk` argument, the options' spp_chunk, the
        TORCH_PBRT_CHUNK knob, or the device default; the pool holds a
        quarter of it, at least min(chunk, 4096) slots, unless
        TORCH_PBRT_POOL sets it."""
        from tpu_pbrt_torch.parallel.checkpoint import render_fingerprint

        scene = scene or self.scene
        film, cam = scene.film, scene.camera
        x0, x1, y0, y1 = film.sample_bounds()
        w = x1 - x0
        npix = w * (y1 - y0)
        spp = scene.sampler.spp
        total = npix * spp
        if chunk is None:
            chunk = int(getattr(self.options, "spp_chunk", 0) or 0) or None
        if chunk is None:
            default = GPU_CHUNK if scene.device.type == "cuda" else CPU_CHUNK
            chunk = int(cfg.chunk if cfg.chunk is not None else default)
        chunk = max(min(int(chunk), max(1024, total)), 1)
        use_regen = self._regen_enabled()
        pool = 0
        if use_regen:
            pool = int(cfg.pool)
            if pool <= 0:
                pool = max(chunk // 4, min(chunk, 4096))
            pool = min(pool, chunk)
        plan = ChunkPlan(
            scene=scene, film=film, chunk=chunk,
            n_chunks=(total + chunk - 1) // chunk, spp=spp, total=total, npix=npix,
            bounds=(x0, x1, y0, y1), pool=pool, use_regen=use_regen,
            fingerprint=render_fingerprint(chunk=chunk, spp=spp, total=total, scene=scene),
            tracer="fused" if scene.device.type == "cuda" else "plain",
        )
        if use_regen:

            def dispatch(state, c):
                start_pix, start_s = plan.start(c)
                _, nrays, live, waves, trunc, ctr = self.pool_chunk(
                    scene.dev, state, start_pix, start_s, chunk, pool, film=film, cam=cam)
                return nrays, live, waves, trunc, ctr

        else:
            # pixel-major chunks that tile the frame exactly take the
            # film's scatter-free aligned deposit
            aligned = film.aligned_chunk_pixels(chunk, spp) > 0
            box_fast = film.pixel_deposit_ok()
            k = torch.arange(chunk, dtype=torch.int32, device=scene.device)

            def dispatch(state, c):
                start_pix, start_s = plan.start(c)
                valid, px, py, s, p_film, o, d, wt = self.work_to_rays(
                    cam, spp, x0, y0, w, npix, start_pix, start_s, k)
                out = self.li(scene.dev, o, d, px, py, s)
                L, nrays = out[:2]
                nrays = torch.where(valid, nrays, torch.zeros_like(nrays)).sum()
                nf = _fixed_batch_nonfinite(valid, L)
                if aligned:
                    film.add_samples_aligned(state, start_pix, spp, L, wt)
                elif box_fast:
                    film.add_samples_pixel(state, px, py, L, valid, wt)
                else:
                    p_film = torch.where(valid[..., None], p_film, torch.full_like(p_film, -1e6))
                    film.add_samples(state, p_film, L, wt)
                if len(out) == 4:
                    # a splatting integrator (BDPT's t=1 strategies):
                    # (L, nrays, splat_xy (R,K,2), splat_val (R,K,3))
                    sxy, sval = out[2:]
                    sval = torch.where(valid[..., None, None], sval, torch.zeros_like(sval))
                    film.add_splats(state, sxy.reshape(-1, 2), sval.reshape(-1, 3))
                return nrays, nf

        plan._dispatch = dispatch
        return plan

    def render(self, scene=None, chunk: Optional[int] = None, checkpoint_path=None,
               checkpoint_every: int = 0, max_seconds: float = 0.0) -> RenderResult:
        """SamplerIntegrator::Render on one device: every chunk through
        the pool (or the fixed batch), deposited into the film.

        Checkpoint/resume: a checkpoint is the film state plus the chunk
        cursor (chunks are pure functions of their work range and the
        film sums associatively), so a resumed render is bit-identical to
        an uninterrupted one. It is read from and written to
        `checkpoint_path` (default: the options' checkpoint_path) every
        `checkpoint_every` chunks and at the end. max_seconds > 0 stops
        at the first chunk boundary past the budget and returns a partial
        render with completed_fraction < 1 (pixel-major, so the trailing
        pixels are unsampled). Writes the image when the film names a
        file. The wall time ends in a device synchronize."""
        from tpu_pbrt_torch.accel import stream
        from tpu_pbrt_torch.obs import counters as obs_counters
        from tpu_pbrt_torch.parallel.checkpoint import (
            checkpoint_exists,
            load_checkpoint,
            save_checkpoint,
        )
        from tpu_pbrt_torch.utils.error import Warning as _W

        plan = self.prepare_chunks(scene, chunk)
        scene, film, device = plan.scene, plan.film, plan.scene.device
        ckpt_path = checkpoint_path or getattr(self.options, "checkpoint_path", None)
        checkpoint_every = checkpoint_every or getattr(self.options, "checkpoint_every", 0)
        first_chunk, prev_rays, prev_ctr = 0, 0, {}
        if ckpt_path and checkpoint_exists(ckpt_path):
            state, first_chunk, prev_rays, prev_ctr = load_checkpoint(
                ckpt_path, plan.fingerprint, device=device)
        else:
            state = film.init_state(device)
        ray_counts, occ_counts, ctr_counts, nf_counts = [], [], [], []

        def rays_so_far() -> int:
            return prev_rays + (int(torch.stack(ray_counts).sum()) if ray_counts else 0)

        def ctr_snapshot() -> Dict[str, Any]:
            """Cumulative host counters: the resumed snapshot + every chunk
            so far (one device read each)."""
            snap = obs_counters.merge_host(prev_ctr, obs_counters.to_host(ctr_counts))
            if nf_counts:
                snap = obs_counters.merge_host(
                    snap, {"nonfinite_deposits": int(torch.stack(nf_counts).sum())})
            return snap

        prev_det = torch.are_deterministic_algorithms_enabled()
        prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
        if device.type == "cuda":
            # the film's scatter-adds accumulate in a fixed order
            torch.use_deterministic_algorithms(True, warn_only=True)
        stream.WAVES.reset()
        c = first_chunk
        try:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            while c < plan.n_chunks:
                aux = plan.dispatch(state, c)
                c += 1
                ray_counts.append(aux[0])
                if plan.use_regen:
                    occ_counts.append(aux[1:4])
                    if aux[4] is not None:
                        ctr_counts.append(aux[4])
                elif aux[1] is not None:
                    nf_counts.append(aux[1])
                if ckpt_path and checkpoint_every and c % checkpoint_every == 0:
                    save_checkpoint(ckpt_path, state, c, rays_so_far(),
                                    fingerprint=plan.fingerprint, counters=ctr_snapshot())
                if max_seconds > 0 and time.perf_counter() - t0 > max_seconds:
                    break
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            secs = time.perf_counter() - t0
        finally:
            torch.use_deterministic_algorithms(prev_det, warn_only=prev_warn)
        completed_fraction = c / max(plan.n_chunks, 1)
        rays = rays_so_far()
        ctr_total = ctr_snapshot()
        if ckpt_path:
            save_checkpoint(ckpt_path, state, c, rays, fingerprint=plan.fingerprint,
                            counters=ctr_total)
        # pbrt film.cpp splatScale: splats divide by the samples taken
        splat_scale = 1.0 / max(plan.spp * completed_fraction, 1e-9)
        img = film.develop(state, splat_scale=splat_scale)
        if film.filename:
            try:
                film.write_image(state, splat_scale=splat_scale)
            except OSError as e:
                _W(f"could not write image {film.filename}: {e}")

        waves = stream.WAVES
        per_wave = max(waves.waves, 1)
        stats: Dict[str, Any] = {
            "chunks": plan.n_chunks,
            "chunk": plan.chunk,
            "waves": waves.waves,
            "iters_per_wave_mean": waves.iters / per_wave,
            "iters_per_wave_max": waves.iters_max,
            "host_reads_per_wave_mean": waves.host_reads / per_wave,
            "loop_host_reads_per_wave": waves.loop_reads / per_wave,
            # traversal pairs lost to worklist capacity (0 unless the
            # headroom knob is cut below 1)
            "n_drop": int(waves.drops),
            # closest-hit and any-hit waves apart: waves, iterations, host
            # reads and kernel-wrapper calls, with their per-wave means
            "wave_modes": waves.mode_stats(),
        }
        if "tstream" in scene.dev:
            stats["tracer_mode"] = plan.tracer
        wave_counts = []
        if plan.use_regen and occ_counts:
            live_t = int(torch.stack([lv for lv, _, _ in occ_counts]).sum())
            wave_counts = [int(wv) for _, wv, _ in occ_counts]
            trunc_t = sum(int(t) for _, _, t in occ_counts)
            if trunc_t:
                _W(f"persistent wavefront truncated {trunc_t} chunk drain(s) at the "
                   "max_waves safety bound; the image is missing samples (raise "
                   "TORCH_PBRT_POOL or report a bug)")
                stats["truncated_chunks"] = trunc_t
            stats |= {
                # fraction of pool slots holding a live path at trace time,
                # averaged over every wave
                "mean_wave_occupancy": live_t / max(sum(wave_counts) * plan.pool, 1),
                "n_waves": sum(wave_counts),
                "pool": plan.pool,
                "regen": True,
            }
        if obs_counters.enabled() and ctr_total:
            stats["telemetry"] = {
                "counters": ctr_total,
                "wave_spread": obs_counters.spread_stats([sum(wave_counts)] if wave_counts else []),
            }
        return RenderResult(
            image=img, film_state=state, seconds=secs, rays_traced=rays,
            mray_per_sec=rays / max(secs, 1e-9) / 1e6, spp=plan.spp,
            completed_fraction=completed_fraction, stats=stats,
        )

