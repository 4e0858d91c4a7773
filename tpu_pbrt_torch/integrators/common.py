"""Shared wavefront-integrator machinery (port of tpu_pbrt/integrators/common.py).

- Scene::Intersect / IntersectP dispatch to the stream tracer, the
  packet, wide or binary walker (TORCH_PBRT_BVH), or the brute feature
  product for scenes of at most BRUTE_MAX_TRIS triangles,
  and the fused camera+shadow closest hit of the 2R wave layout;
- SurfaceInteraction construction from a Hit, and the material at a hit
  (`textured_mat`: the mix resolution, the row gather and every textured
  slot's evaluation, with the camera hits' ray-differential footprint of
  `texture_footprint` driving the mip filter);
- the chunk plan and the render loop on one device: the image x spp
  work domain is cut into chunks of camera rays; each chunk drains
  through the integrator's persistent pool (`pool_chunk`) or runs its
  fixed batch (`li`) to completion, and deposits into the film; the loop
  keeps a window of chunk-slices in flight (DispatchWindow), checkpoints
  at a cadence (deferred under the window), resumes from a checkpoint,
  recovers from failed dispatches (re-dispatch, rollback, restart, with
  backoff), runs the film firewall's scrub/raise/retry modes, reports to
  STATS, FLIGHT, TRACE and METRICS, stops at a time box, and writes the
  image.

Every sampler dimension is a pure function of (px, py, s, dimension
salt), so the port draws the reference's sample streams.
"""

from __future__ import annotations

import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from tpu_pbrt_torch.accel.traverse import WALKS, Hit
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
from tpu_pbrt_torch.core.xla_math import fmac, sqrt as _sqrt
from tpu_pbrt_torch.utils.clock import WALL

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
#: camera rays per GPU dispatch under the packet, wide and binary walkers
#: (the reference's accelerator default for them: their waves are orders
#: of magnitude slower than the stream tracer's)
WALKER_CHUNK = 1 << 13


def scene_intersect(dev, o, d, t_max, time=None) -> Hit:
    """Scene::Intersect over the acceleration structure the compiler chose:
    the stream tracer, the packet, wide or binary walker
    (TORCH_PBRT_BVH=packet|wide|binary, static: they take no ray time),
    or the brute feature product. time: each ray's shutter time in [0, 1]
    on a motion scene (dev carries tri_verts1), None for time 0 and the
    shutter-start vertices."""
    if "tstream" in dev:
        from tpu_pbrt_torch.accel.stream import stream_intersect

        return stream_intersect(dev["tstream"], dev["tri_verts"], o, d, t_max, time=time,
                                tri_verts1=dev.get("tri_verts1"), tv9T=dev.get("tri_verts9T"),
                                tv9T1=dev.get("tri_verts1_9T"))
    if walker_kind(dev) is not None:
        return _walk(dev, o, d, t_max, any_hit=False)
    from tpu_pbrt_torch.accel.mxu import brute_feature_intersect

    bf = dev["bfeat"]
    hit = brute_feature_intersect(
        bf["feat"], bf["center"], bf["feat"].shape[1] // 4, o, d, t_max, time=time
    )
    if "tri_verts1" in dev and time is not None:
        # shading sees the triangle at the ray's time, not the
        # shutter-start keyframe make_interaction would fetch
        from tpu_pbrt_torch.accel.stream import keyframe_lerp

        prim = hit.prim.clamp(min=0).long()
        hit = hit._replace(tv=keyframe_lerp(dev["tri_verts"][prim], dev["tri_verts1"][prim], time))
    return hit


def scene_intersect_fused(dev, o, d, t_max, n_cam: int, time=None):
    """Fused camera+shadow closest hit: the full Hit for the first n_cam
    rays, bare prim ids for the tail (queued shadow rays only need
    prim >= 0)."""
    if "tstream" in dev:
        from tpu_pbrt_torch.accel.stream import stream_intersect_split

        return stream_intersect_split(dev["tstream"], dev["tri_verts"], o, d, t_max, n_cam,
                                      time=time, tri_verts1=dev.get("tri_verts1"),
                                      tv9T=dev.get("tri_verts9T"),
                                      tv9T1=dev.get("tri_verts1_9T"))
    hit = scene_intersect(dev, o, d, t_max, time=time)
    return Hit(*(None if a is None else a[:n_cam] for a in hit)), hit.prim[n_cam:]


def scene_intersect_p(dev, o, d, t_max, time=None):
    """Scene::IntersectP, the shadow-ray predicate: the stream tracer's
    any-hit traversal at the rays' times, a walker's any-hit walk, or the
    brute product's closest hit tested for a hit, at time 0 (as the
    reference does)."""
    if "tstream" in dev:
        from tpu_pbrt_torch.accel.stream import stream_intersect_p

        return stream_intersect_p(dev["tstream"], o, d, t_max, time=time)
    if walker_kind(dev) is not None:
        return _walk(dev, o, d, t_max, any_hit=True)
    return scene_intersect(dev, o, d, t_max).prim >= 0


#: a walker scene's table -> its TORCH_PBRT_BVH name
WALKER_TABLES = {"tpack": "packet", "wbvh": "wide", "bvh": "binary"}


def walker_kind(dev) -> Optional[str]:
    """The walker the scene traces through ("packet", "wide" or "binary"),
    or None."""
    return next((kind for key, kind in WALKER_TABLES.items() if key in dev), None)


def device_chunk(scene) -> int:
    """The default chunk of one device: CPU_CHUNK on the CPU; on the card
    WALKER_CHUNK where the compiler built a walker's tables, else
    GPU_CHUNK (a walker knob on a scene it falls back from keeps the
    stream tracer's or the brute product's chunk)."""
    if scene.device.type != "cuda":
        return CPU_CHUNK
    return GPU_CHUNK if walker_kind(scene.dev) is None else WALKER_CHUNK


def _walk(dev, o, d, t_max, any_hit: bool):
    """The walker scene's closest hit, or its any-hit predicate."""
    from tpu_pbrt_torch.accel import packet, traverse, wide

    if "tpack" in dev:
        fn = packet.packet_intersect_p if any_hit else packet.packet_intersect
        return fn(dev["tpack"], o, d, t_max)
    if "wbvh" in dev:
        fn = wide.wide_intersect_p if any_hit else wide.wide_intersect
        return fn(dev["wbvh"], dev["tri_verts"], o, d, t_max)
    fn = traverse.bvh_intersect_p if any_hit else traverse.bvh_intersect
    return fn(dev["bvh"], dev["tri_verts"], o, d, t_max)


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
            if not bool(active.any()):  # torchlint: disable=JL-SYNC (the segment loop's test)
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
    # p and ns as the reference's compiled program rounds them:
    # fma(b2, v2, fma(b0, v0, b1 v1)) per component
    p = fmac(b2[..., None], tv[..., 2, :],
              fmac(b0[..., None], tv[..., 0, :], b1[..., None] * tv[..., 1, :]))
    e1 = tv[..., 1, :] - tv[..., 0, :]
    e2 = tv[..., 2, :] - tv[..., 0, :]
    ng = normalize(cross(e1, e2))
    ns = fmac(b2[..., None], tn[..., 2, :],
               fmac(b0[..., None], tn[..., 0, :], b1[..., None] * tn[..., 1, :]))
    ns_len = _sqrt(dot(ns, ns))[..., None]
    ns = torch.where(ns_len > 1e-12, ns / torch.clamp(ns_len, min=1e-20), ng)
    ng = face_forward(ng, ns)
    uv = (b0[..., None] * tuv[..., 0, :] + b1[..., None] * tuv[..., 1, :]
          + b2[..., None] * tuv[..., 2, :])
    if "tri_tanT" in dev:
        # the uv-aligned shading tangent (triangle.cpp dpdu), which the
        # hair BSDF needs as its x axis (along the curve); built only for
        # scenes with hair
        tan = dev["tri_tanT"][:, prim].T
        tan = fmac(-ns, dot(tan, ns)[..., None], tan)
        tl = _sqrt(dot(tan, tan))[..., None]
        ss0, ts0 = coordinate_system(ns)
        ok = tl[..., 0] > 1e-8
        ss = torch.where(ok[..., None], tan / torch.clamp(tl, min=1e-20), ss0)
        ts = torch.where(ok[..., None], cross(ns, ss), ts0)
    else:
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
    if mp.hz is not None:
        # hair: the across-width offset h = -1 + 2v of the ribbon's uv
        # (curve.cpp's flat-curve parameterization)
        h = torch.clamp(-1.0 + 2.0 * uv[..., 1], -0.9995, 0.9995)
        mp = mp._replace(hz=mp.hz._replace(h=h))
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


class ChunkDispatchError(RuntimeError):
    """A chunk dispatch failed. poisons_state=True means the film
    accumulator cannot be trusted (the port deposits in place, so a
    dispatch that died part-way has written part of its chunk) and
    recovery must roll back to the last checkpoint or restart; False
    means the dispatch never ran and a plain re-dispatch is exact."""

    def __init__(self, msg="chunk dispatch failed", poisons_state=False):
        super().__init__(msg)
        self.poisons_state = poisons_state


class NonFiniteWaveError(ChunkDispatchError):
    """The film firewall scrubbed deposits of a chunk under
    TORCH_PBRT_NONFINITE=retry: the film holds zeroed contributions where
    radiance belonged, so the chunk poisons the state and recovery
    re-renders it exactly."""

    def __init__(self, msg):
        super().__init__(msg, poisons_state=True)


class NonFiniteRadianceError(RuntimeError):
    """TORCH_PBRT_NONFINITE=raise: a chunk deposited NaN/Inf radiance (the
    firewall scrubbed it; strict mode makes any contamination fatal)."""


#: the errors of a device dispatch that enter the recovery ladder: the
#: CUDA runtime's error type, and only that. A kernel that fails to build,
#: a failed launch and a wrapper that refuses its inputs raise other
#: types and reach the caller at once, never retried.
DEVICE_ERRORS = tuple(e for e in (getattr(torch, "AcceleratorError", None),) if e is not None)


def redispatch_backoff(chunk: int, attempt: int) -> float:
    """Seconds to wait before re-dispatch `attempt` (1-based) of `chunk`:
    min(base * 2^(attempt-1), cap) scaled into [0.5, 1.0] by a hash of
    (chunk, attempt), so recoveries are reproducible while retries of
    different chunks still spread apart (the reference's function)."""
    base = float(cfg.retry_backoff)
    cap = float(cfg.retry_backoff_cap)
    if base <= 0.0:
        return 0.0
    b = min(base * (2.0 ** max(attempt - 1, 0)), cap)
    frac = (zlib.crc32(f"{chunk}:{attempt}".encode()) & 0xFFFF) / 65535.0
    return b * (0.5 + 0.5 * frac)


def live_film_carries(depth: int) -> int:
    """Worst-case film-sized buffers live at once for one render through
    a depth-N window: at depth 1 the film alone (written in place); at
    depth > 1 each in-flight slice may hold a deferred checkpoint's
    snapshot, plus the live film: depth + 1 (the reference's count)."""
    d = max(1, int(depth))
    return 1 if d == 1 else d + 1


def _block(handle) -> None:
    """Wait for a slice's sync handle: a torch.cuda.Event (recorded after
    the chunk's last op) is synchronized; anything else (a CPU chunk's
    handle) is complete already."""
    sync = getattr(handle, "synchronize", None)
    if sync is not None:
        sync()


class DispatchWindow:
    """Bounded in-flight window of dispatched chunk-slices (the
    reference's DispatchWindow on CUDA events).

    Keep up to ``depth`` slices dispatched ahead and retire the oldest
    (block on its event) only when the window is full, so the host work
    between dispatches (bookkeeping, progress, deferred checkpoint
    writes, trace and metrics recording) runs under the device work of
    the slices still in flight. Depth 1 is the synchronous loop. The
    window moves sync points, never the dispatched work or its order, so
    every depth gives the same film bit for bit.

    Deferred actions (``defer``) run once their cursor's slice has
    retired. A CUDA error at a retire is re-raised as
    ``ChunkDispatchError(poisons_state=True)``; on any ChunkDispatchError
    the caller calls ``flush`` before its ladder: a poisoning failure
    discards the window, a clean one quiesces it (waits for the
    survivors and runs the deferred writes)."""

    __slots__ = ("depth", "slices", "deferred", "on_wait", "span_name", "clock")

    def __init__(self, depth: int, on_wait=None, span_name: str = "", clock=None):
        self.depth = max(1, int(depth))
        #: [(chunk index, sync handle, trace span | None)]
        self.slices: list = []
        #: [(cursor, fn)]: fn() runs once chunk cursor-1 has retired
        self.deferred: list = []
        self.on_wait = on_wait  # dt -> None (device_wait attribution)
        self.span_name = span_name
        if clock is None:
            from tpu_pbrt_torch.utils.clock import WALL as clock  # noqa: N811
        self.clock = clock

    def __len__(self) -> int:
        return len(self.slices)

    def push(self, chunk: int, handle, span=None) -> None:
        """`span`: the async-span descriptor opened at dispatch ({"name",
        "id", "cat", optional "flow", "trace_id", "span_id"}), closed at
        the slice's retire or discard."""
        self.slices.append((chunk, handle, span))

    @staticmethod
    def _close_span(span, ok: bool) -> None:
        if not span:
            return
        from tpu_pbrt_torch.obs.trace import TRACE

        fid = span.get("flow")
        if fid:
            TRACE.flow_finish(span.get("flow_name", "slice_flow"), id=fid, ok=ok)
        TRACE.async_end(span["name"], id=span["id"], cat=span.get("cat", "slice"), ok=ok)

    def close_spans(self, ok: bool) -> None:
        """Close every in-flight slice's span without retiring it, for a
        caller that syncs the whole job another way (the service's park
        and finalize paths wait on the film, which every in-flight slice
        writes) and then drops the window. The handles stay; a later
        flush or drain finds the spans already closed."""
        for i, (chunk, handle, span) in enumerate(self.slices):
            self._close_span(span, ok)
            self.slices[i] = (chunk, handle, None)

    def defer(self, cursor: int, fn) -> None:
        self.deferred.append((cursor, fn))

    def full(self) -> bool:
        return len(self.slices) >= self.depth

    def retire_one(self) -> int:
        """Block on the oldest slice (the device_wait phase), then run every
        deferred action whose cursor has retired. Returns its chunk."""
        chunk, handle, span = self.slices.pop(0)
        from tpu_pbrt_torch.obs.trace import TRACE

        targs = {k: span[k] for k in ("trace_id", "span_id") if span and k in span}
        t0 = self.clock.monotonic()
        ok = False
        try:
            if self.span_name:
                with TRACE.span(self.span_name, chunk=chunk, **targs):
                    _block(handle)
            else:
                _block(handle)
            ok = True
        except DEVICE_ERRORS as e:
            raise ChunkDispatchError(f"in-flight slice {chunk} failed: {e}",
                                     poisons_state=True) from e
        finally:
            if self.on_wait is not None:
                self.on_wait(self.clock.monotonic() - t0)
            self._close_span(span, ok)
        while self.deferred and self.deferred[0][0] <= chunk + 1:
            self.deferred.pop(0)[1]()
        return chunk

    def drain(self) -> None:
        """Retire everything in flight and run every deferred action."""
        while self.slices:
            self.retire_one()
        while self.deferred:
            self.deferred.pop(0)[1]()

    def flush(self, discard: bool = False) -> None:
        """Error-path teardown: discard=True drops the slices (closing their
        spans) and the deferred actions without touching the device;
        discard=False drains, and a latent device failure surfaces here
        as a poisoning ChunkDispatchError with the window cleared."""
        if discard:
            for _, _, span in self.slices:
                self._close_span(span, ok=False)
            self.slices.clear()
            self.deferred.clear()
            return
        try:
            self.drain()
        finally:
            for _, _, span in self.slices:
                self._close_span(span, ok=False)
            self.slices.clear()
            self.deferred.clear()


@dataclass
class ChunkPlan:
    """The chunked decomposition of one render's work domain, on one
    device or over a mesh of ranks, and the dispatch of one chunk (the
    reference's ChunkPlan without the jit cache).

    ``dispatch(state, c)`` renders chunk ``c`` into the film accumulator
    ``state`` (in place) and returns its accounting: ``(rays, live lane
    waves, waves, truncated, counters)`` through the pool (over a mesh
    with the per-rank wave vector after them), ``(rays, nonfinite count
    or None)`` through the fixed batch. Over a mesh each rank renders
    ``per_dev`` items of the chunk (rank i from ``c * chunk + i *
    per_dev``) into a fresh film, and one sum all-reduce merges the
    contributions and the accounting, so every rank returns the chunk's
    totals and holds the same film. The (film state, chunk cursor, rays,
    counters) a caller carries between dispatches is exactly the
    checkpoint's payload."""

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
    #: the in-flight window depth the render loop runs this plan at
    #: (parallel/mesh.py resolve_pipeline_depth)
    pipeline_depth: int = 1
    #: a chaos nan:wave plan is installed: each pool dispatch asks the
    #: registry which wave (if any) to contaminate
    chaos_nan: bool = False
    integrator: Any = field(repr=False, default=None)
    #: the process-group mesh (parallel/mesh.py Mesh), None on one device
    mesh: Any = None
    #: ranks, and work items per rank per chunk (chunk // n_dev)
    n_dev: int = 1
    per_dev: int = 0
    _dispatch: Callable = field(repr=False, default=None)

    def start(self, c: int, rank: int = 0):
        """Rank `rank`'s first work item of chunk c as (pixel, sample):
        int32-safe."""
        return divmod(c * self.chunk + rank * self.per_dev, self.spp)

    def dispatch(self, state, c: int):
        return self._dispatch(state, c)

    def aux_parts(self, aux):
        """Split a dispatch's aux into (nrays, occ, ctr, spread, nf): occ =
        (live, waves, truncated) on the pool, ctr the wave counters (None
        with telemetry killed), spread the per-rank wave vector (None on
        one device), nf the fixed batch's firewall scrub count."""
        if self.use_regen:
            return aux[0], tuple(aux[1:4]), aux[4], (aux[5] if len(aux) > 5 else None), None
        return aux[0], None, None, None, aux[1]

    @property
    def is_writer(self) -> bool:
        """Whether this process writes checkpoints and images: the one
        device, or rank 0 of a mesh."""
        return self.mesh is None or self.mesh.rank == 0

    def capacity_audit(self):
        """Pre-render stream-capacity audit (on by default: an overflow
        must fail in seconds, not after the render): trace one chunk of
        camera rays (pixel centres, lens centre) through the stream
        tracer's stats variant and raise if any traversal pair was
        dropped to capacity. The camera wave bounds the live worklist of
        every later wave. TORCH_PBRT_AUDIT_DROPS=0 opts out,
        TORCH_PBRT_ALLOW_DROPS=1 downgrades the raise to a warning; the
        drop count is memoized per (scene, chunk)."""
        dev = self.scene.dev
        if not cfg.audit_drops or "tstream" not in dev:
            return
        integ = self.integrator
        memo = getattr(integ, "_audit_memo", None)
        if memo is None:
            memo = integ._audit_memo = {}
        # keyed by identity; the value keeps the scene alive so the id
        # cannot be recycled under the memo
        memo_key = (id(self.scene), self.per_dev or self.chunk)
        if memo_key in memo:
            drops = memo[memo_key][1]
        else:
            from tpu_pbrt_torch.accel.stream import stream_traverse_stats
            from tpu_pbrt_torch.cameras import generate_rays
            from tpu_pbrt_torch.obs.trace import TRACE

            x0, x1, y0, _ = self.bounds
            w = x1 - x0
            with TRACE.span("render/capacity_audit"):
                k = torch.arange(min(self.per_dev or self.chunk, self.total), dtype=torch.int32,
                                 device=self.scene.device)
                pix = torch.div(k, self.spp, rounding_mode="floor")
                p_film0 = torch.stack(
                    [(x0 + pix % w).to(torch.float32) + 0.5,
                     (y0 + torch.div(pix, w, rounding_mode="floor")).to(torch.float32) + 0.5],
                    dim=-1)
                o0, d0, _ = generate_rays(self.scene.camera, p_film0, torch.zeros_like(p_film0))
                drops = stream_traverse_stats(dev["tstream"], o0, d0, float("inf"))[2]
            memo[memo_key] = (self.scene, drops)
        if drops > 0:
            msg = (f"stream tracer dropped {drops} traversal pairs to capacity on the "
                   "camera wave; the render may have false misses: lower "
                   "TORCH_PBRT_CHUNK or raise TORCH_PBRT_HEADROOM")
            if cfg.allow_drops:
                from tpu_pbrt_torch.utils.error import Warning as _W

                _W(msg)
            else:
                raise RuntimeError(msg)


def _merge_film_(state, contrib) -> None:
    """core/film.py::merge_film into the film accumulator, in place (the
    render loop writes its film in place)."""
    for acc, add in zip(state, contrib):
        acc.add_(add)


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

    #: the time source of the recovery ladder's backoff (utils/clock.py):
    #: WALL sleeps; a VirtualClock turns the backoff into a virtual-time
    #: advance (tests)
    clock = WALL

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

    def prepare_chunks(self, scene=None, mesh=None, chunk: Optional[int] = None) -> ChunkPlan:
        """The chunk decomposition of the work domain (pixel-major, spp
        consecutive samples per pixel) and its dispatch, on one device or
        over `mesh` (parallel/mesh.py; the options' mesh_shape resolves
        one when none is given). The chunk is, in order: the `chunk`
        argument, the options' spp_chunk, the TORCH_PBRT_CHUNK knob, or
        the device default times the ranks, rounded to a multiple of the
        ranks; each rank renders chunk / ranks items of it, and its pool
        holds a quarter of those, at least min(them, 4096) slots, unless
        TORCH_PBRT_POOL sets it."""
        from tpu_pbrt_torch.chaos import CHAOS
        from tpu_pbrt_torch.parallel.checkpoint import render_fingerprint
        from tpu_pbrt_torch.parallel.mesh import resolve_pipeline_depth

        scene = scene or self.scene
        if mesh is None and getattr(self.options, "mesh_shape", None):
            from tpu_pbrt_torch.parallel.mesh import resolve_mesh

            mesh = resolve_mesh(self.options.mesh_shape, device=scene.device)
        if mesh is not None and mesh.size < 2:
            mesh = None
        if mesh is not None and torch.device(mesh.device) != scene.device:
            raise ValueError(f"rank {mesh.rank} renders on {mesh.device}, but its scene "
                             f"was compiled on {scene.device}")
        n_dev = 1 if mesh is None else mesh.size
        film, cam = scene.film, scene.camera
        x0, x1, y0, y1 = film.sample_bounds()
        w = x1 - x0
        npix = w * (y1 - y0)
        spp = scene.sampler.spp
        total = npix * spp
        if chunk is None:
            chunk = int(getattr(self.options, "spp_chunk", 0) or 0) or None
        if chunk is None:
            # the device default is a rank's share: a pool's cost is per
            # wave, so a rank given a fraction of it would drain its slice
            # in as many waves as the whole chunk takes on one device
            default = device_chunk(scene) * n_dev
            chunk = int(cfg.chunk if cfg.chunk is not None else default)
        chunk = max(min(int(chunk), max(1024 * n_dev, total)), 1)
        chunk = max((chunk // n_dev) * n_dev, n_dev)
        per_dev = chunk // n_dev
        use_regen = self._regen_enabled()
        pool = 0
        if use_regen:
            pool = int(cfg.pool)
            if pool <= 0:
                pool = max(per_dev // 4, min(per_dev, 4096))
            pool = min(pool, per_dev)
        plan = ChunkPlan(
            scene=scene, film=film, chunk=chunk,
            n_chunks=(total + chunk - 1) // chunk, spp=spp, total=total, npix=npix,
            bounds=(x0, x1, y0, y1), pool=pool, use_regen=use_regen,
            fingerprint=render_fingerprint(chunk=chunk, spp=spp, total=total, scene=scene),
            tracer="fused" if scene.device.type == "cuda" else "plain",
            pipeline_depth=resolve_pipeline_depth(mesh),
            # a nan:wave plan contaminates one rank's drain; the reference
            # runs it on one device only
            chaos_nan=CHAOS.has_nan() and use_regen and mesh is None,
            integrator=self, mesh=mesh, n_dev=n_dev, per_dev=per_dev,
        )
        rank = 0 if mesh is None else mesh.rank
        if use_regen:

            def drain(fs, c):
                start_pix, start_s = plan.start(c, rank)
                kw = {"nan_wave": CHAOS.nan_wave_for(c)} if plan.chaos_nan else {}
                _, nrays, live, waves, trunc, ctr = self.pool_chunk(
                    scene.dev, fs, start_pix, start_s, per_dev, pool, film=film, cam=cam, **kw)
                return nrays, live, waves, trunc, ctr

            if mesh is None:
                dispatch = drain
            else:
                from tpu_pbrt_torch.obs.counters import WaveCounters
                from tpu_pbrt_torch.parallel.mesh import device_spread, sharded_pool_renderer

                def per_device_drain(c):
                    # this rank drains ITS slice with its own pool, into a
                    # fresh film; the wave count rides the aux all-reduce
                    # as a one-hot vector (the per-rank wave spread)
                    contrib = film.init_state(scene.device)
                    nrays, live, waves, trunc, ctr = drain(contrib, c)
                    i64 = dict(dtype=torch.int64, device=scene.device)
                    aux = (torch.as_tensor(nrays, **i64).reshape(()),
                           torch.as_tensor(live, **i64).reshape(()),
                           torch.tensor(waves, **i64), torch.tensor(trunc, **i64),
                           *(() if ctr is None else tuple(ctr)), device_spread(waves, mesh))
                    return contrib, aux

                step = sharded_pool_renderer(mesh, per_device_drain)

                def dispatch(state, c):
                    contrib, aux = step(c)
                    _merge_film_(state, contrib)
                    ctr = None if len(aux) == 5 else WaveCounters(*aux[4:-1])
                    return aux[0], aux[1], int(aux[2]), int(aux[3]), ctr, aux[-1]

        else:
            # pixel-major chunks that tile the frame exactly take the
            # film's scatter-free aligned deposit (on one device)
            aligned = mesh is None and film.aligned_chunk_pixels(chunk, spp) > 0
            box_fast = film.pixel_deposit_ok()
            k = torch.arange(per_dev, dtype=torch.int32, device=scene.device)

            def body(fs, c):
                start_pix, start_s = plan.start(c, rank)
                valid, px, py, s, p_film, o, d, wt = self.work_to_rays(
                    cam, spp, x0, y0, w, npix, start_pix, start_s, k)
                out = self.li(scene.dev, o, d, px, py, s)
                L, nrays = out[:2]
                nrays = torch.where(valid, nrays, torch.zeros_like(nrays)).sum()
                nf = _fixed_batch_nonfinite(valid, L)
                if aligned:
                    film.add_samples_aligned(fs, start_pix, spp, L, wt)
                elif box_fast:
                    film.add_samples_pixel(fs, px, py, L, valid, wt)
                else:
                    p_film = torch.where(valid[..., None], p_film, torch.full_like(p_film, -1e6))
                    film.add_samples(fs, p_film, L, wt)
                if len(out) == 4:
                    # a splatting integrator (BDPT's t=1 strategies):
                    # (L, nrays, splat_xy (R,K,2), splat_val (R,K,3))
                    sxy, sval = out[2:]
                    sval = torch.where(valid[..., None, None], sval, torch.zeros_like(sval))
                    film.add_splats(fs, sxy.reshape(-1, 2), sval.reshape(-1, 3))
                return nrays, nf

            if mesh is None:
                dispatch = body
            else:
                from tpu_pbrt_torch.parallel.mesh import sharded_chunk_renderer

                def per_device_fn(c):
                    # this rank's slice into a fresh film; BDPT's splats
                    # ride the same all-reduce
                    contrib = film.init_state(scene.device)
                    nrays, nf = body(contrib, c)
                    return contrib, (nrays.to(torch.int64), nf)

                step = sharded_chunk_renderer(mesh, per_device_fn)

                def dispatch(state, c):
                    contrib, (nrays, nf) = step(c)
                    _merge_film_(state, contrib)
                    return nrays, nf

        plan._dispatch = dispatch
        return plan

    def render(self, scene=None, mesh=None, checkpoint_path=None, checkpoint_every: int = 0,
               max_seconds: float = 0.0, chunk: Optional[int] = None) -> RenderResult:
        """SamplerIntegrator::Render: every chunk through the pool (or the
        fixed batch), deposited into the film, through the reference's
        render loop, on one device or over `mesh` (every rank of the
        process group calls render with its Mesh; each renders its slice
        of every chunk, one all-reduce per chunk merges the film, and
        rank 0 alone writes checkpoints and the image).

        - The dispatch window keeps TORCH_PBRT_PIPELINE chunk-slices in
          flight (DispatchWindow), and a cadence checkpoint that falls
          while slices are in flight is written from a host snapshot
          taken at enqueue time (parallel/checkpoint.begin_host_copy),
          once its slice has retired.
        - The recovery ladder: a failed dispatch (ChunkDispatchError: a
          chaos fault, a CUDA runtime error, the retry firewall) is
          re-dispatched after a backoff on `self.clock`; one that poisons
          the film rolls back to the checkpoint, or restarts the render
          without one. Past TORCH_PBRT_RETRY_MAX attempts or the retry
          deadline it writes an emergency checkpoint (unless the
          failure poisoned the film) and raises.
        - The film firewall: scrub (count NaN/Inf deposits), raise
          (NonFiniteRadianceError), retry (re-render the chunk).
        - Reporting: STATS, the progress bar, FLIGHT heartbeats, TRACE
          spans, the METRICS phase histogram; stats["recovery"] when a
          failure was survived and stats["phase_seconds"].

        Checkpoint/resume: a checkpoint is the film state plus the chunk
        cursor, so a resumed render is bit-identical to an uninterrupted
        one (of the same mesh width: every rank reads the file rank 0
        wrote, after a barrier). It is read from and written to `checkpoint_path` (default:
        the options' checkpoint_path) every `checkpoint_every` chunks and
        at the end. max_seconds > 0 stops at a chunk boundary past the
        budget and returns a partial render with completed_fraction < 1.
        Writes the image when the film names a file. The wall time ends
        in a device synchronize."""
        from tpu_pbrt_torch.accel import stream
        from tpu_pbrt_torch.chaos import CHAOS
        from tpu_pbrt_torch.obs import counters as obs_counters
        from tpu_pbrt_torch.obs.flight import FLIGHT
        from tpu_pbrt_torch.obs.metrics import METRICS, phase_histogram
        from tpu_pbrt_torch.obs.trace import TRACE
        from tpu_pbrt_torch.parallel.checkpoint import (
            begin_host_copy,
            checkpoint_exists,
            load_checkpoint,
            save_checkpoint,
        )
        from tpu_pbrt_torch.utils.error import Warning as _W
        from tpu_pbrt_torch.utils.stats import STATS, ProgressReporter

        plan = self.prepare_chunks(scene, mesh, chunk)
        scene, film, device = plan.scene, plan.film, plan.scene.device
        mesh, writer = plan.mesh, plan.is_writer
        if mesh is not None:
            mesh.take_log()
        n_chunks, spp, total = plan.n_chunks, plan.spp, plan.total
        use_regen, fp = plan.use_regen, plan.fingerprint
        cuda = device.type == "cuda"
        ckpt_path = checkpoint_path or getattr(self.options, "checkpoint_path", None)
        checkpoint_every = checkpoint_every or getattr(self.options, "checkpoint_every", 0)
        first_chunk, prev_rays, prev_ctr = 0, 0, {}
        if ckpt_path and checkpoint_exists(ckpt_path):
            state, first_chunk, prev_rays, prev_ctr = load_checkpoint(
                ckpt_path, fp, device=device)
        else:
            state = film.init_state(device)

        # per-phase wall-time attribution into the METRICS phase
        # histogram (labels: phase, tracer); nothing with TORCH_PBRT_METRICS=0
        metrics_on = METRICS.enabled
        phase_s: Dict[str, float] = {}

        def _phase(name: str, dt: float) -> None:
            if not metrics_on:
                return
            phase_s[name] = phase_s.get(name, 0.0) + dt
            phase_histogram().observe(dt, phase=name, tracer=plan.tracer)

        plan.capacity_audit()

        quiet = bool(getattr(self.options, "quiet", False))
        progress = ProgressReporter(n_chunks, "Rendering", quiet=quiet)
        ray_counts, occ_counts, ctr_counts, nf_counts, spread_counts = [], [], [], [], []
        recovery = {"redispatches": 0, "rollbacks": 0, "restarts": 0,
                    "nonfinite_retries": 0, "backoff_ms": 0}
        # the retry extras a resume brought in from earlier processes: a
        # rollback reloads a snapshot this loop wrote, whose counters
        # already hold part of `recovery`, so only the unbaked rest is added
        prior_rec = {k: int(prev_ctr.get(k, 0))
                     for k in ("chunks_redispatched", "retry_backoff_ms")}

        def ctr_snapshot(n_ctr=None, n_nf=None, rec=None) -> Dict[str, Any]:
            """Cumulative host counters: the resumed snapshot, every chunk so
            far (or the list prefixes a deferred checkpoint captured), the
            fixed batch's scrub counts and the retry accounting."""
            snap = obs_counters.merge_host(prev_ctr, obs_counters.to_host(ctr_counts[:n_ctr]))
            nf = nf_counts[:n_nf]
            if nf:
                snap = obs_counters.merge_host(
                    snap, {"nonfinite_deposits": int(torch.stack(nf).sum())})
            rec = recovery if rec is None else rec
            extra = {}
            for key, cur in (("chunks_redispatched", rec["redispatches"]),
                             ("retry_backoff_ms", rec["backoff_ms"])):
                baked = max(0, int(snap.get(key, 0)) - prior_rec[key])
                if cur > baked:
                    extra[key] = cur - baked
            return obs_counters.merge_host(snap, extra)

        def rays_of(n_ray=None) -> int:
            r = ray_counts[:n_ray]
            return prev_rays + (int(torch.stack(r).sum()) if r else 0)

        chunks_done = first_chunk
        FLIGHT.heartbeat("render", chunks=n_chunks, resumed_at=first_chunk, spp=spp)
        hb_every = max(1, n_chunks // 16)
        retry_max = int(cfg.retry_max)
        retry_deadline = float(cfg.retry_deadline)
        firewall_mode = cfg.nonfinite  # scrub | raise | retry
        if firewall_mode != "scrub" and not obs_counters.enabled():
            # the strict modes read the scrub count the telemetry carries;
            # without it they would silently degrade to scrub
            raise ValueError(
                f"TORCH_PBRT_NONFINITE={firewall_mode} needs the telemetry counters (the "
                "firewall's scrub count), but TORCH_PBRT_TELEMETRY=0 disabled them; "
                "re-enable telemetry or use the default scrub mode")

        def chunk_nonfinite(aux):
            """The chunk's firewall scrub count (device scalar), or None."""
            if use_regen:
                return None if aux[4] is None else aux[4].nonfinite
            return aux[1]

        depth = plan.pipeline_depth
        window = DispatchWindow(depth, on_wait=lambda dt: _phase("device_wait", dt),
                                span_name="render/chunk_retire")
        rloop_tid = TRACE.trace_id("render")

        def _write_checkpoint(st, cursor, n_ray, n_ctr, n_nf, rec=None):
            """One cadence write: chunks [0, cursor) of `st`, the counters
            restricted to the captured list prefixes."""
            if not writer:
                return
            t_ph = time.perf_counter()
            with TRACE.span("render/checkpoint", chunk=cursor):
                save_checkpoint(ckpt_path, st, cursor, rays_of(n_ray), fingerprint=fp,
                                counters=ctr_snapshot(n_ctr, n_nf, rec))
            _phase("checkpoint", time.perf_counter() - t_ph)

        def _queue_checkpoint(cursor):
            """Cadence checkpoint at `cursor`: written at once with an empty
            window; with slices in flight, the film (written in place by
            the next dispatches) is copied to the host now, ordered after
            this chunk on the device, and written once the slice retires."""
            lens = (len(ray_counts), len(ctr_counts), len(nf_counts))
            if not writer:
                return
            if not len(window):
                _write_checkpoint(state, cursor, *lens)
                return
            snap = begin_host_copy(state)
            rec = dict(recovery)
            window.defer(cursor, lambda: _write_checkpoint(snap.wait(), cursor, *lens, rec=rec))

        def _reset_lists():
            ray_counts.clear()
            occ_counts.clear()
            ctr_counts.clear()
            nf_counts.clear()
            spread_counts.clear()

        prev_det = torch.are_deterministic_algorithms_enabled()
        prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
        if cuda:
            # the film's scatter-adds accumulate in a fixed order
            torch.use_deterministic_algorithms(True, warn_only=True)
        stream.WAVES.reset()
        WALKS.reset()
        c = first_chunk
        attempt = 0
        retry_t0 = None  # wall clock of the current failure streak
        timed_out = False
        try:
            if cuda:
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            with STATS.phase("Integrator/Render loop"):
                while c < n_chunks or len(window):
                    try:
                        if c < n_chunks:
                            # the failure seam: chaos faults fire here; a
                            # chunk is a pure function of its work range,
                            # so a re-dispatch is exact
                            try:
                                CHAOS.dispatch(c, attempt, mesh=mesh is not None)
                            except ChunkDispatchError as e:
                                if mesh is None:
                                    raise
                                # the other ranks may be in this chunk's
                                # step: agree on its outcome with them
                                from tpu_pbrt_torch.parallel.mesh import join_failure

                                raise join_failure(mesh, e) from e
                            if c == first_chunk:
                                ph_name, span = "dispatch_compile", "render/chunk_dispatch+compile"
                            elif len(window):
                                ph_name, span = "dispatch_ahead", "render/chunk_dispatch_ahead"
                            else:
                                ph_name, span = "dispatch", "render/chunk_dispatch"
                            t_ph = time.perf_counter()
                            try:
                                with TRACE.span(span, chunk=c, tracer=plan.tracer):
                                    aux = plan.dispatch(state, c)
                                    handle = None
                                    if cuda:
                                        handle = torch.cuda.Event()
                                        handle.record()
                            except DEVICE_ERRORS as e:
                                # a CUDA runtime error part-way: the film,
                                # written in place, cannot be trusted
                                raise ChunkDispatchError(f"device dispatch failed: {e}",
                                                         poisons_state=True) from e
                            _phase(ph_name, time.perf_counter() - t_ph)
                            if firewall_mode != "scrub":
                                # strict firewall: this chunk's scrub count
                                # (one device read per chunk; the window runs
                                # at depth 1 in these modes)
                                nf_dev = chunk_nonfinite(aux)
                                nf_ct = 0 if nf_dev is None else int(nf_dev)
                                if nf_ct:
                                    if firewall_mode == "raise":
                                        raise NonFiniteRadianceError(
                                            f"chunk {c} deposited {nf_ct} non-finite radiance "
                                            "sample(s) (scrubbed to zero); "
                                            "TORCH_PBRT_NONFINITE=raise treats this as fatal")
                                    recovery["nonfinite_retries"] += 1
                                    raise NonFiniteWaveError(
                                        f"non-finite firewall: chunk {c} scrubbed {nf_ct} "
                                        "deposit(s)")
                            attempt = 0
                            retry_t0 = None
                            c += 1
                            nrays, occ, ctr, spread, nf_dep = plan.aux_parts(aux)
                            if use_regen:
                                occ_counts.append(occ)
                                if ctr is not None:
                                    ctr_counts.append(ctr)
                                if spread is not None:
                                    spread_counts.append(spread)
                            elif nf_dep is not None:
                                nf_counts.append(nf_dep)
                            ray_counts.append(nrays)
                            progress.update()
                            chunks_done = c
                            if c == first_chunk + 1 or c % hb_every == 0:
                                FLIGHT.heartbeat("render", chunk=c, of=n_chunks,
                                                 render_s=round(time.perf_counter() - t0, 3))
                            if ckpt_path and checkpoint_every and c % checkpoint_every == 0:
                                _queue_checkpoint(c)
                            sid = f"{rloop_tid}/c{c - 1}"
                            TRACE.async_begin("render/slice", id=sid, cat="slice", chunk=c - 1,
                                              trace_id=rloop_tid, span_id=sid)
                            TRACE.flow_start("slice_flow", id=sid)
                            window.push(c - 1, handle, span={
                                "name": "render/slice", "id": sid, "cat": "slice", "flow": sid,
                                "trace_id": rloop_tid, "span_id": sid})
                        # retire the oldest slice(s) when the window is full,
                        # and all of them once the work is dispatched
                        while len(window) and (window.full() or c >= n_chunks):
                            window.retire_one()
                        if max_seconds > 0:
                            # drain early when the remaining budget cannot
                            # absorb the window, so the overshoot stays
                            # about one chunk
                            elapsed = time.perf_counter() - t0
                            rate = elapsed / max(len(ray_counts) - len(window), 1)
                            if max_seconds - elapsed < (depth + 2) * rate:
                                window.drain()
                            timed_out = time.perf_counter() - t0 > max_seconds
                            if mesh is not None:
                                # the ranks stop at the same chunk: rank 0's clock decides
                                flag = torch.tensor([int(timed_out)], device=device)
                                mesh.broadcast_(flag)
                                timed_out = bool(flag.item())
                    except ChunkDispatchError as e:
                        # flush the window before the ladder: a poisoning
                        # failure discards it, a clean one quiesces it so
                        # the deferred writes land
                        try:
                            window.flush(discard=e.poisons_state)
                        except ChunkDispatchError as e2:
                            e = e2
                            window.flush(discard=True)
                        attempt += 1
                        recovery["redispatches"] += 1
                        STATS.counter("Distribution/Chunks re-dispatched", 1)
                        now = time.time()
                        if retry_t0 is None:
                            retry_t0 = now
                        deadline_hit = retry_deadline > 0 and now - retry_t0 > retry_deadline
                        if attempt > retry_max or deadline_hit:
                            # unrecoverable: an emergency checkpoint keeps the
                            # completed work, unless this failure poisoned
                            # the film (then the last durable file holds all
                            # that can be trusted)
                            if ckpt_path and not e.poisons_state and writer:
                                save_checkpoint(ckpt_path, state, c, rays_of(), fingerprint=fp,
                                                counters=ctr_snapshot())
                                FLIGHT.heartbeat("render_emergency_checkpoint", chunk=c,
                                                 attempt=attempt)
                            reason = (f"retry deadline ({retry_deadline:.0f}s) exceeded"
                                      if deadline_hit else f"failed {attempt} times")
                            raise RuntimeError(f"chunk {c} {reason}") from e
                        if mesh is not None:
                            # the ranks agreed on this chunk's failure
                            # (parallel/mesh.py agree), so every rank is
                            # here; rank 0's deferred writes have landed
                            # once all ranks pass
                            mesh.barrier()
                        if e.poisons_state and ckpt_path and checkpoint_exists(ckpt_path):
                            state, c, prev_rays, prev_ctr = load_checkpoint(ckpt_path, fp,
                                                                            device=device)
                            recovery["rollbacks"] += 1
                            _reset_lists()
                        elif e.poisons_state:
                            # nothing durable to roll back to: restart
                            state = film.init_state(device)
                            c, prev_rays, prev_ctr = 0, 0, {}
                            prior_rec = {k: 0 for k in prior_rec}
                            recovery["restarts"] += 1
                            _reset_lists()
                        backoff_s = redispatch_backoff(c, attempt)
                        recovery["backoff_ms"] += int(backoff_s * 1000)
                        FLIGHT.heartbeat("render_redispatch", chunk=c, attempt=attempt,
                                         poisoned=e.poisons_state, backoff_s=round(backoff_s, 3),
                                         backoff_total_ms=recovery["backoff_ms"],
                                         error=str(e)[:200])
                        if backoff_s > 0:
                            TRACE.complete("render/backoff", backoff_s * 1e6, chunk=c,
                                           attempt=attempt, trace_id=rloop_tid)
                            self.clock.sleep(backoff_s)
                        continue
                    except BaseException:
                        # an error that ends the render (a kernel that does
                        # not build, an interrupt): let the in-flight slices
                        # finish and their deferred checkpoints land first
                        try:
                            window.flush()
                        except Exception:  # noqa: BLE001 - the first error wins
                            pass
                        raise
                    if timed_out:
                        break
                t_ph = time.perf_counter()
                with TRACE.span("render/wave_drain+film_merge"):
                    if cuda:
                        torch.cuda.synchronize(device)
                _phase("device_wait", time.perf_counter() - t_ph)
            secs = time.perf_counter() - t0
        finally:
            torch.use_deterministic_algorithms(prev_det, warn_only=prev_warn)
        progress.done()
        completed_fraction = chunks_done / max(n_chunks, 1)
        rays = rays_of()
        STATS.counter("Integrator/Rays traced", rays)
        STATS.counter("Integrator/Camera rays traced", total)
        STATS.distribution("Integrator/Rays per camera ray", rays / max(total, 1))
        ctr_total = ctr_snapshot()
        if obs_counters.enabled() and ctr_total:
            FLIGHT.counters(ctr_total, phase="render_done")
        else:
            FLIGHT.heartbeat("render_done", rays=rays, seconds=round(secs, 3))
        if ckpt_path and writer:
            t_ph = time.perf_counter()
            save_checkpoint(ckpt_path, state, chunks_done, rays, fingerprint=fp,
                            counters=ctr_total)
            _phase("checkpoint", time.perf_counter() - t_ph)
        if ckpt_path and mesh is not None:
            mesh.barrier()  # no rank reads the file before rank 0 has written it
        # pbrt film.cpp splatScale: splats divide by the samples taken
        splat_scale = 1.0 / max(spp * completed_fraction, 1e-9)
        t_ph = time.perf_counter()
        with TRACE.span("render/develop"):
            img = film.develop(state, splat_scale=splat_scale)
        FLIGHT.heartbeat("develop")
        if film.filename and writer:
            with TRACE.span("render/write_image"):
                try:
                    film.write_image(state, splat_scale=splat_scale)
                except OSError as e:
                    _W(f"could not write image {film.filename}: {e}")
        _phase("deposit_develop", time.perf_counter() - t_ph)

        waves = stream.WAVES
        per_wave = max(waves.waves, 1)
        stats: Dict[str, Any] = {
            "chunks": n_chunks,
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
            "pipeline_depth": depth,
        }
        if "tstream" in scene.dev:
            stats["tracer_mode"] = plan.tracer
        walker = walker_kind(scene.dev)
        if walker is not None:
            # the walker's waves, masked steps and the host reads of its
            # loop tests
            stats["walker"] = dict(WALKS.stats(), kind=walker)
        if any(recovery.values()):
            stats["recovery"] = dict(recovery)
        wave_counts = []
        if use_regen and occ_counts:
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
            STATS.distribution("Integrator/Wave occupancy", stats["mean_wave_occupancy"])
        if obs_counters.enabled() and ctr_total:
            if spread_counts:
                per_rank = torch.stack(spread_counts).sum(dim=0).tolist()
            else:
                per_rank = [sum(wave_counts)] if wave_counts else []
            stats["telemetry"] = {
                "counters": ctr_total,
                "wave_spread": obs_counters.spread_stats(per_rank),
            }
        if mesh is not None:
            spent = mesh.take_log()
            stats["mesh"] = {
                "ranks": mesh.size, "rank": mesh.rank, "backend": mesh.backend,
                "layout": mesh.layout, "chunk_per_rank": plan.per_dev,
                # per dispatched chunk: the film + accounting all-reduce,
                # host staging included, and the wait for the slowest rank
                # before it
                "allreduce_ms": [round(1e3 * t, 4) for t in spent.get("all_reduce", [])],
                "wait_ms": [round(1e3 * t, 4) for t in spent.get("wait", [])],
            }
        if metrics_on and phase_s:
            stats["phase_seconds"] = {k: round(v, 6) for k, v in sorted(phase_s.items())}
        TRACE.maybe_export()
        return RenderResult(
            image=img, film_state=state, seconds=secs, rays_traced=rays,
            mray_per_sec=rays / max(secs, 1e-9) / 1e6, spp=spp,
            completed_fraction=completed_fraction, stats=stats,
        )
