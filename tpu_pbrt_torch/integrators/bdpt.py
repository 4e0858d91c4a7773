"""BDPTIntegrator — bidirectional path tracing (port of tpu_pbrt/integrators/bdpt.py).

pbrt-v3 BDPTIntegrator as a fixed-batch wavefront, in the reference's
order: a camera subpath and a light subpath per work item (pbrt's Vertex
arrays as (R, N) SoA slots, one closest-hit wave per depth slot), every
(s, t) connection strategy with s + t - 2 <= maxdepth, the pdf-ratio MIS
walk with the junction overrides (MISWeight's a1..a4), the t=1
light-tracing strategies splatted through the pinhole camera
(Film::AddSplat) and the s=1 light-resampling strategy. Every strategy's
visibility ray goes into ONE any-hit wave of R x K rays with a finite
per-ray t_max (K = 20 at maxdepth 5), traced once at the end.

Scope, as in the reference (warned at construction):
- light subpaths start from every light type but INFINITE: an escaped
  camera ray picks up the environment with MIS weight 1, which is
  unbiased because no other strategy samples it (s=1 masks it out);
  DISTANT lights start subpaths with pbrt's planar-beam densities;
- with a lens camera the t=1 strategies are skipped;
- null-interface materials are traversed as opaque surfaces.

The reference traces every depth slot whatever its lanes; the port stops
a subpath's walk once none of its lanes is alive (one host read per
slot): the slots left out stay empty, as they would have.
"""

from __future__ import annotations

import torch

from tpu_pbrt_torch.accel import stream
from tpu_pbrt_torch.cameras import camera_pdf_we, camera_sample_wi, camera_world_frame
from tpu_pbrt_torch.core import bxdf
from tpu_pbrt_torch.core import lights_dev as ld
from tpu_pbrt_torch.core.sampling import uniform_float
from tpu_pbrt_torch.core.vecmath import (
    coordinate_system,
    dot,
    normalize,
    offset_ray_origin,
    to_local,
    to_world,
)
from tpu_pbrt_torch.integrators.common import (
    DIMS_PER_BOUNCE,
    WavefrontIntegrator,
    make_interaction,
    scene_intersect,
    scene_intersect_p,
)
from tpu_pbrt_torch.utils.error import Warning

# sampler-dimension salt bases of the three BDPT sample streams
_SALT_CAM = 0
_SALT_LIGHT = 3001
_SALT_CONNECT = 6001


def _where(mask, a, b):
    """torch.where with a (R,) mask over (R, ...) values."""
    while mask.dim() < max(torch.as_tensor(a).dim(), torch.as_tensor(b).dim()):
        mask = mask[..., None]
    return torch.where(mask, a, b)


def _remap0(x):
    """MISWeight's remap0: a pdf of 0 (a delta or unsampleable vertex)
    counts as 1, so it cancels out of the ratio product."""
    return torch.where(x == 0.0, torch.ones_like(x), x)


def _convert_density(pdf_sa, p_from, p_to, n_to, to_is_surface: bool):
    """A solid-angle pdf at p_from -> the area pdf at p_to (ConvertDensity):
    pdf * |cos(n_to, w)| / dist^2; a camera or point endpoint
    (to_is_surface False) drops the cosine."""
    d = p_to - p_from
    d2 = torch.clamp(dot(d, d), min=1e-20)
    w = d / torch.sqrt(d2)[..., None]
    cos_t = torch.abs(dot(n_to, w)) if to_is_surface else 1.0
    return pdf_sa * cos_t / d2


def _correction(wo, wi, ns, ng):
    """pbrt's CorrectShadingNormal factor of importance transport."""
    num = torch.abs(dot(wo, ns)) * torch.abs(dot(wi, ng))
    den = torch.clamp(torch.abs(dot(wo, ng)) * torch.abs(dot(wi, ns)), min=1e-9)
    return num / den


class _Path:
    """SoA vertex storage of one subpath family: N slots per lane."""

    def __init__(self, R, N, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.p = torch.zeros((R, N, 3), **f32)
        self.ng = torch.zeros((R, N, 3), **f32)
        self.ns = torch.zeros((R, N, 3), **f32)
        self.beta = torch.zeros((R, N, 3), **f32)
        self.pdf_fwd = torch.zeros((R, N), **f32)
        self.pdf_rev = torch.zeros((R, N), **f32)
        self.mat = torch.full((R, N), -1, dtype=torch.int32, device=device)
        self.light = torch.full((R, N), -1, dtype=torch.int32, device=device)
        self.delta = torch.zeros((R, N), dtype=torch.bool, device=device)
        self.valid = torch.zeros((R, N), dtype=torch.bool, device=device)

    def set(self, i, **kw):
        for k, v in kw.items():
            getattr(self, k)[:, i] = v


class BDPTIntegrator(WavefrontIntegrator):
    name = "bdpt"
    rays_per_camera_ray = 4.0

    def __init__(self, params, scene, options):
        super().__init__(params, scene, options)
        self.max_depth = params.find_one_int("maxdepth", 5)
        #: restricts the render to a set of (s, t) strategies (tests)
        self._only = None
        if scene.has_null_materials:
            Warning("bdpt: null-interface materials are traversed as opaque")
        if isinstance(self.light_distr, ld.SpatialLightDistribution):
            # the MIS walk reads pick pmfs at several vertices; the
            # position-dependent strategy is not plumbed through it
            self.light_distr = scene.light_distr
        self._pinhole = float(scene.camera.lens_radius) == 0.0
        if not self._pinhole:
            Warning("bdpt: lens camera — t=1 (light tracing) strategies skipped")
        if bool((scene.dev["light"]["type"] == ld.LIGHT_INFINITE).any()):
            Warning("bdpt: infinite lights contribute via escaped camera rays and s=1 "
                    "resampling only (env-subpath MIS is future work); distant lights "
                    "source full subpaths")

    # ------------------------------------------------------------------
    def _walk(self, dev, path: _Path, o, d, beta, pdf_dir, alive, px, py, s, salt_base,
              n_steps, mode, origin_surface=None):
        """RandomWalk: extend `path`, writing slots [1, 1 + n_steps). o, d
        leave the slot-0 vertex and pdf_dir is d's solid-angle pdf there.
        mode "radiance" (the camera subpath) or "importance" (the light
        subpath, with the shading-normal correction). Returns (rays
        traced per lane, the environment radiance of escaped
        radiance-mode rays, at MIS weight 1)."""
        nrays = torch.zeros(alive.shape, dtype=torch.int32, device=o.device)
        l_env = torch.zeros(alive.shape + (3,), dtype=torch.float32, device=o.device)
        prev_p = path.p[:, 0]
        prev_ns = path.ns[:, 0]
        # area-light origins are surface points (the scatter-back density
        # keeps the cosine); camera and point origins are not
        prev_surf = (torch.zeros_like(alive) if origin_surface is None else origin_surface)
        inf = torch.full(alive.shape, float("inf"), dtype=torch.float32, device=o.device)
        for k in range(n_steps):
            if k:
                stream.WAVES.add_loop_read()
                if not bool(alive.any()):
                    break
            i = 1 + k
            salt = salt_base + k * DIMS_PER_BOUNCE
            hit = scene_intersect(dev, o, d, torch.where(alive, inf, -1.0))
            nrays = nrays + alive.to(torch.int32)
            it = make_interaction(dev, hit, o, d)
            found = alive & it.valid
            if mode == "radiance" and "envmap" in dev:
                miss = alive & (hit.prim < 0)
                l_env = l_env + _where(miss, beta * ld.env_lookup(dev, d), 0.0)
            pdf_area = _convert_density(pdf_dir, prev_p, it.p, it.ns, True)
            # mix materials resolve here (one draw per vertex) and the vertex
            # stores the resolved sub-material, so every later MIS and
            # connection evaluation shades the same leaf row; like the
            # reference, BDPT gathers that row without evaluating textures
            mid = bxdf.resolve_mix(dev["mat"], it.mat, uniform_float(px, py, s, salt + 11)
                                   if "mix_a" in dev["mat"] else None)
            path.set(
                i,
                p=_where(found, it.p, 0.0),
                ng=_where(found, it.ng, 0.0),
                ns=_where(found, it.ns, 0.0),
                beta=_where(found, beta, 0.0),
                pdf_fwd=_where(found, pdf_area, 0.0),
                mat=_where(found, mid, -1),
                light=_where(found, it.light, -1),
                valid=found,
            )
            if k == n_steps - 1:
                break  # the last slot never scatters
            mp = bxdf.gather_mat(dev["mat"], mid)
            wo_l = to_local(it.wo, it.ss, it.ts, it.ns)
            bs = bxdf.bsdf_sample(
                mp, wo_l,
                uniform_float(px, py, s, salt + 7),
                uniform_float(px, py, s, salt + 8),
                uniform_float(px, py, s, salt + 9),
            )
            wi_w = normalize(to_world(bs.wi, it.ss, it.ts, it.ns))
            cont = found & (bs.pdf > 0.0) & (bs.f.amax(dim=-1) > 0.0)
            if mode == "importance":
                corr = _correction(it.wo, wi_w, it.ns, it.ng)
            else:
                corr = torch.ones(alive.shape, dtype=torch.float32, device=o.device)
            throughput = bs.f * (torch.abs(dot(wi_w, it.ns))
                                 / torch.clamp(bs.pdf, min=1e-20))[..., None]
            beta = _where(cont, beta * throughput * corr[..., None], beta)
            # the reverse pdf of the PREVIOUS vertex (scattering backwards)
            _, pdf_rev_sa = bxdf.bsdf_eval(mp, to_local(wi_w, it.ss, it.ts, it.ns), wo_l)
            pdf_rev_sa = torch.where(bs.is_specular, 0.0, pdf_rev_sa)
            d_b = prev_p - it.p
            d2_b = torch.clamp(dot(d_b, d_b), min=1e-20)
            w_b = d_b / torch.sqrt(d2_b)[..., None]
            cos_b = torch.where(prev_surf, torch.abs(dot(prev_ns, w_b)), 1.0)
            pdf_rev_prev = pdf_rev_sa * cos_b / d2_b
            path.pdf_rev[:, i - 1] = torch.where(found, pdf_rev_prev, path.pdf_rev[:, i - 1])
            path.delta[:, i] = found & bs.is_specular
            prev_p = it.p
            prev_ns = it.ns
            prev_surf = torch.ones_like(alive)
            o = _where(cont, offset_ray_origin(it.p, it.ng, wi_w), o)
            d = _where(cont, wi_w, d)
            pdf_dir = torch.where(cont, torch.where(bs.is_specular, 0.0, bs.pdf), pdf_dir)
            alive = cont
        return nrays, l_env

    # ------------------------------------------------------------------
    def _vertex_bsdf(self, dev, path: _Path, i, wo_w, wi_w):
        """(f, solid-angle pdf) of the BSDF at surface vertex slot i."""
        mp = bxdf.gather_mat(dev["mat"], path.mat[:, i].clamp(min=0))
        ns = path.ns[:, i]
        ss, ts = coordinate_system(ns)
        return bxdf.bsdf_eval(mp, to_local(wo_w, ss, ts, ns), to_local(wi_w, ss, ts, ns))

    def _surface_pdf_sa(self, dev, path: _Path, i, wo_w, wi_w):
        return self._vertex_bsdf(dev, path, i, wo_w, wi_w)[1]

    def _surface_f(self, dev, path: _Path, i, wo_w, wi_w):
        return self._vertex_bsdf(dev, path, i, wo_w, wi_w)[0]

    # ------------------------------------------------------------------
    def li(self, dev, o, d, px, py, s):
        """Radiance of the camera rays (o, d) of work items (px, py, s), the
        per-lane traced-ray counts and, with a pinhole camera, the t=1
        strategies' splats: (L, nrays[, splat_xy (R,K,2), splat_val (R,K,3)])."""
        R = o.shape[0]
        dv = o.device
        n_t = self.max_depth + 2  # camera vertices, the camera point included
        n_s = self.max_depth + 1  # light vertices, the light point included
        cam = self.scene.camera
        light_distr = self.light_distr
        lt = dev["light"]
        ones = torch.ones((R,), dtype=torch.float32, device=dv)
        true = torch.ones((R,), dtype=torch.bool, device=dv)

        # ---------------- camera subpath --------------------------------
        cpath = _Path(R, n_t, dv)
        # pbrt's camera vertex is NOT delta: the t=1 family samples the same
        # paths, and its pdf enters every strategy's MIS denominator
        cpath.set(0, p=o, ng=d, ns=d, beta=torch.ones((R, 3), dtype=torch.float32, device=dv),
                  pdf_fwd=ones, valid=true)
        _, cam_pdf_dir = camera_pdf_we(cam, d)
        nrays, l_env = self._walk(
            dev, cpath, o, d, torch.ones((R, 3), dtype=torch.float32, device=dv), cam_pdf_dir,
            true, px, py, s, _SALT_CAM, n_t - 1, "radiance",
        )

        # ---------------- light subpath ---------------------------------
        les = ld.sample_le(
            dev, light_distr,
            *(uniform_float(px, py, s, _SALT_LIGHT + k) for k in range(5)),
        )
        lpath = _Path(R, n_s, dv)
        lt_type = lt["type"][les.li_idx.long()]
        # INFINITE lights start no subpath (see the module doc); DISTANT
        # lights do, with the planar beam density below
        l_ok = (les.supported & (lt_type != ld.LIGHT_INFINITE)
                & (les.pdf_pos > 0.0) & (les.pdf_dir > 0.0))
        lpath.set(
            0, p=les.p, ng=les.n, ns=les.n,
            beta=_where(l_ok, les.le / (les.pmf * les.pdf_pos)[..., None], 0.0),
            pdf_fwd=torch.where(l_ok, les.pmf * les.pdf_pos, 0.0),
            light=les.li_idx.to(torch.int32), valid=l_ok,
        )
        cos0 = torch.where(les.is_delta, 1.0, torch.abs(dot(les.n, les.d)))
        beta_l1 = lpath.beta[:, 0] * (cos0 / torch.clamp(les.pdf_dir, min=1e-20))[..., None]
        o_l = _where(les.is_delta, les.p, offset_ray_origin(les.p, les.n, les.d))
        nrays_l, _ = self._walk(
            dev, lpath, o_l, les.d, beta_l1, les.pdf_dir, l_ok, px, py, s,
            _SALT_LIGHT + 10, n_s - 1, "importance", origin_surface=~les.is_delta,
        )
        nrays = nrays + nrays_l
        # "Correct subpath sampling densities for infinite area lights": a
        # delta-direction (distant) light reaches vertex 1 as a PARALLEL
        # beam, whose area density is the planar disk pdf 1/(pi r^2) x |cos|
        is_dd0 = lt["type"][les.li_idx.long().clamp(min=0)] == ld.LIGHT_DISTANT
        wr = dev["world_radius"]
        planar1 = (1.0 / (torch.pi * wr * wr)) * torch.abs(dot(lpath.ng[:, 1], les.d))
        lpath.pdf_fwd[:, 1] = torch.where(is_dd0 & lpath.valid[:, 1], planar1,
                                          lpath.pdf_fwd[:, 1])
        light0_is_delta = les.is_delta
        cam_p, _ = camera_world_frame(cam)
        cam_pb = torch.broadcast_to(cam_p, (R, 3))

        # ---------------- MIS -------------------------------------------
        def mis_weight(sidx, tidx, qs_override=None, pt_is_camera=False):
            """MISWeight of strategy (s=sidx, t=tidx). qs_override (s=1):
            (p, ns, light row, PdfLightOrigin, is_delta) of the resampled
            light vertex; pt_is_camera (t=1): the camera point is the
            camera-side endpoint."""
            if sidx + tidx == 2:
                return ones
            light0_delta = light0_is_delta
            if sidx > 0:
                if qs_override is not None:
                    qs_p, qs_ns, qs_li, _, light0_delta = qs_override
                    qs_delta = torch.zeros_like(true)
                else:
                    qs_p = lpath.p[:, sidx - 1]
                    qs_ns = lpath.ns[:, sidx - 1]
                    qs_li = lpath.light[:, 0]
                    qs_delta = lpath.delta[:, sidx - 1]
            if pt_is_camera:
                pt_p = cam_pb
                pt_ns = torch.zeros((R, 3), dtype=torch.float32, device=dv)
                pt_delta = torch.zeros_like(true)
                pt_surface = False
            else:
                pt_p = cpath.p[:, tidx - 1]
                pt_ns = cpath.ns[:, tidx - 1]
                pt_delta = cpath.delta[:, tidx - 1]
                pt_surface = True

            # a1: pt.pdf_rev, the light side generating pt
            if sidx > 0:
                wi_qp = normalize(pt_p - qs_p)
                if sidx == 1:
                    _, pdf_dir = ld.le_pdfs(dev, qs_li.clamp(min=0), qs_ns, wi_qp)
                    pt_pdf_rev = _convert_density(pdf_dir, qs_p, pt_p, pt_ns, pt_surface)
                    # a distant light's beam density at pt is the PLANAR
                    # disk density (Vertex::PdfLight's infinite-light
                    # case), times |cos| on surfaces
                    is_dd = lt["type"][qs_li.long().clamp(min=0)] == ld.LIGHT_DISTANT
                    planar = 1.0 / (torch.pi * wr * wr)
                    if pt_surface:
                        planar = planar * torch.abs(dot(pt_ns, wi_qp))
                    pt_pdf_rev = torch.where(is_dd, planar, pt_pdf_rev)
                else:
                    wo_qs = normalize(lpath.p[:, sidx - 2] - qs_p)
                    pdf_sa = self._surface_pdf_sa(dev, lpath, sidx - 1, wo_qs, wi_qp)
                    pt_pdf_rev = _convert_density(pdf_sa, qs_p, pt_p, pt_ns, pt_surface)
            else:
                # s = 0: pt IS on a light (PdfLightOrigin)
                li0 = cpath.light[:, tidx - 1]
                pmf = ld.light_pick_pmf(dev, light_distr, li0)
                area = lt["area"][li0.long().clamp(min=0)]
                pt_pdf_rev = torch.where(li0 >= 0, pmf / torch.clamp(area, min=1e-20), 0.0)

            # a2: ptMinus.pdf_rev, pt scattering backward
            ptm_pdf_rev = None
            if tidx >= 2:
                ptm_p = cpath.p[:, tidx - 2]
                ptm_ns = cpath.ns[:, tidx - 2]
                wi_ptm = normalize(ptm_p - pt_p)
                if sidx > 0:
                    wo_pt = normalize(qs_p - pt_p)
                    pdf_sa = self._surface_pdf_sa(dev, cpath, tidx - 1, wo_pt, wi_ptm)
                else:
                    # s = 0: the emission direction pdf of the light at pt
                    li0 = cpath.light[:, tidx - 1]
                    _, pdf_sa = ld.le_pdfs(dev, li0.clamp(min=0), cpath.ng[:, tidx - 1], wi_ptm)
                ptm_pdf_rev = _convert_density(pdf_sa, pt_p, ptm_p, ptm_ns, True)

            # a3: qs.pdf_rev, the camera side generating qs
            qs_pdf_rev = None
            if sidx > 0:
                wi_pq = normalize(qs_p - pt_p)
                if pt_is_camera:
                    _, pdf_sa = camera_pdf_we(cam, wi_pq)
                else:
                    wo_pt = normalize(cpath.p[:, tidx - 2] - pt_p)
                    pdf_sa = self._surface_pdf_sa(dev, cpath, tidx - 1, wo_pt, wi_pq)
                qs_pdf_rev = _convert_density(pdf_sa, pt_p, qs_p, qs_ns, True)

            # a4: qsMinus.pdf_rev, qs scattering backward
            qsm_pdf_rev = None
            if sidx >= 2:
                qsm_p = lpath.p[:, sidx - 2]
                qsm_ns = lpath.ns[:, sidx - 2]
                wo_qs = normalize(pt_p - qs_p)
                wi_qsm = normalize(qsm_p - qs_p)
                pdf_sa = self._surface_pdf_sa(dev, lpath, sidx - 1, wo_qs, wi_qsm)
                qsm_pdf_rev = _convert_density(pdf_sa, qs_p, qsm_p, qsm_ns, True)

            # sumRi over both sides
            sum_ri = torch.zeros((R,), dtype=torch.float32, device=dv)
            ri = ones
            for i in range(tidx - 1, 0, -1):
                rev = cpath.pdf_rev[:, i]
                if i == tidx - 1:
                    rev = pt_pdf_rev
                elif i == tidx - 2 and ptm_pdf_rev is not None:
                    rev = ptm_pdf_rev
                ri = ri * _remap0(rev) / _remap0(cpath.pdf_fwd[:, i])
                d_i = pt_delta if i == tidx - 1 else cpath.delta[:, i]
                d_im1 = cpath.delta[:, i - 1]  # slot 0 (the camera): False
                sum_ri = sum_ri + torch.where(~d_i & ~d_im1, ri, 0.0)
            ri = ones
            for i in range(sidx - 1, -1, -1):
                rev = lpath.pdf_rev[:, i]
                fwd = lpath.pdf_fwd[:, i]
                if i == sidx - 1:
                    rev = qs_pdf_rev
                    if qs_override is not None:
                        fwd = qs_override[3]  # the resampled vertex's PdfLightOrigin
                elif i == sidx - 2 and qsm_pdf_rev is not None:
                    rev = qsm_pdf_rev
                ri = ri * _remap0(rev) / _remap0(fwd)
                d_i = qs_delta if i == sidx - 1 else lpath.delta[:, i]
                d_im1 = light0_delta if i == 0 else lpath.delta[:, i - 1]
                sum_ri = sum_ri + torch.where(~d_i & ~d_im1, ri, 0.0)
            return 1.0 / (1.0 + sum_ri)

        # ---------------- strategies ------------------------------------
        L = l_env
        vis_o, vis_d, vis_t, pend = [], [], [], []

        def skip(sidx, tidx):
            return self._only is not None and (sidx, tidx) not in self._only

        def queue(has, o_vis, wi, t_vis, kind, contrib, raster=None):
            vis_o.append(_where(has, o_vis, 0.0))
            vis_d.append(_where(has, wi, 1.0))
            vis_t.append(torch.where(has, t_vis, -1.0))
            pend.append((kind, contrib, raster))

        # ---- s = 0: the camera subpath hits a light ---------------------
        for t in range(2, n_t + 1):
            if skip(0, t):
                continue
            v = cpath.valid[:, t - 1]
            lid = cpath.light[:, t - 1]
            on_light = v & (lid >= 0)
            wo = normalize(cpath.p[:, t - 2] - cpath.p[:, t - 1])
            le = ld.emitted_radiance(dev, torch.where(on_light, lid, -1), wo, cpath.ng[:, t - 1])
            c = cpath.beta[:, t - 1] * le
            has = on_light & (c.amax(dim=-1) > 0.0)
            w = torch.where(has, mis_weight(0, t), 0.0)
            L = L + _where(has, c * w[..., None], 0.0)

        # ---- t = 1: light-tracing splats through the camera -------------
        if self._pinhole:
            # st = 1 (the light point itself to the lens) is skipped: the
            # s=0 strategies cover directly visible lights with less variance
            for st in range(2, n_s + 1):
                if skip(st, 1):
                    continue
                v = lpath.valid[:, st - 1]
                qp = lpath.p[:, st - 1]
                qns = lpath.ns[:, st - 1]
                qng = lpath.ng[:, st - 1]
                wi, dist, pdf, we, raster, in_b = camera_sample_wi(cam, qp)
                wo_q = normalize(lpath.p[:, st - 2] - qp)
                f_val = self._surface_f(dev, lpath, st - 1, wo_q, wi)
                f_val = f_val * _correction(wo_q, wi, qns, qng)[..., None]
                c = (lpath.beta[:, st - 1] * f_val
                     * (we / torch.clamp(pdf, min=1e-20) * torch.abs(dot(wi, qns)))[..., None])
                has = v & in_b & (pdf > 0.0) & (c.amax(dim=-1) > 0.0)
                w = torch.where(has, mis_weight(st, 1, pt_is_camera=True), 0.0)
                queue(has, offset_ray_origin(qp, qng, wi), wi, dist * 0.999, "splat",
                      _where(has, c * w[..., None], 0.0), raster)

        # ---- s = 1: light resampling (NEE-like) -------------------------
        for t in range(2, min(n_t, self.max_depth + 1) + 1):
            if skip(1, t):
                continue
            v = cpath.valid[:, t - 1]
            ptp = cpath.p[:, t - 1]
            ls = ld.sample_one_light(
                dev, light_distr, ptp,
                *(uniform_float(px, py, s, _SALT_CONNECT + t * 4 + k) for k in range(3)),
            )
            wo_pt = normalize(cpath.p[:, t - 2] - ptp)
            f_pt = self._surface_f(dev, cpath, t - 1, wo_pt, ls.wi)
            cos_pt = torch.abs(dot(ls.wi, cpath.ns[:, t - 1]))
            c = (cpath.beta[:, t - 1] * f_pt * ls.li
                 * (cos_pt / torch.clamp(ls.pdf, min=1e-20))[..., None])
            li_row = ls.li_idx.long().clamp(min=0)
            not_env = lt["type"][li_row] != ld.LIGHT_INFINITE
            has = v & not_env & (ls.pdf > 0.0) & (c.amax(dim=-1) > 0.0)
            # the resampled light vertex for MIS: its position, its surface
            # normal (an area row's triangle's) and its PdfLightOrigin (the
            # pick pmf x the area-measure position pdf; 0 for delta lights,
            # whose Pdf_Le pdfPos is 0, so it remaps to 1 in the walk)
            sam_p = ptp + ls.wi * ls.dist[..., None]
            n_tri = ld.triangle_normal(dev["tri_verts"][lt["tri"][li_row].long().clamp(min=0)])
            sam_ns = _where(ls.is_delta, -ls.wi, n_tri)
            pmf = ld.light_pick_pmf(dev, light_distr, li_row)
            area = lt["area"][li_row]
            pdf_origin = torch.where(ls.is_delta, 0.0, pmf / torch.clamp(area, min=1e-20))
            w = torch.where(has, mis_weight(1, t, qs_override=(sam_p, sam_ns, li_row, pdf_origin,
                                                               ls.is_delta)), 0.0)
            queue(has, offset_ray_origin(ptp, cpath.ng[:, t - 1], ls.wi), ls.wi, ls.dist * 0.999,
                  "add", _where(has, c * w[..., None], 0.0))

        # ---- s >= 2, t >= 2: surface-surface connections -----------------
        for t in range(2, n_t + 1):
            for st in range(2, n_s + 1):
                if st + t - 2 > self.max_depth or skip(st, t):
                    continue
                vc = cpath.valid[:, t - 1]
                vl = lpath.valid[:, st - 1]
                ptp = cpath.p[:, t - 1]
                qsp = lpath.p[:, st - 1]
                link = qsp - ptp
                d2 = torch.clamp(dot(link, link), min=1e-20)
                dist = torch.sqrt(d2)
                wi = link / dist[..., None]
                wo_pt = normalize(cpath.p[:, t - 2] - ptp)
                wo_qs = normalize(lpath.p[:, st - 2] - qsp)
                f_pt = self._surface_f(dev, cpath, t - 1, wo_pt, wi)
                f_qs = self._surface_f(dev, lpath, st - 1, wo_qs, -wi)
                qns = lpath.ns[:, st - 1]
                qng = lpath.ng[:, st - 1]
                f_qs = f_qs * _correction(wo_qs, -wi, qns, qng)[..., None]
                g = torch.abs(dot(wi, cpath.ns[:, t - 1])) * torch.abs(dot(-wi, qns)) / d2
                c = cpath.beta[:, t - 1] * f_pt * g[..., None] * f_qs * lpath.beta[:, st - 1]
                has = vc & vl & (c.amax(dim=-1) > 0.0)
                w = torch.where(has, mis_weight(st, t), 0.0)
                queue(has, offset_ray_origin(ptp, cpath.ng[:, t - 1], wi), wi, dist * 0.998,
                      "add", _where(has, c * w[..., None], 0.0))

        # ---- one fused any-hit wave gates every connection ---------------
        splat_xy, splat_val = [], []
        if pend:
            O = torch.cat(vis_o)
            D = torch.cat(vis_d)
            T = torch.cat(vis_t)
            del vis_o, vis_d
            occ = scene_intersect_p(dev, O, D, torch.where(T > 0, T, -1.0))
            del O, D
            for i, (kind, contrib, raster) in enumerate(pend):
                seg = slice(i * R, (i + 1) * R)
                live = T[seg] > 0
                nrays = nrays + live.to(torch.int32)
                cv = _where(~occ[seg] & live, contrib, 0.0)
                if kind == "add":
                    L = L + cv
                else:
                    splat_xy.append(raster)
                    splat_val.append(cv)
        if splat_xy:
            return L, nrays, torch.stack(splat_xy, dim=1), torch.stack(splat_val, dim=1)
        return L, nrays
