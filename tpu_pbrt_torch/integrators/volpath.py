"""VolPathIntegrator — path tracing with participating media (port of
tpu_pbrt/integrators/volpath.py).

pbrt-v3 VolPathIntegrator::Li as a fixed-batch wavefront, in the
reference's order: every segment samples the ray's current medium
(`media.medium_sample`); a medium interaction scatters by the
Henyey-Greenstein phase function, a surface interaction by its BSDF,
each with NEE whose shadow ray carries the transmittance (and walks
through null-interface surfaces in scenes that have them); an escaped
ray sees the environment; emission and the environment take forward
MIS. Null (MAT_NONE) surfaces pass the ray through and switch its medium
by the surface's MediumInterface, without counting a bounce (the loop
runs PASSTHROUGH_MARGIN more iterations); transmissive BSDF crossings
switch it too and track eta^2 for Russian roulette, which starts after
the fourth real bounce.

The reference runs every iteration whatever its lanes and traces every
lane's rays; the port traces only live lanes and lanes that take NEE,
stops once no lane is alive (one host read per iteration), and stops the
shadow walk once no lane is still crossing: the lanes left out add
nothing to the image or the ray count.
"""

from __future__ import annotations

import torch

from tpu_pbrt_torch.accel import stream
from tpu_pbrt_torch.core import bxdf
from tpu_pbrt_torch.core import lights_dev as ld
from tpu_pbrt_torch.core import media as md
from tpu_pbrt_torch.core.sampling import power_heuristic, uniform_float
from tpu_pbrt_torch.core.vecmath import dot, normalize, offset_ray_origin, to_local, to_world
from tpu_pbrt_torch.integrators.common import (
    DIM_BSDF_LOBE,
    DIM_BSDF_UV,
    DIM_LIGHT_PICK,
    DIM_LIGHT_UV,
    DIM_RR,
    DIMS_PER_BOUNCE,
    WavefrontIntegrator,
    make_interaction,
    scene_intersect,
    unoccluded_tr,
)
from tpu_pbrt_torch.integrators.path import PASSTHROUGH_MARGIN

_DIM_MEDIUM = 12
_DIM_PHASE = 14


class VolPathIntegrator(WavefrontIntegrator):
    name = "volpath"

    def __init__(self, params, scene, options):
        super().__init__(params, scene, options)
        self.max_depth = params.find_one_int("maxdepth", 5)
        self.rr_threshold = params.find_one_float("rrthreshold", 1.0)
        self.camera_medium = scene.camera_medium_id
        self.margin = PASSTHROUGH_MARGIN if scene.has_null_materials else 0

    def li(self, dev, o, d, px, py, s):
        """Radiance of the camera rays (o, d) of work items (px, py, s) and
        the per-lane traced-ray counts (one per live segment, one per NEE
        shadow walk)."""
        shape = o.shape[:-1]
        dv = o.device
        mt: md.MediumTable = dev["media"]
        zero3 = torch.zeros(shape + (3,), dtype=torch.float32, device=dv)
        L = zero3
        beta = torch.ones_like(zero3)
        alive = torch.ones(shape, dtype=torch.bool, device=dv)
        nrays = torch.zeros(shape, dtype=torch.int32, device=dv)
        prev_pdf = torch.zeros(shape, dtype=torch.float32, device=dv)
        specular = torch.ones(shape, dtype=torch.bool, device=dv)
        eta_scale = torch.ones(shape, dtype=torch.float32, device=dv)
        prev_p = o
        no_med = torch.full(shape, -1, dtype=torch.int32, device=dv)
        cur_med = torch.full(shape, self.camera_medium, dtype=torch.int32, device=dv)
        depth = torch.zeros(shape, dtype=torch.int32, device=dv)  # real bounces taken
        inf = torch.full(shape, float("inf"), dtype=torch.float32, device=dv)
        dead = torch.full(shape, -1.0, dtype=torch.float32, device=dv)

        for bounce in range(self.max_depth + 1 + self.margin):
            if bounce:
                stream.WAVES.add_loop_read()
                if not bool(alive.any()):  # the loop test: one host read per iteration
                    break
            salt = bounce * DIMS_PER_BOUNCE
            # dead lanes trace with t_max < 0: never seeded into the traversal
            hit = scene_intersect(dev, o, d, torch.where(alive, inf, dead))
            nrays = nrays + alive.to(torch.int32)
            it = make_interaction(dev, hit, o, d)
            it.valid = it.valid & alive
            miss = alive & (hit.prim < 0)

            # ---- medium sampling over the segment ------------------------
            t_seg = torch.where(hit.prim >= 0, hit.t, inf)
            ms = md.medium_sample(mt, torch.where(alive, cur_med, no_med), o, d, t_seg,
                                  px, py, s, salt + _DIM_MEDIUM)
            beta = beta * torch.where(alive[..., None], ms.weight, torch.ones_like(ms.weight))
            in_medium = alive & ms.sampled_medium
            at_surface = alive & (hit.prim >= 0) & ~in_medium
            escaped = miss & ~in_medium

            # ---- emitted radiance (surface, environment) with forward MIS --
            if "envmap" in dev:
                le_env = ld.env_lookup(dev, d)
                pdf_env = ld.infinite_pdf(dev, self.light_distr, d, ref_p=prev_p)
                w_env = torch.where(specular, torch.ones_like(pdf_env),
                                    power_heuristic(1.0, prev_pdf, 1.0, pdf_env))
                L = L + torch.where(escaped[..., None], beta * le_env * w_env[..., None], zero3)
            hit_light = torch.where(at_surface, it.light, torch.full_like(it.light, -1))
            le = ld.emitted_radiance(dev, hit_light, it.wo, it.ng)
            pdf_light = ld.emitted_pdf(dev, self.light_distr, prev_p, it.p, hit_light, it.ng)
            w_emit = torch.where(specular, torch.ones_like(pdf_light),
                                 power_heuristic(1.0, prev_pdf, 1.0, pdf_light))
            L = L + beta * le * w_emit[..., None]

            alive = in_medium | at_surface
            if bounce >= self.max_depth + self.margin:
                break

            # ---- null material pass-through (a medium transition) ---------
            mp = self.mat_at(dev, it)
            is_null = at_surface & (mp.mtype == bxdf.MAT_NONE)
            going_in_null = dot(d, it.ng) < 0.0
            prim = hit.prim.clamp(min=0).long()
            med_in = dev["tri_med_in"][prim]
            med_out = dev["tri_med_out"][prim]
            new_med_null = torch.where(going_in_null, med_in, med_out)
            at_surface = at_surface & ~is_null

            # ---- NEE ---------------------------------------------------
            p_medium = o + ms.t[..., None] * d
            ref_p = torch.where(in_medium[..., None], p_medium, it.p)
            u_pick = self.u1d(px, py, s, salt + DIM_LIGHT_PICK)
            u1, u2 = self.u2d(px, py, s, salt + DIM_LIGHT_UV)
            ls = ld.sample_one_light(dev, self.light_distr, ref_p, u_pick, u1, u2)
            # the scattering function's value and pdf toward the light
            wo_l = to_local(it.wo, it.ss, it.ts, it.ns)
            wi_l = to_local(ls.wi, it.ss, it.ts, it.ns)
            f_surf, pdf_surf = bxdf.bsdf_eval(mp, wo_l, wi_l)
            f_surf = f_surf * torch.abs(dot(ls.wi, it.ns))[..., None]
            g_hg = mt.g[cur_med.clamp(min=0).long()]
            p_phase = md.hg_p(dot(-d, ls.wi), g_hg)
            f_nee = torch.where(in_medium[..., None], p_phase[..., None].expand(shape + (3,)),
                                f_surf)
            pdf_nee_fwd = torch.where(in_medium, p_phase, pdf_surf)
            # pbrt stops before light sampling once bounces reach maxDepth:
            # the last vertex emits but takes no NEE
            can_scatter = depth < self.max_depth
            do_nee = ((in_medium | at_surface) & can_scatter & (ls.pdf > 0.0)
                      & (f_nee.amax(dim=-1) > 0.0) & (ls.li.amax(dim=-1) > 0.0))
            o_sh = torch.where(in_medium[..., None], p_medium,
                               offset_ray_origin(it.p, it.ng, ls.wi))
            # the reference walks every lane's shadow ray and keeps the
            # do_nee lanes' answers: the port walks only those
            visible, tr_sh = unoccluded_tr(
                dev, o_sh, ls.wi, torch.where(do_nee, ls.dist, dead),
                torch.where(do_nee, cur_med, no_med),
                px, py, s, salt + _DIM_MEDIUM + 1, segments=self.vis_segments,
            )
            nrays = nrays + do_nee.to(torch.int32)
            w_l = torch.where(ls.is_delta, torch.ones_like(ls.pdf),
                              power_heuristic(1.0, ls.pdf, 1.0, pdf_nee_fwd))
            Ld = f_nee * ls.li * tr_sh * (w_l / torch.clamp(ls.pdf, min=1e-20))[..., None]
            L = L + torch.where((do_nee & visible)[..., None], beta * Ld, zero3)

            # ---- continuation ------------------------------------------
            # medium: an HG sample around wo = -d, matching the hg_p(dot(-d, wi)) eval
            up1 = uniform_float(px, py, s, salt + _DIM_PHASE)
            up2 = uniform_float(px, py, s, salt + _DIM_PHASE + 1)
            wi_m, pdf_m = md.hg_sample(-d, g_hg, up1, up2)
            wi_m = normalize(wi_m)

            # surface: a BSDF sample
            ul = self.u1d(px, py, s, salt + DIM_BSDF_LOBE)
            ub1, ub2 = self.u2d(px, py, s, salt + DIM_BSDF_UV)
            bs = bxdf.bsdf_sample(mp, wo_l, ul, ub1, ub2)
            wi_surf = normalize(to_world(bs.wi, it.ss, it.ts, it.ns))
            cont_surf = at_surface & (bs.pdf > 0.0) & (bs.f.amax(dim=-1) > 0.0)
            throughput = bs.f * (torch.abs(dot(wi_surf, it.ns))
                                 / torch.clamp(bs.pdf, min=1e-20))[..., None]

            # merge the three continuations (medium, surface, null); real
            # scattering counts toward maxdepth, null crossings do not
            in_medium = in_medium & can_scatter
            cont_surf = cont_surf & can_scatter
            depth = depth + (in_medium | cont_surf).to(torch.int32)
            cont = in_medium | cont_surf | is_null
            beta = torch.where(cont_surf[..., None], beta * throughput, beta)
            new_d = torch.where(in_medium[..., None], wi_m, wi_surf)
            new_d = torch.where(is_null[..., None], d, new_d)
            new_o = torch.where(in_medium[..., None], p_medium,
                                offset_ray_origin(it.p, it.ng, new_d))
            prev_p = torch.where(cont[..., None],
                                 torch.where(in_medium[..., None], p_medium, it.p), prev_p)
            o = torch.where(cont[..., None], new_o, o)
            d = torch.where(cont[..., None], new_d, d)
            prev_pdf = torch.where(in_medium, pdf_m, torch.where(cont_surf, bs.pdf, prev_pdf))
            specular = torch.where(in_medium, torch.zeros_like(specular),
                                   torch.where(cont_surf, bs.is_specular, specular))
            # medium transitions: a null interface or a transmissive crossing
            crossing = cont_surf & bs.is_transmission
            going_in = dot(new_d, it.ng) < 0.0
            new_med_cross = torch.where(going_in, med_in, med_out)
            cur_med = torch.where(is_null, new_med_null, cur_med)
            cur_med = torch.where(crossing, new_med_cross, cur_med)
            # eta^2 tracking for RR
            eta2 = mp.eta[..., 0] ** 2
            scale = torch.where(dot(it.wo, it.ns) > 0.0, eta2,
                                1.0 / torch.clamp(eta2, min=1e-12))
            eta_scale = torch.where(crossing, eta_scale * scale, eta_scale)
            alive = cont

            # ---- Russian roulette after 3 real bounces (null crossings do
            # not count: pbrt's bounces-- semantics) ------------------------
            if bounce > 3:
                rr_lane = depth > 4
                rr_beta = beta.amax(dim=-1) * eta_scale
                q = torch.clamp(1.0 - rr_beta, min=0.05)
                u_rr = uniform_float(px, py, s, salt + DIM_RR)
                rr_cand = alive & rr_lane & (rr_beta < self.rr_threshold)
                kill = rr_cand & (u_rr < q)
                survive = rr_cand & ~kill
                beta = beta * torch.where(survive, 1.0 / torch.clamp(1.0 - q, min=1e-6),
                                          torch.ones_like(q))[..., None]
                alive = alive & ~kill
        return L, nrays
