"""PathIntegrator — the wavefront bounce loop (port of tpu_pbrt/integrators/path.py).

pbrt-v3 PathIntegrator::Li as a wavefront: the whole ray batch advances
one bounce per loop iteration under a live mask: emission with forward
MIS (the continuation ray carries its BSDF pdf), NEE with MIS and a
shadow ray traced right away (`_bounce_wave(fused=False)`, the
reference's split trace), the BSDF-sampled continuation, and Russian
roulette after depth 3 with the eta^2 correction. The loop runs on the
host and stops when every lane is dead (one host read per bounce).

The reference's persistent pool (`pool_chunk`: compaction, camera-ray
regeneration and the fused camera+shadow wave) is not ported yet; it
draws the same sample streams and therefore estimates the same image.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_pbrt_torch.core import bxdf
from tpu_pbrt_torch.core import lights_dev as ld
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


class LaneSt(NamedTuple):
    """Per-lane path state carried between bounces."""

    o: torch.Tensor
    d: torch.Tensor
    L: torch.Tensor
    beta: torch.Tensor
    alive: torch.Tensor
    depth: torch.Tensor  # real bounces taken
    prev_pdf: torch.Tensor
    specular: torch.Tensor
    eta_scale: torch.Tensor
    prev_p: torch.Tensor


def fresh_lanes(o, d) -> LaneSt:
    """Camera-ray lane state: the MIS state treats the camera 'bounce' as
    specular."""
    shape = o.shape[:-1]
    kw = dict(device=o.device)
    return LaneSt(
        o=o,
        d=d,
        L=torch.zeros(shape + (3,), dtype=torch.float32, **kw),
        beta=torch.ones(shape + (3,), dtype=torch.float32, **kw),
        alive=torch.ones(shape, dtype=torch.bool, **kw),
        depth=torch.zeros(shape, dtype=torch.int32, **kw),
        prev_pdf=torch.zeros(shape, dtype=torch.float32, **kw),
        specular=torch.ones(shape, dtype=torch.bool, **kw),
        eta_scale=torch.ones(shape, dtype=torch.float32, **kw),
        prev_p=o,
    )


class PathIntegrator(WavefrontIntegrator):
    name = "path"

    def __init__(self, params, scene, options):
        super().__init__(params, scene, options)
        self.max_depth = params.find_one_int("maxdepth", 5)
        self.rr_threshold = params.find_one_float("rrthreshold", 1.0)

    def _bounce_wave(self, dev, px, py, s, salt: int, st: LaneSt, nrays):
        """Advance every lane one bounce (the reference's fused=False wave).
        Returns (LaneSt, nrays + this wave's per-lane traced-ray counts)."""
        o, d, L, beta, alive = st.o, st.d, st.L, st.beta, st.alive
        depth, prev_pdf, specular = st.depth, st.prev_pdf, st.specular
        eta_scale, prev_p = st.eta_scale, st.prev_p

        # dead lanes trace with t_max < 0: never seeded into the traversal
        t_max = torch.where(alive, torch.full_like(o[..., 0], float("inf")),
                            torch.full_like(o[..., 0], -1.0))
        hit = scene_intersect(dev, o, d, t_max)
        nrays = nrays + alive.to(torch.int32)
        it = make_interaction(dev, hit, o, d)
        it.valid = it.valid & alive

        # ---- emitted radiance with forward MIS ----------------------
        hit_light = torch.where(it.valid, it.light, torch.full_like(it.light, -1))
        le = ld.emitted_radiance(dev, hit_light, it.wo, it.ng)
        pdf_light = ld.emitted_pdf(dev, self.light_distr, prev_p, it.p, hit_light, it.ng)
        w_emit = torch.where(specular, torch.ones_like(pdf_light),
                             power_heuristic(1.0, prev_pdf, 1.0, pdf_light))
        L = L + beta * le * w_emit[..., None]

        alive = alive & (hit.prim >= 0)
        # pbrt: the vertex at bounces == maxDepth emits but neither
        # samples lights nor continues
        can_scatter = depth < self.max_depth

        # ---- NEE: light-sampling half ---------------------------------
        mp = self.mat_at(dev, it)
        u_pick = self.u1d(px, py, s, salt + DIM_LIGHT_PICK)
        u1, u2 = self.u2d(px, py, s, salt + DIM_LIGHT_UV)
        ls = ld.sample_one_light(dev, self.light_distr, it.p, u_pick, u1, u2)
        wo_l = to_local(it.wo, it.ss, it.ts, it.ns)
        wi_l = to_local(ls.wi, it.ss, it.ts, it.ns)
        f, bsdf_pdf = bxdf.bsdf_eval(mp, wo_l, wi_l)
        f = f * torch.abs(dot(ls.wi, it.ns))[..., None]
        do_nee = (
            it.valid
            & can_scatter
            & (ls.pdf > 0.0)
            & (f.amax(dim=-1) > 0.0)
            & (ls.li.amax(dim=-1) > 0.0)
        )
        o_sh = offset_ray_origin(it.p, it.ng, ls.wi)
        sh_dist = torch.where(do_nee, ls.dist, torch.full_like(ls.dist, -1.0))
        w_l = torch.where(ls.is_delta, torch.ones_like(ls.pdf),
                          power_heuristic(1.0, ls.pdf, 1.0, bsdf_pdf))
        Ld = f * ls.li * (w_l / torch.clamp(ls.pdf, min=1e-20))[..., None]
        visible = unoccluded_tr(dev, o_sh, ls.wi, sh_dist)
        nrays = nrays + do_nee.to(torch.int32)
        L = L + torch.where((do_nee & visible)[..., None], beta * Ld, torch.zeros_like(Ld))

        # ---- continuation: BSDF sample --------------------------------
        ul = self.u1d(px, py, s, salt + DIM_BSDF_LOBE)
        ub1, ub2 = self.u2d(px, py, s, salt + DIM_BSDF_UV)
        bs = bxdf.bsdf_sample(mp, wo_l, ul, ub1, ub2)
        wi_w = normalize(to_world(bs.wi, it.ss, it.ts, it.ns))
        cont = it.valid & can_scatter & (bs.pdf > 0.0) & (bs.f.amax(dim=-1) > 0.0)
        throughput = bs.f * (torch.abs(dot(wi_w, it.ns))
                             / torch.clamp(bs.pdf, min=1e-20))[..., None]
        beta = torch.where(cont[..., None], beta * throughput, beta)
        # eta^2 tracking for RR (path.cpp etaScale)
        eta2 = mp.eta[..., 0] ** 2
        going_in = dot(it.wo, it.ns) > 0.0
        scale = torch.where(going_in, eta2, 1.0 / torch.clamp(eta2, min=1e-12))
        eta_scale = torch.where(cont & bs.is_transmission, eta_scale * scale, eta_scale)

        prev_p = torch.where(cont[..., None], it.p, prev_p)
        o = torch.where(cont[..., None], offset_ray_origin(it.p, it.ng, wi_w), o)
        d = torch.where(cont[..., None], wi_w, d)
        prev_pdf = torch.where(cont, bs.pdf, prev_pdf)
        specular = torch.where(cont, bs.is_specular, specular)
        depth = depth + cont.to(torch.int32)
        alive = cont

        # ---- Russian roulette: first possible kill after the 5th real
        # bounce is sampled (pbrt's `bounces > 3` at the end of the
        # iteration, with depth counted post-increment) -----------------
        rr_on = depth > 4
        rr_beta = beta.amax(dim=-1) * eta_scale
        q = torch.clamp(1.0 - rr_beta, min=0.05)
        u_rr = uniform_float(px, py, s, salt + DIM_RR)
        rr_cand = alive & rr_on & (rr_beta < self.rr_threshold)
        kill = rr_cand & (u_rr < q)
        survive_scale = torch.where(rr_cand & ~kill, 1.0 / torch.clamp(1.0 - q, min=1e-6),
                                    torch.ones_like(q))
        beta = beta * survive_scale[..., None]
        alive = alive & ~kill
        return LaneSt(o, d, L, beta, alive, depth, prev_pdf, specular, eta_scale,
                      prev_p), nrays

    def li(self, dev, o, d, px, py, s):
        """Radiance of the camera rays (o, d) of work items (px, py, s):
        bounce waves until every lane is dead or maxdepth + 1 waves ran.
        Returns (L (R, 3), per-lane traced-ray counts (R,))."""
        lane = fresh_lanes(o, d)
        nrays = torch.zeros(o.shape[:-1], dtype=torch.int32, device=o.device)
        for bounce in range(self.max_depth + 1):
            if not bool(lane.alive.any()):
                break
            lane, nrays = self._bounce_wave(
                dev, px, py, s, bounce * DIMS_PER_BOUNCE, lane, nrays
            )
        return lane.L, nrays
