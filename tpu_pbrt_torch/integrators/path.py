"""PathIntegrator — the wavefront bounce loop (port of tpu_pbrt/integrators/path.py).

pbrt-v3 PathIntegrator::Li as a wavefront: a batch of lanes advances one
bounce per `_bounce_wave`: emission with forward MIS (the continuation
ray carries its BSDF pdf; a ray that escapes sees the environment map),
NEE with MIS, the BSDF-sampled continuation (specular bounces through
glass and mirrors keep the `specular` flag and the eta^2 scale of
transmission), and Russian roulette after depth 3 with the eta^2
correction.

Two loops share that wave, as in the reference:

- the fixed batch (`li`): every camera ray of a chunk advances in
  lockstep until all lanes are dead;
- the persistent pool (`pool_chunk`, the default render path): a
  resident pool of path slots is compacted every wave (one packed-int32
  sort moves live lanes to the front), its free tail is refilled with
  fresh camera rays from the chunk's work counter, and terminated lanes
  deposit into the film. Every sampler dimension is a pure function of
  (px, py, s, dimension), so a regenerated lane draws exactly the
  stream the fixed batch would have: the two estimate the same image.

Both trace the reference's fused layout where the scene allows it: each
wave traces [continuation rays; the previous bounce's shadow rays] as one
2R closest-hit batch, and the NEE contribution lands one wave later. A
scene with null-interface (MAT_NONE) surfaces takes the reference's split
layout instead, through the fixed batch only: each bounce traces its
continuation rays, then its shadow rays' walk through the null surfaces
(`unoccluded_tr` with vis_segments segments); a lane that hits a null
surface passes through it without counting a bounce (pbrt's
`bounces--`), so the loop runs PASSTHROUGH_MARGIN more iterations. The
reference's lax.while_loops are host loops here, with one host read per
wave for their exit tests.

On a motion scene (a shape's transform animated over an open shutter)
each camera sample draws its shutter time (DIM_TIME), which every wave
of its path, and its queued shadow rays, trace at; the pool draws it
for each regenerated lane.

In a textured scene a camera hit carries its ray-differential footprint
(at the pixel centre, as the reference takes it) into the mip filter:
the fixed batch computes it at bounce 0 only, the pool every wave,
masked to its depth-0 lanes; deeper vertices look up with a zero
footprint. Mix-material lanes resolve with the DIM_MIX draw.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_pbrt_torch.accel import stream
from tpu_pbrt_torch.cameras import ray_differentials
from tpu_pbrt_torch.core import bxdf
from tpu_pbrt_torch.core import lights_dev as ld
from tpu_pbrt_torch.core.film import nonfinite_mask
from tpu_pbrt_torch.core.sampling import power_heuristic, uniform_float
from tpu_pbrt_torch.core.vecmath import dot, normalize, offset_ray_origin, to_local, to_world
from tpu_pbrt_torch.core.xla_math import fmac
from tpu_pbrt_torch.integrators.common import (
    DIM_BSDF_LOBE,
    DIM_TIME,
    DIM_BSDF_UV,
    DIM_LIGHT_PICK,
    DIM_LIGHT_UV,
    DIM_MIX,
    DIM_RR,
    DIMS_PER_BOUNCE,
    WavefrontIntegrator,
    make_interaction,
    scene_intersect,
    scene_intersect_fused,
    texture_footprint,
    unoccluded_tr,
)
from tpu_pbrt_torch.obs import counters as obs_counters

#: extra bounce iterations for null-interface crossings, which do not count
#: as bounces (scenes with MAT_NONE surfaces only)
PASSTHROUGH_MARGIN = 4

#: compaction packs (free_flag << 30) | lane into one int32 sort key
_POOL_LANE_BITS = 30


class LaneSt(NamedTuple):
    """Per-lane path state carried between bounces (fixed batch: lanes in
    lockstep; pool: lanes at mixed depths)."""

    o: torch.Tensor
    d: torch.Tensor
    L: torch.Tensor
    beta: torch.Tensor
    alive: torch.Tensor
    depth: torch.Tensor  # real bounces taken; the pool's per-lane salt base
    prev_pdf: torch.Tensor
    specular: torch.Tensor
    eta_scale: torch.Tensor
    prev_p: torch.Tensor
    sh_o: torch.Tensor  # pending shadow ray (fused layout)
    sh_d: torch.Tensor
    sh_dist: torch.Tensor  # < 0: no pending shadow
    ld_pend: torch.Tensor  # beta-weighted NEE awaiting the shadow's visibility


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
        sh_o=o,
        sh_d=d,
        sh_dist=torch.full(shape, -1.0, dtype=torch.float32, **kw),
        ld_pend=torch.zeros(shape + (3,), dtype=torch.float32, **kw),
    )


class PathIntegrator(WavefrontIntegrator):
    name = "path"

    def __init__(self, params, scene, options):
        super().__init__(params, scene, options)
        self.max_depth = params.find_one_int("maxdepth", 5)
        self.rr_threshold = params.find_one_float("rrthreshold", 1.0)
        self.margin = PASSTHROUGH_MARGIN if scene.has_null_materials else 0

    @property
    def fused(self) -> bool:
        """Whether the bounce waves take the fused 2R layout (single-segment
        visibility and no null pass-through) or the split one."""
        return self.vis_segments == 1 and self.margin == 0

    def _regen_enabled(self) -> bool:
        """The persistent pool is on by default wherever its preconditions
        hold: the fused layout, and a sampler whose dimension salts work
        per lane (not halton). A scene with null interfaces takes the
        fixed batch."""
        from tpu_pbrt_torch.config import cfg

        return cfg.regen and self.fused and self.skind != "halton"

    # -- one wavefront step ------------------------------------------------
    def _bounce_wave(self, dev, px, py, s, salt, st: LaneSt, nrays, ctr=None, ray_time=None):
        """Advance every lane one bounce. Fused layout: trace the
        continuation rays and the pending shadow rays as one 2R wave,
        settling the previous bounce's NEE, and queue this bounce's shadow
        ray. Split layout: trace the continuation rays, then this
        bounce's shadow walk, and let null-surface lanes pass through.
        Both add emission with forward MIS, sample the BSDF continuation
        and apply Russian roulette.

        `salt` is the sampler-dimension base: the loop iteration *
        DIMS_PER_BOUNCE (an int) in the fixed batch, the per-lane depth *
        DIMS_PER_BOUNCE (a tensor) in the pool; both give a live lane the
        same value. `ctr` is the optional wave-counter block
        (obs/counters.py). `ray_time` (R,): each lane's shutter time on a
        motion scene (None: static); a queued shadow ray takes its lane's
        time in the fused wave, while the split layout's shadow walk, as
        in the reference, takes none. Returns (LaneSt, nrays + this wave's
        per-lane traced-ray counts, ctr)."""
        nrays_in = nrays
        o, d, L, beta, alive = st.o, st.d, st.L, st.beta, st.alive
        depth, prev_pdf, specular = st.depth, st.prev_pdf, st.specular
        eta_scale, prev_p = st.eta_scale, st.prev_p

        fused = self.fused
        # dead lanes trace with t_max < 0: never seeded into the traversal
        t_max = torch.where(alive, torch.full_like(o[..., 0], float("inf")),
                            torch.full_like(o[..., 0], -1.0))
        if fused:
            hit, sh_prim = scene_intersect_fused(
                dev, torch.cat([o, st.sh_o]), torch.cat([d, st.sh_d]),
                torch.cat([t_max, st.sh_dist]), n_cam=o.shape[0],
                time=None if ray_time is None else torch.cat([ray_time, ray_time]),
            )
            # settle the previous bounce's NEE with its visibility
            vis_prev = (st.sh_dist > 0.0) & (sh_prim < 0)
            L = L + torch.where(vis_prev[..., None], st.ld_pend, torch.zeros_like(st.ld_pend))
            nrays = nrays + (st.sh_dist > 0.0).to(torch.int32)
        else:
            hit = scene_intersect(dev, o, d, t_max, time=ray_time)
        nrays = nrays + alive.to(torch.int32)
        it = make_interaction(dev, hit, o, d)
        it.valid = it.valid & alive
        miss = alive & (hit.prim < 0)

        # ---- emitted radiance with forward MIS ----------------------
        if "envmap" in dev:
            # an escaped ray sees the environment, weighted against the
            # light-sampling pdf of its direction
            le_env = ld.env_lookup(dev, d)
            pdf_env = ld.infinite_pdf(dev, self.light_distr, d, ref_p=prev_p)
            w_env = torch.where(specular, torch.ones_like(pdf_env),
                                power_heuristic(1.0, prev_pdf, 1.0, pdf_env))
            L = L + torch.where(miss[..., None], beta * le_env * w_env[..., None],
                                torch.zeros_like(le_env))
        hit_light = torch.where(it.valid, it.light, torch.full_like(it.light, -1))
        le = ld.emitted_radiance(dev, hit_light, it.wo, it.ng)
        pdf_light = ld.emitted_pdf(dev, self.light_distr, prev_p, it.p, hit_light, it.ng)
        w_emit = torch.where(specular, torch.ones_like(pdf_light),
                             power_heuristic(1.0, prev_pdf, 1.0, pdf_light))
        L = fmac(beta * le, w_emit[..., None], L)

        alive = alive & (hit.prim >= 0)
        # pbrt: the vertex at bounces == maxDepth emits but neither
        # samples lights nor continues
        can_scatter = depth < self.max_depth

        # ---- NEE: light-sampling half ---------------------------------
        u_mix = (self.u1d(px, py, s, salt + DIM_MIX) if "mix_a" in dev["mat"] else None)
        mp = self.mat_at(dev, it, self._camera_footprint(dev, px, py, salt, depth, o, d, hit, it),
                         u_mix=u_mix)
        is_null = it.valid & (mp.mtype == bxdf.MAT_NONE) if self.margin else None
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
        if fused:
            # queue the shadow ray for the NEXT wave, stopping at 0.999 of
            # the light distance (VisibilityTester::Unoccluded's margin);
            # its contribution uses this bounce's beta
            pend = (
                o_sh, ls.wi,
                torch.where(do_nee, sh_dist * 0.999, torch.full_like(sh_dist, -1.0)),
                torch.where(do_nee[..., None], beta * Ld, torch.zeros_like(Ld)),
            )
        else:
            visible, _ = unoccluded_tr(dev, o_sh, ls.wi, sh_dist, None, px, py, s,
                                       salt + DIM_LIGHT_UV + 200, segments=self.vis_segments)
            nrays = nrays + do_nee.to(torch.int32)
            L = L + torch.where((do_nee & visible)[..., None], beta * Ld, torch.zeros_like(Ld))
            pend = (st.sh_o, st.sh_d, st.sh_dist, st.ld_pend)

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

        if "bssrdf" in dev:
            (o, d, L, beta, alive, prev_p, prev_pdf, specular, nrays) = self._probe_wave(
                dev, px, py, s, salt, ray_time, it, mp, bs, cont, can_scatter,
                o, d, L, beta, alive, prev_p, prev_pdf, specular, nrays)

        # ---- null pass-through: not a bounce (path.cpp bounces--); d,
        # beta and the MIS state stay those of the last real vertex -------
        if is_null is not None:
            alive = alive | is_null
            o = torch.where(is_null[..., None], offset_ray_origin(it.p, it.ng, d), o)

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

        ctr = obs_counters.bounce_update(ctr, alive=st.alive, rays_before=nrays_in,
                                         rays_after=nrays)
        return LaneSt(o, d, L, beta, alive, depth, prev_pdf, specular, eta_scale,
                      prev_p, *pend), nrays, ctr

    def _probe_wave(self, dev, px, py, s, salt, ray_time, it, mp, bs, cont, can_scatter,
                    o, d, L, beta, alive, prev_p, prev_pdf, specular, nrays):
        """The BSSRDF probe wave (bssrdf.cpp Sample_S / Sample_Sp and
        path.cpp's BSSRDF block, as the reference lays them out), on a
        scene with a subsurface material. A lane whose interface sample
        was the smooth transmission into its subsurface material
        re-emerges at an exit vertex found by a probe chord: the chord's
        axis (the shading normal w.p. 1/2, each tangent 1/4) and channel
        come from dims salt + 12, 13, its radius from the baked diffusion
        CDF (salt + 14) and angle (salt + 15); the chord is traced as up
        to four closest-hit waves through the stream tracer, keeping one
        hit of the same material by reservoir selection (salt + 4000 + k).
        Beta gains Sp * nFound / Pdf_Sp (the 3 axes x 3 channels MIS) and
        the eta^2 of the exit crossing; the exit vertex adds its NEE under
        the Sw lobe (one any-hit shadow ray at the shutter start, as the
        reference traces it) and continues along a cosine sample weighted
        by Sw pi. The entry Fresnel rides the interface sample (the
        specular transmission's f cos / pdf is 1). Returns the updated
        lane state and ray counts."""
        from tpu_pbrt_torch.core import xla_math as xm
        from tpu_pbrt_torch.core.bssrdf import pdf_sp, sample_sr, sr_eval, sw_eval
        from tpu_pbrt_torch.core.sampling import cosine_sample_hemisphere
        from tpu_pbrt_torch.integrators.common import scene_intersect_p

        tab = dev["bssrdf"]
        sub = torch.clamp(mp.sub, min=0)
        sss = cont & (mp.sub >= 0) & bs.is_transmission
        ua = self.u1d(px, py, s, salt + 12)
        uc = self.u1d(px, py, s, salt + 13)
        ur = self.u1d(px, py, s, salt + 14)
        uphi = self.u1d(px, py, s, salt + 15)
        # the probe frame: the shading normal w.p. 1/2, ss and ts 1/4 each
        ax0 = (ua < 0.5)[..., None]
        ax1 = ((ua >= 0.5) & (ua < 0.75))[..., None]
        vz = torch.where(ax0, it.ns, torch.where(ax1, it.ss, it.ts))
        vx = torch.where(ax0, it.ss, torch.where(ax1, it.ts, it.ns))
        vy = torch.where(ax0, it.ts, torch.where(ax1, it.ns, it.ss))
        ch = torch.clamp((uc * 3.0).to(torch.int32), 0, 2)
        r_s = sample_sr(tab, sub, ch, ur)
        rmax = torch.gather(tab.r_max[sub.long()], 1, ch.long()[:, None])[:, 0]
        l_ch = 2.0 * xm.sqrt(torch.clamp(rmax * rmax - r_s * r_s, min=0.0))
        phi = 2.0 * np.pi * uphi
        start = (it.p + r_s[..., None] * (xm.cos(phi)[..., None] * vx + xm.sin(phi)[..., None] * vy)
                 + (0.5 * l_ch)[..., None] * vz)
        pdir = -vz
        ok_r = sss & (r_s < rmax) & (l_ch > 0.0)

        cur_o = start
        t_rem = torch.where(ok_r, l_ch, torch.full_like(l_ch, -1.0))
        n_found = torch.zeros_like(sub)
        sel_p, sel_ng, sel_ns, sel_ss, sel_ts = it.p, it.ng, it.ns, it.ss, it.ts
        sub_col = dev["mat"]["sub_id"]
        inf = torch.full_like(t_rem, float("inf"))
        for k in range(4):
            hitk = scene_intersect(dev, cur_o, pdir, t_rem, time=ray_time)
            itk = make_interaction(dev, hitk, cur_o, pdir)
            nrays = nrays + (t_rem > 0.0).to(torch.int32)
            m_sub = sub_col[itk.mat.long().clamp(0, sub_col.shape[0] - 1)]
            matchk = itk.valid & (m_sub == sub) & ok_r
            n_found = n_found + matchk.to(n_found.dtype)
            u_res = uniform_float(px, py, s, salt + 4000 + k)
            tk = (matchk & (u_res * n_found.to(torch.float32) < 1.0))[..., None]
            sel_p = torch.where(tk, itk.p, sel_p)
            sel_ng = torch.where(tk, itk.ng, sel_ng)
            sel_ns = torch.where(tk, itk.ns, sel_ns)
            sel_ss = torch.where(tk, itk.ss, sel_ss)
            sel_ts = torch.where(tk, itk.ts, sel_ts)
            adv = torch.where(itk.valid, hitk.t + 1e-4, inf)
            cur_o = cur_o + adv[..., None] * pdir
            t_rem = torch.where(itk.valid, t_rem - adv, torch.full_like(t_rem, -1.0))

        ok_exit = ok_r & (n_found > 0)
        dvec = sel_p - it.p
        dist = xm.sqrt(dvec[..., 0] * dvec[..., 0] + dvec[..., 1] * dvec[..., 1]
                       + dvec[..., 2] * dvec[..., 2])
        sp = sr_eval(tab, sub, dist)  # (R, 3)
        pdf_tot = pdf_sp(tab, sub, it.ss, it.ts, it.ns, dvec, sel_ns)
        ok_exit = ok_exit & (pdf_tot > 0.0) & (sp.amax(dim=-1) > 0.0)
        w_sss = sp * (n_found.to(torch.float32) / torch.clamp(pdf_tot, min=1e-20))[..., None]
        beta = torch.where(ok_exit[..., None], beta * w_sss, beta)
        # the exit crossing's eta^2 (the Sw adapter's radiance-mode factor),
        # once, so the NEE term and the continuation both carry it
        eta_sub = tab.eta[sub.long()]
        beta = torch.where(ok_exit[..., None], beta * (eta_sub * eta_sub)[..., None], beta)

        # ---- the exit vertex's NEE under the Sw lobe ---------------------
        ls2 = ld.sample_one_light(dev, self.light_distr, sel_p,
                                  uniform_float(px, py, s, salt + 4100),
                                  uniform_float(px, py, s, salt + 4101),
                                  uniform_float(px, py, s, salt + 4102))
        cos_l = dot(ls2.wi, sel_ns)
        f_sw = sw_eval(eta_sub, cos_l) * torch.clamp(cos_l, min=0.0)
        do2 = (ok_exit & can_scatter & (ls2.pdf > 0.0) & (cos_l > 1e-6)
               & (ls2.li.amax(dim=-1) > 0.0))
        occ2 = scene_intersect_p(dev, offset_ray_origin(sel_p, sel_ng, ls2.wi), ls2.wi,
                                 torch.where(do2, ls2.dist * 0.999, torch.full_like(ls2.dist, -1.0)))
        nrays = nrays + do2.to(torch.int32)
        pi32 = torch.full_like(cos_l, float(np.float32(np.pi)))
        w_l2 = torch.where(ls2.is_delta, torch.ones_like(cos_l),
                           power_heuristic(1.0, ls2.pdf, 1.0, cos_l / pi32))
        contrib = beta * f_sw[..., None] * ls2.li * (w_l2 / torch.clamp(ls2.pdf, min=1e-20))[..., None]
        L = L + torch.where((do2 & ~occ2)[..., None], contrib, torch.zeros_like(contrib))

        # ---- the cosine continuation from the exit: beta *= Sw pi --------
        wloc = cosine_sample_hemisphere(uniform_float(px, py, s, salt + 4103),
                                        uniform_float(px, py, s, salt + 4104))
        wi2 = normalize(wloc[..., 0:1] * sel_ss + wloc[..., 1:2] * sel_ts
                        + wloc[..., 2:3] * sel_ns)
        cos2 = torch.clamp(dot(wi2, sel_ns), min=1e-6)
        beta = torch.where(ok_exit[..., None], beta * (sw_eval(eta_sub, cos2) * np.pi)[..., None],
                           beta)
        ok3 = ok_exit[..., None]
        o = torch.where(ok3, offset_ray_origin(sel_p, sel_ng, wi2), o)
        d = torch.where(ok3, wi2, d)
        prev_p = torch.where(ok3, sel_p, prev_p)
        prev_pdf = torch.where(ok_exit, cos2 / pi32, prev_pdf)
        specular = specular & ~ok_exit
        alive = torch.where(sss, ok_exit, alive)
        return o, d, L, beta, alive, prev_p, prev_pdf, specular, nrays

    def _camera_footprint(self, dev, px, py, salt, depth, o, d, hit, it):
        """The (R, 4) uv footprint of the camera hits (camera.cpp
        GenerateRayDifferential + interaction.cpp ComputeDifferentials)
        at the pixel centres, 0 on other lanes; None when the scene has no
        texture or TORCH_PBRT_MIPFILTER is off. The fixed batch (an int
        salt) computes it at bounce 0 only, the pool every wave, masked
        to the lanes at depth 0."""
        from tpu_pbrt_torch.config import cfg

        if self.tex_eval is None or "tri_difT" not in dev or not cfg.mipfilter:
            return None
        if isinstance(salt, int) and salt // DIMS_PER_BOUNCE != 0:
            return torch.zeros(o.shape[:-1] + (4,), dtype=torch.float32, device=o.device)
        pf_c = torch.stack([px.to(torch.float32) + 0.5, py.to(torch.float32) + 0.5], dim=-1)
        dox, ddx, doy, ddy = ray_differentials(self.scene.camera, pf_c)
        w0 = texture_footprint(dev, hit.prim, it.p, it.ng, o, d, dox, ddx, doy, ddy)
        keep = it.valid if isinstance(salt, int) else it.valid & (depth == 0)
        return torch.where(keep[..., None], w0, torch.zeros_like(w0))

    # -- fixed-batch loop (TORCH_PBRT_REGEN=0) -------------------------------
    def li(self, dev, o, d, px, py, s):
        """Radiance of the camera rays (o, d) of work items (px, py, s):
        bounce waves until every lane is dead (and, fused, every pending
        shadow ray has settled), at most maxdepth + 1 (+ the null
        pass-through margin) waves, + 1 to settle the last shadow rays when
        fused. Returns (L (R, 3), per-lane traced-ray counts (R,))."""
        lane = fresh_lanes(o, d)
        nrays = torch.zeros(o.shape[:-1], dtype=torch.int32, device=o.device)
        fused = self.fused
        # motion blur: one shutter time per camera sample, kept along the
        # whole path (CameraSample::time); the keyframes are the shutter's
        # ends, so the normalized time is the sample itself
        ray_time = self.u1d(px, py, s, DIM_TIME) if "tri_verts1" in dev else None
        for bounce in range(self.max_depth + 1 + self.margin + int(fused)):
            live = lane.alive.any()
            if fused:
                live = live | (lane.sh_dist > 0.0).any()
            stream.WAVES.add_loop_read()
            if not bool(live):  # the loop test: one host read per wave
                break
            lane, nrays, _ = self._bounce_wave(
                dev, px, py, s, bounce * DIMS_PER_BOUNCE, lane, nrays, ray_time=ray_time
            )
        return lane.L, nrays

    # -- persistent wavefront: compaction + regeneration --------------------
    def pool_chunk(self, dev, fs, start_pix: int, start_s: int, n_work: int, pool: int,
                   film=None, cam=None, nan_wave: Optional[int] = None):
        """Drain work items [start, start + n_work) through a resident pool
        of `pool` path slots, one bounce per wave, depositing into the film
        state `fs` in place.

        Per wave: (1) COMPACT: one packed-int32 sort of (free << 30) | lane
        moves active lanes to a contiguous prefix, and every pool array is
        gathered by the recovered lane index; (2) REGENERATE: the free
        tail takes fresh camera rays from the chunk's work counter; (3) one
        `_bounce_wave`; (4) DEPOSIT: lanes that finished
        (dead, no pending shadow) add their L to the film and release
        their slot; while no more than `seg` lanes finish, one more sort
        moves them to a prefix and only that window is scattered. The
        exit test and the deposit's choice read three scalars in ONE host
        transfer per wave.

        Returns (fs, rays_traced, live_lane_waves, n_waves, truncated,
        counters): mean wave occupancy = live_lane_waves / (n_waves *
        pool); truncated is 1 if the max_waves safety bound stopped the
        drain with work outstanding (render() warns); counters is the
        WaveCounters block (None with telemetry killed).

        nan_wave is the chaos seam (`nan:wave`): on that wave (counted
        from 0; None or -1: none) every lane with work gets NaN radiance,
        which its deposit carries to the film firewall (scrubbed and
        counted)."""
        from tpu_pbrt_torch.config import cfg

        assert pool < (1 << _POOL_LANE_BITS)
        film = film if film is not None else self.scene.film
        cam = cam if cam is not None else self.scene.camera
        x0, x1, y0, y1 = film.sample_bounds()
        w = x1 - x0
        npix = w * (y1 - y0)
        spp = self.spp
        motion = "tri_verts1" in dev
        seg = int(cfg.deposit_seg)
        if seg == 0:
            seg = pool // 4 if pool >= 256 else pool
        if seg < 0 or seg > pool:
            seg = pool
        seg = max(seg, 1)
        # worst case: every refill round runs every lane to max_depth,
        # plus the shadow-settle wave (a safety bound only)
        max_waves = (n_work // pool + 2) * (self.max_depth + 2) + 8
        device = fs.rgb.device
        i32 = dict(dtype=torch.int32, device=device)
        lane_idx = torch.arange(pool, **i32)
        free_bit = 1 << _POOL_LANE_BITS
        lane_mask = free_bit - 1

        zero3 = torch.zeros((pool, 3), dtype=torch.float32, device=device)
        unit_d = torch.tensor([0.0, 0.0, 1.0], device=device).expand(pool, 3).contiguous()
        lane = fresh_lanes(zero3, unit_d)._replace(
            alive=torch.zeros((pool,), dtype=torch.bool, device=device))
        px = torch.zeros((pool,), **i32)
        py = torch.zeros((pool,), **i32)
        s = torch.zeros((pool,), **i32)
        wt = torch.zeros((pool,), dtype=torch.float32, device=device)
        tl = torch.zeros((pool,), dtype=torch.float32, device=device)  # lane shutter times
        has_work = torch.zeros((pool,), dtype=torch.bool, device=device)
        cursor = torch.zeros((), **i32)  # work items consumed so far
        nrays = torch.zeros((), dtype=torch.int64, device=device)
        live = torch.zeros((), dtype=torch.int64, device=device)
        ctr = obs_counters.maybe_zeros(device)
        waves = 0
        cursor_h, any_work = 0, False
        while (cursor_h < n_work or any_work) and waves < max_waves:
            # ---- compaction: ONE packed-i32 sort (keys are unique) -------
            key = torch.where(has_work, lane_idx, lane_idx + free_bit)
            perm = (torch.sort(key).values & lane_mask).long()
            lane = LaneSt(*(a[perm] for a in lane))
            px, py, s, wt, tl = px[perm], py[perm], s[perm], wt[perm], tl[perm]
            active = has_work[perm]
            n_live = active.sum(dtype=torch.int32)

            # ---- regeneration from the work counter ----------------------
            widx = cursor + (lane_idx - n_live)
            can = (~active) & (widx < n_work)
            valid, pxn, pyn, sn, _, o_n, d_n, wt_n = self.work_to_rays(
                cam, spp, x0, y0, w, npix, start_pix, start_s,
                torch.where(can, widx, torch.zeros_like(widx)),
            )
            can = can & valid
            lane = LaneSt(*(
                torch.where(can.reshape((pool,) + (1,) * (new.dim() - 1)), new, old)
                for new, old in zip(fresh_lanes(o_n, d_n), lane)
            ))
            px = torch.where(can, pxn, px)
            py = torch.where(can, pyn, py)
            s = torch.where(can, sn, s)
            wt = torch.where(can, wt_n, wt)
            if motion:
                # a regenerated lane draws its camera sample's time
                tl = torch.where(can, self.u1d(pxn, pyn, sn, DIM_TIME), tl)
            # the counter also consumes work items past the frame (the
            # final chunk's tail), which `valid` kept out of the pool
            consumed = torch.minimum(torch.clamp(n_work - cursor, min=0), pool - n_live)
            has_work = active | can
            live = live + lane.alive.sum()
            alive_pre = lane.alive

            # ---- one bounce wave ---------------------------------------
            lane, nray_d, ctr = self._bounce_wave(
                dev, px, py, s, lane.depth * DIMS_PER_BOUNCE, lane,
                torch.zeros((pool,), **i32), ctr=ctr, ray_time=tl if motion else None,
            )
            if nan_wave is not None and waves == nan_wave:
                lane = lane._replace(L=torch.where(has_work[..., None], float("nan"), lane.L))

            # ---- scatter-on-terminate film deposit ----------------------
            done = has_work & ~lane.alive & ~(lane.sh_dist > 0.0)
            n_done = done.sum(dtype=torch.int32)
            ctr = obs_counters.pool_update(
                ctr,
                regenerated=can.sum(dtype=torch.int32),
                terminated=(alive_pre & ~lane.alive).sum(dtype=torch.int32),
                deposits=n_done,
                compacted=(active & (perm != lane_idx)).sum(dtype=torch.int32),
                nonfinite=(done & nonfinite_mask(lane.L)).sum(dtype=torch.int32),
            )
            cursor = cursor + consumed
            has_work_next = has_work & ~done
            nrays = nrays + nray_d.sum()
            waves += 1
            # the wave's one host read: the deposit's width and the exit test
            n_done_h, cursor_h, any_work = torch.stack(
                [n_done, cursor, has_work_next.any().to(torch.int32)]).tolist()
            stream.WAVES.add_loop_read()
            if n_done_h:
                self._pool_deposit(film, fs, px, py, s, lane.L, wt, done,
                                   seg if n_done_h <= seg < pool else pool, lane_idx)
            has_work = has_work_next
        truncated = int(cursor_h < n_work or bool(any_work))
        return fs, nrays, live, waves, truncated, ctr

    def _pool_deposit(self, film, fs, px, py, s, L, wt, done, seg: int, lane_idx):
        """Deposit the lanes marked `done`. With seg < pool (at most seg of
        them) one packed-i32 sort moves them to a prefix, stable on lane
        index so they land in the full-width scatter's relative order,
        and only that seg-wide window is scattered."""
        if seg < done.shape[0]:
            free_bit = 1 << _POOL_LANE_BITS
            dkey = torch.where(done, lane_idx, lane_idx + free_bit)
            dperm = (torch.sort(dkey).values[:seg] & (free_bit - 1)).long()
            px, py, s, L, wt, done = px[dperm], py[dperm], s[dperm], L[dperm], wt[dperm], done[dperm]
        if film.pixel_deposit_ok():
            film.add_samples_pixel(fs, px, py, L, done, wt)
            return
        # general filter footprint: the film jitter is a pure function of
        # the work item, recomputed here instead of carried
        fx, fy = self.film_jitter(px, py, s)
        p_film = torch.stack([px.to(torch.float32) + fx, py.to(torch.float32) + fy], dim=-1)
        film.add_samples(fs, torch.where(done[..., None], p_film, torch.full_like(p_film, -1e6)),
                         L, wt)
