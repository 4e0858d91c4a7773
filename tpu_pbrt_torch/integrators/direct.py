"""DirectLightingIntegrator (port of tpu_pbrt/integrators/direct.py).

pbrt-v3 DirectLightingIntegrator as a fixed-batch wavefront: at every
vertex, direct lighting by `estimate_direct` (strategy "all": every light
row in turn; "one": one light picked through the light distribution),
and the path continues only through specular bounces (SpecularReflect /
SpecularTransmit), up to maxdepth vertices.

The reference traces all maxdepth bounces on every lane, a dead lane
re-tracing its last ray with every term masked out. The port stops once
no lane is alive (one host read per bounce): those bounces add nothing
to the image or the ray count.
"""

from __future__ import annotations

import torch

from tpu_pbrt_torch.accel import stream
from tpu_pbrt_torch.core import bxdf
from tpu_pbrt_torch.core import lights_dev as ld
from tpu_pbrt_torch.core.vecmath import dot, normalize, offset_ray_origin, to_local, to_world
from tpu_pbrt_torch.integrators.common import (
    DIM_BSDF_LOBE,
    DIM_BSDF_UV,
    DIM_MIX,
    DIMS_PER_BOUNCE,
    WavefrontIntegrator,
    estimate_direct,
    make_interaction,
    scene_intersect,
)
from tpu_pbrt_torch.utils.error import Warning

#: "all" samples every light at each vertex up to this many lights
_MAX_ALL_LIGHTS = 16


class DirectLightingIntegrator(WavefrontIntegrator):
    name = "directlighting"

    def __init__(self, params, scene, options):
        super().__init__(params, scene, options)
        self.max_depth = params.find_one_int("maxdepth", 5)
        strategy = params.find_one_string("strategy", "all")
        if strategy not in ("all", "one"):
            Warning(f'Strategy "{strategy}" for direct lighting unknown. Using "all".')
            strategy = "all"
        self.set_strategy(strategy)

    def set_strategy(self, strategy: str):
        """Keeps the strategy and the number of light rows looped per vertex
        in sync ("all" over more than 16 lights falls back to "one")."""
        self.strategy = strategy
        if strategy == "all" and self.scene.n_lights > _MAX_ALL_LIGHTS:
            Warning(
                f"UniformSampleAll over {self.scene.n_lights} lights would unroll "
                f"{self.scene.n_lights} NEE taps; falling back to one-light sampling."
            )
            self.strategy = "one"
        self.n_light_loop = self.scene.n_lights if self.strategy == "all" else 1

    def li(self, dev, o, d, px, py, s):
        """Radiance of the camera rays (o, d) of work items (px, py, s) and
        the per-lane traced-ray counts: one ray per live vertex, and a
        shadow ray plus a BSDF ray per valid vertex and light sample."""
        shape = o.shape[:-1]
        L = torch.zeros(shape + (3,), dtype=torch.float32, device=o.device)
        beta = torch.ones_like(L)
        alive = torch.ones(shape, dtype=torch.bool, device=o.device)
        nrays = torch.zeros(shape, dtype=torch.int32, device=o.device)
        sampler = (self.skind, self.spp)

        for depth in range(self.max_depth):
            if depth > 0:
                stream.WAVES.add_loop_read()
                if not bool(alive.any()):  # the loop test: one host read per bounce
                    break
            hit = scene_intersect(dev, o, d, float("inf"))
            nrays = nrays + alive.to(torch.int32)
            it = make_interaction(dev, hit, o, d)
            it.valid = it.valid & alive
            miss = alive & (hit.prim < 0)
            if "envmap" in dev:
                le_env = ld.env_lookup(dev, d)
                L = L + torch.where(miss[..., None], beta * le_env, torch.zeros_like(le_env))
            # emission at the hit (camera and specular paths see emitters)
            le = ld.emitted_radiance(
                dev, torch.where(it.valid, it.light, torch.full_like(it.light, -1)), it.wo, it.ng)
            L = L + beta * le

            u_mix = (self.u1d(px, py, s, depth * 2000 + DIM_MIX) if "mix_a" in dev["mat"]
                     else None)
            mp = self.mat_at(dev, it, u_mix=u_mix)
            two = 2 * it.valid.to(torch.int32)
            if self.strategy == "all":
                for li_i in range(self.n_light_loop):
                    idx = torch.full(shape, li_i, dtype=torch.int32, device=o.device)
                    Ld = estimate_direct(dev, self.light_distr, it, mp, px, py, s, depth,
                                         light_idx=idx, salt_extra=li_i * 1000,
                                         vis_segments=self.vis_segments, sampler=sampler)
                    L = L + torch.where(it.valid[..., None], beta * Ld, torch.zeros_like(Ld))
                    nrays = nrays + two
            else:
                Ld = estimate_direct(dev, self.light_distr, it, mp, px, py, s, depth,
                                     vis_segments=self.vis_segments, sampler=sampler)
                L = L + torch.where(it.valid[..., None], beta * Ld, torch.zeros_like(Ld))
                nrays = nrays + two

            if depth + 1 >= self.max_depth:
                break
            # specular continuation only: non-specular paths stop here
            salt = depth * DIMS_PER_BOUNCE
            wo_l = to_local(it.wo, it.ss, it.ts, it.ns)
            ul = self.u1d(px, py, s, salt + DIM_BSDF_LOBE + 77)
            u1, u2 = self.u2d(px, py, s, salt + DIM_BSDF_UV + 77)
            bs = bxdf.bsdf_sample(mp, wo_l, ul, u1, u2)
            cont = it.valid & bs.is_specular & (bs.pdf > 0.0)
            wi_w = normalize(to_world(bs.wi, it.ss, it.ts, it.ns))
            beta = torch.where(
                cont[..., None],
                beta * bs.f * (torch.abs(dot(wi_w, it.ns))
                               / torch.clamp(bs.pdf, min=1e-20))[..., None],
                beta,
            )
            o = torch.where(cont[..., None], offset_ray_origin(it.p, it.ng, wi_w), o)
            d = torch.where(cont[..., None], wi_w, d)
            alive = cont
        return L, nrays
