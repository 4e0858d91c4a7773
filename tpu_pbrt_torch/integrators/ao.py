"""AOIntegrator — ambient occlusion (port of tpu_pbrt/integrators/ao.py).

One occlusion ray per camera sample: a cosine- or uniform-weighted
hemisphere direction about the shading normal, flipped to the viewer's
side, traced as an any-hit ray up to `maxdistance`."""

from __future__ import annotations

import numpy as np
import torch

from tpu_pbrt_torch.core.sampling import (
    UNIFORM_HEMISPHERE_PDF,
    cosine_hemisphere_pdf,
    cosine_sample_hemisphere,
    uniform_float,
    uniform_sample_hemisphere,
)
from tpu_pbrt_torch.core.vecmath import dot, offset_ray_origin, to_world
from tpu_pbrt_torch.integrators.common import (
    DIM_BSDF_UV,
    WavefrontIntegrator,
    make_interaction,
    scene_intersect,
    scene_intersect_p,
)


class AOIntegrator(WavefrontIntegrator):
    name = "ao"

    def __init__(self, params, scene, options):
        super().__init__(params, scene, options)
        self.cos_sample = params.find_one_bool("cossample", True)
        self.max_dist = params.find_one_float("maxdistance", float("inf"))

    def li(self, dev, o, d, px, py, s):
        hit = scene_intersect(dev, o, d, float("inf"))
        it = make_interaction(dev, hit, o, d)
        nrays = torch.ones(o.shape[:-1], dtype=torch.int32, device=o.device)

        u1 = uniform_float(px, py, s, DIM_BSDF_UV)
        u2 = uniform_float(px, py, s, DIM_BSDF_UV + 100)
        if self.cos_sample:
            w_local = cosine_sample_hemisphere(u1, u2)
            pdf = cosine_hemisphere_pdf(w_local[..., 2])
        else:
            w_local = uniform_sample_hemisphere(u1, u2)
            pdf = torch.full(u1.shape, UNIFORM_HEMISPHERE_PDF, dtype=torch.float32,
                             device=u1.device)
        # flip into the hemisphere facing the viewer (ao.cpp)
        wi = to_world(w_local, it.ss, it.ts, it.ns)
        flip = dot(wi, it.ns) * dot(it.wo, it.ns) < 0.0
        wi = torch.where(flip[..., None], -wi, wi)
        o_sh = offset_ray_origin(it.p, it.ng, wi)
        occluded = scene_intersect_p(dev, o_sh, wi, self.max_dist)
        nrays = nrays + it.valid.to(torch.int32)
        cos_w = torch.abs(dot(wi, it.ns))
        val = torch.where(it.valid & ~occluded & (pdf > 0),
                          cos_w / torch.clamp(pdf, min=1e-20) / np.pi, torch.zeros_like(cos_w))
        return val[..., None].expand(val.shape + (3,)).contiguous(), nrays
