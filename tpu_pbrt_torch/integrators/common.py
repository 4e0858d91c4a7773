"""Shared wavefront-integrator machinery (port of tpu_pbrt/integrators/common.py).

- Scene::Intersect / IntersectP dispatch to the stream tracer (or the
  brute feature product for scenes of at most BRUTE_MAX_TRIS triangles);
- the single-segment visibility test of the path integrator's NEE;
- SurfaceInteraction construction from a Hit;
- the fixed-batch render loop: the image x spp work domain is cut into
  chunks of camera rays; each chunk generates its rays, runs the
  integrator's `li` to completion and deposits into the film.

Every sampler dimension is a pure function of (px, py, s, dimension
salt), so the port draws the reference's sample streams.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict

import numpy as np
import torch

from tpu_pbrt_torch.accel.traverse import Hit
from tpu_pbrt_torch.cameras import generate_rays
from tpu_pbrt_torch.config import cfg
from tpu_pbrt_torch.core import bxdf
from tpu_pbrt_torch.core.sampling import (
    hash_u32,
    normalize_sampler_name,
    sample_1d,
    sample_2d,
    sobol_2d,
)
from tpu_pbrt_torch.core.vecmath import coordinate_system, cross, dot, face_forward, normalize

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


def scene_intersect_p(dev, o, d, t_max):
    """Scene::IntersectP — shadow-ray predicate."""
    if "tstream" in dev:
        from tpu_pbrt_torch.accel.stream import stream_intersect_p

        return stream_intersect_p(dev["tstream"], o, d, t_max)
    return scene_intersect(dev, o, d, t_max).prim >= 0


def unoccluded_tr(dev, o, d, dist):
    """VisibilityTester::Unoccluded for one segment (no null interfaces,
    no media): is the light sample visible? The segment stops at 0.999 of
    the light distance, as the reference's."""
    remaining = torch.broadcast_to(dist, o.shape[:-1]) * 0.999
    return ~scene_intersect_p(dev, o, d, remaining)


@dataclass
class RenderResult:
    image: np.ndarray
    film_state: Any
    seconds: float
    rays_traced: int
    mray_per_sec: float
    spp: int
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
    sh = dev["tri_sh16"][:, prim]  # (16, R): normals, uvs, packed ids
    shT = sh.T
    tn = shT[..., 0:9].reshape(shT.shape[:-1] + (3, 3))
    tuv = shT[..., 9:15].reshape(shT.shape[:-1] + (3, 2))
    packed = sh[15].to(torch.int32)
    mat_id = packed // 4096
    light_id = packed % 4096 - 1
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


def textured_mat(dev, mid) -> bxdf.MatParams:
    """Material::ComputeScatteringFunctions on the constant-parameter path:
    the compiled material rows (textures are not ported; the compiler
    rejects them)."""
    return bxdf.gather_mat(dev["mat"], mid)


class WavefrontIntegrator:
    """Base class: the fixed-batch chunked render loop."""

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
        self.skind = normalize_sampler_name(scene.sampler.name)
        self.spp = int(scene.sampler.spp)

    def u1d(self, px, py, s, salt):
        return sample_1d(self.skind, self.spp, px, py, s, salt)

    def u2d(self, px, py, s, salt):
        return sample_2d(self.skind, self.spp, px, py, s, salt)

    def film_jitter(self, px, py, s):
        """In-pixel film sample offset of sample s of pixel (px, py): the
        per-pixel scrambled (0,2)-sequence."""
        return sobol_2d(s, hash_u32(px, py, 0x11), hash_u32(px, py, 0x22))

    def work_to_rays(self, cam, spp, x0, y0, w, npix, start_pix, start_s, k):
        """Flat work offsets k (R,) -> camera rays. The range start is
        carried as (start_pix, start_s) so the arithmetic stays in int32."""
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

    def mat_at(self, dev, it) -> bxdf.MatParams:
        return textured_mat(dev, it.mat)

    def li(self, dev, o, d, px, py, s):
        raise NotImplementedError

    def prepare_chunks(self, scene=None, chunk=None) -> dict:
        """The chunk decomposition of the work domain (pixel-major, spp
        consecutive samples per pixel)."""
        scene = scene or self.scene
        film = scene.film
        x0, x1, y0, y1 = film.sample_bounds()
        w = x1 - x0
        npix = w * (y1 - y0)
        spp = scene.sampler.spp
        total = npix * spp
        if chunk is None:
            default = GPU_CHUNK if scene.device.type == "cuda" else CPU_CHUNK
            chunk = int(cfg.chunk if cfg.chunk is not None else default)
        chunk = max(min(int(chunk), max(1024, total)), 1)
        return {
            "chunk": chunk, "n_chunks": (total + chunk - 1) // chunk,
            "spp": spp, "total": total, "npix": npix, "bounds": (x0, x1, y0, y1),
        }

    def render(self, scene=None, chunk=None) -> RenderResult:
        """SamplerIntegrator::Render: every chunk of camera rays through
        `li`, deposited into the film; returns the developed image, the
        rays traced and the wall time (synchronized with the device)."""
        from tpu_pbrt_torch.accel import stream

        scene = scene or self.scene
        plan = self.prepare_chunks(scene, chunk)
        film, cam, dev, device = scene.film, scene.camera, scene.dev, scene.device
        chunk, spp, npix = plan["chunk"], plan["spp"], plan["npix"]
        x0, _, y0, _ = plan["bounds"]
        w = plan["bounds"][1] - x0
        state = film.init_state(device)
        box_fast = film.pixel_deposit_ok()
        prev_det = torch.are_deterministic_algorithms_enabled()
        prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
        if device.type == "cuda":
            # the film's scatter-adds accumulate in a fixed order
            torch.use_deterministic_algorithms(True, warn_only=True)
        stream.WAVES.reset()
        rays = torch.zeros((), dtype=torch.int64, device=device)
        try:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            k = torch.arange(chunk, dtype=torch.int32, device=device)
            for c in range(plan["n_chunks"]):
                start_pix, start_s = divmod(c * chunk, spp)
                valid, px, py, s, p_film, o, d, wt = self.work_to_rays(
                    cam, spp, x0, y0, w, npix, start_pix, start_s, k
                )
                L, nrays = self.li(dev, o, d, px, py, s)
                rays += torch.where(valid, nrays, torch.zeros_like(nrays)).sum()
                if box_fast:
                    film.add_samples_pixel(state, px, py, L, valid, wt)
                else:
                    p_film = torch.where(valid[..., None], p_film,
                                         torch.full_like(p_film, -1e6))
                    film.add_samples(state, p_film, L, wt)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            secs = time.perf_counter() - t0
        finally:
            torch.use_deterministic_algorithms(prev_det, warn_only=prev_warn)
        img = film.develop(state)
        n_rays = int(rays)
        waves = stream.WAVES
        per_wave = max(waves.waves, 1)
        stats = {
            "chunks": plan["n_chunks"],
            "chunk": chunk,
            "waves": waves.waves,
            "iters_per_wave_mean": waves.iters / per_wave,
            "iters_per_wave_max": waves.iters_max,
            "host_reads_per_wave_mean": waves.host_reads / per_wave,
        }
        return RenderResult(
            image=img, film_state=state, seconds=secs, rays_traced=n_rays,
            mray_per_sec=n_rays / max(secs, 1e-9) / 1e6, spp=spp, stats=stats,
        )
