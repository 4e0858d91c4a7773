"""SPPMIntegrator — stochastic progressive photon mapping (port of
tpu_pbrt/integrators/sppm.py), on one device.

pbrt-v3 SPPMIntegrator::Render: per iteration, a camera pass storing one
visible point per pixel (with the direct light of every real vertex by
UniformSampleOneLight), a photon pass of Light::Sample_Le random walks
(closest-hit waves whose rays leave the lights), the gather of each
visible point's photons within its radius, the progressive radius/flux
update (gamma = 2/3) and the final estimate
L = Ld / N_iter + tau / (N_iter * photonsPerIteration * pi * r^2).

pbrt's hash grid of atomic linked lists is the reference's sort-by-cell:
photon deposits are sorted by their integer cell (a stable sort), each
visible point finds the runs of the (up to) 8 cells its radius box
overlaps with searchsorted, and scans them in `scancap`-photon chunks
until every run is exhausted (nothing is dropped: `photons_dropped` is
always 0). Flux sums per visible point run over a fixed slot order, so
the counts match the reference exactly and the flux to f32 summation
order.

The reference's depth loops run every depth whatever their lanes; the
port stops a pass once none of its lanes is alive (one host read per
depth), which changes nothing: the depths left out would add zeros.

Over a mesh (parallel/mesh.py, the reference's `_mesh_iteration`) the
pixels and the photons shard over the ranks: rank i holds a contiguous
slice of the pixels (padded with copies of pixel 0 to a multiple of the
ranks, dropped at develop time) and traces photons [i * npd, (i + 1) *
npd) by their global ids; the deposits are all-gathered in rank order,
which is the one-device order, the largest radius is a max all-reduce
and the rays a sum. The grid is the one-device render's (the scene's
vertex bounds widened by the global largest radius), so the mesh render
equals it where the photon count divides over the ranks.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from tpu_pbrt_torch.accel import stream
from tpu_pbrt_torch.cameras import generate_rays
from tpu_pbrt_torch.core import bxdf
from tpu_pbrt_torch.core import lights_dev as ld
from tpu_pbrt_torch.core.sampling import hash_u32, sobol_2d, uniform_float
from tpu_pbrt_torch.core.vecmath import dot, normalize, offset_ray_origin, to_local, to_world
from tpu_pbrt_torch.core.xla_math import sqrt as _sqrt
from tpu_pbrt_torch.integrators.common import (
    DIM_LENS,
    DIM_MIX,
    DIMS_PER_BOUNCE,
    Interaction,
    RenderResult,
    WavefrontIntegrator,
    estimate_direct,
    make_interaction,
    scene_intersect,
    textured_mat,
)
from tpu_pbrt_torch.utils.error import Warning

# sampler-dimension salt bases of the two SPPM streams
_SALT_CAM = 12001
_SALT_PHOTON = 24001

#: progressive radius shrink parameter (sppm.cpp gamma)
_GAMMA = 2.0 / 3.0
#: the gather grid's resolution per axis (64^3 cells, ids below 2^31)
_GRES = (64, 64, 64)


def _where(mask, a, b):
    """torch.where with a (R,) mask over (R, 3) values."""
    return torch.where(mask[..., None], a, b)


class _VisiblePoints(NamedTuple):
    """SoA per-pixel visible points of one iteration (sppm.h VisiblePoint)."""

    p: torch.Tensor  # (P,3)
    wo: torch.Tensor  # (P,3) world
    ns: torch.Tensor  # (P,3) shading frame
    ss: torch.Tensor
    ts: torch.Tensor
    beta: torch.Tensor  # (P,3)
    uv: torch.Tensor  # (P,2)
    mat: torch.Tensor  # (P,) material row, -1: no visible point this iteration
    ld: torch.Tensor  # (P,3) this iteration's direct and emitted radiance


class _SPPMState(NamedTuple):
    """Per-pixel state across iterations (sppm.h SPPMPixel)."""

    r2: torch.Tensor  # (P,) search radius^2
    n: torch.Tensor  # (P,) accumulated photon count (gamma-weighted)
    tau: torch.Tensor  # (P,3) accumulated flux
    ld: torch.Tensor  # (P,3) accumulated direct radiance


class SPPMIntegrator(WavefrontIntegrator):
    name = "sppm"
    rays_per_camera_ray = 3.0

    def __init__(self, params, scene, options):
        super().__init__(params, scene, options)
        self.max_depth = params.find_one_int("maxdepth", 5)
        self.n_iterations = params.find_one_int("numiterations", 64)
        self.photons_per_iter = params.find_one_int("photonsperiteration", -1)
        self.initial_radius = params.find_one_float("radius", 1.0)
        #: photons per gather chunk: a width / iterations trade, not a bound
        self.scan_cap = params.find_one_int("scancap", 32)
        if scene.has_null_materials:
            Warning("sppm: null-interface materials are traversed as opaque")

    # ------------------------------------------------------------------
    def _camera_pass(self, dev, px, py, it_idx: int):
        """One visible point per pixel (sppm.cpp "Generate SPPM visible
        points"): the first diffuse vertex (or glossy at the last depth)
        along a BSDF-sampled camera path, with every real vertex's direct
        light and emission. Returns (_VisiblePoints, rays traced)."""
        cam = self.scene.camera
        shape = px.shape
        dv = px.device
        s = torch.full(shape, it_idx, dtype=torch.int32, device=dv)
        fx, fy = sobol_2d(s, hash_u32(px, py, 0x31), hash_u32(px, py, 0x42))
        p_film = torch.stack([px.to(torch.float32) + fx, py.to(torch.float32) + fy], dim=-1)
        u_lens = torch.stack([uniform_float(px, py, s, _SALT_CAM + DIM_LENS),
                              uniform_float(px, py, s, _SALT_CAM + DIM_LENS + 1)], dim=-1)
        o, d, wt = generate_rays(cam, p_film, u_lens)
        beta = torch.broadcast_to(wt[..., None], shape + (3,)).to(torch.float32)

        z3 = torch.zeros(shape + (3,), dtype=torch.float32, device=dv)
        ld_acc, vp_p, vp_wo, vp_ns, vp_ss, vp_ts, vp_beta = (z3,) * 7
        vp_uv = torch.zeros(shape + (2,), dtype=torch.float32, device=dv)
        vp_mat = torch.full(shape, -1, dtype=torch.int32, device=dv)
        alive = torch.ones(shape, dtype=torch.bool, device=dv)
        specular = torch.ones(shape, dtype=torch.bool, device=dv)  # the first hit counts
        nrays = torch.zeros((), dtype=torch.int64, device=dv)
        inf = torch.full(shape, float("inf"), dtype=torch.float32, device=dv)
        for depth in range(self.max_depth):
            if depth:
                stream.WAVES.add_loop_read()
                if not bool(alive.any()):
                    break
            salt = _SALT_CAM + depth * DIMS_PER_BOUNCE
            hit = scene_intersect(dev, o, d, torch.where(alive, inf, -1.0))
            nrays = nrays + alive.sum()
            it = make_interaction(dev, hit, o, d)
            found = alive & it.valid
            # escaped rays: the environment (specular chains and first hits)
            if "envmap" in dev:
                miss = alive & (hit.prim < 0) & specular
                ld_acc = ld_acc + _where(miss, beta * ld.env_lookup(dev, d), 0.0)
            le = ld.emitted_radiance(dev, torch.where(found, it.light, -1), it.wo, it.ng)
            ld_acc = ld_acc + _where(found & specular, beta * le, 0.0)
            u_mix = (uniform_float(px, py, s, salt + DIM_MIX) if "mix_a" in dev["mat"]
                     else None)
            mp = self.mat_at(dev, it, u_mix=u_mix)
            # direct light at every real vertex (pixel.Ld); the sample index
            # is the iteration, so the sampler's domain is the iteration count
            it_masked = Interaction(it.p, it.ng, it.ns, it.ss, it.ts, it.uv, it.mat, it.light,
                                    it.wo, found)
            ld_acc = ld_acc + beta * estimate_direct(
                dev, self.light_distr, it_masked, mp, px, py, s, depth,
                salt_extra=_SALT_CAM + 500, vis_segments=self.vis_segments,
                sampler=(self.skind, self.n_iterations),
            )
            nrays = nrays + 2 * found.sum()
            has_diffuse, has_glossy, _ = bxdf._lobe_flags(mp)
            store = found & (has_diffuse | (has_glossy & (depth == self.max_depth - 1)))
            vp_p = _where(store, it.p, vp_p)
            vp_wo = _where(store, it.wo, vp_wo)
            vp_ns = _where(store, it.ns, vp_ns)
            vp_ss = _where(store, it.ss, vp_ss)
            vp_ts = _where(store, it.ts, vp_ts)
            vp_beta = _where(store, beta, vp_beta)
            vp_uv = _where(store, it.uv, vp_uv)
            vp_mat = torch.where(store, it.mat, vp_mat)
            alive = found & ~store
            # continue by BSDF sampling (specular and glossy chains)
            wo_l = to_local(it.wo, it.ss, it.ts, it.ns)
            bs = bxdf.bsdf_sample(mp, wo_l, uniform_float(px, py, s, salt + 7),
                                  uniform_float(px, py, s, salt + 8),
                                  uniform_float(px, py, s, salt + 9))
            wi_w = normalize(to_world(bs.wi, it.ss, it.ts, it.ns))
            cont = alive & (bs.pdf > 0.0) & (bs.f.amax(dim=-1) > 0.0)
            thr = bs.f * (torch.abs(dot(wi_w, it.ns)) / torch.clamp(bs.pdf, min=1e-20))[..., None]
            beta = _where(cont, beta * thr, beta)
            specular = bs.is_specular
            o = _where(cont, offset_ray_origin(it.p, it.ng, wi_w), o)
            d = _where(cont, wi_w, d)
            alive = cont & (depth < self.max_depth - 1)
        return _VisiblePoints(vp_p, vp_wo, vp_ns, vp_ss, vp_ts, vp_beta, vp_uv, vp_mat,
                              ld_acc), nrays

    # ------------------------------------------------------------------
    def _photon_pass(self, dev, n_photons: int, it_idx: int, pid0: int = 0):
        """Trace n_photons light subpaths (sppm.cpp "Trace photons and
        accumulate contributions"): deposits of shape (n_photons *
        max_depth,) — position, the photon's travel direction, beta,
        valid. Depth 0 deposits nothing (the camera pass's direct light
        covers it). pid0 offsets the photons' stream ids."""
        dv = dev["tri_verts"].device
        pid = pid0 + torch.arange(n_photons, dtype=torch.int32, device=dv)
        py = torch.full((n_photons,), 0x5995 + it_idx, dtype=torch.int32, device=dv)
        s = torch.full((n_photons,), it_idx, dtype=torch.int32, device=dv)

        def u(salt):
            return uniform_float(pid, py, s, _SALT_PHOTON + salt)

        les = ld.sample_le(dev, self.scene.light_distr, u(0), u(1), u(2), u(3), u(4))
        cos0 = torch.where(les.is_delta, 1.0, torch.abs(dot(les.n, les.d)))
        denom = torch.clamp(les.pmf * les.pdf_pos * les.pdf_dir, min=1e-20)
        beta = les.le * (cos0 / denom)[..., None]
        alive = les.supported & (beta.amax(dim=-1) > 0.0)
        o = _where(les.is_delta, les.p, offset_ray_origin(les.p, les.n, les.d))
        d = les.d

        D = self.max_depth
        dep_p = torch.zeros((n_photons, D, 3), dtype=torch.float32, device=dv)
        dep_d = torch.zeros((n_photons, D, 3), dtype=torch.float32, device=dv)
        dep_beta = torch.zeros((n_photons, D, 3), dtype=torch.float32, device=dv)
        dep_valid = torch.zeros((n_photons, D), dtype=torch.bool, device=dv)
        nrays = torch.zeros((), dtype=torch.int64, device=dv)
        inf = torch.full((n_photons,), float("inf"), dtype=torch.float32, device=dv)
        for depth in range(D):
            if depth:
                stream.WAVES.add_loop_read()
                if not bool(alive.any()):
                    break
            salt = 100 + depth * DIMS_PER_BOUNCE
            hit = scene_intersect(dev, o, d, torch.where(alive, inf, -1.0))
            nrays = nrays + alive.sum()
            it = make_interaction(dev, hit, o, d)
            found = alive & it.valid
            dep_found = found & (depth > 0)
            dep_p[:, depth] = _where(dep_found, it.p, 0.0)
            dep_d[:, depth] = d
            dep_beta[:, depth] = _where(dep_found, beta, 0.0)
            dep_valid[:, depth] = dep_found
            mp = self.mat_at(dev, it, u_mix=u(salt + DIM_MIX) if "mix_a" in dev["mat"] else None)
            wo_l = to_local(it.wo, it.ss, it.ts, it.ns)
            bs = bxdf.bsdf_sample(mp, wo_l, u(salt + 7), u(salt + 8), u(salt + 9))
            wi_w = normalize(to_world(bs.wi, it.ss, it.ts, it.ns))
            cont = found & (bs.pdf > 0.0) & (bs.f.amax(dim=-1) > 0.0)
            # importance transport: the shading-normal correction
            num = torch.abs(dot(it.wo, it.ns)) * torch.abs(dot(wi_w, it.ng))
            den = torch.clamp(torch.abs(dot(it.wo, it.ng)) * torch.abs(dot(wi_w, it.ns)),
                              min=1e-9)
            thr = bs.f * (torch.abs(dot(wi_w, it.ns)) / torch.clamp(bs.pdf, min=1e-20))[..., None]
            beta_new = beta * thr * (num / den)[..., None]
            # Russian roulette on the throughput ratio (sppm.cpp's photon RR)
            by = beta.amax(dim=-1)
            bny = beta_new.amax(dim=-1)
            q = torch.clamp(1.0 - bny / torch.clamp(by, min=1e-20), min=0.0)
            survive = u(salt + 10) >= q
            beta = _where(cont & survive, beta_new / torch.clamp(1.0 - q, min=1e-6)[..., None],
                          beta_new)
            alive = cont & survive
            o = _where(alive, offset_ray_origin(it.p, it.ng, wi_w), o)
            d = _where(alive, wi_w, d)
        return (dep_p.reshape(-1, 3), dep_d.reshape(-1, 3), dep_beta.reshape(-1, 3),
                dep_valid.reshape(-1), nrays)

    # ------------------------------------------------------------------
    def _gather(self, dev, vps: _VisiblePoints, dep_p, dep_d, dep_beta, dep_valid, r2, lo, cs,
                gres):
        """Photons within each visible point's radius: (phi (P,3), m (P,)).
        lo / cs / gres define the grid: cell = floor((p - lo) / cs), linear
        id x + gx * (y + gy * z). Deposits are sorted by cell (stably),
        each visible point's 8 overlapped cells are found by searchsorted,
        and their runs are scanned in scan_cap-photon chunks until every
        run is exhausted (one host read per chunk)."""
        K = self.scan_cap
        P = vps.p.shape[0]
        n_dep = dep_p.shape[0]
        gx, gy, gz = gres
        dv = vps.p.device
        hi = torch.tensor([gx - 1, gy - 1, gz - 1], dtype=torch.int64, device=dv)

        def cells(q):
            # f32 -> int saturates like XLA's convert (NaN of a dead lane -> 0)
            c = torch.floor(q / cs)
            return torch.nan_to_num(c, nan=0.0).clamp(-2.0**31, 2.0**31 - 1).to(torch.int64)

        n_cells = gx * gy * gz
        c = torch.minimum(torch.clamp(cells(dep_p - lo), min=0), hi)
        dcell = torch.where(dep_valid, c[..., 0] + gx * (c[..., 1] + gy * c[..., 2]), n_cells)
        dcell_s, order = torch.sort(dcell, stable=True)
        dp_s = dep_p[order]
        dd_s = dep_d[order]
        db_s = dep_beta[order]

        has_vp = vps.mat >= 0
        r = _sqrt(r2)
        base = cells(vps.p - lo - r[..., None])
        # the visible point's stored (unresolved) material, textured at its
        # uv and position, as the reference gathers it
        mp_vp = textured_mat(dev, vps.mat.clamp(min=0), vps.uv, vps.p, self.tex_eval,
                             self.tex_used, slot_ids=self.tex_slot_ids)
        wo_l = to_local(vps.wo, vps.ss, vps.ts, vps.ns)

        # the 8 overlapped cells' run windows: starts / ends (P, 8)
        starts, ends = [], []
        for ox in (0, 1):
            for oy in (0, 1):
                for oz in (0, 1):
                    cc = base + torch.tensor([ox, oy, oz], dtype=torch.int64, device=dv)
                    inb = ((cc >= 0) & (cc < hi + 1)).all(dim=-1)
                    use = has_vp & inb
                    cid = torch.where(use, cc[..., 0] + gx * (cc[..., 1] + gy * cc[..., 2]),
                                      n_cells)
                    st = torch.searchsorted(dcell_s, cid)
                    en = torch.searchsorted(dcell_s, cid, right=True)
                    # a lane without a visible point or an out-of-grid cell
                    # scans nothing (the n_cells run is the invalid tail)
                    starts.append(st)
                    ends.append(torch.where(use, en, st))
        start8 = torch.stack(starts, dim=1)
        end8 = torch.stack(ends, dim=1)

        mp_b = bxdf.map_params(lambda a: a[:, None] if a.dim() == 1 else a[:, None, :], mp_vp)
        wo_b = wo_l[:, None, :]
        koff = torch.arange(K, dtype=torch.int64, device=dv)
        phi = torch.zeros((P, 3), dtype=torch.float32, device=dv)
        m = torch.zeros((P,), dtype=torch.float32, device=dv)
        j = 0
        while True:
            stream.WAVES.add_loop_read()
            if not bool((start8 + j * K < end8).any()):
                break
            # (P, 8, K) slots of this chunk of every cell's run
            slot = start8[..., None] + j * K + koff
            ok = (slot < end8[..., None]).reshape(P, 8 * K)
            slot = torch.clamp(slot, max=n_dep - 1).reshape(P, 8 * K)
            diff = dp_s[slot] - vps.p[:, None, :]
            within = ok & (dot(diff, diff) <= r2[:, None])
            wi_l = to_local(-dd_s[slot], vps.ss[:, None, :], vps.ts[:, None, :],
                            vps.ns[:, None, :])
            f, _ = bxdf.bsdf_eval(mp_b, wo_b, wi_l)
            contrib = torch.where(within[..., None], f * db_s[slot], 0.0)
            phi = phi + contrib.sum(dim=1)
            m = m + within.sum(dim=1).to(torch.float32)
            j += 1
        return phi, m

    @staticmethod
    def _update(state: _SPPMState, vps: _VisiblePoints, phi, m) -> _SPPMState:
        """sppm.cpp "Update pixel values from this pass's photons": the
        radius shrinks and the flux rescales where photons arrived (m > 0)."""
        has = m > 0.0
        n_new = state.n + _GAMMA * m
        r2_new = state.r2 * n_new / torch.clamp(state.n + m, min=1e-20)
        tau_new = (state.tau + vps.beta * phi) * (
            r2_new / torch.clamp(state.r2, min=1e-30))[..., None]
        return _SPPMState(
            r2=torch.where(has, r2_new, state.r2),
            n=torch.where(has, n_new, state.n),
            tau=_where(has, tau_new, state.tau),
            ld=state.ld + vps.ld,
        )

    # ------------------------------------------------------------------
    def render(self, scene=None, mesh=None, max_seconds: float = 0.0, **kw) -> RenderResult:
        """SPPMIntegrator::Render: n_iterations of camera pass, photon pass
        and gather with the progressive update, on one device or over
        `mesh` (the module doc); writes the image when the film names a
        file (rank 0 of a mesh). The wall time ends in a device
        synchronize."""
        from tpu_pbrt_torch.utils.stats import STATS, ProgressReporter

        scene = scene or self.scene
        dev = scene.dev
        film = scene.film
        device = scene.device
        if mesh is None and getattr(self.options, "mesh_shape", None):
            from tpu_pbrt_torch.parallel.mesh import resolve_mesh

            mesh = resolve_mesh(self.options.mesh_shape, device=device)
        if mesh is not None and mesh.size < 2:
            mesh = None
        x0, x1, y0, y1 = film.sample_bounds()
        w, h = x1 - x0, y1 - y0
        P = w * h
        n_photons = self.photons_per_iter if self.photons_per_iter > 0 else P
        n_iter = self.n_iterations
        pix = torch.arange(P, dtype=torch.int32, device=device)
        n_local, pid0 = n_photons, 0
        if mesh is not None:
            mesh.take_log()
            # this rank's pixels (the tail padded with pixel 0) and photons
            pad = (-P) % mesh.size
            per = (P + pad) // mesh.size
            pix = torch.cat([pix, torch.zeros(pad, dtype=torch.int32, device=device)])
            pix = pix[mesh.rank * per:(mesh.rank + 1) * per]
            n_local = -(-n_photons // mesh.size)
            pid0 = mesh.rank * n_local
            n_photons = n_local * mesh.size
        px = x0 + pix % w
        py = y0 + torch.div(pix, w, rounding_mode="floor")

        # the initial radius: the "radius" parameter, or 2 x a pixel's
        # footprint estimated from the scene's diagonal
        verts = dev["tri_verts"].detach().cpu().numpy().reshape(-1, 3)
        s_lo = verts.min(0)
        s_hi = verts.max(0)
        r0 = self.initial_radius
        if r0 <= 0.0:
            r0 = 2.0 * float(np.linalg.norm(s_hi - s_lo)) / max(w, h)
        lo_t = torch.from_numpy(np.asarray(s_lo, np.float32)).to(device)
        hi_t = torch.from_numpy(np.asarray(s_hi, np.float32)).to(device)
        Pl = pix.shape[0]
        state = _SPPMState(
            r2=torch.full((Pl,), r0 * r0, dtype=torch.float32, device=device),
            n=torch.zeros((Pl,), dtype=torch.float32, device=device),
            tau=torch.zeros((Pl, 3), dtype=torch.float32, device=device),
            ld=torch.zeros((Pl, 3), dtype=torch.float32, device=device),
        )

        stream.WAVES.reset()
        rays = []
        iters_done = 0
        progress = ProgressReporter(n_iter, "SPPM", quiet=bool(getattr(self.options, "quiet",
                                                                        False)))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with STATS.phase("Integrator/SPPM render"):
            for i in range(n_iter):
                vps, nr_c = self._camera_pass(dev, px, py, i)
                dep_p, dep_d, dep_beta, dep_valid, nr_p = self._photon_pass(dev, n_local, i,
                                                                            pid0=pid0)
                # this iteration's grid: the cell size follows the largest radius
                r_max = _sqrt(state.r2.max())
                if mesh is not None:
                    # every rank sees every deposit, and bins them alike
                    dep_p, dep_d, dep_beta = (mesh.all_gather(x) for x in (dep_p, dep_d, dep_beta))
                    dep_valid = mesh.all_gather(dep_valid.to(torch.uint8)).to(torch.bool)
                    r_max = r_max.reshape(1)
                    mesh.all_reduce_([r_max], op="max")
                    r_max = r_max[0]
                glo = lo_t - r_max
                ext = (hi_t + r_max) - glo
                cs = torch.maximum(2.0 * r_max, ext.max() / 64.0)
                phi, m = self._gather(dev, vps, dep_p, dep_d, dep_beta, dep_valid, state.r2,
                                      glo, cs, _GRES)
                state = self._update(state, vps, phi, m)
                rays.append(nr_c + nr_p)
                iters_done = i + 1
                progress.update()
                if max_seconds > 0:
                    stop = torch.tensor([int(time.perf_counter() - t0 > max_seconds)], device=device)
                    if mesh is not None:  # rank 0's clock decides for every rank
                        mesh.broadcast_(stop)
                    if stop.item():
                        break
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        secs = time.perf_counter() - t0
        progress.done()
        n_rays = torch.stack(rays).sum().to(torch.int64).reshape(1) if rays else None
        mesh_stats = None
        if mesh is not None:
            mesh.all_reduce_([n_rays])
            state = _SPPMState(*(mesh.all_gather(x)[:P] for x in state))
            mesh_stats = {"ranks": mesh.size, "rank": mesh.rank, "backend": mesh.backend,
                          "layout": mesh.layout, "photons_per_rank": n_local,
                          "collective_ms": {k: round(1e3 * sum(v), 4) for k, v in mesh.take_log().items()}}
        n_rays = int(n_rays) if n_rays is not None else 0
        STATS.counter("SPPM/Photons dropped (scan cap)", 0)
        STATS.counter("Integrator/Rays traced", n_rays)

        ni = max(iters_done, 1)
        ld_img = state.ld.cpu().numpy().reshape(h, w, 3) / ni
        tau = state.tau.cpu().numpy().reshape(h, w, 3)
        r2 = state.r2.cpu().numpy().reshape(h, w, 1)
        img = np.ascontiguousarray(ld_img + tau / (ni * n_photons * np.pi * r2), np.float32)
        if film.filename and (mesh is None or mesh.rank == 0):
            try:
                from tpu_pbrt_torch.utils.imageio import write_image

                write_image(film.filename, img)
            except OSError as e:
                Warning(f"could not write image {film.filename}: {e}")
        waves = stream.WAVES
        return RenderResult(
            image=img, film_state=None, seconds=secs, rays_traced=n_rays,
            mray_per_sec=n_rays / max(secs, 1e-9) / 1e6, spp=ni,
            completed_fraction=iters_done / max(n_iter, 1),
            stats={"photons_dropped": 0, "photons_per_iteration": n_photons,
                   **({"mesh": mesh_stats} if mesh_stats else {}),
                   "waves": waves.waves, "n_drop": int(waves.drops),
                   "loop_host_reads_per_wave": waves.loop_reads / max(waves.waves, 1),
                   "wave_modes": waves.mode_stats()},
        )
