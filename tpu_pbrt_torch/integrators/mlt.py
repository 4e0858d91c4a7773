"""MLTIntegrator — primary-sample-space Metropolis light transport (port of
tpu_pbrt/integrators/mlt.py), on one device.

pbrt-v3 MLTIntegrator's machinery, as the reference has it: the
primary-sample vector with large and small (exponential-kernel) steps,
the bootstrap whose luminances give the chain seeds and the
normalization b, every lane of a (C,) batch an independent Markov chain
(one step advances all chains at once), the Kelemen-weighted splats of
the proposal and the current state, and the final b-normalized image.
The path contribution f(U) re-traces the unidirectional path estimator
(path's NEE and forward MIS) with every random dimension read from an
explicit (C, D) primary-sample matrix U, so MLT's mean matches `path`'s.

Like the reference, this mutates the unidirectional path space
(Kelemen et al.'s original PSSMLT) rather than pbrt's multiplexed BDPT
strategies. Chain seeds come from numpy's default_rng(0x51F0) on the
host, as in the reference. The reference's depth loop runs every depth
whatever its lanes; f(U) here stops once none of its lanes is alive (one
host read per depth), which adds nothing the skipped depths would have.
Over a mesh of ranks the chains shard with their global ids (render()).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpu_pbrt_torch.accel import stream
from tpu_pbrt_torch.cameras import generate_rays
from tpu_pbrt_torch.core import bxdf
from tpu_pbrt_torch.core import lights_dev as ld
from tpu_pbrt_torch.core.sampling import power_heuristic, uniform_float
from tpu_pbrt_torch.core.vecmath import dot, normalize, offset_ray_origin, to_local, to_world
from tpu_pbrt_torch.integrators.common import (
    RenderResult,
    WavefrontIntegrator,
    make_interaction,
    scene_intersect,
    scene_intersect_p,
)
from tpu_pbrt_torch.utils.error import Warning

#: dims per bounce: light pick + light uv (3), bsdf lobe + uv (3), rr, mix
_DIMS_PER_BOUNCE = 8
_DIMS_CAMERA = 4  # film xy + lens uv
#: chain steps per progress update
_INNER = 16


def _luminance(c):
    return 0.2126 * c[..., 0] + 0.7152 * c[..., 1] + 0.0722 * c[..., 2]


def _where(mask, a, b):
    return torch.where(mask[..., None], a, b)


class MLTIntegrator(WavefrontIntegrator):
    name = "mlt"
    rays_per_camera_ray = 3.0

    def __init__(self, params, scene, options):
        super().__init__(params, scene, options)
        self.max_depth = params.find_one_int("maxdepth", 5)
        self.n_bootstrap = params.find_one_int("bootstrapsamples", 100000)
        self.n_chains = params.find_one_int("chains", 4096)
        self.mutations_per_pixel = params.find_one_int("mutationsperpixel", 100)
        self.sigma = params.find_one_float("sigma", 0.01)
        self.large_step_prob = params.find_one_float("largestepprobability", 0.3)
        self.n_dims = _DIMS_CAMERA + _DIMS_PER_BOUNCE * self.max_depth
        if scene.has_null_materials:
            Warning("mlt: null-interface materials are traversed as opaque")

    # ------------------------------------------------------------------
    def _f(self, dev, U):
        """f(U) for U (C, D) in [0, 1): (raster p_film (C, 2), L (C, 3))."""
        scene = self.scene
        x0, x1, y0, y1 = scene.film.sample_bounds()
        w, h = x1 - x0, y1 - y0
        p_film = torch.stack([x0 + U[:, 0] * w, y0 + U[:, 1] * h], dim=-1)
        o, d, wt = generate_rays(scene.camera, p_film, U[:, 2:4])
        C = U.shape[0]
        dv = U.device
        L = torch.zeros((C, 3), dtype=torch.float32, device=dv)
        beta = wt[..., None] * torch.ones((C, 3), dtype=torch.float32, device=dv)
        alive = torch.ones((C,), dtype=torch.bool, device=dv)
        specular = torch.ones((C,), dtype=torch.bool, device=dv)
        prev_pdf = torch.zeros((C,), dtype=torch.float32, device=dv)
        prev_p = o
        inf = torch.full((C,), float("inf"), dtype=torch.float32, device=dv)
        for depth in range(self.max_depth + 1):
            if depth:
                stream.WAVES.add_loop_read()
                if not bool(alive.any()):
                    break
            hit = scene_intersect(dev, o, d, torch.where(alive, inf, -1.0))
            it = make_interaction(dev, hit, o, d)
            it.valid = it.valid & alive
            miss = alive & (hit.prim < 0)
            if "envmap" in dev:
                le_env = ld.env_lookup(dev, d)
                pdf_env = ld.infinite_pdf(dev, self.light_distr, d, ref_p=prev_p)
                w_env = torch.where(specular, 1.0, power_heuristic(1.0, prev_pdf, 1.0, pdf_env))
                L = L + _where(miss, beta * le_env * w_env[..., None], 0.0)
            hit_light = torch.where(it.valid, it.light, -1)
            le = ld.emitted_radiance(dev, hit_light, it.wo, it.ng)
            pdf_light = ld.emitted_pdf(dev, self.light_distr, prev_p, it.p, hit_light, it.ng)
            w_emit = torch.where(specular, 1.0, power_heuristic(1.0, prev_pdf, 1.0, pdf_light))
            L = L + beta * le * w_emit[..., None]
            alive = alive & (hit.prim >= 0)
            # the last depth's window clamps to the vector's end, as the
            # reference's dynamic_slice does (its lanes only shade emission)
            base = min(_DIMS_CAMERA + depth * _DIMS_PER_BOUNCE, U.shape[1] - _DIMS_PER_BOUNCE)
            Ub = U[:, base:base + _DIMS_PER_BOUNCE]
            scatter_ok = alive & (depth < self.max_depth)
            # the mix draw rides its own primary-sample dimension, so f(U)
            # stays a function of U
            mp = self.mat_at(dev, it, u_mix=Ub[:, 7])
            wo_l = to_local(it.wo, it.ss, it.ts, it.ns)
            # NEE, the light-sampling half (MIS against the BSDF pdf, as path)
            ls = ld.sample_one_light(dev, self.light_distr, it.p, Ub[:, 0], Ub[:, 1], Ub[:, 2])
            wi_l = to_local(ls.wi, it.ss, it.ts, it.ns)
            f_l, pdf_b = bxdf.bsdf_eval(mp, wo_l, wi_l)
            f_l = f_l * torch.abs(dot(ls.wi, it.ns))[..., None]
            do_l = (it.valid & scatter_ok & (ls.pdf > 0.0) & (f_l.amax(dim=-1) > 0.0)
                    & (ls.li.amax(dim=-1) > 0.0))
            occluded = scene_intersect_p(dev, offset_ray_origin(it.p, it.ng, ls.wi), ls.wi,
                                         torch.where(do_l, ls.dist * 0.999, -1.0))
            w_l = torch.where(ls.is_delta, 1.0, power_heuristic(1.0, ls.pdf, 1.0, pdf_b))
            contrib = f_l * ls.li * (w_l / torch.clamp(ls.pdf, min=1e-20))[..., None]
            L = L + _where(do_l & ~occluded, beta * contrib, 0.0)
            # the BSDF continuation
            bs = bxdf.bsdf_sample(mp, wo_l, Ub[:, 3], Ub[:, 4], Ub[:, 5])
            wi_w = normalize(to_world(bs.wi, it.ss, it.ts, it.ns))
            cont = scatter_ok & (bs.pdf > 0.0) & (bs.f.amax(dim=-1) > 0.0)
            thr = bs.f * (torch.abs(dot(wi_w, it.ns)) / torch.clamp(bs.pdf, min=1e-20))[..., None]
            beta = _where(cont, beta * thr, beta)
            specular = bs.is_specular
            prev_pdf = torch.where(bs.is_specular, 0.0, bs.pdf)
            prev_p = _where(cont, it.p, prev_p)
            o = _where(cont, offset_ray_origin(it.p, it.ng, wi_w), o)
            d = _where(cont, wi_w, d)
            alive = cont
            # Russian roulette after depth 3 (path.cpp's bounces > 3)
            if depth >= 3:
                q = torch.clamp(1.0 - beta.amax(dim=-1), min=0.05)
                survive = Ub[:, 6] >= q
                beta = _where(alive & survive, beta / torch.clamp(1.0 - q, min=1e-6)[..., None],
                              beta)
                alive = alive & survive
        return p_film, torch.clamp(L, min=0.0)

    def _bootstrap_u(self, nb: int, device):
        """The bootstrap's primary-sample vectors (nb, D)."""
        bid = torch.arange(nb, dtype=torch.int32, device=device)
        return torch.stack([uniform_float(bid, bid * 7 + 3, 0x8F2, k) for k in range(self.n_dims)],
                           dim=-1)

    def _step_u(self, cid, step: int):
        """A chain step's draws: (large-step flag, the large step's vector,
        the small step's vector from U_cur) as functions of (chain id,
        step), for the caller to combine."""
        D = self.n_dims
        stp = torch.full_like(cid, step)

        def u(salt):
            return uniform_float(cid, stp, 0x3D7, salt)

        large = u(0) < self.large_step_prob
        Un = torch.stack([u(100 + k) for k in range(D)], dim=-1)
        eps = torch.stack([u(300 + k) for k in range(D)], dim=-1)
        # pbrt's exponential-scale symmetric small-step kernel
        mag = self.sigma * torch.exp(-float(np.log(np.float32(1024.0))) * eps)
        delta = torch.where(Un < 0.5, mag, -mag)
        return large, Un, delta, u(700)

    def _chain_step(self, dev, carry, splat, step: int, b: float, x0: int, y0: int, w: int,
                    h: int, cid0: int = 0):
        """One Metropolis step of every chain (chain ids from cid0): propose,
        splat the proposal and the current state with the Kelemen weights,
        accept. Returns (carry, the accept mask)."""
        U_cur, p_cur, L_cur, y_cur = carry
        npix = w * h
        cid = cid0 + torch.arange(U_cur.shape[0], dtype=torch.int32, device=U_cur.device)
        large, Un, delta, u_acc = self._step_u(cid, step)
        # (U_cur + delta) mod 1 as jnp.remainder computes it: fmod, then +1
        # where the remainder is negative
        r = torch.fmod(U_cur + delta, 1.0)
        U_small = torch.where((r != 0.0) & (r < 0.0), r + 1.0, r)
        U_prop = torch.where(large[:, None], Un, U_small)
        p_prop, L_prop = self._f(dev, U_prop)
        y_prop = _luminance(L_prop)
        pL = self.large_step_prob
        a = torch.clamp(y_prop / torch.clamp(y_cur, min=1e-20), max=1.0)
        bt = torch.tensor(b, dtype=torch.float32, device=U_cur.device)
        w_new = (a + large.to(torch.float32)) / (y_prop / bt + pL)
        w_old = (1.0 - a) / (y_cur / bt + pL)

        def splat_to(pf, val):
            px = (torch.nan_to_num(pf[:, 0], nan=0.0).clamp(-2.0**31, 2.0**31 - 1)
                  .to(torch.int64) - x0).clamp(0, w - 1)
            py = (torch.nan_to_num(pf[:, 1], nan=0.0).clamp(-2.0**31, 2.0**31 - 1)
                  .to(torch.int64) - y0).clamp(0, h - 1)
            ok = torch.isfinite(val).all(dim=-1) & (val.amax(dim=-1) >= 0.0)
            idx = torch.where(ok, py * w + px, npix)
            splat.index_add_(0, idx, _where(ok, val, 0.0))

        splat_to(p_prop, L_prop * w_new[:, None])
        splat_to(p_cur, L_cur * w_old[:, None])
        accept = u_acc < a
        carry = (torch.where(accept[:, None], U_prop, U_cur), _where(accept, p_prop, p_cur),
                 _where(accept, L_prop, L_cur), torch.where(accept, y_prop, y_cur))
        return carry, accept

    # ------------------------------------------------------------------
    def render(self, scene=None, mesh=None, max_seconds: float = 0.0, **kw) -> RenderResult:
        """The bootstrap, then mutations_per_pixel x pixels / chains steps of
        every chain in blocks of 16; writes the image when the film names a
        file. The wall time (the chain steps) ends in a device synchronize.

        Over `mesh` (parallel/mesh.py) the chains shard over the ranks with
        their global ids, so the ranks' chains are the one-device render's
        chains; a chain count that does not divide is padded with chains
        seeded from distinct bootstrap states (wrapping around the chain
        set), which are real chains and count in the normalization. Each
        rank splats its chains into a plane of its own per outer block,
        and one sum all-reduce merges the planes at the block's end."""
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
        npix = w * h
        C = self.n_chains
        n_steps = max(npix * self.mutations_per_pixel // C, 1)
        stream.WAVES.reset()

        # ---- bootstrap (mlt.cpp "Generate bootstrap samples") ----------
        nb = self.n_bootstrap
        U_boot = self._bootstrap_u(nb, device)
        y_boot = _luminance(self._f(dev, U_boot)[1])
        y_np = y_boot.cpu().numpy().astype(np.float64)
        b = float(y_np.mean())  # the normalization constant (an estimate of E[y])
        if b <= 0.0:  # a black scene: nothing to mutate toward
            return RenderResult(image=np.zeros((h, w, 3), np.float32), film_state=None,
                                seconds=0.0, rays_traced=nb, mray_per_sec=0.0,
                                spp=self.mutations_per_pixel)
        # chain seeds ~ y (a Distribution1D over the bootstrap luminances)
        seeds = np.random.default_rng(0x51F0).choice(nb, size=C, p=y_np / y_np.sum())
        U_cur = U_boot[torch.from_numpy(seeds).to(device)]
        del U_boot, y_boot
        cid0 = 0
        if mesh is not None:
            mesh.take_log()
            pad = (-C) % mesh.size
            if pad:
                wrap = torch.arange(pad, device=device) % C
                U_cur = torch.cat([U_cur, U_cur[wrap]])
            C = U_cur.shape[0]
            per = C // mesh.size
            cid0 = mesh.rank * per
            U_cur = U_cur[cid0:cid0 + per]
        p_cur, L_cur = self._f(dev, U_cur)
        carry = (U_cur, p_cur, L_cur, _luminance(L_cur))
        # one spare row takes the splats of non-finite or negative values
        splat = torch.zeros((npix + 1, 3), dtype=torch.float32, device=device)

        n_outer = max(n_steps // _INNER, 1)
        progress = ProgressReporter(n_outer, "MLT", quiet=bool(getattr(self.options, "quiet",
                                                                        False)))
        prev_det = torch.are_deterministic_algorithms_enabled()
        prev_warn = torch.is_deterministic_algorithms_warn_only_enabled()
        if device.type == "cuda":
            # the splats' scatter-adds accumulate in a fixed order
            torch.use_deterministic_algorithms(True, warn_only=True)
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        done_steps = 0
        accepts = []
        try:
            with STATS.phase("Integrator/MLT render"):
                for outer in range(n_outer):
                    acc = []
                    plane = splat if mesh is None else torch.zeros_like(splat)
                    for k in range(_INNER):
                        carry, accept = self._chain_step(dev, carry, plane, outer * _INNER + k,
                                                         b, x0, y0, w, h, cid0=cid0)
                        acc.append(accept.to(torch.float32).mean())
                    acc = torch.stack(acc).mean().reshape(1)
                    if mesh is not None:
                        # the block's splat planes and acceptances merge here
                        mesh.all_reduce_([plane, acc])
                        splat += plane
                        acc = acc / mesh.size
                    accepts.append(acc[0])
                    done_steps += _INNER
                    progress.update()
                    if max_seconds > 0:
                        stop = torch.tensor([int(time.perf_counter() - t0 > max_seconds)], device=device)
                        if mesh is not None:  # rank 0's clock decides for every rank
                            mesh.broadcast_(stop)
                        if stop.item():
                            break
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        finally:
            torch.use_deterministic_algorithms(prev_det, warn_only=prev_warn)
        secs = time.perf_counter() - t0
        progress.done()
        acc_rate = float(accepts[-1]) if accepts else 0.0
        STATS.distribution("MLT/Acceptance rate", acc_rate)

        # the splat average scaled by b (film.cpp WriteImage's splatScale,
        # the per-pixel mutation count expressed through n_done)
        n_done = done_steps * C
        img = splat[:npix].cpu().numpy().reshape(h, w, 3) * (npix / max(n_done, 1))
        img = np.ascontiguousarray(img, np.float32)
        rays = (nb + n_done) * int(self.max_depth * 2)
        if film.filename and (mesh is None or mesh.rank == 0):
            try:
                from tpu_pbrt_torch.utils.imageio import write_image

                write_image(film.filename, img)
            except OSError as e:
                Warning(f"could not write image {film.filename}: {e}")
        waves = stream.WAVES
        return RenderResult(
            image=img, film_state=None, seconds=secs, rays_traced=rays,
            mray_per_sec=rays / max(secs, 1e-9) / 1e6, spp=self.mutations_per_pixel,
            completed_fraction=done_steps / max(n_steps, 1),
            stats={"b": b, "acceptance": acc_rate, "chains": C, "steps": done_steps,
                   **({"mesh": {"ranks": mesh.size, "rank": mesh.rank, "backend": mesh.backend,
                                "layout": mesh.layout, "chains_per_rank": C // mesh.size,
                                "collective_ms": {k: round(1e3 * sum(v), 4) for k, v in mesh.take_log().items()}}}
                      if mesh is not None else {}),
                   "waves": waves.waves, "n_drop": int(waves.drops),
                   "wave_modes": waves.mode_stats()},
        )
