"""Write the JAX package's outputs of single modules on seeded inputs, which
the port's tests hold it against without running the reference live:

- `bdpt_walk_{radiance,importance}.npz` (tests/test_torch_bdpt.py):
  BDPT's `_walk` of 1,024 camera or light subpaths on the small Cornell
  box (16x16, 4 spp, maxdepth 5): the walk's inputs and every field of
  the path it records, with the traced-ray counts;
- `mlt_parts.npz` (tests/test_torch_mlt.py): MLT's f(U) of 512 chains
  (the bootstrap's own sample vectors and uniform ones) on the Cornell
  box under `mlt` (maxdepth 3), and the first four mutation steps of 512
  chains: each step's accept decisions, the chains' states after it, and
  the splat plane after the last;
- `direct_estimate.npz` (tests/test_torch_direct.py): `estimate_direct`
  of the direct-lighting integrator on one chunk of camera hits of the
  small Cornell box, the small killeroo and the small crown (its sky the
  only light), with every light and with one row per lane
  (`light_idx`), and each scene's light count; and on the null quad of
  tests/test_media.py over its whole image, the shadow rays walking up
  to 4 segments through null surfaces;
- `media_walk.npz` (tests/test_torch_media.py): `unoccluded_tr`'s
  visibility and transmittance of 1,024 seeded shadow rays (half inside
  the medium) walking up to 4 segments, on the null cube under `volpath`
  and the small cloud.

The reference runs as the tests would run it (tests/conftest.py): XLA at
optimization level 0 on the CPU, so its floating-point results are the
ones a live call under pytest returns. Run from the repository root:

    python tests/torch_golden/make_module_reference.py [walk|mlt|direct|media|all]

Each file records the commit of the JAX package.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_backend_optimization_level=0").strip()

#: the walk's lanes and the MLT chains, steps
WALK_R = 1024
MLT_C, MLT_STEPS = 512, 4


def walk_inputs(sj, mode):
    """The seeded inputs of BDPT's walk (camera rays through the
    reference's camera, or light subpaths from its sample_le) as numpy."""
    import jax.numpy as jnp
    import numpy as np

    from tpu_pbrt import cameras as jcam
    from tpu_pbrt.core import lights_dev as jld
    from tpu_pbrt.integrators import bdpt as jbdpt

    R = WALK_R
    rng = np.random.default_rng(15)
    px = rng.integers(0, 16, R).astype(np.int32)
    py = rng.integers(0, 16, R).astype(np.int32)
    s = rng.integers(0, 4, R).astype(np.int32)
    if mode == "radiance":
        pf = np.stack([px + rng.uniform(0, 1, R), py + rng.uniform(0, 1, R)], -1)
        o, d, _ = jcam.generate_rays(sj.camera, jnp.asarray(pf.astype(np.float32)),
                                     jnp.zeros((R, 2), jnp.float32))
        o, d = np.asarray(o), np.asarray(d)
        n0, beta = d, np.ones((R, 3), np.float32)
        pdf_dir = np.asarray(jcam.camera_pdf_we(sj.camera, jnp.asarray(d))[1])
        alive, surf = np.ones(R, bool), None
    else:
        u = rng.uniform(0, 1, (5, R)).astype(np.float32)
        les = jld.sample_le(sj.dev, sj.light_distr, *map(jnp.asarray, u))
        o = np.asarray(jnp.where(les.is_delta[:, None], les.p,
                                 jbdpt.offset_ray_origin(les.p, les.n, les.d)))
        d, n0 = np.asarray(les.d), np.asarray(les.n)
        beta = np.asarray(les.le / (les.pmf * les.pdf_pos)[:, None])
        pdf_dir, alive = np.asarray(les.pdf_dir), np.asarray(les.supported)
        surf = ~np.asarray(les.is_delta)
    out = dict(o=o, d=d, n0=n0, beta=beta, pdf_dir=pdf_dir, alive=alive, px=px, py=py, s=s)
    if surf is not None:
        out["surf"] = surf
    return out


#: the path fields the walk records
WALK_FIELDS = ("mat", "light", "delta", "valid", "p", "ng", "ns", "beta", "pdf_fwd", "pdf_rev")


def write_walk(mode, commit):
    import jax.numpy as jnp
    import numpy as np

    from tpu_pbrt import scenes as jscenes
    from tpu_pbrt.integrators import bdpt as jbdpt

    sj, ij = jscenes.compile_api(jscenes.make_cornell(res=16, spp=4, integrator="bdpt",
                                                      maxdepth=5))
    x = walk_inputs(sj, mode)
    A = {k: jnp.asarray(v) for k, v in x.items()}
    path = jbdpt._Path(WALK_R, 6)
    path.set(0, p=A["o"], ng=A["n0"], ns=A["n0"], valid=A["alive"])
    nrays, _ = ij._walk(sj.dev, path, A["o"], A["d"], A["beta"], A["pdf_dir"], A["alive"],
                        A["px"], A["py"], A["s"], 0 if mode == "radiance" else 3011, 5, mode,
                        origin_surface=A.get("surf"))
    out = os.path.join(HERE, f"bdpt_walk_{mode}.npz")
    np.savez_compressed(out, nrays=np.asarray(nrays), jax_commit=np.array(commit),
                        **{f"in_{k}": v for k, v in x.items()},
                        **{f"path_{f}": np.asarray(getattr(path, f)) for f in WALK_FIELDS})
    print(f"wrote {out}", flush=True)


def write_mlt(commit):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_pbrt import scenes as jscenes
    from tpu_pbrt.core.sampling import uniform_float as juniform
    from tpu_pbrt.integrators.mlt import _luminance as luminance

    sj, ij = jscenes.compile_api(jscenes.make_cornell(res=16, spp=1, integrator="mlt",
                                                      maxdepth=3))
    jf = jax.jit(ij._f)
    C, D = MLT_C, ij.n_dims
    res = {}
    bid = jnp.arange(C, dtype=jnp.int32)
    Ub = jnp.stack([juniform(bid, bid * 7 + 3, jnp.int32(0x8F2), k) for k in range(D)], -1)
    Uu = jnp.asarray(np.random.default_rng(21).uniform(0, 1, (C, D)).astype(np.float32))
    for kind, U in (("bootstrap", Ub), ("uniform", Uu)):
        p, L = jf(sj.dev, U)
        res.update({f"f_{kind}_U": np.asarray(U), f"f_{kind}_p": np.asarray(p),
                    f"f_{kind}_L": np.asarray(L)})

    # the reference's mutation step (integrators/mlt.py, render's `one`)
    # with its own f(U) and sample streams, from seeded states
    pL, sigma = ij.large_step_prob, ij.sigma
    x0, x1, y0, y1 = sj.film.sample_bounds()
    w, h = x1 - x0, y1 - y0
    npix = w * h
    b = 0.25
    Uj = jnp.asarray(np.random.default_rng(22).uniform(0, 1, (C, D)).astype(np.float32))
    pj, Lj = jf(sj.dev, Uj)
    yj = luminance(Lj)
    splat = jnp.zeros((npix, 3), jnp.float32)
    res["chain_U0"] = np.asarray(Uj)
    for step in range(MLT_STEPS):
        cid = jnp.arange(C, dtype=jnp.int32)

        def u(salt):
            return juniform(cid, jnp.int32(step), jnp.int32(0x3D7), salt)

        large = u(0) < pL
        Un = jnp.stack([u(100 + k) for k in range(D)], -1)
        eps = jnp.stack([u(300 + k) for k in range(D)], -1)
        mag = sigma * jnp.exp(-jnp.log(1024.0) * eps)
        U_prop = jnp.where(large[:, None], Un, (Uj + jnp.where(Un < 0.5, mag, -mag)) % 1.0)
        p_prop, L_prop = jf(sj.dev, U_prop)
        y_prop = luminance(L_prop)
        a = jnp.minimum(1.0, y_prop / jnp.maximum(yj, 1e-20))
        w_new = (a + large.astype(jnp.float32)) / (y_prop / b + pL)
        w_old = (1.0 - a) / (yj / b + pL)
        for pf, val in ((p_prop, L_prop * w_new[:, None]), (pj, Lj * w_old[:, None])):
            px = jnp.clip(pf[:, 0].astype(jnp.int32) - x0, 0, w - 1)
            py = jnp.clip(pf[:, 1].astype(jnp.int32) - y0, 0, h - 1)
            ok = jnp.isfinite(val).all(-1) & (jnp.max(val, -1) >= 0.0)
            splat = splat.at[jnp.where(ok, py * w + px, npix)].add(
                jnp.where(ok[:, None], val, 0.0), mode="drop")
        accept = u(700) < a
        Uj = jnp.where(accept[:, None], U_prop, Uj)
        pj = jnp.where(accept[:, None], p_prop, pj)
        Lj = jnp.where(accept[:, None], L_prop, Lj)
        yj = jnp.where(accept, y_prop, yj)
        for name, v in (("accept", accept), ("U", Uj), ("p", pj), ("L", Lj), ("y", yj)):
            res[f"chain_{step}_{name}"] = np.asarray(v)
    res["chain_splat"] = np.asarray(splat)
    out = os.path.join(HERE, "mlt_parts.npz")
    np.savez_compressed(out, jax_commit=np.array(commit), **res)
    print(f"wrote {out}", flush=True)


#: the scenes of direct_estimate.npz
DIRECT_SCENES = ("cornell_direct", "killeroo_direct", "crown_small")


def direct_api(pkg, name: str, tmp: str, **device_kw):
    """The parsed scene `name` of DIRECT_SCENES under directlighting, built
    with either package (`pkg`: its root module's name)."""
    import importlib

    from make_golden import configure, crown_small_sky, crown_small_text, direct_case_api

    scenes = importlib.import_module(f"{pkg}.scenes")
    if name != "crown_small":
        return direct_case_api(scenes, name, device_kw)
    api = importlib.import_module(f"{pkg}.scene.api")
    imageio = importlib.import_module(f"{pkg}.utils.imageio")
    env = os.path.join(tmp, "sky.pfm")
    imageio.write_image(env, crown_small_sky())
    opts = api.Options(quiet=True)
    init = api.pbrt_init(opts, **device_kw) if device_kw else api.pbrt_init(opts)
    return configure(api.parse_string(crown_small_text(env), init), "directlighting")


def null_quad_api(pkg, **device_kw):
    """tests/test_media.py's null quad under directlighting, parsed with
    either package."""
    import importlib

    from make_golden import configure, media_text

    api = importlib.import_module(f"{pkg}.scene.api")
    opts = api.Options(quiet=True)
    init = api.pbrt_init(opts, **device_kw) if device_kw else api.pbrt_init(opts)
    text = media_text("null_quad_path").rsplit("WorldEnd", 1)[0]
    return configure(api.parse_string(text, init), "directlighting")


def write_direct(commit):
    import tempfile

    import jax.numpy as jnp
    import numpy as np

    from make_golden import LEAF_TRIS

    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    from tpu_pbrt import config, scenes
    from tpu_pbrt.integrators import common

    config.reload()
    out = {}
    for name in DIRECT_SCENES:
        with tempfile.TemporaryDirectory() as tmp:
            sj, ij = scenes.compile_api(direct_api("tpu_pbrt", name, tmp))
        plan = ij.prepare_chunks(sj)
        x0, x1, y0, _ = plan.bounds
        k = np.arange(plan.chunk, dtype=np.int32)
        _, px, py, s, _, o, d, _ = ij.work_to_rays(sj.camera, plan.spp, x0, y0, x1 - x0,
                                                   plan.npix, 0, 0, jnp.asarray(k))
        it = common.make_interaction(sj.dev, common.scene_intersect(sj.dev, o, d, jnp.inf), o, d)
        mp = ij.mat_at(sj.dev, it, u_mix=jnp.zeros(k.shape, jnp.float32))
        rows = (k % sj.n_lights).astype(np.int32)
        for tag, idx, extra in (("all", None, 0), ("row", jnp.asarray(rows), 1000)):
            out[f"{name}_{tag}"] = np.asarray(common.estimate_direct(
                sj.dev, ij.light_distr, it, mp, px, py, s, 0, light_idx=idx, salt_extra=extra,
                sampler=(ij.skind, ij.spp)))
        out[f"{name}_n_lights"] = np.int64(sj.n_lights)
        out[f"{name}_chunk"] = np.int64(plan.chunk)
    # the null quad of tests/test_media.py: shadow rays through up to 4
    # segments of null surfaces, over the whole image
    sj, ij = scenes.compile_api(null_quad_api("tpu_pbrt"))
    plan = ij.prepare_chunks(sj)
    x0, x1, y0, _ = plan.bounds
    k = np.arange(plan.total, dtype=np.int32)
    _, px, py, s, _, o, d, _ = ij.work_to_rays(sj.camera, plan.spp, x0, y0, x1 - x0, plan.npix,
                                               0, 0, jnp.asarray(k))
    it = common.make_interaction(sj.dev, common.scene_intersect(sj.dev, o, d, jnp.inf), o, d)
    out["null_quad_all"] = np.asarray(common.estimate_direct(
        sj.dev, ij.light_distr, it, ij.mat_at(sj.dev, it, u_mix=jnp.zeros(k.shape)), px, py, s,
        0, vis_segments=4, sampler=(ij.skind, ij.spp)))
    out["null_quad_vis_segments"] = np.int64(ij.vis_segments)
    path = os.path.join(HERE, "direct_estimate.npz")
    np.savez_compressed(path, jax_commit=np.array(commit), **out)
    print(f"wrote {path}: {sorted(out)}")


#: the scenes of media_walk.npz (MEDIA_CASES names)
MEDIA_SCENES = ("null_cube_volpath", "cloud_small")


def walk_inputs_tr(n: int = 1024):
    """unoccluded_tr's seeded inputs: half the rays inside the medium (id
    0), half outside; every ninth lane dead (no test)."""
    import numpy as np

    rng = np.random.default_rng(6)
    inside = np.arange(n) % 2 == 0
    o = np.where(inside[:, None], rng.uniform(-0.6, 0.6, (n, 3)),
                 rng.uniform(-3, 3, (n, 3)) + [0.0, 0.0, -4.0]).astype(np.float32)
    v = rng.normal(size=(n, 3))
    d = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    dist = rng.uniform(0.5, 6.0, n).astype(np.float32)
    dist[::9] = -1.0
    med = np.where(inside, 0, -1).astype(np.int32)
    pix = rng.integers(0, 16, (3, n)).astype(np.int32)
    return o, d, dist, med, pix[0], pix[1], pix[2]


def write_media(commit):
    import jax.numpy as jnp
    import numpy as np

    from make_golden import LEAF_TRIS, jax_cloud_api, media_api

    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    from tpu_pbrt import config, scenes
    from tpu_pbrt.integrators import common
    from tpu_pbrt.scene.api import Options, parse_string, pbrt_init

    config.reload()
    out = {}
    for name in MEDIA_SCENES:
        sj, _ = scenes.compile_api(media_api(name, parse_string, pbrt_init, Options,
                                             jax_cloud_api))
        vis, tr = common.unoccluded_tr(sj.dev, *(jnp.asarray(x) for x in walk_inputs_tr()), 77,
                                       segments=4)
        out[f"{name}_vis"], out[f"{name}_tr"] = np.asarray(vis), np.asarray(tr)
    path = os.path.join(HERE, "media_walk.npz")
    np.savez_compressed(path, jax_commit=np.array(commit), **out)
    print(f"wrote {path}: {sorted(out)}")


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in ("walk", "mlt", "direct", "media", "all"):
        raise SystemExit(f"usage: {sys.argv[0]} [walk|mlt|direct|media|all]")
    root = os.path.dirname(os.path.dirname(HERE))
    sys.path.insert(0, root)
    sys.path.insert(0, HERE)
    from make_golden import _commit

    commit = _commit(root)
    if which in ("walk", "all"):
        for mode in ("radiance", "importance"):
            write_walk(mode, commit)
    if which in ("mlt", "all"):
        write_mlt(commit)
    if which in ("direct", "all"):
        write_direct(commit)
    if which in ("media", "all"):
        write_media(commit)


if __name__ == "__main__":
    main()
