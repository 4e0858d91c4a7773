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
  the splat plane after the last.

The reference runs as the tests would run it (tests/conftest.py): XLA at
optimization level 0 on the CPU, so its floating-point results are the
ones a live call under pytest returns. Run from the repository root:

    python tests/torch_golden/make_module_reference.py [walk|mlt|all]

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


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in ("walk", "mlt", "all"):
        raise SystemExit(f"usage: {sys.argv[0]} [walk|mlt|all]")
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


if __name__ == "__main__":
    main()
