"""Write the JAX package's CPU renders of the caustic-glass-class scene
that `chip_smoke.py` holds the port's renders on the GPU against.

The scene is `tpu_pbrt_torch.scenes.make_caustic_like`'s (`caustic_parts`:
the killeroo's 128,880-triangle displaced sphere in glass, eta 1.5, over
the killeroo's matte ground, lit by its quad area light and by a point
light behind the blob that the glass focuses onto the ground), parsed
through the JAX package's API from the same text and arrays
(make_golden.py's `jax_caustic_api`) and rendered on the CPU at maxdepth
5 under each light-transport integrator:

- `bdpt`: RES_BDPT x RES_BDPT pixels at SPP_BDPT spp (the fixed batch,
  every connection strategy's visibility ray in one any-hit wave);
- `sppm`: RES_SPPM x RES_SPPM pixels, SPPM_ITERS iterations of
  SPPM_PHOTONS photons, radius SPPM_RADIUS;
- `mlt`: RES_MLT x RES_MLT pixels, MLT_CHAINS chains seeded from
  MLT_BOOTSTRAP bootstrap samples, MLT_MPP mutations per pixel.

Run from the repository root (each render takes minutes, most of it
compiling):

    JAX_PLATFORMS=cpu python tests/torch_golden/make_caustic_reference.py [bdpt|sppm|mlt|all]

It writes `tests/torch_golden/caustic_<integrator>_cpu_<RES>x<RES>_<N>.npz`
(N: spp, iterations or mutations per pixel) with the image, the
traced-ray count, the render's stats, the scene's triangle and treelet
counts, the compile and render wall times and the commit of the JAX
package it rendered with.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MAXDEPTH = 5
RES_BDPT, SPP_BDPT = 32, 16
RES_SPPM, SPPM_ITERS, SPPM_PHOTONS, SPPM_RADIUS = 64, 8, 1 << 16, 0.1
RES_MLT, MLT_CHAINS, MLT_BOOTSTRAP, MLT_MPP = 32, 4096, 16384, 64

#: integrator -> (resolution, the scene's spp, integrator parameters as scene
#: text, the count in the file name)
CASES = {
    "bdpt": (RES_BDPT, SPP_BDPT, "", SPP_BDPT),
    "sppm": (RES_SPPM, 1, f'"integer numiterations" [{SPPM_ITERS}] '
             f'"integer photonsperiteration" [{SPPM_PHOTONS}] "float radius" [{SPPM_RADIUS}]',
             SPPM_ITERS),
    "mlt": (RES_MLT, 1, f'"integer chains" [{MLT_CHAINS}] "integer bootstrapsamples" '
            f'[{MLT_BOOTSTRAP}] "integer mutationsperpixel" [{MLT_MPP}]', MLT_MPP),
}


def out_path(integrator: str) -> str:
    res, _, _, n = CASES[integrator]
    return os.path.join(HERE, f"caustic_{integrator}_cpu_{res}x{res}_{n}.npz")


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in (*CASES, "all"):
        raise SystemExit(f"usage: {sys.argv[0]} [{'|'.join(CASES)}|all]")
    root = os.path.dirname(os.path.dirname(HERE))
    sys.path.insert(0, root)
    sys.path.insert(0, HERE)
    import numpy as np

    from make_golden import _commit, jax_caustic_api
    from tpu_pbrt.scenes import compile_api

    commit = _commit(root)
    for integrator, (res, spp, params, _) in CASES.items():
        if which not in (integrator, "all"):
            continue
        t0 = time.perf_counter()
        scene, integ = compile_api(jax_caustic_api(res, spp, MAXDEPTH, integrator, params))
        compile_s = time.perf_counter() - t0
        print(f"{integrator}: compiled {scene.n_tris} triangles, "
              f"{scene.dev['tstream'].n_treelets} treelets in {compile_s:.1f} s", flush=True)
        t0 = time.perf_counter()
        res_ = integ.render(scene)
        wall = time.perf_counter() - t0
        img = np.asarray(res_.image, np.float32)
        assert img.shape == (res, res, 3) and np.isfinite(img).all()
        stats = {k: v for k, v in res_.stats.items() if isinstance(v, (int, float, str))}
        path = out_path(integrator)
        np.savez_compressed(
            path,
            image=img,
            rays_traced=np.int64(res_.rays_traced),
            stats=np.array(json.dumps(stats, sort_keys=True)),
            n_tris=np.int64(scene.n_tris),
            n_treelets=np.int64(scene.dev["tstream"].n_treelets),
            maxdepth=np.int64(MAXDEPTH),
            compile_seconds=np.float64(compile_s),
            wall_seconds=np.float64(wall),
            jax_commit=np.array(commit),
        )
        print(f"wrote {path}: mean {float(img.mean()):.8f}, rays {res_.rays_traced}, "
              f"stats {stats}, render {wall:.1f} s", flush=True)


if __name__ == "__main__":
    main()
