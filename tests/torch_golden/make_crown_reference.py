"""Write the JAX package's CPU render of the crown-class scene that
`chip_smoke.py` holds the port's render on the GPU against.

The scene is `tpu_pbrt.scenes.make_crown_like` at its full geometry
(1,153,682 triangles: the displaced glass mesh, two metal-GGX pieces, the
matte ground; the HDR sky as its environment light) at 64x64 pixels,
64 spp, maxdepth 5, rendered on the CPU through the JAX package's default
program (the persistent pool, `PathIntegrator.render`).

Run from the repository root (it takes minutes, most of it tracing):

    JAX_PLATFORMS=cpu python tests/torch_golden/make_crown_reference.py [SPP]

It writes `tests/torch_golden/crown_cpu_64x64_<SPP>spp.npz` (SPP defaults
to 64) with the image, the traced-ray count, the wave count, the scene's
triangle and treelet counts, the render's wall time and the commit of the
JAX package it rendered with.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RES, MAXDEPTH = 64, 5


def main() -> None:
    spp = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    root = os.path.dirname(os.path.dirname(HERE))
    sys.path.insert(0, root)
    sys.path.insert(0, HERE)
    import numpy as np

    from make_golden import _commit
    from tpu_pbrt.scenes import compile_api, make_crown_like

    commit = _commit(root)
    t0 = time.perf_counter()
    scene, integ = compile_api(make_crown_like(res=RES, spp=spp, maxdepth=MAXDEPTH))
    compile_s = time.perf_counter() - t0
    print(f"compiled: {scene.n_tris} triangles, {scene.dev['tstream'].n_treelets} treelets "
          f"in {compile_s:.1f} s", flush=True)
    t0 = time.perf_counter()
    res = integ.render(scene)
    wall = time.perf_counter() - t0
    assert res.stats.get("regen"), "the reference must render through its default program"
    img = np.asarray(res.image, np.float32)
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()
    out = os.path.join(HERE, f"crown_cpu_{RES}x{RES}_{spp}spp.npz")
    np.savez_compressed(
        out,
        image=img,
        rays_traced=np.int64(res.rays_traced),
        n_waves=np.int64(res.stats["n_waves"]),
        pool=np.int64(res.stats["pool"]),
        n_tris=np.int64(scene.n_tris),
        n_treelets=np.int64(scene.dev["tstream"].n_treelets),
        spp=np.int64(spp),
        maxdepth=np.int64(MAXDEPTH),
        compile_seconds=np.float64(compile_s),
        wall_seconds=np.float64(wall),
        jax_commit=np.array(commit),
    )
    print(f"wrote {out}: mean {float(img.mean()):.8f}, rays {res.rays_traced}, "
          f"waves {res.stats['n_waves']}, render {wall:.1f} s", flush=True)


if __name__ == "__main__":
    main()
