"""Write the JAX package's CPU render of the cloud-class scene that
`chip_smoke.py` holds the port's render on the GPU against.

The scene is `tpu_pbrt_torch.scenes.make_cloud_like`'s (`cloud_parts`:
the killeroo's 128,880-triangle displaced sphere as a `Material "none"`
container of a homogeneous medium, sigma_a 0.05, sigma_s 2.5, g 0.5; the
killeroo's ground, quad area light and point light; the crown's HDR sky
as an infinite light), parsed through the JAX package's API from the
same text and arrays (make_golden.py's `jax_cloud_api`), at RES x RES
pixels, SPP spp, `volpath` at maxdepth 5 (4 pass-through iterations
more for the null container: 10 iterations), rendered on the CPU
through the reference's fixed batch.

Run from the repository root (it takes minutes, most of it tracing):

    JAX_PLATFORMS=cpu python tests/torch_golden/make_volpath_reference.py

It writes `tests/torch_golden/cloud_volpath_cpu_<RES>x<RES>_<SPP>spp.npz`
with the image, the traced-ray count, the scene's triangle and treelet
counts, the render's wall time and the commit of the JAX package it
rendered with.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RES, SPP, MAXDEPTH = 64, 16, 5
OUT = os.path.join(HERE, f"cloud_volpath_cpu_{RES}x{RES}_{SPP}spp.npz")


def main() -> None:
    root = os.path.dirname(os.path.dirname(HERE))
    sys.path.insert(0, root)
    sys.path.insert(0, HERE)
    import numpy as np

    from make_golden import _commit, jax_cloud_api
    from tpu_pbrt.scenes import compile_api

    commit = _commit(root)
    t0 = time.perf_counter()
    scene, integ = compile_api(jax_cloud_api(RES, SPP, MAXDEPTH))
    compile_s = time.perf_counter() - t0
    print(f"compiled: {scene.n_tris} triangles, {scene.dev['tstream'].n_treelets} treelets "
          f"in {compile_s:.1f} s", flush=True)
    assert scene.has_null_materials and scene.camera_medium_id == -1
    t0 = time.perf_counter()
    res = integ.render(scene)
    wall = time.perf_counter() - t0
    img = np.asarray(res.image, np.float32)
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()
    np.savez_compressed(
        OUT,
        image=img,
        rays_traced=np.int64(res.rays_traced),
        n_tris=np.int64(scene.n_tris),
        n_treelets=np.int64(scene.dev["tstream"].n_treelets),
        spp=np.int64(SPP),
        maxdepth=np.int64(MAXDEPTH),
        compile_seconds=np.float64(compile_s),
        wall_seconds=np.float64(wall),
        jax_commit=np.array(commit),
    )
    print(f"wrote {OUT}: mean {float(img.mean()):.8f}, rays {res.rays_traced}, "
          f"render {wall:.1f} s", flush=True)


if __name__ == "__main__":
    main()
