"""Write the JAX package's CPU renders of the scene-breadth stand-in that
`chip_smoke.py` holds the port's renders on the GPU against.

The scene is `tpu_pbrt_torch.scenes.make_breadth_like` at its full
geometry (1,178,624 triangles: eight object instances of the killeroo's
128,880-triangle blob, a 257x257 `heightfield2` ground, the five
quadrics, a level-4 `loopsubdiv` tetrahedron and 256 `curve` strands;
the spot, goniometric, projection and infinite lights), parsed through
the JAX package's API from the same text, PLY file and light maps
(make_golden.py's `jax_breadth_api`: the reference's `plymesh` cannot
compile, so the blob is the `trianglemesh` of the arrays read back from
the PLY file), at 64x64 pixels, 16 spp, `path` at maxdepth 5, rendered
on the CPU through the JAX package's default program (the persistent
pool), once per camera:

- `perspective`: the perspective camera under the gaussian filter;
- `realistic`: the realistic camera (the built-in doublet focused at
  5.2, a 4 mm aperture) under the mitchell filter.

Run from the repository root (minutes each, most of it tracing):

    JAX_PLATFORMS=cpu python tests/torch_golden/make_breadth_reference.py [perspective|realistic|all]

It writes `tests/torch_golden/breadth_<camera>_cpu_64x64_16spp.npz` with
the image, the traced-ray count, the wave count, the scene's triangle
and treelet counts, the render's wall time and the commit of the JAX
package it rendered with.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RES, SPP, MAXDEPTH = 64, 16, 5
#: camera -> filter of each reference render
CASES = {"perspective": "gaussian", "realistic": "mitchell"}


def render(camera: str, commit: str) -> None:
    import numpy as np

    from make_golden import jax_breadth_api
    from tpu_pbrt.scenes import compile_api

    t0 = time.perf_counter()
    scene, integ = compile_api(jax_breadth_api(RES, SPP, MAXDEPTH, camera=camera,
                                               filter=CASES[camera]))
    compile_s = time.perf_counter() - t0
    print(f"{camera}: compiled {scene.n_tris} triangles, {scene.dev['tstream'].n_treelets} "
          f"treelets in {compile_s:.1f} s", flush=True)
    t0 = time.perf_counter()
    res = integ.render(scene)
    wall = time.perf_counter() - t0
    assert res.stats.get("regen"), "the reference must render through its default program"
    img = np.asarray(res.image, np.float32)
    assert img.shape == (RES, RES, 3) and np.isfinite(img).all()
    out = os.path.join(HERE, f"breadth_{camera}_cpu_{RES}x{RES}_{SPP}spp.npz")
    np.savez_compressed(
        out,
        image=img,
        rays_traced=np.int64(res.rays_traced),
        n_waves=np.int64(res.stats["n_waves"]),
        n_tris=np.int64(scene.n_tris),
        n_treelets=np.int64(scene.dev["tstream"].n_treelets),
        spp=np.int64(SPP),
        maxdepth=np.int64(MAXDEPTH),
        camera=np.array(camera),
        filter=np.array(CASES[camera]),
        compile_seconds=np.float64(compile_s),
        wall_seconds=np.float64(wall),
        jax_commit=np.array(commit),
    )
    print(f"wrote {out}: mean {float(img.mean()):.8f}, rays {res.rays_traced}, "
          f"waves {res.stats['n_waves']}, render {wall:.1f} s", flush=True)


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in (*CASES, "all"):
        raise SystemExit(f"usage: {sys.argv[0]} [{'|'.join(CASES)}|all]")
    root = os.path.dirname(os.path.dirname(HERE))
    sys.path.insert(0, root)
    sys.path.insert(0, HERE)
    from make_golden import _commit

    commit = _commit(root)
    for camera in CASES:
        if which in (camera, "all"):
            render(camera, commit)


if __name__ == "__main__":
    main()
