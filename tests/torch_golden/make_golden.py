"""Write the JAX package's render of the small killeroo that
tests/test_torch_render.py holds the port against.

The scene is `tpu_pbrt.scenes.make_killeroo_like(**SMALL)` (528 mesh
triangles + the ground quad and the light quad, so it takes the stream
tracer) cut into 64-triangle treelets, rendered on the CPU by the
fixed-batch loop (TPU_PBRT_REGEN=0), the loop the port implements. The
JAX render alone takes longer here than the port's test budget allows
(most of it compiling), so the test reads this file instead.

Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_golden/make_golden.py

It rewrites tests/torch_golden/killeroo_small.npz and records the commit
of the JAX package it rendered with.
"""

import os
import subprocess
import sys

#: the scene every consumer of the golden uses (also read by the test)
SMALL = dict(res=16, spp=4, n_theta=12, n_phi=24, maxdepth=5)
LEAF_TRIS = 64
HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "killeroo_small.npz")


def _commit(root: str) -> str:
    try:
        head = subprocess.run(["git", "-C", root, "rev-parse", "HEAD"], capture_output=True,
                              text=True, check=True).stdout.strip()
        dirty = subprocess.run(["git", "-C", root, "status", "--porcelain", "--", "tpu_pbrt"],
                               capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"
    return head + ("+dirty" if dirty else "")


def main() -> None:
    root = os.path.dirname(os.path.dirname(HERE))
    sys.path.insert(0, root)
    os.environ["TPU_PBRT_REGEN"] = "0"
    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    import numpy as np

    from tpu_pbrt import config
    from tpu_pbrt.scenes import compile_api, make_killeroo_like

    config.reload()
    scene, integ = compile_api(make_killeroo_like(**SMALL))
    assert "tstream" in scene.dev, "the small killeroo must take the stream tracer"
    res = integ.render(scene)
    np.savez_compressed(
        OUT,
        image=np.asarray(res.image, np.float32),
        rays_traced=np.int64(res.rays_traced),
        n_tris=np.int64(scene.n_tris),
        n_treelets=np.int64(scene.dev["tstream"].n_treelets),
        jax_commit=np.array(_commit(root)),
    )
    print(f"wrote {OUT}: mean {float(np.mean(res.image)):.8f}, rays {res.rays_traced}")


if __name__ == "__main__":
    main()
