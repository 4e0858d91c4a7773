"""Write the JAX package's renders of the small killeroo that the port's
tests hold it against.

The scene is `tpu_pbrt.scenes.make_killeroo_like(**SMALL)` (528 mesh
triangles + the ground quad and the light quad, so it takes the stream
tracer) cut into 64-triangle treelets, rendered on the CPU twice:

- `killeroo_small.npz` (tests/test_torch_render.py): the fixed-batch loop
  (TPU_PBRT_REGEN=0), which traces the fused camera+shadow layout;
- `killeroo_small_pool.npz` (tests/test_torch_pool.py): the persistent
  pool (`PathIntegrator.pool_chunk`, TPU_PBRT_REGEN=1) with 256 slots
  (TPU_PBRT_POOL=256), with its wave count and telemetry counters.

The JAX renders alone take longer here than the port's test budget
allows (most of it compiling), so the tests read these files instead.

Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_golden/make_golden.py [fixed|pool|all]

It rewrites the named golden(s) (default: all) and records the commit of
the JAX package it rendered with.
"""

import json
import os
import subprocess
import sys

#: the scene every consumer of the goldens uses (also read by the tests)
SMALL = dict(res=16, spp=4, n_theta=12, n_phi=24, maxdepth=5)
LEAF_TRIS = 64
#: pool slots of the pool golden
POOL = 256
HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "killeroo_small.npz")
OUT_POOL = os.path.join(HERE, "killeroo_small_pool.npz")


def _commit(root: str) -> str:
    try:
        head = subprocess.run(["git", "-C", root, "rev-parse", "HEAD"], capture_output=True,
                              text=True, check=True).stdout.strip()
        dirty = subprocess.run(["git", "-C", root, "status", "--porcelain", "--", "tpu_pbrt"],
                               capture_output=True, text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"
    return head + ("+dirty" if dirty else "")


def _render(regen: bool):
    os.environ["TPU_PBRT_REGEN"] = "1" if regen else "0"
    os.environ["TPU_PBRT_POOL"] = str(POOL) if regen else "0"
    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    from tpu_pbrt import config
    from tpu_pbrt.scenes import compile_api, make_killeroo_like

    config.reload()
    scene, integ = compile_api(make_killeroo_like(**SMALL))
    assert "tstream" in scene.dev, "the small killeroo must take the stream tracer"
    return scene, integ.render(scene)


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in ("fixed", "pool", "all"):
        raise SystemExit(f"usage: {sys.argv[0]} [fixed|pool|all]")
    root = os.path.dirname(os.path.dirname(HERE))
    sys.path.insert(0, root)
    import numpy as np

    commit = _commit(root)
    if which in ("fixed", "all"):
        scene, res = _render(regen=False)
        np.savez_compressed(
            OUT,
            image=np.asarray(res.image, np.float32),
            rays_traced=np.int64(res.rays_traced),
            n_tris=np.int64(scene.n_tris),
            n_treelets=np.int64(scene.dev["tstream"].n_treelets),
            jax_commit=np.array(commit),
        )
        print(f"wrote {OUT}: mean {float(np.mean(res.image)):.8f}, rays {res.rays_traced}")
    if which in ("pool", "all"):
        scene, res = _render(regen=True)
        assert res.stats["pool"] == POOL and res.stats["regen"]
        np.savez_compressed(
            OUT_POOL,
            image=np.asarray(res.image, np.float32),
            rays_traced=np.int64(res.rays_traced),
            n_waves=np.int64(res.stats["n_waves"]),
            pool=np.int64(res.stats["pool"]),
            mean_wave_occupancy=np.float64(res.stats["mean_wave_occupancy"]),
            counters=np.array(json.dumps(res.stats["telemetry"]["counters"], sort_keys=True)),
            n_tris=np.int64(scene.n_tris),
            n_treelets=np.int64(scene.dev["tstream"].n_treelets),
            jax_commit=np.array(commit),
        )
        print(f"wrote {OUT_POOL}: mean {float(np.mean(res.image)):.8f}, rays {res.rays_traced}, "
              f"waves {res.stats['n_waves']}, counters {res.stats['telemetry']['counters']}")


if __name__ == "__main__":
    main()
