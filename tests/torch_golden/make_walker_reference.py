"""Write the JAX package's renders under its packet, wide and binary BVH
walkers (TPU_PBRT_BVH) that tests/test_torch_walkers.py holds the port's
walkers against.

Two scenes, each under `path` through the persistent pool of 256 slots:

- the Cornell box (`make_cornell`, 36 triangles: the binary and wide
  walkers win over the brute feature product there, the packet knob
  keeps the brute product) at 8x8, 4 spp, maxdepth 5;
- the small killeroo (`make_killeroo_like` at n_theta=12, n_phi=24: 532
  triangles, above BRUTE_MAX_TRIS, so the packet walker runs over the
  reference's default 64-triangle treelet pack) at 8x8, 4 spp.

Each golden `walker_<scene>_<knob>.npz` holds the image, the rays traced,
the triangle count and the JAX package's commit. Run from the repository
root (a minute or two each, most of it XLA compiling the walkers):

    JAX_PLATFORMS=cpu python tests/torch_golden/make_walker_reference.py [<scene>_<knob> ...]
"""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
#: scene -> the builder's keyword arguments (either package's scenes module)
SCENES = {
    "cornell": dict(res=8, spp=4, integrator="path", maxdepth=5),
    "killeroo": dict(res=8, spp=4, n_theta=12, n_phi=24, maxdepth=5),
}
KNOBS = ("packet", "wide", "binary")
POOL = 256
CASES = tuple(f"{s}_{k}" for s in SCENES for k in KNOBS)


def build_api(scenes, name: str, **device_kw):
    """The parsed scene of golden `name`, built with `scenes` (either
    package's scenes module)."""
    scene = name.split("_", 1)[0]
    make = scenes.make_cornell if scene == "cornell" else scenes.make_killeroo_like
    return make(**SCENES[scene], **device_kw)


def _commit() -> str:
    try:
        return subprocess.run(["git", "-C", ROOT, "rev-parse", "HEAD"], capture_output=True,
                              text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"


def write(name: str, commit: str) -> None:
    import numpy as np

    os.environ["TPU_PBRT_BVH"] = name.rsplit("_", 1)[1]
    os.environ["TPU_PBRT_REGEN"] = "1"
    os.environ["TPU_PBRT_POOL"] = str(POOL)
    from tpu_pbrt import config, scenes

    config.reload()
    scene, integ = scenes.compile_api(build_api(scenes, name))
    res = integ.render(scene)
    path = os.path.join(HERE, f"walker_{name}.npz")
    np.savez_compressed(path, image=np.asarray(res.image, np.float32),
                        rays_traced=np.int64(res.rays_traced), n_tris=np.int64(scene.n_tris),
                        accel=np.array(sorted(k for k in ("tpack", "wbvh", "bvh", "bfeat")
                                              if k in scene.dev)[0]),
                        jax_commit=np.array(commit))
    print(f"wrote {path}: mean {float(np.mean(res.image)):.8f}, rays {res.rays_traced}")


def main(names) -> None:
    sys.path.insert(0, ROOT)
    bad = [n for n in names if n not in CASES]
    if bad:
        raise SystemExit(f"unknown golden(s) {bad}; choose from {CASES}")
    commit = _commit()
    for name in names or CASES:
        write(name, commit)


if __name__ == "__main__":
    main(sys.argv[1:])
