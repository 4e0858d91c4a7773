"""Write the JAX package's CPU renders of the direct-lighting family that
`chip_smoke.py` holds the port's renders on the GPU against.

- `cornell_direct_cpu_256x256_16spp.npz`: the repository's own
  `scenes/cornell-box.pbrt` (`directlighting`, 256x256, 16 spp, maxdepth
  5) rendered through `tpu_pbrt.render_file`, the CLI's path;
- `killeroo_direct_cpu_64x64_16spp.npz`: `tpu_pbrt.scenes.make_killeroo_like`
  at its full mesh (128,884 triangles), 64x64, 16 spp, under
  `directlighting` (strategy "all", maxdepth 5);
- `killeroo_ao_cpu_64x64_16spp.npz`: the same scene under `ao` with
  `maxdistance` AO_MAXDIST (a finite t_max into the any-hit traversal).

Run from the repository root (minutes, most of it tracing):

    JAX_PLATFORMS=cpu python tests/torch_golden/make_direct_reference.py [cornell|direct|ao|all]

Each file holds the image, the traced-ray count, the killeroo's triangle
count, the render's wall time and the commit of the JAX package it
rendered with.
"""

import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
CORNELL_FILE = os.path.join(ROOT, "scenes", "cornell-box.pbrt")
KILLEROO_RES, KILLEROO_SPP, MAXDEPTH = 64, 16, 5
#: the killeroo ao render's occlusion distance (scene units)
AO_MAXDIST = 0.5
#: target -> output file
OUTS = {
    "cornell": "cornell_direct_cpu_256x256_16spp.npz",
    "direct": "killeroo_direct_cpu_64x64_16spp.npz",
    "ao": "killeroo_ao_cpu_64x64_16spp.npz",
}


def killeroo_api(scenes, which: str, res=KILLEROO_RES, spp=KILLEROO_SPP, **kw):
    """The full killeroo under `directlighting` or `ao` (either package's
    scenes module; kw goes to make_killeroo_like)."""
    from make_golden import configure

    api = scenes.make_killeroo_like(res=res, spp=spp, maxdepth=MAXDEPTH, **kw)
    if which == "direct":
        return configure(api, "directlighting")
    return configure(api, "ao", (("float maxdistance", [AO_MAXDIST]),))


def _render(which: str):
    import numpy as np

    from tpu_pbrt import scenes
    from tpu_pbrt.scene.api import Options, render_file

    if which == "cornell":
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            res = render_file(CORNELL_FILE, Options(quiet=True,
                                                    image_file=os.path.join(tmp, "c.exr")))
            return res, {}, time.perf_counter() - t0
    scene, integ = scenes.compile_api(killeroo_api(scenes, which))
    t0 = time.perf_counter()
    res = integ.render(scene)
    return res, {"n_tris": np.int64(scene.n_tris)}, time.perf_counter() - t0


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which not in tuple(OUTS) + ("all",):
        raise SystemExit(f"usage: {sys.argv[0]} [{'|'.join(OUTS)}|all]")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, HERE)
    import numpy as np

    from make_golden import _commit

    commit = _commit(ROOT)
    for target, name in OUTS.items():
        if which not in (target, "all"):
            continue
        res, extra, wall = _render(target)
        img = np.asarray(res.image, np.float32)
        assert np.isfinite(img).all()
        out = os.path.join(HERE, name)
        np.savez_compressed(
            out,
            image=img,
            rays_traced=np.int64(res.rays_traced),
            **extra,
            wall_seconds=np.float64(wall),
            jax_commit=np.array(commit),
        )
        print(f"wrote {out}: {img.shape}, mean {float(img.mean()):.8f}, rays "
              f"{res.rays_traced}, render {wall:.1f} s", flush=True)


if __name__ == "__main__":
    main()
