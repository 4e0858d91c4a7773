"""Write the JAX package's CPU renders of the textured stand-in that the
port is held against: the small goldens of tests/test_torch_textured.py
and the full-geometry references `chip_smoke.py` reads on the GPU.

The scene is `tpu_pbrt_torch.scenes.textured_parts` (every texture kind,
mapping and wrap mode of the reference's texture evaluator, the uber,
substrate, translucent and mix materials, the crown's sky and a quad
area light), parsed through the JAX package's API from the same text and
the same image files, which the port's `textured_files` writes under
.torch_build/ (so both sides read the same bytes). The reference's
`plymesh` cannot compile, so each `ObjectBegin` declares the blob as the
`trianglemesh` of the arrays read back from the PLY file.

Small goldens (`TEXTURED_SMALL`: a 528-triangle blob, a 17x17
heightfield, 64x64 / 16x16 / 32x32 images; 8,838 triangles in 64-triangle
treelets) at 16x16, 4 spp, maxdepth 5 (2 for `directlighting`):

- `textured_path_pool`: `path` through the persistent pool (256 slots),
  with its wave count;
- `textured_path_fixed`: `path` through the fixed batch;
- `textured_direct`: `directlighting` at maxdepth 2;
- `textured_sppm`: `sppm`, 2 iterations of 4,096 photons;
- `textured_bdpt`: `bdpt`.

Full-geometry references (1,166,214 triangles, the default images):

- `textured_path_cpu_64x64_16spp`: `path` at 64x64, 16 spp through the
  reference's default program (the pool);
- `textured_bdpt_cpu_32x32_16spp`: `bdpt` at 32x32, 16 spp.

Run from the repository root (the small ones in under a minute each,
most of it tracing; the full ones several minutes and a few GB):

    JAX_PLATFORMS=cpu python tests/torch_golden/make_textured_reference.py [<name>|small|full|all]

Each file holds the image, the traced-ray count, the scene's triangle
count (and treelets, atlas texels), the wave count where
the pool ran, the render's wall time and the commit of the JAX package.
"""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
#: small goldens: name -> (integrator, integrator parameters, regen, maxdepth);
#: `directlighting` unrolls its depth loop into one XLA program, whose
#: compile with the scene's fourteen textures outgrows half an hour at
#: maxdepth 5, so its golden stops at maxdepth 2
SMALL_CASES = {
    "textured_path_pool": ("path", "", True, 5),
    "textured_path_fixed": ("path", "", False, 5),
    "textured_direct": ("directlighting", "", False, 2),
    "textured_sppm": ("sppm", '"integer numiterations" [2] "integer photonsperiteration" [4096]',
                      False, 5),
    "textured_bdpt": ("bdpt", "", False, 5),
}
SMALL_RES, SMALL_SPP, LEAF_TRIS, POOL = 16, 4, 64, 256
#: full references: name -> (integrator, resolution, spp)
FULL_CASES = {
    "textured_path_cpu_64x64_16spp": ("path", 64, 16),
    "textured_bdpt_cpu_32x32_16spp": ("bdpt", 32, 16),
}


def jax_textured_api(res, spp, maxdepth=5, integrator="path", params="", **kw):
    """The port's textured stand-in (`textured_parts`: the same text and
    files) parsed through the JAX package's API, up to (not including)
    WorldEnd, each blob a `trianglemesh` of the PLY's float32 arrays."""
    from tpu_pbrt_torch.scenes import textured_parts
    from tpu_pbrt.scene.api import Options, parse_string, pbrt_init
    from tpu_pbrt.scene.paramset import ParamSet
    from tpu_pbrt.scene.plyreader import read_ply

    texts, ply = textured_parts(res, spp, maxdepth, integrator, params, **kw)
    mesh = read_ply(ply)
    api = pbrt_init(Options(quiet=True))
    for k, text in enumerate(texts):
        api = parse_string(text, api)
        if k < len(texts) - 1:
            ps = ParamSet()
            ps.add("integer indices", mesh["indices"].reshape(-1).tolist())
            ps.add("point P", mesh["vertices"].reshape(-1).tolist())
            ps.add("normal N", mesh["normals"].reshape(-1).tolist())
            api.shape("trianglemesh", ps)
    return api


def _render(name, api, regen, commit, **extra):
    import numpy as np

    from tpu_pbrt import scenes

    t0 = time.perf_counter()
    scene, integ = scenes.compile_api(api)
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = integ.render(scene)
    wall = time.perf_counter() - t0
    img = np.asarray(res.image, np.float32)
    assert np.isfinite(img).all() and img.mean() > 0
    if regen is not None:
        assert bool(res.stats.get("regen")) == regen, res.stats.get("regen")
    out = os.path.join(HERE, f"{name}.npz")
    np.savez_compressed(
        out,
        image=img,
        rays_traced=np.int64(res.rays_traced),
        n_waves=np.int64(res.stats.get("n_waves", -1)),
        n_tris=np.int64(scene.n_tris),
        n_treelets=np.int64(scene.dev["tstream"].n_treelets),
        **({"atlas_texels": np.int64(scene.dev["tex_atlas"].shape[0])}
           if "tex_atlas" in scene.dev else {}),
        compile_seconds=np.float64(compile_s),
        wall_seconds=np.float64(wall),
        jax_commit=np.array(commit),
        **extra,
    )
    print(f"wrote {out}: mean {float(img.mean()):.8f}, rays {res.rays_traced}, waves "
          f"{res.stats.get('n_waves')}, {scene.n_tris} triangles, compile {compile_s:.1f} s, "
          f"render {wall:.1f} s", flush=True)


def write_small(name, commit):
    from tpu_pbrt import config
    from tpu_pbrt_torch.scenes import TEXTURED_SMALL

    integrator, params, regen, maxdepth = SMALL_CASES[name]
    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    os.environ["TPU_PBRT_REGEN"] = "1" if regen else "0"
    os.environ["TPU_PBRT_POOL"] = str(POOL) if regen else "0"
    config.reload()
    api = jax_textured_api(SMALL_RES, SMALL_SPP, maxdepth, integrator, params, **TEXTURED_SMALL)
    _render(name, api, regen if integrator == "path" else None, commit)


def write_full(name, commit):
    from tpu_pbrt import config

    integrator, res, spp = FULL_CASES[name]
    for k in ("TPU_PBRT_LEAF_TRIS", "TPU_PBRT_REGEN", "TPU_PBRT_POOL"):
        os.environ.pop(k, None)
    config.reload()
    api = jax_textured_api(res, spp, 5, integrator)
    _render(name, api, True if integrator == "path" else None, commit)


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    names = (*SMALL_CASES, *FULL_CASES, "small", "full", "all")
    if which not in names:
        raise SystemExit(f"usage: {sys.argv[0]} [{'|'.join(names)}]")
    root = os.path.dirname(os.path.dirname(HERE))
    sys.path.insert(0, root)
    sys.path.insert(0, HERE)
    from make_golden import _commit

    commit = _commit(root)
    for name in SMALL_CASES:
        if which in (name, "small", "all"):
            write_small(name, commit)
    for name in FULL_CASES:
        if which in (name, "full", "all"):
            write_full(name, commit)


if __name__ == "__main__":
    main()
