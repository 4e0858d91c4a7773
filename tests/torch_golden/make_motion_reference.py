"""Write the JAX package's CPU renders of the motion stand-in that the port
is held against: the small goldens of tests/test_torch_motion.py and the
full-geometry references `chip_smoke.py` reads on the GPU.

The scene is `tpu_pbrt_torch.scenes.motion_parts` (hair curves under the
three ways `hair` resolves its absorption and three instances of the
killeroo's blob in disney, the hair block and two instances moving over
an open shutter), parsed through the JAX package's API from the same text
and the same files, which the port writes under .torch_build/. The
reference's `plymesh` cannot compile, so each `ObjectBegin` declares the
blob as the `trianglemesh` of the arrays read back from the PLY file.

Small goldens (`MOTION_SMALL`: 240 hair segments, a 528-triangle blob;
9,268 triangles in 64-triangle treelets) at 16x16, 4 spp, maxdepth 5:

- `motion_path_pool`: `path` through the persistent pool (256 slots),
  with its wave count;
- `motion_path_fixed`: `path` through the fixed batch;
- `motion_bdpt`: `bdpt` (the shutter-start frame: the reference's BDPT
  traces at time 0).

The first two camera waves of `motion_path_pool` as the compiled program
computes them (`motion_camera_wave`): each wave's film points, lens
samples and ray origins and directions, read out of the reference's
`pool_chunk` through an ordered debug callback on `generate_rays` (which
leaves the render bit-identical to `motion_path_pool`, checked here).

Full-geometry references (1,042,004 triangles):

- `motion_path_cpu_64x64_64spp`: `path` at 64x64, 64 spp through the
  reference's default program (the pool). The hair's longitudinal
  sampling amplifies the last bits in which XLA's log, exp and asin and
  torch's differ, so a few hair paths take another way (at 16 spp the
  rays differed by 5 of 356,561); their share of the image's squared
  difference falls as 1/spp, and at 16 spp it reached the 1e-4 bar
  (1.14e-4 on the card, 1.13e-4 on the CPU port), so this reference
  takes 64 spp, as the crown's does;
- `motion_bdpt_cpu_32x32_16spp`: `bdpt` at 32x32, 16 spp.

Run from the repository root (the small ones in minutes each, most of it
XLA compiling; the full ones longer and several GB: one at a time):

    JAX_PLATFORMS=cpu python tests/torch_golden/make_motion_reference.py [<name>|small|full|all]

Each file holds the image, the traced-ray count, the scene's triangle
count and treelets, the wave count where the pool ran, the render's wall
time and the commit of the JAX package.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
#: small goldens: name -> (integrator, regen)
SMALL_CASES = {
    "motion_path_pool": ("path", True),
    "motion_path_fixed": ("path", False),
    "motion_bdpt": ("bdpt", False),
}
SMALL_RES, SMALL_SPP, LEAF_TRIS, POOL = 16, 4, 64, 256
#: full references: name -> (integrator, resolution, spp)
FULL_CASES = {
    "motion_path_cpu_64x64_16spp": ("path", 64, 16),
    "motion_path_cpu_64x64_64spp": ("path", 64, 64),
    "motion_bdpt_cpu_32x32_16spp": ("bdpt", 32, 16),
}


def jax_motion_api(res, spp, maxdepth=5, integrator="path", params="", small=False):
    """The port's motion stand-in (`motion_parts`: the same text and files)
    parsed through the JAX package's API, up to (not including) WorldEnd,
    each blob a `trianglemesh` of the PLY's float32 arrays."""
    from tpu_pbrt_torch.scenes import MOTION_SMALL, motion_parts
    from tpu_pbrt.scene.api import Options, parse_string, pbrt_init
    from tpu_pbrt.scene.paramset import ParamSet
    from tpu_pbrt.scene.plyreader import read_ply

    kw = MOTION_SMALL if small else {}
    texts, ply = motion_parts(res, spp, maxdepth, integrator, params, **kw)
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


def write_small(name, commit):
    from tpu_pbrt import config
    from make_textured_reference import _render

    integrator, regen = SMALL_CASES[name]
    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    os.environ["TPU_PBRT_REGEN"] = "1" if regen else "0"
    os.environ["TPU_PBRT_POOL"] = str(POOL) if regen else "0"
    config.reload()
    api = jax_motion_api(SMALL_RES, SMALL_SPP, 5, integrator, small=True)
    _render(name, api, regen if integrator == "path" else None, commit)


def write_camera_wave(commit):
    """The first two regeneration waves' generate_rays inputs and outputs
    inside the reference's compiled small pool render."""
    import jax
    import numpy as np

    import tpu_pbrt.integrators.common as jcommon
    from tpu_pbrt import config, scenes

    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    os.environ["TPU_PBRT_REGEN"] = "1"
    os.environ["TPU_PBRT_POOL"] = str(POOL)
    config.reload()
    waves = []
    generate_rays = jcommon.generate_rays

    def keep(p_film, u_lens, o, d):
        if p_film.shape[0] == POOL:  # the pool's waves, not the capacity audit
            waves.append([np.asarray(x).copy() for x in (p_film, u_lens, o, d)])

    def captured(cam, p_film, u_lens):
        o, d, wt = generate_rays(cam, p_film, u_lens)
        jax.debug.callback(keep, p_film, u_lens, o, d, ordered=True)
        return o, d, wt

    jcommon.generate_rays = captured
    try:
        scene, integ = scenes.compile_api(
            jax_motion_api(SMALL_RES, SMALL_SPP, 5, "path", small=True))
        res = integ.render(scene)
    finally:
        jcommon.generate_rays = generate_rays
    gold = np.load(os.path.join(HERE, "motion_path_pool.npz"))
    assert np.array_equal(np.asarray(res.image, np.float32), gold["image"]), \
        "the capture changed the render"
    out = os.path.join(HERE, "motion_camera_wave.npz")
    np.savez_compressed(out, **{f"{k}{w}": waves[w][i] for w in range(2)
                                for i, k in enumerate(("p_film", "u_lens", "o", "d"))},
                        jax_commit=np.array(commit))
    print(f"wrote {out}: {len(waves)} waves of {POOL}")


def write_full(name, commit):
    from tpu_pbrt import config
    from make_textured_reference import _render

    integrator, res, spp = FULL_CASES[name]
    for k in ("TPU_PBRT_LEAF_TRIS", "TPU_PBRT_REGEN", "TPU_PBRT_POOL"):
        os.environ.pop(k, None)
    config.reload()
    api = jax_motion_api(res, spp, 5, integrator)
    _render(name, api, True if integrator == "path" else None, commit)


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    names = (*SMALL_CASES, "motion_camera_wave", *FULL_CASES, "small", "full", "all")
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
    if which in ("motion_camera_wave", "small", "all"):
        write_camera_wave(commit)
    for name in FULL_CASES:
        if which in (name, "full", "all"):
            write_full(name, commit)


if __name__ == "__main__":
    main()
