"""Write the JAX package's CPU renders of the subsurface stand-in that the
port is held against: the small goldens of tests/test_torch_subsurface.py
and the full-geometry reference `chip_smoke.py` reads on the GPU.

The scene is `tpu_pbrt_torch.scenes.subsurface_parts` (a `subsurface`
blob, a smaller `kdsubsurface` instance and a `fourier` ground whose
3-channel table the port writes), parsed through the JAX package's API
from the same text and the same files, which the port writes under
.torch_build/. The reference's `plymesh` cannot compile, so each blob is
declared as the `trianglemesh` of the arrays read back from its PLY
file.

Small goldens (`SUBSURFACE_SMALL`: 2,740 triangles in 64-triangle
treelets) at 16x16, 4 spp, maxdepth 5:

- `subsurface_path_pool`: `path` through the persistent pool (256
  slots), with its wave count;
- `subsurface_path_fixed`: `path` through the fixed batch;
- `subsurface_probe_wave`: one bounce wave of `path` (the fused layout,
  bounce 0) on 1,024 seeded rays aimed at the large blob, as the JAX
  package's `_bounce_wave` runs it eagerly: the rays, every lane field
  after the wave, and from inside its BSSRDF probe block the profile Sp
  at the exit (`sr_eval`'s output) and Pdf_Sp's sum `pdf_tot` (the
  argument of the reference's `jnp.maximum(pdf_tot, 1e-20)`, read by
  wrapping the functions the block calls); and the compiled material
  columns, Fourier table and baked BSSRDF rows of the scene.

Full-geometry reference (1,126,884 triangles):

- `subsurface_path_cpu_64x64_16spp`: `path` at 64x64, 16 spp through the
  reference's default program (the pool).

Run from the repository root (the small ones in a few minutes each, most
of it XLA compiling; the full one longer and several GB):

    JAX_PLATFORMS=cpu python tests/torch_golden/make_subsurface_reference.py [<name>|small|full|all]

Each file holds the image, the traced-ray count, the scene's triangle
count and treelets, the wave count where the pool ran, the render's wall
time and the commit of the JAX package.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
#: small goldens: name -> regen (the pool or the fixed batch)
SMALL_CASES = {
    "subsurface_path_pool": True,
    "subsurface_path_fixed": False,
}
#: the captured probe wave's rays
PROBE_R = 1024
SMALL_RES, SMALL_SPP, LEAF_TRIS, POOL = 16, 4, 64, 256
#: full references: name -> (resolution, spp)
FULL_CASES = {
    "subsurface_path_cpu_64x64_16spp": (64, 16),
}


def jax_subsurface_api(res, spp, maxdepth=5, integrator="path", small=False):
    """The port's subsurface stand-in (`subsurface_parts`: the same text
    and files) parsed through the JAX package's API, up to (not including)
    WorldEnd, each blob a `trianglemesh` of its PLY's float32 arrays."""
    from tpu_pbrt_torch.scenes import SUBSURFACE_SMALL, subsurface_parts
    from tpu_pbrt.scene.api import Options, parse_string, pbrt_init
    from tpu_pbrt.scene.paramset import ParamSet
    from tpu_pbrt.scene.plyreader import read_ply

    kw = SUBSURFACE_SMALL if small else {}
    texts, plys = subsurface_parts(res, spp, maxdepth, integrator, **kw)
    api = pbrt_init(Options(quiet=True))
    api = parse_string(texts[0], api)
    for ply, more in zip(plys, texts[1:]):
        mesh = read_ply(ply)
        ps = ParamSet()
        ps.add("integer indices", mesh["indices"].reshape(-1).tolist())
        ps.add("point P", mesh["vertices"].reshape(-1).tolist())
        ps.add("normal N", mesh["normals"].reshape(-1).tolist())
        api.shape("trianglemesh", ps)
        api = parse_string(more, api)
    return api


def write_small(name, commit):
    from tpu_pbrt import config
    from make_textured_reference import _render

    regen = SMALL_CASES[name]
    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    os.environ["TPU_PBRT_REGEN"] = "1" if regen else "0"
    os.environ["TPU_PBRT_POOL"] = str(POOL) if regen else "0"
    config.reload()
    api = jax_subsurface_api(SMALL_RES, SMALL_SPP, 5, small=True)
    _render(name, api, regen, commit)


def probe_rays():
    """The probe wave's seeded rays (numpy): from the camera's eye toward
    points around the large blob, with their pixel and sample indices."""
    import numpy as np

    rng = np.random.default_rng(21)
    R = PROBE_R
    eye = np.array([0.0, 1.0, -3.4])
    target = np.array([-0.35, 0.1, 0.6]) + rng.uniform(-0.7, 0.7, (R, 3))
    d = target - eye
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(eye, (R, 3))
    px = rng.integers(0, SMALL_RES, R)
    py = rng.integers(0, SMALL_RES, R)
    s = rng.integers(0, SMALL_SPP, R)
    return (o.astype(np.float32), d.astype(np.float32), px.astype(np.int32),
            py.astype(np.int32), s.astype(np.int32))


def write_probe(name, commit):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_pbrt import config, scenes
    from tpu_pbrt.core import bssrdf as jbs
    from tpu_pbrt.integrators.path import fresh_lanes

    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    os.environ["TPU_PBRT_REGEN"] = "0"
    config.reload()
    scene, integ = scenes.compile_api(jax_subsurface_api(SMALL_RES, SMALL_SPP, 5, small=True))
    o, d, px, py, s = probe_rays()
    seen = {"sp": None, "pdf_sr": 0, "in_pdf": False, "pdf_tot": None}
    sr_eval, pdf_sr, maximum = jbs.sr_eval, jbs.pdf_sr, jnp.maximum

    def rec_sr_eval(*a):
        out = sr_eval(*a)
        seen["sp"] = np.asarray(out)
        return out

    def rec_pdf_sr(*a):
        seen["in_pdf"] = True
        out = pdf_sr(*a)
        seen["in_pdf"] = False
        seen["pdf_sr"] += 1
        return out

    def rec_maximum(x, y, *a, **k):
        # the first jnp.maximum(., 1e-20) after the nine radial pdfs is
        # w_sss's denominator: Pdf_Sp's sum
        if (seen["pdf_sr"] == 9 and not seen["in_pdf"] and seen["pdf_tot"] is None
                and isinstance(y, float) and y == 1e-20):
            seen["pdf_tot"] = np.asarray(x)
        return maximum(x, y, *a, **k)

    jbs.sr_eval, jbs.pdf_sr, jnp.maximum = rec_sr_eval, rec_pdf_sr, rec_maximum
    try:
        st = fresh_lanes(jnp.asarray(o), jnp.asarray(d))
        lane, nrays, _ = integ._bounce_wave(
            scene.dev, jnp.asarray(px), jnp.asarray(py), jnp.asarray(s), 0, None, st,
            jnp.zeros((PROBE_R,), jnp.int32), fused=True, scalar_bounce=jnp.int32(0))
        jax.block_until_ready(lane.o)
    finally:
        jbs.sr_eval, jbs.pdf_sr, jnp.maximum = sr_eval, pdf_sr, maximum
    assert seen["pdf_tot"] is not None and seen["sp"] is not None
    out = os.path.join(HERE, f"{name}.npz")
    np.savez_compressed(
        out, o_in=o, d_in=d, px=px, py=py, s=s, nrays=np.asarray(nrays), sp=seen["sp"],
        pdf_tot=seen["pdf_tot"], jax_commit=np.array(commit),
        **{f"lane_{f}": np.asarray(getattr(lane, f)) for f in lane._fields},
        **{f"mat_{k}": np.asarray(v) for k, v in scene.dev["mat"].items() if k != "_fourier"},
        **{f"fourier_{f}": np.asarray(getattr(scene.dev["mat"]["_fourier"], f))
           for f in ("mu", "cdf", "a", "offset", "m", "eta", "n_channels", "m_max")},
        **{f"bssrdf_{f}": np.asarray(getattr(scene.dev["bssrdf"], f))
           for f in scene.dev["bssrdf"]._fields})
    print(f"wrote {out}: {int(np.asarray(lane.alive).sum())} lanes alive, "
          f"{int((seen['pdf_tot'] > 0).sum())} with pdf_tot > 0", flush=True)


def write_full(name, commit):
    from tpu_pbrt import config
    from make_textured_reference import _render

    res, spp = FULL_CASES[name]
    for k in ("TPU_PBRT_LEAF_TRIS", "TPU_PBRT_REGEN", "TPU_PBRT_POOL"):
        os.environ.pop(k, None)
    config.reload()
    api = jax_subsurface_api(res, spp, 5)
    _render(name, api, True, commit)


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    names = (*SMALL_CASES, "subsurface_probe_wave", *FULL_CASES, "small", "full", "all")
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
    if which in ("subsurface_probe_wave", "small", "all"):
        write_probe("subsurface_probe_wave", commit)
    for name in FULL_CASES:
        if which in (name, "full", "all"):
            write_full(name, commit)


if __name__ == "__main__":
    main()
