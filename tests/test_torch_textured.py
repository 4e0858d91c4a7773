"""The textured stand-in (`tpu_pbrt_torch.scenes.make_textured_like`, its
small variant `TEXTURED_SMALL`: a 528-triangle blob in eight
`ObjectInstance`s, a 17x17 heightfield, 64x64 / 16x16 / 32x32 images;
8,838 triangles in 64-triangle treelets) on the CPU, against the JAX
package, and the ray differentials that drive its mip filter.

- Every device table of the compile equals the reference's compile of
  the same text through scene/bridge.py, bit for bit: the texture atlas,
  the (8, T) dpdu/dpdv table, the mix and texture-id columns and the
  opacity among them; the textured slots and the bump warning are the
  reference's; disney, hair, fourier and subsurface still raise.
- The 16x16x4 renders against the goldens of
  tests/torch_golden/make_textured_reference.py: `path` through the pool
  (256 slots) and the fixed batch, `directlighting` (at maxdepth 2),
  `sppm` and `bdpt`.
  Rays (and the pool's waves) and the image MSE within GOLDEN_TOL: the
  reference's jitted render rounds a*b+c as a fused multiply-add and its
  transcendentals to its own last bits, so a texture value differs in
  its last bits (tests/test_torch_textures.py), which moves no path here.
- The pool equals the fixed batch bit for bit at one sample per pixel
  (the footprint is computed every pool wave and masked to its depth-0
  lanes, at bounce 0 in the fixed batch).
- texture_footprint on the scene's camera hits against the reference's,
  within 2e-6 absolute + 1e-5 relative (the reference's transforms
  contract through XLA's dot); the cameras' ray differentials and the
  reference's mip-filtering oracle are in tests/test_torch_textures.py.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_pbrt_torch import parse_string
from tpu_pbrt_torch.config import cfg as tcfg
from tpu_pbrt_torch.scene.bridge import flat_tables, tables_from_numpy
from tpu_pbrt_torch.scenes import TEXTURED_SMALL, compile_api, make_textured_like
from tpu_pbrt_torch.utils.error import PbrtError

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "torch_golden")
sys.path.insert(0, GOLDEN)
from make_textured_reference import (  # noqa: E402
    LEAF_TRIS, POOL, SMALL_CASES, SMALL_RES, SMALL_SPP, jax_textured_api,
)

#: golden -> (image MSE bound, |rays - the reference's| bound); measured
#: beside each
GOLDEN_TOL = {
    "textured_path_pool": (1e-10, 0),  # 2.7e-13, rays equal (3,067)
    "textured_path_fixed": (1e-10, 0),  # 2.7e-13 (3,067)
    "textured_direct": (1e-10, 0),
    "textured_sppm": (1e-10, 0),  # 3.2e-12 (10,349): flux summed in another photon order
    # 2.2e-10 (3,388): all of it one pixel 7e-4 apart, a connection
    # through the 0.05-roughness metal of the mix, whose f amplifies the
    # sampled direction's last bits (tests/test_torch_materials.py)
    "textured_bdpt": (1e-9, 0),
}
#: ray differentials and footprints: the absolute and relative bound
DIFF_ATOL, DIFF_RTOL = 2e-6, 1e-5


@pytest.fixture
def small_treelets(monkeypatch):
    from tpu_pbrt import config as jconfig

    monkeypatch.setenv("TPU_PBRT_LEAF_TRIS", str(LEAF_TRIS))
    monkeypatch.setattr(tcfg, "leaf_tris", LEAF_TRIS)
    jconfig.reload()
    yield
    monkeypatch.undo()
    jconfig.reload()


def _bits(a):
    a = np.atleast_1d(np.ascontiguousarray(a))
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.fixture(scope="module")
def jax_small():
    """The reference's compile of the small textured scene (16x16x4), in
    the goldens' 64-triangle treelets."""
    from tpu_pbrt import config as jconfig
    from tpu_pbrt.scenes import compile_api as jcompile

    old = os.environ.get("TPU_PBRT_LEAF_TRIS")
    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    jconfig.reload()
    try:
        return jcompile(jax_textured_api(SMALL_RES, SMALL_SPP, **TEXTURED_SMALL))[0]
    finally:
        if old is None:
            os.environ.pop("TPU_PBRT_LEAF_TRIS")
        else:
            os.environ["TPU_PBRT_LEAF_TRIS"] = old
        jconfig.reload()


def test_tables_equal_reference(jax_small, small_treelets, monkeypatch):
    from tpu_pbrt_torch.scene import compiler

    sj = jax_small
    warned = []
    monkeypatch.setattr(compiler, "Warning", warned.append)
    st, _ = compile_api(make_textured_like(SMALL_RES, SMALL_SPP, **TEXTURED_SMALL,
                                           device="cpu"))
    assert any("bump textures are parsed but not applied" in w for w in warned), warned
    ref = flat_tables(tables_from_numpy(jax.tree.map(np.asarray, sj.dev), "cpu"))
    got = flat_tables(st.dev)
    assert sorted(got) == sorted(ref)
    for k in ("tex_atlas", "tri_difT", "mat.mix_a", "mat.kd_tex", "mat.opacity_tex",
              "mat.rough_tex", "mat.sigma_tex", "mat.bump_tex", "mat.opacity"):
        assert k in got, k
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(ref[k]), err_msg=k)
    assert st.n_tris == sj.n_tris == 8838
    assert st.tex_used == sj.tex_used == {"kd", "sigma", "rough", "opacity"}
    assert len(st.tex_eval) == 14 and got["tex_atlas"].shape == (8532, 3)
    # the uber, substrate, translucent, mix (its two sub-rows) and textured rows
    assert set(got["mat.type"].tolist()) == {1, 2, 3, 6, 7, 8}


@pytest.mark.parametrize("mat", ['"disney"', '"hair"', '"subsurface"',
                                 '"fourier" "string bsdffile" "x.bsdf"'])
def test_unported_materials_still_raise(mat):
    text = ('Film "image" "integer xresolution" [4] "integer yresolution" [4]\n'
            'Camera "perspective"\nWorldBegin\n'
            'LightSource "point" "rgb I" [1 1 1] "point from" [0 0 -2]\n'
            'Texture "t" "spectrum" "fbm"\n'
            f'Material {mat}\nShape "trianglemesh" "integer indices" [0 1 2] '
            '"point P" [-1 -1 0  1 -1 0  0 1 0]\nWorldEnd\n')
    with pytest.raises(PbrtError, match="not ported"):
        parse_string(text, render=True, device="cpu")


@pytest.mark.parametrize("name", sorted(SMALL_CASES))
def test_render_matches_golden(name, small_treelets, monkeypatch):
    integrator, params, regen, maxdepth = SMALL_CASES[name]
    monkeypatch.setattr(tcfg, "regen", regen)
    monkeypatch.setattr(tcfg, "pool", POOL if regen else 0)
    scene, integ = compile_api(make_textured_like(SMALL_RES, SMALL_SPP, maxdepth, integrator,
                                                  params, **TEXTURED_SMALL, device="cpu"))
    res = integ.render(scene)
    ref = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    assert scene.n_tris == int(ref["n_tris"]) and res.image.shape == (16, 16, 3)
    assert np.isfinite(res.image).all() and res.stats["n_drop"] == 0
    if integrator == "path":
        assert bool(res.stats.get("regen")) == regen
        if regen:
            assert res.stats["n_waves"] == int(ref["n_waves"])
    mse_bar, ray_bar = GOLDEN_TOL[name]
    assert abs(res.rays_traced - int(ref["rays_traced"])) <= ray_bar, (
        res.rays_traced, int(ref["rays_traced"]))
    mse = float(np.mean((res.image.astype(np.float64) - ref["image"]) ** 2))
    assert mse <= mse_bar, mse
    assert ref["image"].mean() > 0.05


def test_pool_equals_fixed_bit_for_bit(small_treelets, monkeypatch):
    """At one sample per pixel each pixel receives one sample either way,
    so the pool's image is the fixed batch's, bit for bit."""
    scene, integ = compile_api(make_textured_like(12, 1, **TEXTURED_SMALL, device="cpu"))
    out = {}
    for regen in (True, False):
        monkeypatch.setattr(tcfg, "regen", regen)
        out[regen] = integ.render(scene)
    assert out[True].stats["regen"] and out[True].rays_traced == out[False].rays_traced
    np.testing.assert_array_equal(out[True].image, out[False].image)


def test_texture_footprint_matches_reference(jax_small, small_treelets):
    """The footprint of the small scene's camera hits (the pixel-centre
    differentials), the port's against the reference's on the same hits."""
    from tpu_pbrt.cameras import ray_differentials as jrd
    from tpu_pbrt.integrators.common import texture_footprint as jfp
    from tpu_pbrt_torch.cameras import generate_rays, ray_differentials
    from tpu_pbrt_torch.integrators.common import make_interaction, scene_intersect, \
        texture_footprint

    res, sj = SMALL_RES, jax_small
    st, _ = compile_api(make_textured_like(res, SMALL_SPP, **TEXTURED_SMALL, device="cpu"))
    iy, ix = np.mgrid[0:res, 0:res]
    pf = np.stack([ix.ravel() + 0.5, iy.ravel() + 0.5], -1).astype(np.float32)
    o, d, _ = generate_rays(st.camera, torch.from_numpy(pf), torch.zeros(res * res, 2))
    hit = scene_intersect(st.dev, o, d, float("inf"))
    it = make_interaction(st.dev, hit, o, d)
    got = texture_footprint(st.dev, hit.prim, it.p, it.ng, o, d,
                            *ray_differentials(st.camera, torch.from_numpy(pf)))
    J = [jnp.asarray(x.numpy().copy()) for x in (hit.prim, it.p, it.ng, o, d)]
    want = jfp({"tri_difT": sj.dev["tri_difT"]}, *J, *jrd(sj.camera, jnp.asarray(pf)))
    valid = it.valid.numpy()
    assert valid.mean() > 0.6 and (np.abs(got.numpy()[valid]).max(-1) > 0).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=DIFF_RTOL, atol=DIFF_ATOL)
