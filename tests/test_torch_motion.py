"""Motion blur on the CPU: the motion stand-in (`tpu_pbrt_torch.scenes.
make_motion_like(small=True)`: 240 hair segments under the three ways
`hair` resolves its absorption, three instances of a 528-triangle blob in
disney, the hair block and two instances moving over an open shutter;
9,268 triangles in 64-triangle treelets) against the JAX package, and
tests/test_motion.py's analytic oracles run through the port.

- Every device table of the compile equals the reference's compile of
  the same text through scene/bridge.py, bit for bit: the shutter-end
  vertices, the F = 64 treelet features over the union-of-keyframes
  bounds, the hair tangents, the disney and hair columns.
- stream_intersect with per-ray times (and the brute product with times)
  against the reference's: the winning ids exactly, t within T_ULP ulp
  (measured 0), the hit vertices lerped to their times within TV_ATOL.
  The port rounds the lerp as the reference's compiled render does, one
  fused multiply-add (the goldens' generator, at XLA's default
  optimization, matches it bit for bit); under pytest the reference
  compiles at optimization level 0 (tests/conftest.py), which rounds the
  product and the sum apart.
- The 16x16x4 renders against the goldens of
  tests/torch_golden/make_motion_reference.py: `path` through the pool
  and the fixed batch, and `bdpt`. Rays (and the pool's waves) and the
  image MSE within GOLDEN_TOL: the reference's jitted render rounds a*b+c
  as a fused multiply-add, the barycentrics of a hit on a hair ribbon (a
  triangle 1% as wide as it is long) amplify that to 1e-4, and a light
  sample at the peak of a disney clearcoat lobe amplifies a last-bit
  difference of its half-vector to percents (tests/test_torch_disney.py),
  so a few paths go another way.
- The pool equals the fixed batch bit for bit at one sample per pixel:
  a regenerated lane draws its camera sample's time.
- `directlighting` traces at time 0 and shades the shutter-start
  vertices, as the reference's direct integrators do: its render of the
  moving scene equals its render of the shutter-start keyframe alone.
- The animated camera renders from its shutter-start keyframe, with a
  warning; the CLI renders a scene file with ActiveTransform.
"""

import functools
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
from tpu_pbrt_torch.scenes import compile_api, make_motion_like

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "torch_golden")
sys.path.insert(0, GOLDEN)
from make_motion_reference import (  # noqa: E402
    LEAF_TRIS, POOL, SMALL_CASES, SMALL_RES, SMALL_SPP, jax_motion_api,
)

#: golden -> (image MSE bound, |rays - the reference's| bound); measured beside each
GOLDEN_TOL = {
    "motion_path_pool": (2e-6, 8),  # 5.3e-7, rays -3 (3,353 of 3,356)
    "motion_path_fixed": (2e-6, 8),  # 5.3e-7, rays -3
    # the shutter-start frame, hair at h = 0: 5.1e-12, rays equal (3,249)
    "motion_bdpt": (1e-10, 0),
}
#: t of the timed intersections: ulp bound
T_ULP = 2
#: the lerped hit vertices against the reference's under pytest: absolute
#: bound (measured 4.8e-7, an ulp of the scene's coordinates)
TV_ATOL = 1e-6


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
    """The reference's compile of the small motion scene (16x16x4), in the
    goldens' 64-triangle treelets."""
    from tpu_pbrt import config as jconfig
    from tpu_pbrt.scenes import compile_api as jcompile

    old = os.environ.get("TPU_PBRT_LEAF_TRIS")
    os.environ["TPU_PBRT_LEAF_TRIS"] = str(LEAF_TRIS)
    jconfig.reload()
    try:
        return jcompile(jax_motion_api(SMALL_RES, SMALL_SPP, small=True))[0]
    finally:
        if old is None:
            os.environ.pop("TPU_PBRT_LEAF_TRIS")
        else:
            os.environ["TPU_PBRT_LEAF_TRIS"] = old
        jconfig.reload()


@pytest.fixture(scope="module")
def port_small():
    saved = tcfg.leaf_tris
    tcfg.leaf_tris = LEAF_TRIS
    try:
        return compile_api(make_motion_like(SMALL_RES, SMALL_SPP, small=True, device="cpu"))
    finally:
        tcfg.leaf_tris = saved


def test_tables_equal_reference(jax_small, port_small):
    sj, (st, _) = jax_small, port_small
    ref = flat_tables(tables_from_numpy(jax.tree.map(np.asarray, sj.dev), "cpu"))
    got = flat_tables(st.dev)
    assert sorted(got) == sorted(ref)
    for k in ("tri_verts1", "tri_verts1_9T", "tri_tanT", "mat.d_metallic", "mat.d_thin",
              "mat.h_sigma_a", "mat.h_beta_m"):
        assert k in got, k
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(ref[k]), err_msg=k)
    assert st.n_tris == sj.n_tris == 9268
    assert got["tstream.featT"].shape[1] == 64
    # the world bounds span both keyframes
    np.testing.assert_array_equal(st.world_max, sj.world_max)
    n = st.n_tris
    moved = (got["tri_verts1"][:n] != got["tri_verts"][:n]).any(axis=(1, 2))
    assert 0.5 < moved.mean() < 1.0
    assert {9, 10} <= set(got["mat.type"].tolist())


def _rays(scene, n, seed):
    from tpu_pbrt_torch.cameras import generate_rays

    rng = np.random.default_rng(seed)
    pf = rng.uniform(0, SMALL_RES, (n, 2)).astype(np.float32)
    o, d, _ = generate_rays(scene.camera, torch.from_numpy(pf), torch.zeros(n, 2))
    return o, d, rng.uniform(0, 1, n).astype(np.float32)


def _hits_agree(ht, hj, what):
    pt, pj = ht.prim.numpy(), np.asarray(hj.prim)
    np.testing.assert_array_equal(pt, pj, err_msg=what)
    assert (pj >= 0).mean() > 0.5, what
    ok = pj >= 0
    ulp = np.abs(ht.t.numpy()[ok].view(np.int32).astype(np.int64)
                 - np.asarray(hj.t)[ok].view(np.int32).astype(np.int64))
    assert ulp.max() <= T_ULP, (what, ulp.max())
    np.testing.assert_allclose(ht.tv.numpy()[ok], np.asarray(hj.tv)[ok], rtol=0, atol=TV_ATOL,
                               err_msg=what)


def test_stream_intersect_with_time_matches_reference(jax_small, port_small):
    from tpu_pbrt.accel.stream import stream_intersect as jsi
    from tpu_pbrt_torch.accel.stream import stream_intersect

    sj, (st, _) = jax_small, port_small
    o, d, tm = _rays(st, 4096, 3)
    ht = stream_intersect(st.dev["tstream"], st.dev["tri_verts"], o, d, float("inf"),
                          time=torch.from_numpy(tm), tri_verts1=st.dev["tri_verts1"],
                          tv9T=st.dev["tri_verts9T"], tv9T1=st.dev["tri_verts1_9T"])
    hj = jsi(sj.dev["tstream"], sj.dev["tri_verts"], jnp.asarray(o.numpy()),
             jnp.asarray(d.numpy()), jnp.inf, time=jnp.asarray(tm),
             tri_verts1=sj.dev["tri_verts1"], tv9T=sj.dev["tri_verts9T"],
             tv9T1=sj.dev["tri_verts1_9T"])
    _hits_agree(ht, hj, "stream")
    # the any-hit predicate at the same times
    from tpu_pbrt_torch.integrators.common import scene_intersect_p

    occluded = scene_intersect_p(st.dev, o, d, float("inf"), time=torch.from_numpy(tm))
    assert torch.equal(occluded, ht.prim >= 0)
    # the time moves the moving geometry: at t = 0 other rays win
    h0 = stream_intersect(st.dev["tstream"], st.dev["tri_verts"], o, d, float("inf"),
                          tv9T=st.dev["tri_verts9T"])
    assert (h0.prim != ht.prim).float().mean() > 0.01


def test_brute_product_with_time_matches_reference():
    """The brute feature product (a scene of at most 256 triangles: the
    moving quad of tests/test_motion.py) with per-ray times, and the hit
    vertices lerped at those times."""
    from tpu_pbrt.accel.mxu import brute_feature_intersect as jbfi
    from tpu_pbrt.integrators.common import scene_intersect as jsi
    from tpu_pbrt_torch.integrators.common import scene_intersect

    st, sj = _quad_scenes(2.0)
    assert st.dev["bfeat"]["feat"].shape[0] == 64
    o, d, tm = _rays(st, 4096, 5)
    ht = scene_intersect(st.dev, o, d, float("inf"), time=torch.from_numpy(tm))
    J = dict(o=jnp.asarray(o.numpy()), d=jnp.asarray(d.numpy()))
    hj = jsi(sj.dev, J["o"], J["d"], jnp.inf, time=jnp.asarray(tm))
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    assert 0.05 < (ht.prim.numpy() >= 0).mean() < 0.95
    ok = ht.prim.numpy() >= 0
    ulp = np.abs(ht.t.numpy()[ok].view(np.int32).astype(np.int64)
                 - np.asarray(hj.t)[ok].view(np.int32).astype(np.int64))
    assert ulp.max() <= T_ULP
    np.testing.assert_allclose(ht.tv.numpy()[ok], np.asarray(hj.tv)[ok], rtol=0, atol=TV_ATOL)
    bf = st.dev["bfeat"]
    raw = jbfi(sj.dev["bfeat"]["feat"], sj.dev["bfeat"]["center"], 2, J["o"], J["d"], jnp.inf,
               time=jnp.asarray(tm))
    from tpu_pbrt_torch.accel.mxu import brute_feature_intersect

    mine = brute_feature_intersect(bf["feat"], bf["center"], 2, o, d, float("inf"),
                                   time=torch.from_numpy(tm))
    np.testing.assert_array_equal(mine.prim.numpy(), np.asarray(raw.prim))


_QUAD = """
Integrator "path" "integer maxdepth" [1]
Sampler "random" "integer pixelsamples" [{spp}]
PixelFilter "box"
Film "image" "integer xresolution" [{res}] "integer yresolution" [{res}]
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [53] "float shutteropen" [0] "float shutterclose" [1]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 4 4]
  ActiveTransform EndTime
  Translate {dx} 0 0
  ActiveTransform All
  Shape "trianglemesh" "integer indices" [0 2 1 0 3 2]
    "point P" [-1.5 -0.5 0  -0.5 -0.5 0  -0.5 0.5 0  -1.5 0.5 0]
AttributeEnd
"""


def _quad_scenes(dx, spp=128, res=32):
    from tpu_pbrt.scene.api import Options, parse_string as jparse, pbrt_init as jinit
    from tpu_pbrt.scene.compiler import compile_scene as jcompile
    from tpu_pbrt_torch.scene.compiler import compile_scene

    text = _QUAD.format(dx=dx, spp=spp, res=res)
    return (compile_scene(parse_string(text, device="cpu"), device="cpu"),
            jcompile(jparse(text, jinit(Options(quiet=True)))))


@functools.lru_cache(maxsize=None)
def _quad_image(dx):
    """tests/test_motion.py's _render on the port: the emissive quad
    translating by dx over a full shutter, 32x32 at 128 spp, maxdepth 1."""
    text = _QUAD.format(dx=dx, spp=128, res=32) + "WorldEnd\n"
    return parse_string(text, render=True, device="cpu").result.image


def test_streak_energy_conserved():
    static, moving = _quad_image(0.0), _quad_image(2.0)
    assert np.isfinite(moving).all()
    e_static, e_moving = float(static.sum()), float(moving.sum())
    assert e_static > 0
    assert abs(e_moving - e_static) / e_static < 0.04, (e_moving, e_static)


def test_streak_profile_matches_closed_form():
    """The quad (width 1) travels 2 over the shutter: a point inside the
    streak is covered half the time and reads 0.5 L; the static quad L."""
    static, moving = _quad_image(0.0), _quad_image(2.0)
    row = static.shape[0] // 2
    stat_val = float(static[row, 8:12, 0].mean())
    mov_val = float(moving[row, 12:18, 0].mean())
    assert abs(stat_val - 4.0) / 4.0 < 0.06, stat_val
    assert abs(mov_val - 0.5 * 4.0) / (0.5 * 4.0) < 0.12, mov_val


def test_static_scene_unaffected():
    """No moving shape, or a closed shutter: no shutter-end table, the
    16-feature tables."""
    from tpu_pbrt_torch.scenes import make_cornell

    scene, _ = compile_api(make_cornell(res=16, spp=4, integrator="path", maxdepth=2,
                                        device="cpu"))
    assert "tri_verts1" not in scene.dev and scene.dev["bfeat"]["feat"].shape[0] == 16
    closed = _QUAD.format(dx=2.0, spp=1, res=8).replace('"float shutterclose" [1]',
                                                        '"float shutterclose" [0]')
    from tpu_pbrt_torch.scene.compiler import compile_scene

    scene = compile_scene(parse_string(closed, device="cpu"), device="cpu")
    assert "tri_verts1" not in scene.dev and scene.dev["bfeat"]["feat"].shape[0] == 16


def test_moving_mesh_stream_tracer():
    """A moving mesh big enough for the stream tracer (the 64-feature
    treelet pack) renders finite and lit."""
    from tpu_pbrt_torch.scene.compiler import compile_scene
    from tpu_pbrt_torch.scenes import _displaced_sphere
    from tpu_pbrt_torch.scene.paramset import ParamSet

    api = parse_string("""
Integrator "path" "integer maxdepth" [2]
Sampler "random" "integer pixelsamples" [4]
Film "image" "integer xresolution" [24] "integer yresolution" [24]
LookAt 0 0.5 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [50] "float shutteropen" [0] "float shutterclose" [1]
WorldBegin
LightSource "point" "rgb I" [30 30 30] "point from" [0 3 -3]
Material "matte" "rgb Kd" [0.7 0.6 0.5]
ActiveTransform EndTime
Translate 1.2 0 0
ActiveTransform All
""", device="cpu")
    V, F, N = _displaced_sphere(24, 48)
    ps = ParamSet()
    ps.add("integer indices", F.reshape(-1).tolist())
    ps.add("point P", V.reshape(-1).tolist())
    ps.add("normal N", N.reshape(-1).tolist())
    api.shape("trianglemesh", ps)
    scene = compile_scene(api, device="cpu")
    assert "tri_verts1" in scene.dev and scene.dev["tstream"].n_features == 64
    from tpu_pbrt_torch.integrators import make_integrator

    integ = make_integrator(api.render_options.integrator_name,
                            api.render_options.integrator_params, scene, api.options)
    img = integ.render(scene).image
    assert np.isfinite(img).all() and img.max() > 0.0


@pytest.mark.parametrize("name", sorted(SMALL_CASES))
def test_render_matches_golden(name, small_treelets, monkeypatch):
    integrator, regen = SMALL_CASES[name]
    monkeypatch.setattr(tcfg, "regen", regen)
    monkeypatch.setattr(tcfg, "pool", POOL if regen else 0)
    scene, integ = compile_api(make_motion_like(SMALL_RES, SMALL_SPP, 5, integrator, small=True,
                                                device="cpu"))
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
    scene, integ = compile_api(make_motion_like(8, 1, small=True, device="cpu"))
    out = {}
    for regen in (True, False):
        monkeypatch.setattr(tcfg, "regen", regen)
        out[regen] = integ.render(scene)
    assert out[True].stats["regen"] and out[True].rays_traced == out[False].rays_traced
    np.testing.assert_array_equal(out[True].image, out[False].image)


def test_directlighting_renders_the_shutter_start_frame(small_treelets):
    """The direct integrators pass no time: the moving scene renders as
    its shutter-start keyframe alone (the ActiveTransform lines dropped)."""
    from tpu_pbrt_torch.scenes import motion_parts, MOTION_SMALL

    # the uniform light pick: the spatial and power picks follow the world
    # bounds, which span both keyframes on the moving scene
    texts, ply = motion_parts(8, 2, 3, "directlighting",
                              '"string lightsamplestrategy" "uniform"', **MOTION_SMALL)
    blob = f'Shape "plymesh" "string filename" ["{ply}"]\n'
    moving = blob.join(texts)
    start = "\n".join(line for line in moving.split("\n")
                      if not (line.startswith("ActiveTransform") or line in
                              ("Translate 0.25 0 0", "Translate 0.35 0 0", "Rotate 6 0 1 0")))
    imgs = {}
    for name, text in (("moving", moving), ("start", start)):
        scene, integ = compile_api(parse_string(text, device="cpu"))
        assert ("tri_verts1" in scene.dev) == (name == "moving")
        imgs[name] = integ.render(scene)
    assert imgs["moving"].rays_traced == imgs["start"].rays_traced
    np.testing.assert_allclose(imgs["moving"].image, imgs["start"].image, rtol=1e-5, atol=1e-6)
    assert imgs["start"].image.mean() > 0.01


def test_animated_camera_renders_its_start_keyframe(monkeypatch):
    from tpu_pbrt_torch.scene import compiler

    warned = []
    monkeypatch.setattr(compiler, "Warning", warned.append)
    base = _QUAD.format(dx=0.0, spp=1, res=8)
    anim = base.replace('Camera "perspective"', 'ActiveTransform EndTime\nTranslate 0.5 0 0\n'
                        'ActiveTransform All\nCamera "perspective"')
    images = []
    for text in (base, anim):
        images.append(parse_string(text + "WorldEnd\n", render=True, device="cpu").result.image)
    assert sum("camera transform is animated" in w for w in warned) == 1, warned
    np.testing.assert_array_equal(images[0], images[1])


def test_cli_renders_an_animated_scene(tmp_path):
    """`python -m tpu_pbrt_torch.main` on a scene file with ActiveTransform:
    the moving quad, written as an image."""
    from tpu_pbrt_torch import main as cli
    from tpu_pbrt_torch.utils.imageio import read_pfm

    scene = tmp_path / "moving_quad.pbrt"
    scene.write_text(_QUAD.format(dx=2.0, spp=4, res=8) + "WorldEnd\n")
    out = tmp_path / "moving_quad.pfm"
    assert cli.main([str(scene), "--device", "cpu", "--quiet", "-o", str(out)]) == 0
    img = read_pfm(str(out))
    assert img.shape[:2] == (8, 8) and np.isfinite(img).all() and img.max() > 0
