"""The port's scene compiler against the reference's, through the bridge.

Both packages compile the same small killeroo (528 mesh triangles + 4, so
it takes the stream-tracer path, cut into 64-triangle treelets) and the
same small crown (tests/torch_golden/make_golden.py's `crown_small_text`:
glass, metal, anisotropic metal and matte on 1,682 triangles under the
crown's sky as an infinite light). The port's own compile_scene tables
must equal the bridge's conversion of the reference's tables exactly:
integers bit-equal, floats bit-equal — both sides run the same numpy host
code (BVH build, leaf order, treelet cut, feature weights, material rows,
light rows, the environment map and its 2D distribution, the light-pick
distributions). Directives the port does not implement must raise
PbrtError instead of being substituted; the shapes, filters, cameras and
lights that used to raise compile and render.
"""

import os
import sys

import numpy as np
import pytest

import jax

from tpu_pbrt import config as jconfig
from tpu_pbrt import scenes as jscenes
from tpu_pbrt.scene.api import Options as JOptions
from tpu_pbrt.scene.api import parse_string as jparse_string
from tpu_pbrt.scene.api import pbrt_init as jpbrt_init
from tpu_pbrt.scene.compiler import compile_scene as jcompile
from tpu_pbrt_torch import scenes as tscenes
from tpu_pbrt_torch.config import cfg as tcfg
from tpu_pbrt_torch.scene.bridge import flat_tables, tables_from_numpy
from tpu_pbrt_torch.scene.compiler import compile_scene as tcompile
from tpu_pbrt_torch.scene.api import Options as TOptions
from tpu_pbrt_torch.scene.api import parse_string, pbrt_init
from tpu_pbrt_torch.utils.error import PbrtError
from tpu_pbrt_torch.utils.imageio import write_image

SMALL = dict(res=16, spp=4, n_theta=12, n_phi=24)


@pytest.fixture(scope="module")
def scenes():
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_PBRT_LEAF_TRIS", "64")
    mp.setattr(tcfg, "leaf_tris", 64)
    jconfig.reload()
    try:
        sj = jcompile(jscenes.make_killeroo_like(**SMALL))
        st = tcompile(tscenes.make_killeroo_like(**SMALL, device="cpu"))
    finally:
        mp.undo()
        jconfig.reload()
    return sj, st


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def test_displaced_sphere_matches():
    for a, b in zip(tscenes._displaced_sphere(12, 24), jscenes._displaced_sphere(12, 24)):
        np.testing.assert_array_equal(a, b)


def test_compiled_tables_equal_bridge(scenes):
    sj, st = scenes
    assert st.n_tris == sj.n_tris == 532 and "tstream" in st.dev
    assert st.dev["tstream"].n_treelets > 4
    dev_np = jax.tree.map(np.asarray, sj.dev)
    ref = flat_tables(tables_from_numpy(dev_np, "cpu"))
    got = flat_tables(st.dev)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(ref[k]), err_msg=k)


def test_light_distributions_and_camera_equal(scenes):
    sj, st = scenes
    sdj, sdt = sj.spatial_distr, st.spatial_distr
    assert sdj is not None and sdt is not None and sdj.res == sdt.res
    for f in ("cdf", "mean_pmf", "lo", "inv_cs"):
        np.testing.assert_array_equal(_bits(getattr(sdt, f).numpy()),
                                      _bits(np.asarray(getattr(sdj, f))), err_msg=f)
    for f in ("func", "cdf", "func_int"):
        np.testing.assert_array_equal(getattr(st.light_distr, f).numpy(),
                                      np.asarray(getattr(sj.light_distr, f)), err_msg=f)
    np.testing.assert_array_equal(st.camera.raster_to_camera.numpy(),
                                  np.asarray(sj.camera.raster_to_camera))
    np.testing.assert_array_equal(st.camera.camera_to_world.numpy(),
                                  np.asarray(sj.camera.camera_to_world))
    assert st.film.full_resolution == sj.film.full_resolution
    assert st.sampler.spp == sj.sampler.spp == 4


_BASE = '''
Integrator "{integ}" "integer maxdepth" [2]
Sampler "{sampler}" "integer pixelsamples" [2]
PixelFilter "{filter}"
Film "image" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 0 -3  0 0 0  0 1 0
Camera "{camera}" "float fov" [40]
WorldBegin
LightSource "{light}" "rgb I" [1 1 1] "point from" [0 0 -2]
Material "{mat}"
Shape "{shape}" "integer indices" [0 1 2] "point P" [-1 -1 0  1 -1 0  0 1 0]
WorldEnd
'''
_OK = dict(integ="path", sampler="zerotwosequence", light="point", mat="matte",
           shape="trianglemesh", filter="box", camera="perspective")


@pytest.mark.parametrize("field,value", [("mat", "subsurface")])
def test_unported_directives_raise(field, value):
    text = _BASE.format(**{**_OK, field: value})
    with pytest.raises(PbrtError, match="not ported"):
        parse_string(text, render=True, device="cpu")


_TRI = 'Shape "trianglemesh" "integer indices" [0 1 2] "point P" [-1 -1 0  1 -1 0  0 1 0]'
_POINT = 'LightSource "point" "rgb I" [1 1 1] "point from" [0 0 -2]'


@pytest.mark.parametrize("old,new", [
    (_TRI, 'Shape "disk" "float radius" [1.2] "float height" [0.1]'),
    (_POINT, 'LightSource "spot" "rgb I" [1 1 1] "point from" [0 0 -2] "point to" [0 0 0] '
             '"float coneangle" [40]'),
    ('PixelFilter "box"', 'PixelFilter "gaussian"'),
    ('Camera "perspective"', 'Camera "orthographic"'),
    (_POINT, 'AttributeBegin\nTranslate 0 0 -2\nLightSource "goniometric" "rgb I" [1 1 1]\n'
             'AttributeEnd'),
    (_POINT, 'LightSource "spot" "rgb I" [1 1 1] "point from" [0 0 -2] "point to" [0 0.2 0] '
             '"float coneangle" [20] "float conedeltaangle" [15]'),
    ('Material "matte"', 'Material "uber"'),
    ('Material "matte"', 'Material "substrate"'),
    ('Material "matte"', 'Material "translucent"'),
    ('Material "matte"', 'MakeNamedMaterial "a" "string type" "matte"\n'
                         'MakeNamedMaterial "b" "string type" "glass"\n'
                         'Material "mix" "string namedmaterial1" "a" "string namedmaterial2" "b"'),
    ('Material "matte"', 'Texture "t" "spectrum" "checkerboard"\nMaterial "plastic" "texture Kd" "t"'),
    ('Material "matte"', 'Material "disney"'),
    ('Material "matte"', 'Material "disney" "float metallic" [0.6] "float clearcoat" [1] '
                         '"float spectrans" [0.3] "bool thin" "true"'),
    ('Material "matte"', 'Material "hair"'),
    ('Material "matte"', 'Material "hair" "rgb color" [0.5 0.3 0.2]'),
    ('Camera "perspective"', 'ActiveTransform EndTime\nTranslate 0.2 0 0\nActiveTransform All\n'
                             'Camera "perspective"'),
    (_TRI, 'ActiveTransform EndTime\nTranslate 0.3 0 0\nActiveTransform All\n' + _TRI),
], ids=["disk", "spot", "gaussian", "orthographic", "goniometric", "spot_narrow", "uber",
        "substrate", "translucent", "mix", "textured_plastic_kd", "disney", "disney_lobes",
        "hair", "hair_color", "animated_camera", "animated_shape"])
def test_ported_directives_render(old, new):
    """Directives that used to raise "not ported" compile and render a
    finite, lit 8x8 image (a goniometric light without a map takes the
    reference's constant map)."""
    text = _BASE.format(**_OK)
    assert old in text
    api = parse_string(text.replace(old, new), render=True, device="cpu")
    assert api.result.image.shape == (8, 8, 3)
    assert np.isfinite(api.result.image).all() and api.result.image.max() > 0


def test_supported_directives_render():
    api = parse_string(_BASE.format(**_OK), render=True, device="cpu")
    assert api.result.image.shape == (8, 8, 3)
    assert np.isfinite(api.result.image).all() and api.result.image.max() > 0


def test_cornell_defaults_match_reference():
    """make_cornell and cornell_box_text default to the reference's
    integrator, `directlighting`, and the default Cornell box compiles and
    renders through it."""
    import inspect

    from tpu_pbrt_torch.integrators.direct import DirectLightingIntegrator

    for fn in ("make_cornell", "cornell_box_text"):
        ours = inspect.signature(getattr(tscenes, fn)).parameters
        ref = inspect.signature(getattr(jscenes, fn)).parameters
        assert ours["integrator"].default == ref["integrator"].default == "directlighting", fn
        assert ours["sampler"].default == ref["sampler"].default, fn
    scene, integ = tscenes.compile_api(tscenes.make_cornell(res=8, spp=1, device="cpu"))
    assert isinstance(integ, DirectLightingIntegrator) and integ.strategy == "all"
    res = integ.render(scene)
    assert res.image.shape == (8, 8, 3) and np.isfinite(res.image).all()
    assert res.image.max() > 0 and res.rays_traced > 8 * 8


def _compile_both(text_of, leaf_tris=None, tmp=None):
    """Compile the scene text (text_of(tmp dir)) with both packages."""
    mp = pytest.MonkeyPatch()
    if leaf_tris:
        mp.setenv("TPU_PBRT_LEAF_TRIS", str(leaf_tris))
        mp.setattr(tcfg, "leaf_tris", leaf_tris)
    jconfig.reload()
    try:
        text = text_of(tmp)
        sj = jcompile(jparse_string(text, jpbrt_init(JOptions(quiet=True))))
        st = tcompile(parse_string(text, pbrt_init(TOptions(quiet=True), device="cpu")))
    finally:
        mp.undo()
        jconfig.reload()
    return sj, st


def _assert_tables_equal(sj, st):
    dev_np = jax.tree.map(np.asarray, sj.dev)
    ref = flat_tables(tables_from_numpy(dev_np, "cpu"))
    got = flat_tables(st.dev)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(ref[k]), err_msg=k)


@pytest.fixture(scope="module")
def crown_scenes(tmp_path_factory):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_golden"))
    try:
        from make_golden import crown_small_sky, crown_small_text
    finally:
        sys.path.pop(0)

    def text_of(tmp):
        env = os.path.join(tmp, "sky.pfm")
        write_image(env, crown_small_sky())
        return crown_small_text(env)

    return _compile_both(text_of, leaf_tris=64, tmp=str(tmp_path_factory.mktemp("crown")))


def test_small_crown_tables_equal_bridge(crown_scenes):
    sj, st = crown_scenes
    assert st.n_tris == sj.n_tris == 1682 and "tstream" in st.dev
    assert st.has_envmap and sj.has_envmap
    assert sorted(np.asarray(st.dev["mat"]["type"]).tolist()) == [1, 3, 3, 4]
    assert st.dev["envmap"].shape == (16, 32, 3)
    _assert_tables_equal(sj, st)
    # one light (the environment): the power distribution picks it
    assert st.spatial_distr is None and sj.spatial_distr is None
    for f in ("func", "cdf", "func_int"):
        np.testing.assert_array_equal(_bits(getattr(st.light_distr, f).numpy()),
                                      _bits(np.asarray(getattr(sj.light_distr, f))), err_msg=f)


_ENV_POINT = """
Integrator "path" "integer maxdepth" [2]
Sampler "zerotwosequence" "integer pixelsamples" [2]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 0 -3  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "point" "rgb I" [3 3 3] "point from" [0 0 -2]
AttributeBegin
Rotate 90 1 0 0
LightSource "infinite" "rgb L" [0.5 0.6 0.7]
AttributeEnd
Material "plastic" "rgb Kd" [0.3 0.2 0.1] "float roughness" [0.2] "bool remaproughness" "false"
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [-1 -1 0  1 -1 0  0 1 0]
Material "mirror"
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [-1 -1 1  1 -1 1  0 1 1]
"""


def test_environment_row_in_the_light_distributions():
    """A point light and a rotated constant environment: the spatial
    distribution (where the environment's importance is its power share
    in every voxel), the power distribution and every table (the 4x8
    constant map, its rotation) are the reference's."""
    sj, st = _compile_both(lambda _: _ENV_POINT)
    _assert_tables_equal(sj, st)
    assert st.dev["envmap"].shape == (4, 8, 3) and st.n_lights == 2
    sdj, sdt = sj.spatial_distr, st.spatial_distr
    assert sdt is not None and sdt.res == sdj.res
    for f in ("cdf", "mean_pmf", "lo", "inv_cs"):
        np.testing.assert_array_equal(_bits(getattr(sdt, f).numpy()),
                                      _bits(np.asarray(getattr(sdj, f))), err_msg=f)
    for f in ("func", "cdf", "func_int"):
        np.testing.assert_array_equal(_bits(getattr(st.light_distr, f).numpy()),
                                      _bits(np.asarray(getattr(sj.light_distr, f))), err_msg=f)


@pytest.mark.parametrize("directive", [
    'Material "fourier" "string bsdffile" "x.bsdf"', 'Material "subsurface"',
], ids=["fourier", "subsurface"])
def test_unported_materials_and_lights_raise(directive):
    text = f"""
Integrator "path" "integer maxdepth" [2]
Sampler "zerotwosequence" "integer pixelsamples" [1]
Film "image" "integer xresolution" [4] "integer yresolution" [4]
LookAt 0 0 -3  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "point" "rgb I" [1 1 1] "point from" [0 0 -2]
{directive}
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [-1 -1 0  1 -1 0  0 1 0]
WorldEnd
"""
    with pytest.raises(PbrtError, match="not ported"):
        parse_string(text, render=True, device="cpu")


def test_crown_materials_render():
    """plastic, metal, glass and mirror under an environment compile and
    render on the CPU."""
    api = parse_string(_ENV_POINT + "WorldEnd\n", render=True, device="cpu")
    assert api.result.image.shape == (8, 8, 3)
    assert np.isfinite(api.result.image).all() and api.result.image.max() > 0



@pytest.mark.parametrize("name", ["vol_beer", "null_cube_volpath", "grid_null_cube",
                                  "furnace_g05", "cloud_small"])
def test_media_tables_equal_bridge(name):
    """The media goldens' scenes (tests/torch_golden/make_golden.py
    MEDIA_CASES): the medium table (homogeneous rows, the 8^3 grid with
    its p0/p1 placement and majorant), the per-triangle MediumInterface
    ids in leaf order, the camera's medium and the null-surface flag are
    the reference's; the "none" material row too. The furnace's 4,096
    emissive sphere triangles pass the shading-row packing, so both sides
    keep the four per-triangle tables instead of tri_sh16."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "torch_golden"))
    try:
        from make_golden import CLOUD_SMALL, jax_cloud_api, media_text
    finally:
        sys.path.pop(0)
    if name == "cloud_small":
        mp = pytest.MonkeyPatch()
        mp.setenv("TPU_PBRT_LEAF_TRIS", "64")
        mp.setattr(tcfg, "leaf_tris", 64)
        jconfig.reload()
        try:
            sj = jcompile(jax_cloud_api(**CLOUD_SMALL))
            st = tcompile(tscenes.make_cloud_like(**CLOUD_SMALL, device="cpu"))
        finally:
            mp.undo()
            jconfig.reload()
    else:
        sj, st = _compile_both(lambda _: media_text(name).rsplit("WorldEnd", 1)[0])
    _assert_tables_equal(sj, st)
    assert st.camera_medium_id == sj.camera_medium_id == (0 if name in ("vol_beer",
                                                                        "furnace_g05") else -1)
    assert st.has_null_materials == sj.has_null_materials == ("null" in name or "cloud" in name)
    med_in = st.dev["tri_med_in"].numpy()
    assert (med_in == 0).any() == st.has_null_materials
    mt = st.dev["media"]
    assert mt.density.numel() == (512 if name == "grid_null_cube" else 1)
    assert ("tri_sh16" in st.dev) == (name != "furnace_g05")
