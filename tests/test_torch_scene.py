"""The port's scene compiler against the reference's, through the bridge.

Both packages compile the same small killeroo (528 mesh triangles + 4, so
it takes the stream-tracer path, cut into 64-triangle treelets). The
port's own compile_scene tables must equal the bridge's conversion of the
reference's tables exactly: integers bit-equal, floats bit-equal — both
sides run the same numpy host code (BVH build, leaf order, treelet cut,
feature weights, light rows). Directives the port does not implement must
raise PbrtError instead of being substituted.
"""

import numpy as np
import pytest

import jax

from tpu_pbrt import config as jconfig
from tpu_pbrt import scenes as jscenes
from tpu_pbrt.scene.compiler import compile_scene as jcompile
from tpu_pbrt_torch import scenes as tscenes
from tpu_pbrt_torch.config import cfg as tcfg
from tpu_pbrt_torch.scene.bridge import flat_tables, tables_from_numpy
from tpu_pbrt_torch.scene.compiler import compile_scene as tcompile
from tpu_pbrt_torch.scene.api import parse_string
from tpu_pbrt_torch.utils.error import PbrtError

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
Film "image" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 0 -3  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "{light}" "rgb I" [1 1 1] "point from" [0 0 -2]
Material "{mat}"
Shape "{shape}" "integer indices" [0 1 2] "point P" [-1 -1 0  1 -1 0  0 1 0]
WorldEnd
'''
_OK = dict(integ="path", sampler="zerotwosequence", light="point", mat="matte",
           shape="trianglemesh")


@pytest.mark.parametrize("field,value", [
    ("mat", "plastic"), ("shape", "sphere"), ("light", "spot"),
    ("sampler", "halton"), ("integ", "bdpt"),
])
def test_unported_directives_raise(field, value):
    text = _BASE.format(**{**_OK, field: value})
    with pytest.raises(PbrtError, match="not ported"):
        parse_string(text, render=True, device="cpu")


def test_supported_directives_render():
    api = parse_string(_BASE.format(**_OK), render=True, device="cpu")
    assert api.result.image.shape == (8, 8, 3)
    assert np.isfinite(api.result.image).all() and api.result.image.max() > 0


def test_cornell_defaults_match_reference():
    """make_cornell and cornell_box_text default to the reference's
    integrator; the port has no `directlighting` yet, so compiling the
    default Cornell box names it as not ported."""
    import inspect

    for fn in ("make_cornell", "cornell_box_text"):
        ours = inspect.signature(getattr(tscenes, fn)).parameters
        ref = inspect.signature(getattr(jscenes, fn)).parameters
        assert ours["integrator"].default == ref["integrator"].default == "directlighting", fn
    with pytest.raises(PbrtError, match="directlighting.*not ported"):
        tscenes.compile_api(tscenes.make_cornell(res=8, spp=1, device="cpu"))
