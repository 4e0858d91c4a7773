"""The port's pixel filters and the spot, goniometric and projection
lights against the JAX package's.

- Filters (tpu_pbrt_torch/core/filters.py): each filter's `evaluate` on
  an offset grid that reaches past its radius, with the reference's
  defaults and with parameters of the scene's own, to 1e-6 relative (the
  same f32 formulas; exp and sin may round an ulp apart); an unknown
  name takes box(0.5) with a warning on both sides. `Film.add_samples`
  under the gaussian (25 footprint taps per sample) and the sinc (81) on
  a cropped film, 4,096 seeded samples with ray weights, against the
  reference's to 1e-5 relative; and, under deterministic algorithms, the
  port's one scatter of the nonzero in-crop taps equal bit for bit to a
  tap-by-tap scatter (the reference's formulation).
- Lights (tpu_pbrt_torch/core/lights_dev.py): a scene with a spot, a
  goniometric (its map a 16x32 PFM), a projection (a 24x40 PFM, so the
  aspect is not 1), a second projection whose map cannot be read (the
  constant map, with the reference's warning), a point, a distant, an
  area and an infinite light. Its compiled tables (the light rows' w2l
  and img columns, the light atlas, the spatial and power
  distributions) equal the reference's; then `sample_light_rows`,
  `sample_le`, `le_pdfs` and `_light_map_scale` on 4,096 seeded lanes,
  the reference's eager functions fed the reference's tables and the
  port's the bridge's copy, agree to 1e-5 relative + 1e-6 absolute,
  with the boolean outputs (delta, supported) exact.
- Several infinite lights: every one gets a row, the last map is the
  scene's (the reference's rule); every table equal.
"""


import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpu_pbrt.core import filters as jfilters
from tpu_pbrt.core import lights_dev as jl
from tpu_pbrt.core.film import Film as JFilm
from tpu_pbrt.scene import compiler as jc
from tpu_pbrt.scene.api import Options as JOptions
from tpu_pbrt.scene.api import parse_string as jparse_string
from tpu_pbrt.scene.api import pbrt_init as jpbrt_init
from tpu_pbrt.scene.paramset import ParamSet as JParamSet
from tpu_pbrt_torch.core import filters as tfilters
from tpu_pbrt_torch.core import lights_dev as tl
from tpu_pbrt_torch.core.film import Film as TFilm
from tpu_pbrt_torch.scene import compiler as tc
from tpu_pbrt_torch.scene.api import Options as TOptions
from tpu_pbrt_torch.scene.api import parse_string, pbrt_init
from tpu_pbrt_torch.scene.bridge import flat_tables, tables_from_numpy
from tpu_pbrt_torch.scene.paramset import ParamSet as TParamSet
from tpu_pbrt_torch.utils.imageio import write_image
from tests.test_torch_xla_math import JitRef, rounded_apart

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

N = 4096
RTOL, ATOL = 1e-5, 1e-6

#: case -> (filter name, its parameters)
FILTERS = {
    "box": ("box", []),
    "box_wide": ("box", [("float xwidth", [1.5]), ("float ywidth", [1.0])]),
    "triangle": ("triangle", []),
    "gaussian": ("gaussian", []),
    "gaussian_narrow": ("gaussian", [("float alpha", [1.0]), ("float xwidth", [1.5])]),
    "mitchell": ("mitchell", []),
    "mitchell_catmull_rom": ("mitchell", [("float B", [0.0]), ("float C", [0.5])]),
    "sinc": ("sinc", []),
    "lanczos": ("lanczos", [("float xwidth", [2.0]), ("float ywidth", [3.0]),
                            ("float tau", [2.0])]),
}


def _params(cls, spec):
    ps = cls()
    for decl, vals in spec:
        ps.add(decl, list(vals))
    return ps


def _filters(case):
    name, spec = FILTERS[case]
    return (jfilters.make_filter(name, _params(JParamSet, spec)),
            tfilters.make_filter(name, _params(TParamSet, spec)))


@pytest.mark.parametrize("case", sorted(FILTERS))
def test_filter_evaluate_matches_reference(case):
    jf, tf = _filters(case)
    assert tuple(tf) == tuple(jf)
    g = np.linspace(-tf.xwidth - 0.5, tf.xwidth + 0.5, 67, dtype=np.float32)
    h = np.linspace(-tf.ywidth - 0.5, tf.ywidth + 0.5, 61, dtype=np.float32)
    dx, dy = (a.reshape(-1) for a in np.meshgrid(g, h))
    want = np.asarray(jf.evaluate(jnp.asarray(dx), jnp.asarray(dy)))
    got = tf.evaluate(torch.from_numpy(dx.copy()), torch.from_numpy(dy.copy())).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (want != 0).any() and (want == 0).any()


def test_unknown_filter_takes_box(monkeypatch):
    warned, jwarned = [], []
    monkeypatch.setattr(tfilters, "Warning", warned.append)
    monkeypatch.setattr(jfilters, "Warning", jwarned.append)
    tf = tfilters.make_filter("bspline", TParamSet())
    jf = jfilters.make_filter("bspline", JParamSet())
    assert tuple(tf) == tuple(jf) == ("box", 0.5, 0.5, 0.0, 0.0)
    assert warned == jwarned and len(warned) == 1


@pytest.mark.parametrize("case", ["gaussian", "sinc"])
def test_film_add_samples_wide_footprint(case):
    jf, tf = _filters(case)
    res, crop = (16, 12), (0.1, 0.9, 0.0, 0.75)
    rng = np.random.default_rng(17)
    p = (rng.uniform(-1, 1, (N, 2)) + rng.uniform(0, 1, (N, 2)) * np.asarray(res))
    p = p.astype(np.float32)
    L = rng.uniform(0, 2, (N, 3)).astype(np.float32)
    w = rng.uniform(0.5, 1, N).astype(np.float32)
    jfilm = JFilm(res, crop, jf)
    tfilm = TFilm(res, crop, tf)
    assert tfilm.sample_bounds() == jfilm.sample_bounds()
    js = jfilm.add_samples(jfilm.init_state(), jnp.asarray(p.copy()), jnp.asarray(L.copy()),
                           jnp.asarray(w.copy()))
    ts = tfilm.add_samples(tfilm.init_state("cpu"), torch.from_numpy(p.copy()),
                           torch.from_numpy(L.copy()), torch.from_numpy(w.copy()))
    np.testing.assert_allclose(ts.rgb.numpy(), np.asarray(js.rgb), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.weight.numpy(), np.asarray(js.weight), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tfilm.develop(ts), np.asarray(jfilm.develop(js)), rtol=1e-5,
                               atol=1e-5)


def _tap_by_tap(film, state, p, L, w):
    """The footprint deposit as the reference writes it: one clamped
    scatter-add per tap, off-crop taps adding a zero."""
    f = film.filter
    L = L * w[:, None]
    dx, dy = p[:, 0] - 0.5, p[:, 1] - 0.5
    x0f, y0f = torch.ceil(dx - f.xwidth), torch.ceil(dy - f.ywidth)
    rx, ry = film.full_resolution
    cx0, cx1, cy0, cy1 = film.cropped_pixel_bounds
    for oy in range(int(np.floor(2 * f.ywidth)) + 1):
        for ox in range(int(np.floor(2 * f.xwidth)) + 1):
            px, py = x0f.long() + ox, y0f.long() + oy
            fw = f.evaluate((x0f + ox) - dx, (y0f + oy) - dy)
            fw = torch.where((px >= cx0) & (px < cx1) & (py >= cy0) & (py < cy1), fw,
                             torch.zeros_like(fw))
            idx = (py.clamp(0, ry - 1), px.clamp(0, rx - 1))
            state.rgb.index_put_(idx, fw[:, None] * L, accumulate=True)
            state.weight.index_put_(idx, fw, accumulate=True)
    return state


@pytest.mark.parametrize("case", ["gaussian", "mitchell", "sinc", "triangle", "box_wide"])
def test_film_deposit_equals_tap_by_tap_scatter(case):
    """Film.add_samples deposits only the in-crop taps of nonzero weight,
    in one scatter-add: under deterministic algorithms (as every render
    runs) its sums equal the tap-by-tap scatters bit for bit, masked lanes
    (parked at -1e6) and off-crop taps included."""
    _, tf = _filters(case)
    res, crop = (23, 17), (0.1, 0.8, 0.2, 0.9)
    rng = np.random.default_rng(23)
    p = (rng.uniform(-3, 1, (N, 2)) + rng.uniform(0, 1, (N, 2)) * np.asarray(res))
    p = torch.from_numpy(p.astype(np.float32))
    p[::7] = -1e6
    L = torch.from_numpy(rng.uniform(0, 3, (N, 3)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0, 1, N).astype(np.float32))
    film = TFilm(res, crop, tf)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        got = film.add_samples(film.init_state("cpu"), p, L, w)
        want = _tap_by_tap(film, film.init_state("cpu"), p, L, w)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.equal(got.rgb, want.rgb) and torch.equal(got.weight, want.weight)
    assert float(got.weight.sum()) != 0.0


_LIGHTS = """
Integrator "path" "integer maxdepth" [2]
Sampler "zerotwosequence" "integer pixelsamples" [1]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 1 -5  0 0 0  0 1 0
Camera "perspective" "float fov" [50]
WorldBegin
LightSource "spot" "rgb I" [20 18 16] "point from" [1 3 -1] "point to" [0 0 0.5] "float coneangle" [35] "float conedeltaangle" [9]
AttributeBegin
Translate -1.5 2 0
Rotate 30 0 0 1
LightSource "goniometric" "rgb I" [5 5 6] "string mapname" ["{gonio}"]
AttributeEnd
AttributeBegin
Translate 0.5 2.5 0.5
Rotate 80 1 0 0
Rotate 15 0 1 0
LightSource "projection" "rgb I" [9 8 7] "float fov" [55] "string mapname" ["{proj}"]
AttributeEnd
AttributeBegin
Translate -0.5 2.5 1
Rotate 90 1 0 0
LightSource "projection" "rgb I" [3 3 3] "string mapname" ["missing.pfm"]
AttributeEnd
LightSource "point" "rgb I" [2 2 2] "point from" [2 1 -2]
LightSource "distant" "rgb L" [0.5 0.5 0.4] "point from" [1 1 -1] "point to" [0 0 0]
LightSource "infinite" "rgb L" [0.1 0.12 0.15]
AttributeBegin
AreaLightSource "diffuse" "rgb L" [4 4 4]
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [-0.5 2.9 0  0.5 2.9 0  0 2.9 0.5]
AttributeEnd
Material "matte"
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-4 -1 -4  -4 -1 4  4 -1 4  4 -1 -4]
Shape "sphere" "float radius" [0.6]
"""


@pytest.fixture(scope="module")
def light_scenes(tmp_path_factory):
    d = tmp_path_factory.mktemp("lights")
    rng = np.random.default_rng(9)
    gonio, proj = str(d / "gonio.pfm"), str(d / "proj.pfm")
    write_image(gonio, rng.uniform(0.2, 2.0, (16, 32, 3)).astype(np.float32))
    write_image(proj, rng.uniform(0.0, 3.0, (24, 40, 3)).astype(np.float32))
    text = _LIGHTS.format(gonio=gonio, proj=proj)
    sj = jc.compile_scene(jparse_string(text, jpbrt_init(JOptions(quiet=True))))
    st = tc.compile_scene(parse_string(text, pbrt_init(TOptions(quiet=True), device="cpu")))
    dev = tables_from_numpy(jax.tree.map(np.asarray, sj.dev), "cpu")
    return sj, st, dev


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _assert_tables_equal(sj, st):
    ref = flat_tables(tables_from_numpy(jax.tree.map(np.asarray, sj.dev), "cpu"))
    got = flat_tables(st.dev)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(ref[k]), err_msg=k)
    for f in ("func", "cdf", "func_int"):
        np.testing.assert_array_equal(_bits(getattr(st.light_distr, f).numpy()),
                                      _bits(np.asarray(getattr(sj.light_distr, f))), err_msg=f)
    assert (st.spatial_distr is None) == (sj.spatial_distr is None)
    if sj.spatial_distr is not None:
        for f in ("cdf", "mean_pmf", "lo", "inv_cs"):
            np.testing.assert_array_equal(_bits(getattr(st.spatial_distr, f).numpy()),
                                          _bits(np.asarray(getattr(sj.spatial_distr, f))),
                                          err_msg=f)


def test_light_tables_equal_reference(light_scenes):
    sj, st, _ = light_scenes
    types = st.dev["light"]["type"].tolist()
    assert types == [3, 1, 5, 6, 6, 0, 2, 4]
    img = st.dev["light"]["img"].numpy()
    assert img[2].tolist() == [0, 32, 16] and img[3].tolist() == [512, 40, 24]
    assert img[4].tolist() == [512 + 960, 1, 1]  # the constant map of the unreadable file
    assert st.dev["light_atlas"].shape == (512 + 960 + 1, 3)
    _assert_tables_equal(sj, st)


def _lanes(dev, seed):
    rng = np.random.default_rng(seed)
    n_l = dev["light"]["type"].shape[0]
    idx = np.arange(N) % n_l
    ref_p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    u = rng.uniform(0, 1, (6, N)).astype(np.float32)
    return idx.astype(np.int32), ref_p, u


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def test_sample_light_rows_matches_reference(light_scenes):
    sj, _, dev = light_scenes
    idx, ref_p, u = _lanes(dev, 1)
    want = jl.sample_light_rows(sj.dev, jnp.asarray(idx), jnp.asarray(ref_p), jnp.asarray(u[0]),
                                jnp.asarray(u[1]))
    got = tl.sample_light_rows(dev, torch.from_numpy(idx).long(), torch.from_numpy(ref_p),
                               torch.from_numpy(u[0].copy()), torch.from_numpy(u[1].copy()))
    for f in ("li", "wi", "pdf", "dist", "is_delta"):
        _close(getattr(got, f).numpy(), getattr(want, f), f)
    types = dev["light"]["type"].numpy()[idx]
    li = got.li.numpy()
    for t in (tl.LIGHT_SPOT, tl.LIGHT_GONIO, tl.LIGHT_PROJECTION):
        assert (li[types == t] > 0).any() and (li[types == t] == 0).any() or t == tl.LIGHT_GONIO


@rounded_apart
def test_sample_le_and_le_pdfs_match_reference(light_scenes):
    _check_sample_le_and_le_pdfs(light_scenes, jl)


def test_sample_le_and_le_pdfs_match_reference_contracted(light_scenes):
    """The port's default rounding against the reference compiled at the
    renders' optimisation level, with the same bounds."""
    _check_sample_le_and_le_pdfs(light_scenes, JitRef(jl))


def _check_sample_le_and_le_pdfs(light_scenes, jl):
    sj, st, dev = light_scenes
    _, _, u = _lanes(dev, 2)
    for distr_j, distr_t in ((None, None), (sj.light_distr, st.light_distr),
                             (sj.spatial_distr, st.spatial_distr)):
        want = jl.sample_le(sj.dev, distr_j, *(jnp.asarray(x) for x in u[:5]))
        got = tl.sample_le(dev, distr_t, *(torch.from_numpy(x.copy()) for x in u[:5]))
        for f in want._fields:
            _close(getattr(got, f).numpy(), getattr(want, f), f)
    # Pdf_Le of those emission rays, from the same rows and normals
    wp, wd = jl.le_pdfs(sj.dev, want.li_idx, want.n, want.d)
    gp, gd = tl.le_pdfs(dev, got.li_idx, got.n, got.d)
    _close(gp.numpy(), wp, "pdf_pos")
    _close(gd.numpy(), wd, "pdf_dir")
    types = dev["light"]["type"].numpy()[got.li_idx.numpy()]
    assert {1, 5, 6} <= set(types.tolist())


def test_light_map_scale_matches_reference(light_scenes):
    """The image factor over the whole sphere of directions, the map
    borders and the projection's window edges included."""
    sj, _, dev = light_scenes
    rng = np.random.default_rng(4)
    w = rng.normal(size=(N, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    idx = (np.arange(N) % dev["light"]["type"].shape[0]).astype(np.int32)
    types = dev["light"]["type"].numpy()[idx]
    jt = jnp.asarray(types)
    want = jl._light_map_scale(sj.dev, sj.dev["light"], jnp.asarray(idx), jnp.asarray(w),
                               jt == jl.LIGHT_GONIO, jt == jl.LIGHT_PROJECTION)
    tt = torch.from_numpy(types)
    got = tl._light_map_scale(dev, dev["light"], torch.from_numpy(idx).long(),
                              torch.from_numpy(w.copy()), tt == tl.LIGHT_GONIO,
                              tt == tl.LIGHT_PROJECTION)
    _close(got.numpy(), want, "scale")
    proj = types == tl.LIGHT_PROJECTION
    assert (got.numpy()[proj] == 0).any() and (got.numpy()[proj] > 0).any()


_TWO_ENV = """
Integrator "path" "integer maxdepth" [2]
Sampler "zerotwosequence" "integer pixelsamples" [1]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 0 -3  0 0 0  0 1 0
Camera "perspective" "float fov" [40]
WorldBegin
LightSource "point" "rgb I" [2 2 2] "point from" [0 1 -2]
AttributeBegin
Rotate 90 1 0 0
LightSource "infinite" "string mapname" ["{sky}"] "rgb L" [0.5 0.5 0.5]
AttributeEnd
AttributeBegin
Rotate 30 0 1 0
LightSource "infinite" "rgb L" [0.2 0.3 0.4]
AttributeEnd
Material "matte"
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [-1 -1 0  1 -1 0  0 1 0]
"""


def test_two_infinite_lights_last_map_wins(tmp_path):
    sky = str(tmp_path / "sky.pfm")
    write_image(sky, np.random.default_rng(2).uniform(0.1, 3, (8, 16, 3)).astype(np.float32))
    text = _TWO_ENV.format(sky=sky)
    sj = jc.compile_scene(jparse_string(text, jpbrt_init(JOptions(quiet=True))))
    st = tc.compile_scene(parse_string(text, pbrt_init(TOptions(quiet=True), device="cpu")))
    assert st.dev["light"]["type"].tolist() == [0, 4, 4]
    # the second light's constant 4x8 map, under its own rotation
    assert st.dev["envmap"].shape == (4, 8, 3)
    np.testing.assert_array_equal(st.dev["envmap"][0, 0].numpy(),
                                  np.float32([0.2, 0.3, 0.4]))
    _assert_tables_equal(sj, st)
    api = parse_string(text + "WorldEnd\n", render=True, device="cpu")
    assert np.isfinite(api.result.image).all() and api.result.image.max() > 0
