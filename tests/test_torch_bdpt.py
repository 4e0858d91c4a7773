"""BDPT on the CPU, against the JAX package.

- Module parity on seeded numpy inputs handed to both packages' compiled
  tables: `lights_dev.sample_le` and `le_pdfs` on point, one- and
  two-sided area and distant rows (and the distant row's Sample_Li);
  the pinhole camera's importance side (`camera_world_frame`,
  `_screen_area_z1`, `camera_pdf_we`, `camera_sample_wi` with the
  raster projection, and the inverse matrices it takes, which must be
  bit-equal); `Film.add_splats` (the non-finite scrub, the
  maxsampleluminance clamp, the crop window); `_convert_density`; and
  `_walk` in both modes on the small Cornell box (radiance: camera rays;
  importance: light rays from `sample_le`, with the shading-normal
  correction). Integers and masks must match exactly; floats agree to
  RTOL relative + ATOL absolute (measured at most a few ulps where XLA's
  and PyTorch's transcendentals round apart).
- Renders against the JAX CPU goldens of tests/torch_golden/make_golden.py
  (`LT_CASES`): the small Cornell box, tests/test_bdpt.py's
  environment-lit and distant-lit scenes and the small caustic. Each has
  a pinned MSE bound and traced-ray difference in GOLDEN_TOL (measured
  values beside them); where the CPU port follows the JAX package lane
  for lane the rays are exact.
- The reference's oracles, on the port alone: bdpt equals path within
  5% at maxdepth 1 and 3 (per channel within 8% at 3), the (2,1)
  light-tracing splats land on the film, and the render is bit-identical
  across two chunk sizes (every sample stream is a pure function of the
  work item).
"""

import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpu_pbrt import cameras as jcam
from tpu_pbrt import config as jconfig
from tpu_pbrt import scenes as jscenes
from tpu_pbrt.core import film as jfilm
from tpu_pbrt.core import lights_dev as jld
from tpu_pbrt.integrators import bdpt as jbdpt
from tpu_pbrt.scene.api import Options as JOptions
from tpu_pbrt.scene.api import parse_string as jparse_string
from tpu_pbrt.scene.api import pbrt_init as jpbrt_init
from tpu_pbrt_torch import cameras as tcam
from tpu_pbrt_torch import scenes as tscenes
from tpu_pbrt_torch.config import cfg as tcfg
from tpu_pbrt_torch.core import film as tfilm
from tpu_pbrt_torch.core import lights_dev as tld
from tpu_pbrt_torch.core.filters import FilterSpec as TFilterSpec
from tpu_pbrt_torch.integrators import bdpt as tbdpt
from tpu_pbrt_torch.scene.api import Options as TOptions
from tpu_pbrt_torch.scene.api import parse_string as tparse_string
from tpu_pbrt_torch.scene.api import pbrt_init as tpbrt_init

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "torch_golden")
sys.path.insert(0, GOLDEN)
from make_golden import LEAF_TRIS, jax_caustic_api, lt_api  # noqa: E402

N = 4096
RTOL, ATOL = 2e-6, 1e-6
#: the walk's area densities, relative (measured at most 7.8e-4 at a corner)
WALK_PDF_RTOL = 2e-3
#: golden -> (MSE bound, traced-ray difference bound); measured in the comments
GOLDEN_TOL = {
    "bdpt_cornell": (1e-12, 0),  # 1.9e-15, rays equal (16,281)
    "bdpt_env": (1e-12, 0),  # 3.2e-15 (919)
    "bdpt_distant": (1e-12, 0),  # 6.4e-14 (2,101)
    "bdpt_caustic": (1e-12, 0),  # 9.7e-14 (5,779)
}


def _both(x):
    """The same numpy values as a JAX array and a torch tensor (copies)."""
    return jnp.asarray(np.array(x, copy=True)), torch.from_numpy(np.array(x, copy=True))


def _close(t, j, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(t.numpy() if torch.is_tensor(t) else t, np.asarray(j),
                               rtol=rtol, atol=atol, err_msg=what)


def _dirs(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.fixture
def small_treelets(monkeypatch):
    """The goldens' 64-triangle treelets, on both packages."""
    monkeypatch.setenv("TPU_PBRT_LEAF_TRIS", str(LEAF_TRIS))
    monkeypatch.setattr(tcfg, "leaf_tris", LEAF_TRIS)
    jconfig.reload()
    yield
    monkeypatch.undo()
    jconfig.reload()


_LIGHTS = {
    "point": 'LightSource "point" "rgb I" [3 2 1] "point from" [0.3 1.5 -0.2]',
    "area": 'AttributeBegin\nAreaLightSource "diffuse" "rgb L" [4 3 2]\n'
            'Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] '
            '"point P" [-0.5 1.9 -0.5  0.5 1.9 -0.5  0.5 1.9 0.5  -0.5 1.9 0.5]\nAttributeEnd',
    "area_twosided": 'AttributeBegin\nAreaLightSource "diffuse" "rgb L" [4 3 2] '
                     '"bool twosided" ["true"]\nShape "trianglemesh" "integer indices" '
                     '[0 1 2] "point P" [-0.5 1.9 -0.5  0.5 1.7 -0.5  0.5 1.9 0.5]\nAttributeEnd',
    "distant": 'LightSource "distant" "rgb L" [3 3 2.6] "point from" [2 5 -2] "point to" [0 0 0]',
}


def _light_scene(kind):
    text = f"""
Integrator "bdpt" "integer maxdepth" [3]
Sampler "zerotwosequence" "integer pixelsamples" [1]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 1 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" [45]
WorldBegin
{_LIGHTS[kind]}
LightSource "point" "rgb I" [1 1 1] "point from" [-1 2 0]
Material "matte" "rgb Kd" [0.6 0.55 0.5]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3] "point P" [-5 0 -5  5 0 -5  5 0 5  -5 0 5]
"""
    sj, _ = jscenes.compile_api(jparse_string(text, jpbrt_init(JOptions(quiet=True))))
    st, _ = tscenes.compile_api(tparse_string(text, tpbrt_init(TOptions(quiet=True),
                                                                device="cpu")))
    return sj, st


@pytest.mark.parametrize("kind", list(_LIGHTS))
def test_sample_le_and_le_pdfs_match_reference(kind):
    sj, st = _light_scene(kind)
    rng = np.random.default_rng(11)
    u = rng.uniform(0, 1, (5, N)).astype(np.float32)
    uu = [_both(x) for x in u]
    for distr in ("power", None):
        dj = sj.light_distr if distr else None
        dt = st.light_distr if distr else None
        a = jld.sample_le(sj.dev, dj, *(x[0] for x in uu))
        b = tld.sample_le(st.dev, dt, *(x[1] for x in uu))
        np.testing.assert_array_equal(b.li_idx.numpy(), np.asarray(a.li_idx))
        for f in ("is_delta", "supported"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(a, f)), f)
        for f in ("pmf", "p", "n", "d", "le", "pdf_pos", "pdf_dir"):
            _close(getattr(b, f), getattr(a, f), what=f"{kind} {distr} sample_le.{f}")
    # Pdf_Le of every row, for emission normals and directions on the sphere
    n_rows = int(st.dev["light"]["type"].shape[0])
    idx = rng.integers(0, n_rows, N).astype(np.int32)
    (ij, it), (nj, nt), (wj, wt) = _both(idx), _both(_dirs(rng, N)), _both(_dirs(rng, N))
    for x, y, f in zip(tld.le_pdfs(st.dev, it, nt, wt), jld.le_pdfs(sj.dev, ij, nj, wj),
                       ("pdf_pos", "pdf_dir")):
        _close(x, y, what=f"{kind} le_pdfs {f}")
    if kind == "distant":  # the distant row's Sample_Li
        p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
        (pj, pt) = _both(p)
        a = jld.sample_light_rows(sj.dev, ij, pj, uu[0][0], uu[1][0])
        b = tld.sample_light_rows(st.dev, it, pt, uu[0][1], uu[1][1])
        np.testing.assert_array_equal(b.is_delta.numpy(), np.asarray(a.is_delta))
        for f in ("li", "wi", "pdf", "dist"):
            _close(getattr(b, f), getattr(a, f), what=f"distant sample_light_rows.{f}")


@pytest.mark.parametrize("scene", ["cornell", "caustic"])
def test_camera_importance_matches_reference(scene):
    if scene == "cornell":
        sj, _ = jscenes.compile_api(jscenes.make_cornell(res=16, spp=1))
        st, _ = tscenes.compile_api(tscenes.make_cornell(res=16, spp=1, device="cpu"))
    else:
        sj, _ = jscenes.compile_api(jax_caustic_api(64, 1, n_theta=12, n_phi=24))
        st, _ = tscenes.compile_api(tscenes.make_caustic_like(res=64, spp=1, n_theta=12,
                                                              n_phi=24, device="cpu"))
    cj, ct = sj.camera, st.camera
    for f in ("camera_to_world", "raster_to_camera"):
        np.testing.assert_array_equal(tcam._inverse(getattr(ct, f)).numpy(),
                                      np.asarray(jnp.linalg.inv(getattr(cj, f))), err_msg=f)
    for x, y in zip(tcam.camera_world_frame(ct), jcam.camera_world_frame(cj)):
        _close(x, y, what="camera_world_frame")
    _close(tcam._screen_area_z1(ct), jcam._screen_area_z1(cj), what="_screen_area_z1")
    rng = np.random.default_rng(12)
    (dj, dt) = _both(_dirs(rng, N))
    for x, y in zip(tcam.camera_pdf_we(ct, dt), jcam.camera_pdf_we(cj, dj)):
        _close(x, y, what="camera_pdf_we")
    p = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    (pj, pt) = _both(p)
    a, b = jcam.camera_sample_wi(cj, pj), tcam.camera_sample_wi(ct, pt)
    np.testing.assert_array_equal(b[5].numpy(), np.asarray(a[5]))
    assert np.asarray(a[5]).mean() > 0.1
    for k, f in enumerate(("wi", "dist", "pdf", "we", "raster")):
        _close(b[k], a[k], rtol=4e-6, what=f"camera_sample_wi {f}")
    # the splat pixel of every in-bounds point (no point sits on an edge)
    inb = np.asarray(a[5])
    np.testing.assert_array_equal(np.floor(b[4].numpy()[inb]), np.floor(np.asarray(a[4])[inb]))


def test_add_splats_matches_reference():
    rng = np.random.default_rng(13)
    kw = dict(resolution=(24, 16), crop_window=(0.1, 0.9, 0.0, 0.75), max_sample_luminance=8.0)
    fj = jfilm.Film(filt=jfilm.FilterSpec("box", 0.5, 0.5, 0.0, 0.0), **kw)
    ft = tfilm.Film(filt=TFilterSpec("box", 0.5, 0.5, 0.0, 0.0), **kw)
    p = rng.uniform(-3, 27, (N, 2)).astype(np.float32)
    v = rng.exponential(2.0, (N, 3)).astype(np.float32)
    v[::97] = np.nan
    v[1::89, 1] = np.inf
    (pj, pt), (vj, vt) = _both(p), _both(v)
    sj_ = fj.add_splats(fj.init_state(), pj, vj)
    st_ = ft.add_splats(ft.init_state("cpu"), pt, vt)
    _close(st_.splat, sj_.splat, what="add_splats")
    assert np.isfinite(st_.splat.numpy()).all() and st_.splat.numpy().max() > 0
    np.testing.assert_array_equal(ft.develop(st_, 0.5) > 0, fj.develop(sj_, 0.5) > 0)


@pytest.mark.parametrize("surface", [True, False])
def test_convert_density_matches_reference(surface):
    rng = np.random.default_rng(14)
    pdf = rng.uniform(0, 3, N).astype(np.float32)
    a = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    b = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    args = [_both(x) for x in (pdf, a, b, _dirs(rng, N))]
    _close(tbdpt._convert_density(*(x[1] for x in args), surface),
           jbdpt._convert_density(*(x[0] for x in args), surface), what="_convert_density")


@pytest.mark.parametrize("mode", ["radiance", "importance"])
def test_walk_matches_reference(mode):
    """BDPT's walk of 1,024 camera or light subpaths on the small Cornell
    box against the reference's walk of the same inputs
    (tests/torch_golden/make_module_reference.py: bdpt_walk_<mode>.npz,
    the reference run as under pytest)."""
    st, it = tscenes.compile_api(tscenes.make_cornell(res=16, spp=4, integrator="bdpt",
                                                      maxdepth=5, device="cpu"))
    ref = np.load(os.path.join(GOLDEN, f"bdpt_walk_{mode}.npz"))
    x = {k[3:]: torch.from_numpy(np.array(ref[k])) for k in ref.files if k.startswith("in_")}
    R = x["o"].shape[0]
    path = tbdpt._Path(R, 6, "cpu")
    path.set(0, p=x["o"], ng=x["n0"], ns=x["n0"], valid=x["alive"])
    nb, _ = it._walk(st.dev, path, x["o"], x["d"], x["beta"], x["pdf_dir"], x["alive"], x["px"],
                     x["py"], x["s"], 0 if mode == "radiance" else 3011, 5, mode,
                     origin_surface=x.get("surf"))
    np.testing.assert_array_equal(nb.numpy(), ref["nrays"])
    for f in ("mat", "light", "delta", "valid"):
        np.testing.assert_array_equal(getattr(path, f).numpy(), ref[f"path_{f}"], f)
    assert ref["path_valid"][:, 2].mean() > 0.3
    for f in ("p", "ng", "ns", "beta"):
        _close(getattr(path, f), ref[f"path_{f}"], rtol=2e-5, atol=2e-5, what=f"{mode} _walk.{f}")
    # area densities divide by the squared distance between two vertices,
    # which cancels where a path hits two nearby surfaces (a corner): an
    # ulp of position there is a larger relative step in the density
    for f in ("pdf_fwd", "pdf_rev"):
        a, b = ref[f"path_{f}"], getattr(path, f).numpy()
        rel = np.abs(b - a) / np.maximum(np.abs(a), 1e-6)
        assert rel.max() < WALK_PDF_RTOL and (rel < 2e-5).mean() > 0.99, (f, rel.max())


def _port_lt(name):
    return tscenes.compile_api(lt_api(name, tscenes, tparse_string, tpbrt_init, TOptions,
                                      tscenes.make_caustic_like, tscenes._crown_envmap_path(),
                                      device="cpu"))


@pytest.mark.parametrize("name", list(GOLDEN_TOL))
def test_render_matches_jax_golden(name, small_treelets):
    ref = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    scene, integ = _port_lt(name)
    assert scene.n_tris == int(ref["n_tris"])
    res = integ.render(scene)
    img = res.image
    assert img.shape == ref["image"].shape and np.isfinite(img).all()
    mse = float(np.mean((img.astype(np.float64) - ref["image"]) ** 2))
    mse_bar, ray_bar = GOLDEN_TOL[name]
    assert abs(res.rays_traced - int(ref["rays_traced"])) <= ray_bar, (
        name, res.rays_traced, int(ref["rays_traced"]))
    assert mse <= mse_bar, (name, mse)
    assert ref["image"].mean() > 0 and res.stats["n_drop"] == 0


def _cornell(integrator, md, res=16, spp=32, only=None):
    scene, integ = tscenes.compile_api(tscenes.make_cornell(
        res=res, spp=spp, integrator=integrator, maxdepth=md, device="cpu"))
    if only is not None:
        integ._only = only
    return integ.render(scene).image


@pytest.mark.parametrize("md", [1, 3])
def test_bdpt_matches_path(md):
    """bdpt's strategies partition each path family (the reference's
    test_bdpt_matches_path_{direct,indirect})."""
    p, b = _cornell("path", md), _cornell("bdpt", md)
    assert abs(b.mean() - p.mean()) / p.mean() < 0.05, (b.mean(), p.mean())
    if md == 3:
        np.testing.assert_allclose(b.mean(axis=(0, 1)), p.mean(axis=(0, 1)), rtol=0.08)


def test_light_tracing_splats_land():
    img = _cornell("bdpt", 2, spp=8, only={(2, 1)})
    assert np.isfinite(img).all() and img.mean() > 1e-3


def test_chunk_invariance(small_treelets):
    """The small caustic at two chunk sizes: the same image bit for bit and
    the same rays."""
    scene, integ = _port_lt("bdpt_caustic")
    a = integ.render(scene)
    b = integ.render(scene, chunk=256)
    assert a.stats["chunks"] == 1 and b.stats["chunks"] == 4
    assert a.rays_traced == b.rays_traced
    np.testing.assert_array_equal(a.image, b.image)


_CLI_PARAMS = {
    "bdpt": "",
    "sppm": '"integer numiterations" [2] "integer photonsperiteration" [1024]',
    "mlt": '"integer chains" [64] "integer bootstrapsamples" [256] '
           '"integer mutationsperpixel" [16]',
}


@pytest.mark.parametrize("integrator", list(_CLI_PARAMS))
def test_cli_renders_light_transport_integrators(integrator, tmp_path):
    """`python -m tpu_pbrt_torch.main scene.pbrt --device cpu` under bdpt,
    sppm and mlt: a scene file with a distant light, written to an image."""
    from tpu_pbrt_torch import main as cli
    from tpu_pbrt_torch.utils.imageio import read_pfm

    from make_golden import lt_scene_text

    text = lt_scene_text("distant", integrator=integrator, md=2, spp=2, res=8)
    path = tmp_path / "scene.pbrt"
    head = f'"{integrator}" "integer maxdepth" [2]'
    path.write_text(text.replace(head, f"{head} {_CLI_PARAMS[integrator]}"))
    out = tmp_path / "out.pfm"
    assert cli.main([str(path), "--quiet", "--device", "cpu", "-o", str(out)]) == 0
    img = read_pfm(str(out))
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.mean() > 0
