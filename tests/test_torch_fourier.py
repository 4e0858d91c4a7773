"""The port's tabulated Fourier BSDF (tpu_pbrt_torch/core/fourierbsdf.py)
against the JAX package's (tpu_pbrt/core/fourierbsdf.py), the
reference's oracles of tests/test_fourier.py on the port, and the
material's lowering and render through `path`.

Tolerances: the .bsdf reader's arrays equal the reference's; f and pdf
of fourier_f_pdf equal the reference bit for bit on a 1-channel and a
3-channel table written by the test (the same f32 operations, the
Catmull-Rom blend in the same order); the sampled directions within
2e-6 absolute (the shared cosine draw takes torch's CPU sin, cos and
square root, which round an ulp or so apart from glibc's and XLA's;
measured 1.4e-6); bsdf_eval and bsdf_sample hand fourier lanes those
values bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_pbrt.core import fourierbsdf as jfb
from tests.test_fourier import _write_bsdf
from tpu_pbrt_torch.core import bxdf as tbx
from tpu_pbrt_torch.core import fourierbsdf as tfb
from tpu_pbrt_torch.scene.api import parse_string
from tpu_pbrt_torch.scenes import write_fourier_bsdf

torch.set_num_threads(1)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _lambert_vals(n_mu, rho):
    mu = np.linspace(-1.0, 1.0, n_mu).astype(np.float32)
    vals = np.zeros((n_mu, n_mu), np.float32)
    for o in range(n_mu):
        for i in range(n_mu):
            if mu[i] * mu[o] < 0:
                vals[o, i] = rho / np.pi * abs(mu[i])
    return mu, vals


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("bsdf")
    one, three = str(d / "one.bsdf"), str(d / "three.bsdf")
    mu, vals = _lambert_vals(16, 0.7)
    _write_bsdf(one, mu, vals, eta=1.33)
    write_fourier_bsdf(three)
    return {"one": one, "three": three}


def _dirs(rng, n, up=None):
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if up is not None:
        d[:, 2] = np.abs(d[:, 2]) * (1 if up else -1)
    return d.astype(np.float32)


@pytest.mark.parametrize("which", ["one", "three"])
def test_reader_and_f_pdf_equal_reference(tables, which):
    ht, hj = tfb.read_bsdf_file(tables[which]), jfb.read_bsdf_file(tables[which])
    for f in tfb.FourierTable.FIELDS:
        np.testing.assert_array_equal(getattr(ht, f), np.asarray(getattr(hj, f)), err_msg=f)
    assert (ht.eta, ht.n_channels, ht.m_max) == (hj.eta, hj.n_channels, hj.m_max)
    assert ht.n_channels == (1 if which == "one" else 3)
    tt = ht.to("cpu")
    rng = np.random.default_rng(11)
    wo, wi = _dirs(rng, 4096), _dirs(rng, 4096)
    ft, pt = tfb.fourier_f_pdf(tt, torch.from_numpy(wo), torch.from_numpy(wi))
    fj, pj = jfb.fourier_f_pdf(hj, jnp.asarray(wo), jnp.asarray(wi))
    np.testing.assert_array_equal(_bits(ft), _bits(fj))
    np.testing.assert_array_equal(_bits(pt), _bits(pj))
    assert (ft.numpy() > 0).any()
    u = rng.uniform(0, 1, (3, 4096)).astype(np.float32)
    wst = tfb.fourier_sample_wi(torch.from_numpy(wo), *map(torch.from_numpy, u))
    wsj = jfb.fourier_sample_wi(jnp.asarray(wo), *map(jnp.asarray, u))
    np.testing.assert_allclose(wst.numpy(), np.asarray(wsj), rtol=0, atol=2e-6)


def test_bsdf_dispatch_and_transmission_flag(tables):
    """bsdf_eval / bsdf_sample give fourier lanes the table's own f, pdf
    and two-sided draw bit for bit, and flag a hemisphere crossing as
    transmission (the reference's dispatch, bxdf.py:1168, :1226, :1313);
    matte lanes beside them keep their lobe."""
    tab = tfb.read_bsdf_file(tables["three"]).to("cpu")
    n = 1024
    rng = np.random.default_rng(2)
    fl = rng.uniform(size=n) < 0.5
    one3, one = torch.ones((n, 3)), torch.ones(n)
    mp = tbx.MatParams(
        mtype=torch.from_numpy(np.where(fl, tbx.MAT_FOURIER, tbx.MAT_MATTE).astype(np.int32)),
        kd=one3 * 0.5, ks=one3 * 0, kr=one3 * 0, kt=one3 * 0, eta=one3, k=one3 * 0,
        ax=one * 0.1, ay=one * 0.1, sigma=one * 0, opacity=one3, rough_raw=one * 0, fz=tab)
    wo, wi = torch.from_numpy(_dirs(rng, n, up=True)), torch.from_numpy(_dirs(rng, n))
    f, pdf = tbx.bsdf_eval(mp, wo, wi)
    f_fo, pdf_fo = tfb.fourier_f_pdf(tab, wo, wi)
    assert torch.equal(f[fl], f_fo[fl]) and torch.equal(pdf[fl], pdf_fo[fl])
    u = [torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)) for _ in range(3)]
    bs = tbx.bsdf_sample(mp, wo, *u)
    wi_fo = tfb.fourier_sample_wi(wo, *u)
    assert torch.equal(bs.wi[fl], wi_fo[fl])
    f_s, pdf_s = tfb.fourier_f_pdf(tab, wo, wi_fo)
    ok = fl & (pdf_s > 0).numpy()
    assert torch.equal(bs.f[ok], f_s[ok]) and torch.equal(bs.pdf[ok], pdf_s[ok])
    crossed = (wo[:, 2] * bs.wi[:, 2] <= 0).numpy()
    np.testing.assert_array_equal(bs.is_transmission.numpy()[fl], crossed[fl])
    assert bs.is_transmission.numpy()[fl].any() and not bs.is_transmission.numpy()[~fl].any()
    assert not bs.is_specular.any()


def test_lambertian_table_eval(tables):
    """tests/test_fourier.py's oracle on the port: the table of rho / pi
    reflects rho / pi away from grazing and transmits (near) nothing."""
    tab = tfb.read_bsdf_file(tables["one"]).to("cpu")
    rng = np.random.default_rng(1)
    n = 20_000
    wo, wi = _dirs(rng, n, up=True), _dirs(rng, n, up=True)
    f, _ = tfb.fourier_f_pdf(tab, torch.from_numpy(wo), torch.from_numpy(wi))
    mask = (wi[:, 2] > 0.2) & (wo[:, 2] > 0.2)
    np.testing.assert_allclose(f[:, 0].numpy()[mask], 0.7 / np.pi, rtol=0.03)
    wi_t = _dirs(rng, n, up=False)
    f_t, _ = tfb.fourier_f_pdf(tab, torch.from_numpy(wo), torch.from_numpy(wi_t))
    mask_t = (wi_t[:, 2] < -0.2) & (wo[:, 2] > 0.2)
    assert float(np.abs(f_t[:, 0].numpy()[mask_t]).max()) < 0.02


def test_sampling_estimator_matches():
    mu, vals = _lambert_vals(32, 0.7)
    tab = tfb.make_table(mu, vals).to("cpu")
    n = 100_000
    rng = np.random.default_rng(5)
    v = np.asarray([0.1, 0.2, 0.97]) / np.linalg.norm([0.1, 0.2, 0.97])
    wo = torch.from_numpy(np.broadcast_to(v.astype(np.float32), (n, 3)).copy())
    u = [torch.from_numpy(rng.uniform(size=n).astype(np.float32)) for _ in range(3)]
    wi = tfb.fourier_sample_wi(wo, *u)
    f, pdf = tfb.fourier_f_pdf(tab, wo, wi)
    w = torch.where(pdf > 1e-8, f[:, 0] * torch.abs(wi[:, 2]) / torch.clamp(pdf, min=1e-8), 0.0)
    assert abs(float(w.double().mean()) - 0.7) < 0.03


def test_make_table_equals_reference():
    mu, vals = _lambert_vals(12, 0.4)
    a, b = tfb.make_table(mu, vals, eta=1.2), jfb.make_table(mu, vals, eta=1.2)
    for f in tfb.FourierTable.FIELDS:
        np.testing.assert_array_equal(getattr(a, f), np.asarray(getattr(b, f)), err_msg=f)


def _scene(mat):
    return f"""
Integrator "path" "integer maxdepth" [3]
Sampler "random" "integer pixelsamples" [2]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 2 5  0 0 0  0 1 0
Camera "perspective" "float fov" [45]
WorldBegin
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [10 10 10]
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [-1 3.9 -1  1 3.9 -1  1 3.9 1  -1 3.9 1]
AttributeEnd
Material {mat}
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-3 0 -3  3 0 -3  3 0 3  -3 0 3]
WorldEnd
"""


def test_fourier_scene_end_to_end(tables):
    """tests/test_fourier.py's scene: the fourier ground renders lit."""
    api = parse_string(_scene(f'"fourier" "string bsdffile" ["{tables["three"]}"]'),
                       render=True, device="cpu")
    img = api.result.image
    assert np.isfinite(img).all() and img.max() > 0.0


def test_unreadable_table_falls_back_to_diffuse(caplog):
    """A bsdffile that cannot be read lowers to the 0.5 diffuse fallback,
    loudly, as the reference does."""
    from tpu_pbrt_torch.scene.compiler import compile_scene
    from tpu_pbrt_torch.scene.api import Options, pbrt_init

    api = pbrt_init(Options(), device="cpu")
    parse_string(_scene('"fourier" "string bsdffile" ["missing.bsdf"]').replace("WorldEnd", ""),
                 api, render=False)
    sc = compile_scene(api)
    assert "SUBSTITUTING a 0.5 diffuse BSDF" in caplog.text
    fl = sc.dev["mat"]["type"].numpy()
    assert tbx.MAT_FOURIER not in fl and "_fourier" not in sc.dev["mat"]
    np.testing.assert_array_equal(sc.dev["mat"]["kd"].numpy()[-1], [0.5, 0.5, 0.5])
