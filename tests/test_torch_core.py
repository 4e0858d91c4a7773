"""Cheap eager parity checks of the port's core modules against the JAX
package, on seeded numpy inputs handed to both sides.

Integer streams (hashes, (0,2)-sequence draws, film jitter) must match bit
for bit: the port recomputes the reference's uint32 arithmetic in masked
int64. The float modules (camera rays, diffuse BSDF, light sampling, film
deposit) run the same f32 formulas in the same order and must agree to
1e-6 relative, except where a value goes through sin/cos (the cosine
warp), which the two libraries may round an ulp apart; the brute feature
intersector's hit prims exactly and its t/b0/b1 to 1e-5.
"""

import types

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpu_pbrt.accel import mxu as jmxu
from tpu_pbrt.cameras import generate_rays as jgenerate_rays
from tpu_pbrt.cameras import make_camera as jmake_camera
from tpu_pbrt.core import bxdf as jbxdf
from tpu_pbrt.core import lights_dev as jld
from tpu_pbrt.core import sampling as js
from tpu_pbrt.core import transform as jxf
from tpu_pbrt.core.film import Film as JFilm
from tpu_pbrt.integrators.common import WavefrontIntegrator as JWave
from tpu_pbrt.scene.paramset import ParamSet as JParamSet
from tpu_pbrt_torch.accel import mxu as tmxu
from tpu_pbrt_torch.cameras import generate_rays as tgenerate_rays
from tpu_pbrt_torch.cameras import make_camera as tmake_camera
from tpu_pbrt_torch.core import bxdf as tbxdf
from tpu_pbrt_torch.core import lights_dev as tld
from tpu_pbrt_torch.core import sampling as ts
from tpu_pbrt_torch.core import transform as txf
from tpu_pbrt_torch.core.film import Film as TFilm
from tpu_pbrt_torch.integrators.common import WavefrontIntegrator as TWave
from tpu_pbrt_torch.scene.paramset import ParamSet as TParamSet
from tests.test_torch_xla_math import JitRef, rounded_apart

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

RTOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a_t, a_j, rtol=RTOL, atol=1e-7):
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def work():
    rng = np.random.default_rng(11)
    n = 4096
    px = rng.integers(0, 512, n).astype(np.int32)
    py = rng.integers(0, 512, n).astype(np.int32)
    s = rng.integers(0, 256, n).astype(np.int32)
    return px, py, s


def test_hash_u32_bits(work):
    px, py, s = work
    salts = np.random.default_rng(2).integers(-2**31, 2**31 - 1, px.shape).astype(np.int32)
    hj = np.asarray(js.hash_u32(px, py, s, salts)).astype(np.int64)
    ht = ts.hash_u32(_t(px), _t(py), _t(s), _t(salts)).numpy()
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(
        ts.uniform_float(_t(px), _t(py), 7).numpy(), np.asarray(js.uniform_float(px, py, 7))
    )


@pytest.mark.parametrize("spp", [1, 16, 256])
@pytest.mark.parametrize("salt", [2, 37])
def test_zero_two_sampler_bits(work, spp, salt):
    px, py, s = work
    s = s % spp
    u_j = np.asarray(js.sample_1d("02", spp, px, py, s, salt))
    u_t = ts.sample_1d("02", spp, _t(px), _t(py), _t(s), salt).numpy()
    np.testing.assert_array_equal(u_t.view(np.int32), u_j.view(np.int32))
    a_j, b_j = js.sample_2d("02", spp, px, py, s, salt)
    a_t, b_t = ts.sample_2d("02", spp, _t(px), _t(py), _t(s), salt)
    np.testing.assert_array_equal(a_t.numpy().view(np.int32), np.asarray(a_j).view(np.int32))
    np.testing.assert_array_equal(b_t.numpy().view(np.int32), np.asarray(b_j).view(np.int32))


def test_film_jitter_bits(work):
    px, py, s = work
    fx_j, fy_j = JWave.film_jitter(types.SimpleNamespace(skind="02"), px, py, s)
    fx_t, fy_t = TWave.film_jitter(types.SimpleNamespace(skind="02"), _t(px), _t(py), _t(s))
    np.testing.assert_array_equal(fx_t.numpy().view(np.int32), np.asarray(fx_j).view(np.int32))
    np.testing.assert_array_equal(fy_t.numpy().view(np.int32), np.asarray(fy_j).view(np.int32))


@pytest.mark.parametrize("lens", [0.0, 0.05])
def test_generate_rays(lens):
    rng = np.random.default_rng(5)
    cams = []
    for PS, xf, make in ((JParamSet, jxf, jmake_camera), (TParamSet, txf, tmake_camera)):
        ps = PS()
        ps.add("float fov", [38.0])
        ps.add("float lensradius", [lens])
        ps.add("float focaldistance", [3.0])
        c2w = xf.look_at([0, 1.2, -3.4], [0, 0.3, 0], [0, 1, 0]).inverse()
        cams.append(make("perspective", ps, c2w, (64, 48)))
    p_film = rng.uniform(0, 48, (2000, 2)).astype(np.float32)
    u_lens = rng.uniform(0, 1, (2000, 2)).astype(np.float32)
    oj, dj, wj = jgenerate_rays(cams[0], jnp.asarray(p_film), jnp.asarray(u_lens))
    ot, dt, wt = tgenerate_rays(cams[1], _t(p_film), _t(u_lens))
    _close(ot, oj)
    _close(dt, dj)
    _close(wt, wj)


def _mat_tables(rng, m=3):
    kd = rng.uniform(0.1, 0.9, (m, 3)).astype(np.float32)
    sigma = np.array([0.0, 20.0, 0.0], np.float32)[:m]
    types_ = np.array([1, 1, 0], np.int32)[:m]  # matte, matte (Oren-Nayar), none
    z3 = np.zeros((m, 3), np.float32)
    jmat = {
        "type": types_, "kd": kd, "ks": z3, "kr": z3, "kt": z3,
        "eta": np.ones((m, 3), np.float32), "k": z3,
        "rough_u": np.zeros(m, np.float32), "rough_v": np.zeros(m, np.float32),
        "sigma": sigma, "opacity": np.ones((m, 3), np.float32),
        "remap": np.ones(m, np.int32),
    }
    tmat = dict(jmat)  # the port's table has the reference's constant columns
    return ({k: jnp.asarray(v) for k, v in jmat.items()},
            {k: _t(v) for k, v in tmat.items()})


def _dirs(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def test_diffuse_bsdf_eval_and_sample():
    rng = np.random.default_rng(8)
    jmat, tmat = _mat_tables(rng)
    n = 3000
    mid = rng.integers(0, 3, n).astype(np.int32)
    wo, wi = _dirs(rng, n), _dirs(rng, n)
    mpj = jbxdf.gather_mat(jmat, jnp.asarray(mid))
    mpt = tbxdf.gather_mat(tmat, _t(mid))
    fj, pj = jbxdf.bsdf_eval(mpj, jnp.asarray(wo), jnp.asarray(wi))
    ft, pt = tbxdf.bsdf_eval(mpt, _t(wo), _t(wi))
    _close(ft, fj)
    _close(pt, pj)
    u = rng.uniform(0, 1, (3, n)).astype(np.float32)
    bj = jbxdf.bsdf_sample(mpj, jnp.asarray(wo), *(jnp.asarray(x) for x in u))
    bt = tbxdf.bsdf_sample(mpt, _t(wo), *(_t(x) for x in u))
    # the cosine warp goes through sin/cos: the two libraries may differ by
    # an ulp there, so sampled directions (unit vectors) agree to 2e-6
    _close(bt.wi, bj.wi, rtol=1e-5, atol=2e-6)
    _close(bt.f, bj.f, rtol=1e-5, atol=2e-6)
    _close(bt.pdf, bj.pdf, rtol=1e-5, atol=2e-6)
    np.testing.assert_array_equal(bt.is_specular.numpy(), np.asarray(bj.is_specular))
    np.testing.assert_array_equal(bt.is_transmission.numpy(), np.asarray(bj.is_transmission))
    assert (bt.pdf.numpy() > 0).sum() > n // 2


def _light_tables(rng):
    """Two area-light triangles and one point light, plus a spatial
    distribution over a 2^3 voxel grid."""
    tri_v = np.zeros((3, 3, 3), np.float32)
    tri_v[0] = [[-1, 2.98, -1], [1, 2.98, -1], [1, 2.98, 1]]
    tri_v[1] = [[-1, 2.98, -1], [1, 2.98, 1], [-1, 2.98, 1]]
    lt = {
        "type": np.array([3, 3, 0], np.int32),
        "p": np.array([[0, 0, 0], [0, 0, 0], [2.5, 2, -2.5]], np.float32),
        "L": np.array([[18, 17, 15], [18, 17, 15], [4, 4, 5]], np.float32),
        "dir": np.zeros((3, 3), np.float32),
        "cos0": np.zeros(3, np.float32), "cos1": np.zeros(3, np.float32),
        "tri": np.array([0, 1, -1], np.int32),
        "twosided": np.array([0, 1, 0], np.int32),
        "area": np.array([2.0, 2.0, 0.0], np.float32),
        "w2l": np.tile(np.eye(3, dtype=np.float32).reshape(1, 9), (3, 1)),
        "img": np.tile(np.array([[-1, 0, 0]], np.int32), (3, 1)),
        "tri_v": tri_v,
    }
    imp = rng.uniform(0.05, 1.0, (8, 3))
    imp /= imp.sum(-1, keepdims=True)
    cdf = np.cumsum(imp, -1).astype(np.float32)
    cdf[:, -1] = 1.0
    sd = dict(cdf=cdf, mean_pmf=imp.mean(0).astype(np.float32),
              lo=np.array([-3, -1, -3], np.float32),
              inv_cs=np.array([1 / 3.0, 1 / 2.0, 1 / 3.0], np.float32), res=(2, 2, 2))
    jdev = {"light": {k: jnp.asarray(v) for k, v in lt.items()},
            "world_radius": jnp.float32(8.0)}
    tdev = {"light": {k: _t(v) for k, v in lt.items()}}
    jsd = jld.SpatialLightDistribution(
        **{k: (jnp.asarray(v) if k != "res" else v) for k, v in sd.items()})
    tsd = tld.SpatialLightDistribution(
        **{k: (_t(v) if k != "res" else v) for k, v in sd.items()})
    return jdev, tdev, jsd, tsd


@rounded_apart
def test_sample_one_light_spatial():
    _check_sample_one_light_spatial(jld)


def test_sample_one_light_spatial_contracted():
    """The port's default rounding against the reference compiled at the
    renders' optimisation level, with the same bounds."""
    _check_sample_one_light_spatial(JitRef(jld))


def _check_sample_one_light_spatial(jld):
    rng = np.random.default_rng(4)
    jdev, tdev, jsd, tsd = _light_tables(rng)
    n = 3000
    p = rng.uniform([-3, -1, -3], [3, 3, 3], (n, 3)).astype(np.float32)
    u = rng.uniform(0, 1, (3, n)).astype(np.float32)
    lj = jld.sample_one_light(jdev, jsd, jnp.asarray(p), *(jnp.asarray(x) for x in u))
    lt = tld.sample_one_light(tdev, tsd, _t(p), *(_t(x) for x in u))
    np.testing.assert_array_equal(lt.li_idx.numpy(), np.asarray(lj.li_idx))
    np.testing.assert_array_equal(lt.is_delta.numpy(), np.asarray(lj.is_delta))
    for a, b in ((lt.li, lj.li), (lt.wi, lj.wi), (lt.pdf, lj.pdf), (lt.dist, lj.dist)):
        _close(a, b)
    # emission and its MIS pdf at points on the lights
    hit_p = p[:, [0, 1, 2]].copy()
    hit_p[:, 1] = 2.98
    light = rng.integers(-1, 3, n).astype(np.int32)
    n_g, wo = _dirs(rng, n), _dirs(rng, n)
    _close(tld.emitted_radiance(tdev, _t(light), _t(wo), _t(n_g)),
           jld.emitted_radiance(jdev, jnp.asarray(light), jnp.asarray(wo), jnp.asarray(n_g)))
    _close(tld.emitted_pdf(tdev, tsd, _t(p), _t(hit_p), _t(light), _t(n_g)),
           jld.emitted_pdf(jdev, jsd, jnp.asarray(p), jnp.asarray(hit_p), jnp.asarray(light),
                           jnp.asarray(n_g)))


def test_film_pixel_deposit_and_develop():
    rng = np.random.default_rng(6)
    n = 5000
    px = rng.integers(0, 16, n).astype(np.int32)
    py = rng.integers(0, 12, n).astype(np.int32)
    L = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    L[:7] = np.nan  # the NaN firewall zeroes these rows
    mask = rng.uniform(size=n) < 0.8
    wt = rng.uniform(0.5, 1.0, n).astype(np.float32)
    fj, ft = JFilm(resolution=(16, 12)), TFilm(resolution=(16, 12))
    sj = fj.add_samples_pixel(fj.init_state(), jnp.asarray(px), jnp.asarray(py),
                              jnp.asarray(L), jnp.asarray(mask), jnp.asarray(wt))
    st = ft.add_samples_pixel(ft.init_state(), _t(px), _t(py), _t(L), _t(mask), _t(wt))
    _close(st.rgb, sj.rgb, rtol=1e-5)
    np.testing.assert_array_equal(st.weight.numpy(), np.asarray(sj.weight))
    np.testing.assert_allclose(ft.develop(st), fj.develop(sj), rtol=1e-5)


def test_brute_feature_intersect():
    rng = np.random.default_rng(12)
    tris = (rng.uniform(-1, 1, (60, 1, 3)) + rng.uniform(-0.3, 0.3, (60, 3, 3))).astype(np.float32)
    center = tris.reshape(-1, 3).mean(0).astype(np.float32)
    feat = tmxu.tri_feature_weights(tris, center)
    np.testing.assert_array_equal(feat, jmxu.tri_feature_weights(tris, center))
    o = (rng.normal(size=(500, 3)) * 3).astype(np.float32)
    d = _dirs(rng, 500)
    d = (-o / np.linalg.norm(o, axis=-1, keepdims=True) + 0.2 * d).astype(np.float32)
    hj = jmxu.brute_feature_intersect(jnp.asarray(feat), jnp.asarray(center), 60,
                                      jnp.asarray(o), jnp.asarray(d), 1e30)
    ht = tmxu.brute_feature_intersect(_t(feat), _t(center), 60, _t(o), _t(d), 1e30)
    np.testing.assert_array_equal(ht.prim.numpy(), np.asarray(hj.prim))
    assert (ht.prim.numpy() >= 0).sum() > 100
    hit = ht.prim.numpy() >= 0
    # one (R, 16) x (16, 4T) product per side: the two product libraries may
    # round the 16-term sums differently, and the barycentric numerators
    # cancel at world scale, so t/b0/b1 agree to 1e-5 (relative and absolute), not to the bit
    for a, b in ((ht.t, hj.t), (ht.b0, hj.b0), (ht.b1, hj.b1)):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit], rtol=1e-5, atol=1e-5)
