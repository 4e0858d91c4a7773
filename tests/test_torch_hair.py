"""The port's hair BSDF (tpu_pbrt_torch/core/bxdf.py, Chiang et al.'s
HairBSDF of hair.cpp) against the JAX package's (tpu_pbrt/core/bxdf.py),
on seeded numpy inputs handed to both as separate copies, the oracles of
tests/test_hair.py (pbrt's own src/tests/hair.cpp) on the port alone,
the compiler's hair rows and the hair shading frame.

Covered:
- every hair function (`_i0`, `_log_i0`, `_mp`, the logistic, its CDF,
  the trimmed logistic and its sampler, `_hair_phi_p`, `_wrap_pi`,
  `_hair_setup`, `_hair_f_pdf`, `_hair_sample_wi`) on 4,096 lanes of
  seeded parameters (beta_m, beta_n in [0.1, 0.9], alpha in [0, 4]
  degrees, h in (-1, 1), sigma_a in [0, 3]) and directions over the whole
  sphere: f and pdf within EVAL_RTOL relative + 2e-6 absolute on every
  lane (measured: 3.3e-5 relative where a value exceeds 1e-3, 0.94 of the
  bound: XLA's exp, log, asin, atan2 and sinh round an ulp or two apart
  from torch's, and the Mp lobe of a small beta_m amplifies that), the
  sampled directions within SAMPLE_RTOL + SAMPLE_ATOL (measured: 5.8e-5
  absolute, 0.23 of the bound: an ulp of the longitudinal cosine near 1
  moves sqrt(1 - cos^2) by far more; most lanes are bit-equal);
- `_hair_sigma_a_from_reflectance` and the three ways the compiler
  resolves sigma_a (`sigma_a`, `color`, `eumelanin`/`pheomelanin`), with
  every hair column, bit-equal to the reference's lowering;
- the oracles at tests/test_hair.py's tolerances: the white furnace
  (sigma_a = 0 conserves energy), the pdf integrates to 1, the sampling
  estimator matches a sphere estimate, absorption darkens. The sphere
  integrals take a Fibonacci lattice of N_SPHERE directions (a
  quadrature of the same integral the reference estimates with 500,000
  random ones), which keeps the file inside its time budget;
- tri_tanT of a curve scene bit-equal to the reference's, and
  make_interaction's shading frame and textured_mat's h = -1 + 2v on its
  camera hits against the reference's.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tests.test_torch_bxdf import ATOL, _close, _dirs, _t
from tpu_pbrt.core import bxdf as jb
from tpu_pbrt_torch.core import bxdf as tb

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

N = 4096
EVAL_RTOL = 2e-5
SAMPLE_RTOL, SAMPLE_ATOL = 1e-3, 2e-5
N_SPHERE = 65536


def _hair_mp(mod, n, *, sigma_a=(0.0, 0.0, 0.0), beta_m=0.3, beta_n=0.3, alpha=0.0, eta=1.55,
             h=0.0):
    """tests/test_hair.py's _hair_mp for either package; each parameter
    a scalar or an (n,) / (n, 3) array."""
    T = jnp.asarray if mod is jb else _t
    one = np.ones(n, np.float32)
    one3 = np.ones((n, 3), np.float32)
    f1 = lambda v: (one * np.asarray(v, np.float32)).astype(np.float32)  # noqa: E731
    hz = mod.HairParams(
        sigma_a=T((one3 * np.asarray(sigma_a, np.float32)).astype(np.float32)),
        beta_m=T(f1(beta_m)), beta_n=T(f1(beta_n)), alpha=T(f1(alpha)), h=T(f1(h)),
    )
    return mod.MatParams(
        mtype=T(np.full(n, 10, np.int32)), kd=T(one3 * 0.5), ks=T(one3 * 0), kr=T(one3 * 0),
        kt=T(one3 * 0), eta=T(one3 * eta), k=T(one3 * 0), ax=T(one * 0.1), ay=T(one * 0.1),
        sigma=T(one * 0), opacity=T(one3), rough_raw=T(one * 0.3), hz=hz,
    )


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(31)
    p = dict(
        sigma_a=rng.uniform(0, 3, (N, 3)).astype(np.float32),
        beta_m=rng.uniform(0.1, 0.9, N).astype(np.float32),
        beta_n=rng.uniform(0.1, 0.9, N).astype(np.float32),
        alpha=rng.uniform(0, 4, N).astype(np.float32),
        h=rng.uniform(-0.999, 0.999, N).astype(np.float32),
    )
    return p, _dirs(rng, N), _dirs(rng, N), rng.uniform(0, 1, (3, N)).astype(np.float32)


def test_scalar_functions_match_reference():
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.uniform(0, 12, 2048), rng.uniform(12, 60, 2048)]).astype(np.float32)
    _close(tb._i0(_t(x[:2048])), jb._i0(jnp.asarray(x[:2048])), rtol=EVAL_RTOL)
    _close(tb._log_i0(_t(x)), jb._log_i0(jnp.asarray(x)), rtol=EVAL_RTOL)
    s = rng.uniform(0.05, 1.5, 4096).astype(np.float32)
    phi = rng.uniform(-8, 8, 4096).astype(np.float32)
    u = rng.uniform(0, 1, 4096).astype(np.float32)
    _close(tb._logistic(_t(phi), _t(s)), jb._logistic(jnp.asarray(phi), jnp.asarray(s)),
           rtol=EVAL_RTOL)
    _close(tb._logistic_cdf(_t(phi), _t(s)), jb._logistic_cdf(jnp.asarray(phi), jnp.asarray(s)),
           rtol=EVAL_RTOL)
    _close(tb._trimmed_logistic(_t(phi), _t(s)),
           jb._trimmed_logistic(jnp.asarray(phi), jnp.asarray(s)), rtol=EVAL_RTOL)
    _close(tb._sample_trimmed_logistic(_t(u), _t(s)),
           jb._sample_trimmed_logistic(jnp.asarray(u), jnp.asarray(s)),
           rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)
    _close(tb._wrap_pi(_t(phi)), jb._wrap_pi(jnp.asarray(phi)), rtol=EVAL_RTOL)
    g_o, g_t = (rng.uniform(-1.5, 1.5, 4096).astype(np.float32) for _ in range(2))
    for p in range(4):
        _close(tb._hair_phi_p(p, _t(g_o), _t(g_t)),
               jb._hair_phi_p(p, jnp.asarray(g_o), jnp.asarray(g_t)), rtol=EVAL_RTOL)
    ct, co, st, so = (rng.uniform(-1, 1, 4096).astype(np.float32) for _ in range(4))
    v = rng.uniform(0.005, 0.9, 4096).astype(np.float32)
    args = (np.abs(ct), np.abs(co), st, so, v)
    _close(tb._mp(*map(_t, args)), jb._mp(*map(jnp.asarray, args)), rtol=EVAL_RTOL, atol=ATOL)


def test_hair_bsdf_matches_reference(lanes):
    p, wo, wi, u = lanes
    mt, mj = _hair_mp(tb, N, **p), _hair_mp(jb, N, **p)
    got = tb._hair_setup(mt, _t(wo))
    want = jb._hair_setup(mj, jnp.asarray(wo))
    flat_t = [got[0], got[1], *got[2], got[3], got[4], got[5], got[6], got[7], *got[8],
              *got[9], *(x for t in got[10] for x in t)]
    flat_j = [want[0], want[1], *want[2], want[3], want[4], want[5], want[6], want[7], *want[8],
              *want[9], *(x for t in want[10] for x in t)]
    for a, b in zip(flat_t, flat_j):
        _close(a, b, rtol=EVAL_RTOL, atol=ATOL)
    ft, pt = tb._hair_f_pdf(mt, _t(wo), _t(wi))
    fj, pj = jb._hair_f_pdf(mj, jnp.asarray(wo), jnp.asarray(wi))
    _close(ft, fj, rtol=EVAL_RTOL, atol=ATOL)
    _close(pt, pj, rtol=EVAL_RTOL, atol=ATOL)
    assert (pt.numpy() > 0).mean() > 0.9
    wst = tb._hair_sample_wi(mt, _t(wo), *map(_t, u))
    wsj = jb._hair_sample_wi(mj, jnp.asarray(wo), *map(jnp.asarray, u))
    _close(wst, wsj, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)
    # through the public dispatch: eval overrides, sampling draws from the
    # hair lobes and flags no transmission
    (fe, pe), bs = tb.bsdf_eval(mt, _t(wo), _t(wi)), tb.bsdf_sample(mt, _t(wo), *map(_t, u))
    assert torch.equal(fe, ft) and torch.equal(pe, pt)
    assert torch.equal(bs.wi, wst) and not bs.is_transmission.any()


def _fib_sphere(n):
    k = np.arange(n) + 0.5
    z = 1.0 - 2.0 * k / n
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    phi = k * np.pi * (3.0 - np.sqrt(5.0))
    return torch.from_numpy(np.stack([r * np.cos(phi), r * np.sin(phi), z], -1).astype(np.float32))


def _wo(n, v=(0.3, 0.4, 0.87)):
    v = np.asarray(v, np.float64) / np.linalg.norm(v)
    return torch.from_numpy(np.broadcast_to(v.astype(np.float32), (n, 3)).copy())


def test_white_furnace():
    """sigma_a = 0: int f |cos| dwi = 1 at any roughness and offset."""
    n = N_SPHERE
    wi = _fib_sphere(n)
    for bm, bn in ((0.2, 0.4), (0.4, 0.2), (0.6, 0.6), (0.9, 0.9)):
        for h in (-0.6, 0.0, 0.7):
            f, _ = tb._hair_f_pdf(_hair_mp(tb, n, beta_m=bm, beta_n=bn, h=h), _wo(n), wi)
            est = float((f[:, 0] * torch.abs(wi[:, 2])).double().mean()) * 4.0 * np.pi
            assert abs(est - 1.0) < 0.05, f"bm={bm} bn={bn} h={h}: {est}"


def test_pdf_normalizes():
    n = N_SPHERE
    wi = _fib_sphere(n)
    for bm, bn in ((0.3, 0.3), (0.8, 0.4)):
        mp = _hair_mp(tb, n, sigma_a=(0.5, 1.0, 2.0), beta_m=bm, beta_n=bn, h=0.3, alpha=2.0)
        _, pdf = tb._hair_f_pdf(mp, _wo(n), wi)
        est = float(pdf.double().mean()) * 4.0 * np.pi
        assert abs(est - 1.0) < 0.05, f"bm={bm} bn={bn}: int pdf = {est}"


def test_sample_eval_consistency():
    n = 2 * N_SPHERE
    rng = np.random.default_rng(3)
    wo = _wo(n)
    mp = _hair_mp(tb, n, sigma_a=(0.3, 0.6, 1.2), beta_m=0.4, beta_n=0.35, h=0.25, alpha=2.0)
    u_l, u1, u2 = (_t(rng.uniform(size=n).astype(np.float32)) for _ in range(3))
    wi_s = tb._hair_sample_wi(mp, wo, u_l, u1, u2)
    f_s, pdf_s = tb._hair_f_pdf(mp, wo, wi_s)
    w = torch.where((pdf_s > 1e-8)[:, None],
                    f_s * torch.abs(wi_s[:, 2:3]) / torch.clamp(pdf_s, min=1e-8)[:, None], 0.0)
    est_s = w.double().mean(0).numpy()
    wi_u = _fib_sphere(n)
    f_u, _ = tb._hair_f_pdf(mp, wo, wi_u)
    est_u = (f_u * torch.abs(wi_u[:, 2:3])).double().mean(0).numpy() * 4.0 * np.pi
    assert np.all(np.abs(est_s - est_u) < 0.05 + 0.12 * est_u), (est_s, est_u)


def test_absorption_darkens():
    n = N_SPHERE
    wi = _fib_sphere(n)
    f_w, _ = tb._hair_f_pdf(_hair_mp(tb, n), _wo(n), wi)
    f_d, _ = tb._hair_f_pdf(_hair_mp(tb, n, sigma_a=(2.0, 2.0, 2.0)), _wo(n), wi)
    a_w = float((f_w[:, 0] * torch.abs(wi[:, 2])).double().mean()) * 4 * np.pi
    a_d = float((f_d[:, 0] * torch.abs(wi[:, 2])).double().mean()) * 4 * np.pi
    assert a_d < 0.6 * a_w


_HAIR_TEXT = """
Film "image" "integer xresolution" [12] "integer yresolution" [12]
LookAt 0 0.5 3  0 0.5 0  0 1 0
Camera "perspective" "float fov" [35]
WorldBegin
LightSource "point" "rgb I" [4 4 4] "point from" [0 2 2]
Material "hair" "rgb sigma_a" [0.2 0.5 1.1] "float beta_m" [0.25] "float alpha" [3]
Shape "curve" "point P" [-0.6 0 0  -0.2 1.2 0  0.2 -0.2 0  0.6 1 0] "float width0" [0.4] "float width1" [0.3]
Material "hair" "rgb color" [0.6 0.4 0.2] "float beta_n" [0.5] "float eta" [1.6]
Shape "curve" "point P" [-0.6 0.4 -0.2  -0.2 1.6 -0.2  0.2 0.2 -0.2  0.6 1.4 -0.2] "float width0" [0.3]
Material "hair" "float eumelanin" [0.8] "float pheomelanin" [0.4]
Shape "curve" "point P" [-0.6 -0.4 0.2  -0.2 0.8 0.2  0.2 -0.6 0.2  0.6 0.6 0.2] "float width0" [0.3]
Material "hair"
Shape "curve" "point P" [-0.6 0.8 0.3  -0.2 2 0.3  0.2 0.6 0.3  0.6 1.8 0.3] "float width0" [0.2]
"""


@pytest.fixture(scope="module")
def compiled():
    from tpu_pbrt.scene.api import Options, parse_string as jparse, pbrt_init as jinit
    from tpu_pbrt.scene.compiler import compile_scene as jcompile
    from tpu_pbrt_torch import parse_string
    from tpu_pbrt_torch.scene.compiler import compile_scene

    st = compile_scene(parse_string(_HAIR_TEXT, device="cpu"), device="cpu")
    sj = jcompile(jparse(_HAIR_TEXT, jinit(Options(quiet=True))))
    return st, sj


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def test_sigma_a_branches_and_columns_equal_reference(compiled):
    from tpu_pbrt.scene.compiler import _hair_sigma_a_from_reflectance as jref
    from tpu_pbrt_torch.scene.compiler import _hair_sigma_a_from_reflectance as tref

    c = np.random.default_rng(4).uniform(0, 1, (64, 3))
    for bn in (0.1, 0.3, 0.77):
        np.testing.assert_array_equal(tref(c, bn), jref(c, bn))
    st, sj = compiled
    for k in tb.MAT_COLUMNS + tb.HAIR_COLUMNS:
        np.testing.assert_array_equal(_bits(st.dev["mat"][k].numpy()),
                                      _bits(np.asarray(sj.dev["mat"][k])), err_msg=k)
    sa = st.dev["mat"]["h_sigma_a"].numpy()
    assert "d_metallic" not in st.dev["mat"]
    # the four rows: explicit, from a colour, from melanin, the default melanin
    np.testing.assert_array_equal(sa[0], np.float32([0.2, 0.5, 1.1]))
    np.testing.assert_allclose(sa[2], 0.8 * np.array([0.419, 0.697, 1.37])
                               + 0.4 * np.array([0.187, 0.4, 1.05]), rtol=1e-6)
    np.testing.assert_allclose(sa[3], 1.3 * np.array([0.419, 0.697, 1.37]), rtol=1e-6)


def test_shading_frame_and_h_match_reference(compiled):
    """tri_tanT bit-equal; on the camera hits of the curve scene, the port's
    shading frame (make_interaction: ss along dpdu) and the h offset
    (textured_mat) against the reference's on the same hits."""
    from tpu_pbrt.integrators.common import make_interaction as jmi, textured_mat as jtm
    from tpu_pbrt.accel.traverse import Hit as JHit
    from tpu_pbrt_torch.cameras import generate_rays
    from tpu_pbrt_torch.integrators.common import make_interaction, scene_intersect, textured_mat

    st, sj = compiled
    np.testing.assert_array_equal(_bits(st.dev["tri_tanT"].numpy()),
                                  _bits(np.asarray(sj.dev["tri_tanT"])))
    iy, ix = np.mgrid[0:12, 0:12]
    pf = np.stack([ix.ravel() + 0.5, iy.ravel() + 0.5], -1).astype(np.float32)
    o, d, _ = generate_rays(st.camera, torch.from_numpy(pf), torch.zeros(144, 2))
    hit = scene_intersect(st.dev, o, d, float("inf"))
    it = make_interaction(st.dev, hit, o, d)
    valid = it.valid.numpy()
    assert valid.mean() > 0.3
    jh = JHit(*(None if x is None else jnp.asarray(x.numpy().copy()) for x in hit))
    # one compiled program instead of ~60 eagerly compiled operations
    tabs = {k: sj.dev[k] for k in ("tri_verts", "tri_sh16", "tri_tanT")}
    fields = ("ns", "ss", "ts", "uv", "mat", "p")
    jit = dict(zip(fields, jax.jit(lambda *a: tuple(getattr(jmi(*a), f) for f in fields))(
        tabs, jh, jnp.asarray(o.numpy().copy()), jnp.asarray(d.numpy().copy()))))
    for name in ("ns", "ss", "ts", "uv"):
        _close(getattr(it, name).numpy()[valid], np.asarray(jit[name])[valid],
               rtol=1e-5, atol=ATOL)
    mp = textured_mat(st.dev, it.mat, it.uv, it.p, None, frozenset())
    mpj = jtm(sj.dev, jit["mat"], jit["uv"], jit["p"], None, frozenset())
    _close(mp.hz.h, mpj.hz.h, rtol=1e-5, atol=ATOL)
    h = mp.hz.h.numpy()[valid]
    assert h.min() < -0.5 and h.max() > 0.5
