"""The port's Disney BSDF (tpu_pbrt_torch/core/bxdf.py, disney.cpp's eight
lobes) against the JAX package's (tpu_pbrt/core/bxdf.py), on seeded numpy
inputs handed to both as separate copies, the reference's oracles of
tests/test_disney.py on the port alone, and the compiler's disney rows.

Covered:
- every disney function (`_sw`, `_gtr1_d`, `_smith_g_sep`,
  `_disney_weights`, `_disney_presence`, `_disney_trans_terms`,
  `_disney_f_pdf`, `_disney_sample_wi`) on 4,096 lanes for each of the
  reference's seven parameter sets, whose wo and wi cover both
  hemispheres: presence masks, lobe counts and the `bad` flags exactly;
  the weights and the evaluated f and pdf within EVAL_RTOL relative +
  2e-6 absolute on every lane (measured: 6.1e-7 relative where a value
  exceeds 1e-3, at most 0.03 of the bound); the sampled directions within
  SAMPLE_RTOL + SAMPLE_ATOL (measured: 9.7e-6 absolute, 0.27 of the
  bound, anisotropic);
- bsdf_eval / bsdf_sample through gather_mat on a table of disney rows
  beside a matte row (the dispatch, the zeroed pdf of a total internal
  reflection, the transmission flag by hemisphere): the flags exactly,
  eval and the sampled wi on every lane, the sampled f and pdf on
  STRICT_SHARE of the lanes and their ratio on every lane (see the test:
  measured: 1 of 512 clearcoat lanes off the strict bound, 1.2% apart);
- the oracles (tests/test_disney.py, at its tolerances): the pdf
  integrates to 1, the sampling estimator matches a sphere estimate,
  the white-base albedo stays below 1.35, metallic kills the diffuse
  floor, spectrans transmits. The sphere integrals take a Fibonacci
  lattice of N_SPHERE directions (a quadrature of the same integral the
  reference estimates with 400,000 random ones; the sampling estimator's
  largest error is under 7% of its bound), which keeps the file inside
  its time budget;
- lower_materials' disney columns, bit-equal to the reference's, and
  its scatterdistance warning.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tests.test_torch_bxdf import ATOL, _close, _dirs, _t
from tpu_pbrt.core import bxdf as jb
from tpu_pbrt_torch.core import bxdf as tb

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

N = 4096
EVAL_RTOL = 1e-5
SAMPLE_RTOL, SAMPLE_ATOL = 1e-3, 2e-5
#: the share of lanes whose sampled f and pdf meet the sample bound
STRICT_SHARE = 0.999
#: directions of the sphere quadratures of the oracles
N_SPHERE = 65536

#: the reference's parameter sets (tests/test_disney.py PARAM_SETS)
PARAM_SETS = [
    dict(),
    dict(metallic=0.9, rough=0.3),
    dict(clearcoat=1.0, rough=0.5),
    dict(sheen=1.0, rough=0.6),
    dict(aniso=0.8, rough=0.3, metallic=0.5),
    dict(strans=0.7, rough=0.25),
    dict(thin=True, flat=0.6, dtrans=0.8, rough=0.4),
]
_IDS = ["base", "metallic", "clearcoat", "sheen", "aniso", "strans", "thin"]


def _mp(mod, n, *, color=(0.6, 0.4, 0.3), rough=0.4, metallic=0.0, aniso=0.0, sheen=0.0,
        clearcoat=0.0, strans=0.0, thin=False, flat=0.0, dtrans=1.0, eta=1.5):
    """tests/test_disney.py's _disney_mp for either package (mod: a bxdf
    module), on fresh copies of the same numpy arrays."""
    T = jnp.asarray if mod is jb else _t
    one = np.ones(n, np.float32)
    one3 = np.ones((n, 3), np.float32)
    dz = mod.DisneyParams(
        metallic=T(one * metallic), spectint=T(one * 0.0), aniso=T(one * aniso),
        sheen=T(one * sheen), sheentint=T(one * 0.5), clearcoat=T(one * clearcoat),
        ccgloss=T(one * 1.0), strans=T(one * strans), flat=T(one * flat),
        dtrans=T(one * dtrans), thin=T(np.full(n, thin)), rough=T(one * rough),
    )
    return mod.MatParams(
        mtype=T(np.full(n, 9, np.int32)), kd=T(one3 * np.asarray(color, np.float32)),
        ks=T(one3 * 0), kr=T(one3 * 0), kt=T(one3 * 0), eta=T(one3 * eta), k=T(one3 * 0),
        ax=T(one * 0.1), ay=T(one * 0.1), sigma=T(one * 0), opacity=T(one3),
        rough_raw=T(one * rough), dz=dz,
    )


@pytest.mark.parametrize("ps", PARAM_SETS, ids=_IDS)
def test_disney_functions_match_reference(ps):
    rng = np.random.default_rng(17)
    wo, wi = _dirs(rng, N), _dirs(rng, N)
    u = rng.uniform(0, 1, (3, N)).astype(np.float32)
    mj, mt = _mp(jb, N, **ps), _mp(tb, N, **ps)
    for a, b in zip(tb._disney_weights(mt), jb._disney_weights(mj)):
        _close(a, b, rtol=EVAL_RTOL, atol=ATOL)
    (pr_t, n_t), (pr_j, n_j) = tb._disney_presence(mt), jb._disney_presence(mj)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    for a, b in zip(pr_t, pr_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    c = np.abs(wi[:, 2])
    _close(tb._sw(_t(c)), jb._sw(jnp.asarray(c)), rtol=EVAL_RTOL)
    _close(tb._gtr1_d(_t(c), _t(np.float32(0.05) + 0 * c)),
           jb._gtr1_d(jnp.asarray(c), jnp.asarray(np.float32(0.05) + 0 * c)), rtol=EVAL_RTOL)
    _close(tb._smith_g_sep(_t(c), 0.25), jb._smith_g_sep(jnp.asarray(c), 0.25), rtol=EVAL_RTOL)

    ft, pt = tb._disney_f_pdf(mt, _t(wo), _t(wi))
    fj, pj = jb._disney_f_pdf(mj, jnp.asarray(wo), jnp.asarray(wi))
    _close(ft, fj, rtol=EVAL_RTOL, atol=ATOL)
    _close(pt, pj, rtol=EVAL_RTOL, atol=ATOL)
    assert (ft.numpy().max(-1) > 0).mean() > 0.2

    wst, bt = tb._disney_sample_wi(mt, _t(wo), *map(_t, u))
    wsj, bj = jb._disney_sample_wi(mj, jnp.asarray(wo), *map(jnp.asarray, u))
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    _close(wst, wsj, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)

    # the transmission lobe at the sampled half-vector of its own distribution
    e = mt.eta[:, 0]
    T6 = mt.dz.strans[:, None] * torch.sqrt(mt.kd)
    w = tb._disney_weights(mt)
    wh = tb.tr_sample_wh(_t(wo), _t(u[1]), _t(u[2]), w[8], w[9])
    got = tb._disney_trans_terms(T6, e, w[8], w[9], _t(wo), _t(wi), wh)
    wj = jb._disney_weights(mj)
    want = jb._disney_trans_terms(
        mj.dz.strans[:, None] * jnp.sqrt(mj.kd), mj.eta[:, 0], wj[8], wj[9], jnp.asarray(wo),
        jnp.asarray(wi), jnp.asarray(wh.numpy().copy()))
    for a, b in zip(got[:2], want[:2]):
        _close(a, b, rtol=EVAL_RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def _table(rows):
    """A material table of matte (0) and disney rows with their columns."""
    n = len(rows)
    tab = {
        "type": np.array([9 if r else 1 for r in rows], np.int32),
        "kd": np.tile(np.array([0.6, 0.4, 0.3], np.float32), (n, 1)),
        "ks": np.zeros((n, 3), np.float32), "kr": np.zeros((n, 3), np.float32),
        "kt": np.zeros((n, 3), np.float32), "eta": np.full((n, 3), 1.5, np.float32),
        "k": np.zeros((n, 3), np.float32),
        "rough_u": np.array([r.get("rough", 0.4) if r else 0.0 for r in rows], np.float32),
        "rough_v": np.array([r.get("rough", 0.4) if r else 0.0 for r in rows], np.float32),
        "sigma": np.zeros(n, np.float32), "opacity": np.ones((n, 3), np.float32),
        "remap": np.array([0 if r else 1 for r in rows], np.int32),
    }
    dflt = dict(metallic=0.0, spectint=0.0, aniso=0.0, sheen=0.0, sheentint=0.5,
                clearcoat=0.0, ccgloss=1.0, strans=0.0, flat=0.0, dtrans=1.0)
    for k, v in dflt.items():
        tab[f"d_{k}"] = np.array([(r or {}).get(k, v) for r in rows], np.float32)
    tab["d_thin"] = np.array([int(bool((r or {}).get("thin", False))) for r in rows], np.int32)
    return tab


def test_bsdf_dispatch_matches_reference():
    """bsdf_eval / bsdf_sample through gather_mat on the seven disney rows
    and a matte row, N / 8 lanes each (N in all: the shapes the JAX side
    compiled its eager operations for above)."""
    rows = [None] + [dict(ps, rough=ps.get("rough", 0.4)) for ps in PARAM_SETS]
    tab = _table(rows)
    rng = np.random.default_rng(5)
    n = N
    mid = np.repeat(np.arange(len(rows), dtype=np.int32), N // len(rows))
    wo, wi = _dirs(rng, n), _dirs(rng, n)
    u = rng.uniform(0, 1, (3, n)).astype(np.float32)
    mpj = jb.gather_mat({k: jnp.asarray(v) for k, v in tab.items()}, jnp.asarray(mid))
    mpt = tb.gather_mat({k: _t(v) for k, v in tab.items()}, _t(mid))
    assert mpt.dz is not None and mpt.hz is None
    (fj, pj), sj = jb.bsdf_eval(mpj, jnp.asarray(wo), jnp.asarray(wi)), jb.bsdf_sample(
        mpj, jnp.asarray(wo), *map(jnp.asarray, u))
    (ft, pt), st = tb.bsdf_eval(mpt, _t(wo), _t(wi)), tb.bsdf_sample(mpt, _t(wo), *map(_t, u))
    _close(ft, fj, rtol=EVAL_RTOL, atol=ATOL)
    _close(pt, pj, rtol=EVAL_RTOL, atol=ATOL)
    for a, b in (("is_specular", "is_specular"), ("is_transmission", "is_transmission")):
        np.testing.assert_array_equal(getattr(st, a).numpy(), np.asarray(getattr(sj, b)))
    np.testing.assert_array_equal(st.pdf.numpy() > 0, np.asarray(sj.pdf) > 0)
    _close(st.wi, sj.wi, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)
    # f and pdf on STRICT_SHARE of the lanes: at the peak of the clearcoat's
    # GTR1 (alpha 0.001) D is conditioned by 1 / (1 - cos^2) ~ 1e6, and an
    # ulp of the half-vector moves it by percents (measured: 1 of 512
    # clearcoat lanes, 1.2% apart; 3 of 4,096 at 2.9% on a wider run); the
    # sample's weight f / pdf, where D cancels, on every lane
    for a, b in ((st.f, sj.f), (st.pdf, sj.pdf)):
        a, b = a.numpy().reshape(n, -1), np.asarray(b).reshape(n, -1)
        ok = (np.abs(a - b) <= SAMPLE_ATOL + SAMPLE_RTOL * np.abs(b)).all(-1)
        assert ok.mean() >= STRICT_SHARE, ok.mean()
    live = np.asarray(sj.pdf) > 0
    wt = st.f.numpy()[live] / st.pdf.numpy()[live][:, None]
    wj = np.asarray(sj.f)[live] / np.asarray(sj.pdf)[live][:, None]
    np.testing.assert_allclose(wt, wj, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)
    # spec-trans rows transmit through the sampler, the matte row never
    strans = mid == 1 + _IDS.index("strans")
    assert st.is_transmission.numpy()[strans].mean() > 0.1
    assert not st.is_transmission.numpy()[mid == 0].any()


def _fib_sphere(n):
    """n directions of a Fibonacci lattice on the unit sphere (f32)."""
    k = np.arange(n) + 0.5
    z = 1.0 - 2.0 * k / n
    r = np.sqrt(np.maximum(0.0, 1.0 - z * z))
    phi = k * np.pi * (3.0 - np.sqrt(5.0))
    return torch.from_numpy(np.stack([r * np.cos(phi), r * np.sin(phi), z], -1).astype(np.float32))


def _wo(n, v):
    v = np.asarray(v, np.float64) / np.linalg.norm(v)
    return torch.from_numpy(np.broadcast_to(v.astype(np.float32), (n, 3)).copy())


def test_pdf_normalizes_over_sphere():
    wi = _fib_sphere(N_SPHERE)
    wo = _wo(N_SPHERE, [0.3, -0.2, 0.93])
    for ps in PARAM_SETS:
        _, pdf = tb._disney_f_pdf(_mp(tb, N_SPHERE, **ps), wo, wi)
        est = float(pdf.double().mean()) * 4.0 * np.pi
        assert abs(est - 1.0) < 0.06, f"{ps}: int pdf = {est}"


def test_sample_eval_consistency():
    """E[f |cos| / pdf] over sampled wi matches the sphere estimate of
    int f |cos| dwi, per channel (tests/test_disney.py's bound)."""
    n = N_SPHERE
    rng = np.random.default_rng(3)
    wo = _wo(n, [0.2, 0.1, 0.97])
    wi_u = _fib_sphere(n)
    for ps in PARAM_SETS:
        mp = _mp(tb, n, **ps)
        u_l, u1, u2 = (_t(rng.uniform(size=n).astype(np.float32)) for _ in range(3))
        wi_s, bad = tb._disney_sample_wi(mp, wo, u_l, u1, u2)
        f_s, pdf_s = tb._disney_f_pdf(mp, wo, wi_s)
        ok = ((pdf_s > 1e-9) & ~bad)[:, None]
        w = torch.where(ok, f_s * torch.abs(wi_s[:, 2:3]) / torch.clamp(pdf_s, min=1e-9)[:, None],
                        0.0)
        est_s = w.double().mean(0).numpy()
        f_u, _ = tb._disney_f_pdf(mp, wo, wi_u)
        est_u = (f_u * torch.abs(wi_u[:, 2:3])).double().mean(0).numpy() * 4.0 * np.pi
        assert np.all(np.abs(est_s - est_u) < 0.04 + 0.1 * est_u), (
            f"{ps}: sampled {est_s} vs sphere {est_u}")


def test_energy_bounded():
    wi = _fib_sphere(N_SPHERE)
    wo = _wo(N_SPHERE, [0.0, 0.0, 1.0])
    for ps in PARAM_SETS:
        f, _ = tb._disney_f_pdf(_mp(tb, N_SPHERE, color=(1.0, 1.0, 1.0), **ps), wo, wi)
        est = float((f.amax(-1) * torch.abs(wi[:, 2])).double().mean()) * 4.0 * np.pi
        assert est < 1.35, f"{ps}: albedo {est}"


def test_metallic_kills_diffuse():
    n = 4096
    wo = _wo(n, [0.0, 0.0, 1.0])
    wi = torch.from_numpy(_dirs(np.random.default_rng(5), n))
    wi[:, 2] = torch.abs(wi[:, 2])
    f_m, _ = tb._disney_f_pdf(_mp(tb, n, metallic=1.0, rough=0.4), wo, wi)
    f_d, _ = tb._disney_f_pdf(_mp(tb, n, metallic=0.0, rough=0.4), wo, wi)
    off_peak = wi[:, 2] < 0.7
    assert float(torch.where(off_peak, f_m[:, 0], 0.0).mean()) < 0.25 * float(
        torch.where(off_peak, f_d[:, 0], 0.0).mean())


def test_spectrans_transmits():
    n = 65536
    wo = _wo(n, [0.0, 0.0, 1.0])
    wi = _fib_sphere(n)
    f, _ = tb._disney_f_pdf(_mp(tb, n, strans=0.9, rough=0.3), wo, wi)
    below = wi[:, 2] < -0.05
    assert float(torch.where(below, f[:, 0], 0.0).sum()) > 0.0


_DISNEY_TEXT = """
Film "image" "integer xresolution" [4] "integer yresolution" [4]
Camera "perspective"
WorldBegin
LightSource "point" "rgb I" [1 1 1] "point from" [0 0 -2]
Material "disney" "rgb color" [0.7 0.3 0.2] "float metallic" [0.4] "float roughness" [0.35]
  "float clearcoat" [0.8] "float sheen" [0.5] "float anisotropic" [0.3] "float eta" [1.4]
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [-1 -1 0  1 -1 0  0 1 0]
Material "disney" "float spectrans" [0.6] "bool thin" "true" "float flatness" [0.2]
  "float difftrans" [0.7] "float speculartint" [0.3] "float sheentint" [0.2]
  "float clearcoatgloss" [0.4] "rgb scatterdistance" [0.1 0.2 0.3]
Shape "trianglemesh" "integer indices" [0 1 2] "point P" [-1 -1 1  1 -1 1  0 1 1]
"""


def test_lowered_columns_equal_reference(monkeypatch):
    """Two disney materials (every parameter, thin, a scatterdistance)
    lowered by both compilers: every column bit-equal, and the port warns
    about the scatterdistance as the reference does."""
    from tpu_pbrt.scene.api import Options, parse_string as jparse, pbrt_init as jinit
    from tpu_pbrt.scene.compiler import compile_scene as jcompile
    from tpu_pbrt_torch import parse_string
    from tpu_pbrt_torch.scene import compiler
    from tpu_pbrt_torch.scene.compiler import compile_scene

    warned = []
    monkeypatch.setattr(compiler, "Warning", warned.append)
    st = compile_scene(parse_string(_DISNEY_TEXT, device="cpu"), device="cpu")
    assert any("scatterdistance" in w for w in warned), warned
    sj = jcompile(jparse(_DISNEY_TEXT, jinit(Options(quiet=True))))
    for k in tb.MAT_COLUMNS + tb.DISNEY_COLUMNS:
        a, b = st.dev["mat"][k].numpy(), np.asarray(sj.dev["mat"][k])
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a.view(np.uint32) if a.dtype == np.float32 else a,
                                      b.view(np.uint32) if b.dtype == np.float32 else b, err_msg=k)
    assert "h_beta_m" not in st.dev["mat"] and "tri_tanT" not in st.dev
    assert st.dev["mat"]["d_thin"].tolist()[-2:] == [0, 1]
