"""The port's layered materials (tpu_pbrt_torch/core/bxdf.py: uber,
substrate, translucent, the mix resolution and the Beckmann
distribution) against the JAX package's (tpu_pbrt/core/bxdf.py), on
seeded numpy inputs handed to both as separate copies, and the
reference's own oracles on the port alone.

Covered:
- bsdf_eval / bsdf_sample for uber, substrate (isotropic and
  anisotropic, remapped and raw roughness) and translucent on 4,096
  lanes each whose wo covers both hemispheres; the booleans (specular,
  transmission, pdf > 0) exactly, f and pdf of bsdf_eval within
  EVAL_RTOL relative + 2e-6 absolute on every lane (measured: at most
  9.1e-7 relative where the value exceeds 1e-3), the sampled wi, f and
  pdf within SAMPLE_RTOL relative + SAMPLE_ATOL absolute on every lane
  (measured: 7.8e-5 relative, on the raw 0.05-alpha substrate whose
  sampled f reaches 1e2, and 9.7e-6 absolute on a wi component: the
  warps' sin/cos and the VNDF slopes may round an ulp apart between the
  two libraries, and a sharp lobe amplifies that);
- resolve_mix: the resolved ids exactly equal, on a table with a nested
  mix (a mix of a mix), at 65,536 draws;
- the Beckmann D, Lambda, G, sample_wh and pdf against the reference
  (D, Lambda, G within 1e-5 relative + 2e-6; the sample's log/atan/tan
  chain and its pdf within SAMPLE_RTOL + SAMPLE_ATOL), and tests/test_bxdf_rough.py's
  oracles on the port: the normalization of D cos and the sampled
  half-vectors' moments against a uniform-hemisphere estimate;
- tests/test_mix.py's oracle on the port: a mix of two mattes renders
  the same image mean as the matte of the blended Kd (Lambertian f is
  linear in Kd).
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
#: bsdf_eval's relative bound (+ ATOL) on every lane
EVAL_RTOL = 1e-6
#: the bound on sampled values (wi, f, pdf) on every lane
SAMPLE_RTOL, SAMPLE_ATOL = 1e-4, 2e-5

#: name -> (type, kd, ks, kr, kt, eta, rough_u, rough_v, remap)
MATERIALS = {
    "uber": (6, [0.5, 0.35, 0.2], [0.25, 0.25, 0.3], 0.0, 0.0, 1.5, 0.1, 0.1, 1),
    "substrate": (7, [0.4, 0.5, 0.3], [0.05, 0.05, 0.06], 0, 0, 1.0, 0.1, 0.1, 1),
    "substrate_aniso_raw": (7, [0.6, 0.2, 0.2], [0.2, 0.2, 0.2], 0, 0, 1.0, 0.3, 0.05, 0),
    "translucent": (8, [0.3, 0.5, 0.4], [0.2, 0.2, 0.2], [0.6, 0.5, 0.5], [0.4, 0.5, 0.3],
                    1.5, 0.2, 0.2, 1),
}


def _table(rows):
    r3 = lambda v: np.broadcast_to(np.asarray(v, np.float32), (3,))  # noqa: E731
    col3 = lambda i: np.stack([r3(r[i]) for r in rows])  # noqa: E731
    col1 = lambda i, dt: np.array([r[i] for r in rows], dt)  # noqa: E731
    n = len(rows)
    return {
        "type": col1(0, np.int32), "kd": col3(1), "ks": col3(2), "kr": col3(3), "kt": col3(4),
        "eta": col3(5), "k": np.zeros((n, 3), np.float32), "rough_u": col1(6, np.float32),
        "rough_v": col1(7, np.float32), "sigma": np.zeros(n, np.float32),
        "opacity": np.ones((n, 3), np.float32), "remap": col1(8, np.int32),
    }


@pytest.fixture(scope="module")
def shaded():
    """Every material on its own N lanes, all in one batch, through both
    packages op by op. Returns {name: (jax outputs, port outputs, wo)}."""
    names = sorted(MATERIALS)
    tab = _table([MATERIALS[n] for n in names])
    rng = np.random.default_rng(77)
    n = N * len(names)
    wo, wi = _dirs(rng, n), _dirs(rng, n)
    u = rng.uniform(0, 1, (3, n)).astype(np.float32)
    mid = np.repeat(np.arange(len(names), dtype=np.int32), N)
    mpj = jb.gather_mat({k: jnp.array(v) for k, v in tab.items()}, jnp.array(mid))
    ja = jax.block_until_ready((jb.bsdf_eval(mpj, jnp.array(wo), jnp.array(wi)),
                                jb.bsdf_sample(mpj, jnp.array(wo), *map(jnp.array, u))))
    mpt = tb.gather_mat({k: _t(v) for k, v in tab.items()}, _t(mid))
    ta = (tb.bsdf_eval(mpt, _t(wo), _t(wi)), tb.bsdf_sample(mpt, _t(wo), *map(_t, u)))
    flat_j, tree = jax.tree.flatten(ja)
    flat_t = [x.numpy() for x in jax.tree.leaves(ta)]
    out = {}
    for i, name in enumerate(names):
        sl = slice(i * N, (i + 1) * N)
        out[name] = (jax.tree.unflatten(tree, [np.asarray(x)[sl] for x in flat_j]),
                     jax.tree.unflatten(tree, [x[sl] for x in flat_t]), wo[sl])
    return out


@pytest.mark.parametrize("name", sorted(MATERIALS))
def test_layered_bsdf_eval_and_sample(name, shaded):
    ((fj, pj), bj), ((ft, pt), bt), wo = shaded[name]
    assert (wo[:, 2] < 0).mean() > 0.4 and (wo[:, 2] > 0).mean() > 0.4
    _close(ft, fj, rtol=EVAL_RTOL, atol=ATOL)
    _close(pt, pj, rtol=EVAL_RTOL, atol=ATOL)
    np.testing.assert_array_equal(bt.is_specular, bj.is_specular)
    np.testing.assert_array_equal(bt.is_transmission, bj.is_transmission)
    np.testing.assert_array_equal(bt.pdf > 0, bj.pdf > 0)
    for a, b in ((bt.wi, bj.wi), (bt.f, bj.f), (bt.pdf, bj.pdf)):
        _close(a, b, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)
    assert (ft.max(-1) > 0).mean() > 0.3 and (bt.pdf > 0).mean() > 0.3
    assert not bt.is_specular.any()
    if name == "translucent":
        # the diffuse lobe transmits: both hemispheres receive light
        assert 0.1 < bt.is_transmission.mean() < 0.5
        assert (ft[(wo[:, 2] > 0) & (np.arange(N) % 2 == 0)].max(-1) > 0).any()


def test_resolve_mix_ids_exact():
    """A table with plain rows 0-3, mix 4 = (0, 1) at 0.35, mix 5 = (4, 2)
    at 0.6 (a nested mix), mix 6 = (5, 3) at 0.8: the resolved ids of
    every lane equal the reference's, every sub-row is reached, and a
    0.9999999-clipped rescaled draw is exercised at the edges."""
    n_rows = 7
    tab = _table([MATERIALS["uber"]] * n_rows)
    tab["mix_a"] = np.array([-1, -1, -1, -1, 0, 4, 5], np.int32)
    tab["mix_b"] = np.array([-1, -1, -1, -1, 1, 2, 3], np.int32)
    tab["mix_amt"] = np.array([0.5, 0.5, 0.5, 0.5, 0.35, 0.6, 0.8], np.float32)
    rng = np.random.default_rng(3)
    n = 65536
    mid = rng.integers(0, n_rows, n).astype(np.int32)
    u = rng.uniform(0, 1, n).astype(np.float32)
    u[:8] = [0.0, 0.35, np.float32(0.34999999), 0.6, 0.99999994, 0.21, 0.2099999, 0.5]
    got = tb.resolve_mix({k: _t(v) for k, v in tab.items()}, _t(mid), _t(u)).numpy()
    want = np.asarray(jb.resolve_mix({k: jnp.array(v) for k, v in tab.items()},
                                     jnp.array(mid), jnp.array(u)))
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got[mid >= 4]).tolist()) == {0, 1, 2, 3}
    assert (got[mid < 4] == mid[mid < 4]).all()
    # no mix columns, or no draw: a no-op
    plain = {k: _t(v) for k, v in tab.items() if not k.startswith("mix")}
    assert torch.equal(tb.resolve_mix(plain, _t(mid), _t(u)), _t(mid))
    assert torch.equal(tb.resolve_mix({k: _t(v) for k, v in tab.items()}, _t(mid), None),
                       _t(mid))


def test_beckmann_matches_reference():
    rng = np.random.default_rng(11)
    n = 8192
    wh, wo, wi = _dirs(rng, n), _dirs(rng, n), _dirs(rng, n)
    wh[:, 2] = np.abs(wh[:, 2])
    ax = rng.uniform(0.05, 0.8, n).astype(np.float32)
    ay = rng.uniform(0.05, 0.8, n).astype(np.float32)
    u1, u2 = rng.uniform(0, 1, (2, n)).astype(np.float32)
    J = [jnp.asarray(x) for x in (wh, wo, wi, ax, ay, u1, u2)]
    T = [_t(x) for x in (wh, wo, wi, ax, ay, u1, u2)]
    _close(tb.beckmann_d(T[0], T[3], T[4]), jb.beckmann_d(J[0], J[3], J[4]))
    _close(tb.beckmann_lambda(T[1], T[3], T[4]), jb.beckmann_lambda(J[1], J[3], J[4]))
    _close(tb.beckmann_g(T[1], T[2], T[3], T[4]), jb.beckmann_g(J[1], J[2], J[3], J[4]))
    whs_t = tb.beckmann_sample_wh(T[5], T[6], T[3], T[4])
    whs_j = jb.beckmann_sample_wh(J[5], J[6], J[3], J[4])
    _close(whs_t, whs_j, rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)
    _close(tb.beckmann_pdf(whs_t, T[3], T[4]), jb.beckmann_pdf(whs_j, J[3], J[4]),
           rtol=SAMPLE_RTOL, atol=SAMPLE_ATOL)


def _hemisphere(n, seed):
    d = _dirs(np.random.default_rng(seed), n)
    d[:, 2] = np.abs(d[:, 2])
    return torch.from_numpy(d)


def test_beckmann_normalization_oracle():
    """int D(wh) cos(wh) dw = 1 over the hemisphere (tests/test_bxdf_rough.py)."""
    n = 200_000
    wh = _hemisphere(n, 1)
    for ax, ay in ((0.1, 0.1), (0.3, 0.3), (0.2, 0.5)):
        d = tb.beckmann_d(wh, torch.tensor(ax), torch.tensor(ay)).numpy()
        est = float(np.mean(d * wh[:, 2].numpy())) * 2.0 * np.pi
        assert abs(est - 1.0) < 0.08, (ax, ay, est)


def test_beckmann_sample_matches_pdf_oracle():
    """The sampled half-vectors' E[cos^2] equals the NDF-weighted
    uniform-hemisphere estimate of the same moment (tests/test_bxdf_rough.py)."""
    n = 200_000
    rng = np.random.default_rng(2)
    u1, u2 = (torch.from_numpy(rng.uniform(size=n).astype(np.float32)) for _ in range(2))
    a = torch.tensor(0.25)
    wh = tb.beckmann_sample_wh(u1, u2, a, a)
    assert (tb.beckmann_pdf(wh, a, a) > 0).all()
    est_a = float((wh[:, 2] ** 2).mean())
    whu = _hemisphere(n, 3)
    d = tb.beckmann_d(whu, a, a).numpy()
    cz = whu[:, 2].numpy()
    est_b = float(np.sum(cz ** 2 * d * cz) / np.sum(d * cz))
    assert abs(est_a - est_b) < 0.02, (est_a, est_b)


_PLANE_SCENE = """
Integrator "path" "integer maxdepth" [2]
Sampler "zerotwosequence" "integer pixelsamples" [{spp}]
Film "image" "integer xresolution" [24] "integer yresolution" [24]
LookAt 0 1 -3  0 0 0  0 1 0
Camera "perspective" "float fov" [60]
WorldBegin
LightSource "infinite" "rgb L" [1.0 1.0 1.0]
{material}
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-20 -1 -20  20 -1 -20  20 -1 20  -20 -1 20]
WorldEnd
"""


def test_mix_matches_linear_blend_of_mattes():
    """tests/test_mix.py's oracle: Lambertian f is linear in Kd, so
    mix(matte(kd1), matte(kd2), 0.3) converges to matte(0.3 kd1 + 0.7 kd2)."""
    from tpu_pbrt_torch import parse_string

    mix = ('MakeNamedMaterial "red" "string type" ["matte"] "rgb Kd" [0.8 0.1 0.1]\n'
           'MakeNamedMaterial "blue" "string type" ["matte"] "rgb Kd" [0.1 0.1 0.7]\n'
           'Material "mix" "string namedmaterial1" ["red"] "string namedmaterial2" ["blue"] '
           '"rgb amount" [0.3 0.3 0.3]')
    kd = 0.3 * np.array([0.8, 0.1, 0.1]) + 0.7 * np.array([0.1, 0.1, 0.7])
    blend = f'Material "matte" "rgb Kd" [{kd[0]} {kd[1]} {kd[2]}]'
    a = parse_string(_PLANE_SCENE.format(spp=32, material=mix), render=True,
                     device="cpu").result.image
    b = parse_string(_PLANE_SCENE.format(spp=32, material=blend), render=True,
                     device="cpu").result.image
    fa, fb = a[12:], b[12:]  # the floor fills the lower half
    assert fa.mean() > 0.05
    assert abs(fa.mean() - fb.mean()) < 0.01, (fa.mean(), fb.mean())
    assert np.abs(fa - fb).mean() < 0.05
