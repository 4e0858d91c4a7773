"""The port's environment light against the JAX package's, and the small
crown-class scene rendered by both.

- Distribution2D (core/sampling.py): the host build's six tables
  bit-equal; sample_continuous and pdf on seeded (u1, u2) bit-equal
  (the same searches and the same f32 arithmetic).
- On the crown's own sky (the port writes it byte for byte as the
  reference does): env_lookup, env_pdf, _env_sample (directions, pdfs,
  radiance) and infinite_pdf under each light-pick strategy. atan2, acos,
  sin and cos may round an ulp apart between the two libraries: 1e-5
  relative + 1e-6 absolute (measured: 86-96% of the values bit-equal,
  the rest at most 4.4e-6 relative, in the sun's radiance).
- The small crown (tests/torch_golden/make_golden.py's `crown_small_text`:
  the infinite light with the crown's sky at 16x32, a glass mesh with
  per-vertex normals, a metal mesh, an anisotropic metal mesh and a
  matte ground on 1,682 triangles in 64-triangle treelets) rendered by
  the port's fixed batch and pool against the JAX renders in
  tests/torch_golden/crown_small{,_pool}.npz: the traced rays exact, for
  the pool also the waves and every wave counter; the image MSE <= 1e-10
  with >= 99% of the pixel channels within 1e-5 (measured: MSE 8.5e-12,
  one channel of 768 off by 5.7e-5, on both paths). No glass lane picks
  the other lobe: a flipped reflect/refract choice would change the
  ray count.
"""

import json
import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpu_pbrt import scenes as jscenes
from tpu_pbrt.core import lights_dev as jld
from tpu_pbrt.core import sampling as js
from tpu_pbrt.utils.imageio import read_pfm as jread_pfm
from tpu_pbrt_torch import scenes as tscenes
from tpu_pbrt_torch.config import cfg as tcfg
from tpu_pbrt_torch.core import lights_dev as tld
from tpu_pbrt_torch.core import sampling as ts
from tpu_pbrt_torch.core.spectrum import luminance
from tpu_pbrt_torch.scene.api import Options, parse_string, pbrt_init
from tpu_pbrt_torch.utils.imageio import read_pfm, write_image
from tests.test_torch_xla_math import JitRef, rounded_apart

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "torch_golden", "crown_small.npz")
GOLDEN_POOL = os.path.join(HERE, "torch_golden", "crown_small_pool.npz")
N = 4096
RTOL, ATOL = 1e-5, 1e-6


def _t(x):
    """A torch copy: the two frameworks never share an input buffer."""
    return torch.from_numpy(np.array(x, copy=True))


def _close(a_t, a_j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(a_t.numpy(), np.asarray(a_j), rtol=rtol, atol=atol)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.fixture(scope="module")
def sky(tmp_path_factory):
    """The crown's sky as the port writes it; it must be the reference's
    file byte for byte."""
    path = tscenes._crown_envmap_path(str(tmp_path_factory.mktemp("sky") / "crown_env.pfm"))
    with open(path, "rb") as a, open(jscenes._crown_envmap_path(), "rb") as b:
        assert a.read() == b.read()
    img = read_pfm(path)
    assert img.shape == (64, 128, 3)
    np.testing.assert_array_equal(img, jread_pfm(path))
    return img


def _weights(img):
    h = img.shape[0]
    theta = (np.arange(h) + 0.5) / h * np.pi
    return luminance(img) * np.sin(theta)[:, None]


@pytest.fixture(scope="module")
def envs(sky):
    """(JAX dev, port dev) environment tables on the crown's sky: the
    identity light frame and a rotated one."""
    dj = js.Distribution2D.build(_weights(sky))
    dt = ts.Distribution2D.build(_weights(sky))
    rot = np.asarray([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    out = []
    for w2l in (np.eye(3, dtype=np.float32), rot):
        jdev = {"envmap": jnp.array(sky), "env_distr": dj, "env_w2l": jnp.array(w2l),
                "light": {"type": jnp.asarray([0, 4], jnp.int32)}, "world_radius": jnp.float32(9.0)}
        tdev = {"envmap": _t(sky), "env_distr": dt, "env_w2l": _t(w2l),
                "light": {"type": _t(np.asarray([0, 4], np.int32))},
                "world_radius": torch.tensor(9.0)}
        out.append((jdev, tdev))
    return out


def test_distribution2d_matches(sky):
    f = _weights(sky)
    dj = js.Distribution2D.build(f)
    dt = ts.Distribution2D.build(f)
    for name in ts.Distribution2D._fields:
        np.testing.assert_array_equal(_bits(getattr(dt, name).numpy()),
                                      _bits(np.asarray(getattr(dj, name))), err_msg=name)
    rng = np.random.default_rng(21)
    u = rng.uniform(0, 1, (2, N)).astype(np.float32)
    u[:, :4] = [[0.0, 0.0, 0.99999994, 0.5], [0.0, 0.99999994, 0.0, 0.5]]
    (uj, vj), pj = dj.sample_continuous(jnp.asarray(u[0]), jnp.asarray(u[1]))
    (ut, vt), pt = dt.sample_continuous(_t(u[0]), _t(u[1]))
    for a, b in ((ut, uj), (vt, vj), (pt, pj)):
        np.testing.assert_array_equal(_bits(a.numpy()), _bits(np.asarray(b)))
    np.testing.assert_array_equal(_bits(dt.pdf(ut, vt).numpy()), _bits(np.asarray(dj.pdf(uj, vj))))
    # a flat map samples uniformly with pdf 1
    (uf, vf), pf = ts.Distribution2D.build(np.ones((4, 8))).sample_continuous(_t(u[0]), _t(u[1]))
    np.testing.assert_allclose(uf.numpy(), u[0], atol=1e-6)
    np.testing.assert_allclose(pf.numpy(), 1.0)


@pytest.mark.parametrize("frame", [0, 1], ids=["identity", "rotated"])
@rounded_apart
def test_env_lookup_pdf_and_sample(envs, frame):
    _check_env_lookup_pdf_and_sample(envs, frame, jld)


@pytest.mark.parametrize("frame", [0, 1], ids=["identity", "rotated"])
def test_env_lookup_pdf_and_sample_contracted(envs, frame):
    """The port's default rounding against the reference compiled at the
    renders' optimisation level, with the same bounds."""
    _check_env_lookup_pdf_and_sample(envs, frame, JitRef(jld))


def _check_env_lookup_pdf_and_sample(envs, frame, jld):
    jdev, tdev = envs[frame]
    rng = np.random.default_rng(22 + frame)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _close(tld.env_lookup(tdev, _t(d)), jld.env_lookup(jdev, jnp.asarray(d)))
    _close(tld.env_pdf(tdev, _t(d)), jld.env_pdf(jdev, jnp.asarray(d)))
    u = rng.uniform(0, 1, (2, N)).astype(np.float32)
    wt, pt, lt = tld._env_sample(tdev, _t(u[0]), _t(u[1]))
    wj, pj, lj = jld._env_sample(jdev, jnp.asarray(u[0]), jnp.asarray(u[1]))
    _close(wt, wj)
    _close(pt, pj)
    _close(lt, lj)
    # importance sampling follows the sun: most samples land brighter than average
    assert float(lt.mean()) > float(tdev["envmap"].mean()) * 2
    # the sampled pdf is the pdf of the sampled direction
    _close(tld.env_pdf(tdev, wt), pt.numpy(), rtol=1e-3, atol=1e-4)


def test_infinite_pdf_by_strategy(envs):
    jdev, tdev = envs[0]
    rng = np.random.default_rng(23)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    power = np.array([3.0, 5.0])
    imp = rng.uniform(0.1, 1.0, (8, 2))
    imp[:, 1] = 0.4  # the environment's row is position-independent
    imp /= imp.sum(-1, keepdims=True)
    cdf = np.cumsum(imp, -1).astype(np.float32)
    cdf[:, -1] = 1.0
    sd = dict(cdf=cdf, mean_pmf=imp.mean(0).astype(np.float32),
              lo=np.full(3, -2, np.float32), inv_cs=np.full(3, 0.5, np.float32), res=(2, 2, 2))
    cases = [
        (None, None),
        (js.Distribution1D.build(power), ts.Distribution1D.build(power)),
        (jld.SpatialLightDistribution(**{k: v if k == "res" else jnp.asarray(v)
                                         for k, v in sd.items()}),
         tld.SpatialLightDistribution(**{k: v if k == "res" else _t(v) for k, v in sd.items()})),
    ]
    for dj, dt in cases:
        for ref_p in (None, p):
            got = tld.infinite_pdf(tdev, dt, _t(d), None if ref_p is None else _t(ref_p))
            want = jld.infinite_pdf(jdev, dj, jnp.asarray(d),
                                    None if ref_p is None else jnp.asarray(ref_p))
            _close(got, np.broadcast_to(np.asarray(want), got.shape))


def _small_crown(regen: bool):
    sys.path.insert(0, os.path.join(HERE, "torch_golden"))
    try:
        from make_golden import POOL, crown_small_sky, crown_small_text
    finally:
        sys.path.pop(0)
    knobs = dict(leaf_tris=64, regen=regen, pool=POOL if regen else 0)
    saved = {k: getattr(tcfg, k) for k in knobs}
    for k, v in knobs.items():
        setattr(tcfg, k, v)
    try:
        import tempfile

        from tpu_pbrt_torch.scenes import compile_api

        with tempfile.TemporaryDirectory() as tmp:
            env = os.path.join(tmp, "sky.pfm")
            write_image(env, crown_small_sky())
            api = parse_string(crown_small_text(env), pbrt_init(Options(quiet=True), device="cpu"))
            scene, integ = compile_api(api)
        return scene, integ.render(scene)
    finally:
        for k, v in saved.items():
            setattr(tcfg, k, v)


def _check_image(img, want):
    assert img.shape == want.shape == (16, 16, 3) and np.isfinite(img).all()
    assert float(np.mean((img - want) ** 2)) <= 1e-10
    assert np.mean(np.abs(img - want) <= 1e-5) >= 0.99


def test_small_crown_fixed_batch_matches_jax_render():
    ref = np.load(GOLDEN)
    scene, res = _small_crown(regen=False)
    assert scene.has_envmap and "tstream" in scene.dev
    assert scene.n_tris == int(ref["n_tris"]) == 1682
    assert scene.dev["tstream"].n_treelets == int(ref["n_treelets"])
    assert "regen" not in res.stats
    assert res.rays_traced == int(ref["rays_traced"])
    _check_image(res.image, ref["image"])


def test_small_crown_pool_matches_jax_render():
    ref = np.load(GOLDEN_POOL)
    scene, res = _small_crown(regen=True)
    st = res.stats
    assert st["regen"] and st["pool"] == int(ref["pool"])
    assert res.rays_traced == int(ref["rays_traced"])
    assert st["n_waves"] == int(ref["n_waves"])
    assert st["telemetry"]["counters"] == json.loads(str(ref["counters"]))
    assert st["mean_wave_occupancy"] == pytest.approx(float(ref["mean_wave_occupancy"]), abs=1e-12)
    _check_image(res.image, ref["image"])
