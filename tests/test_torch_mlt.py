"""MLT on the CPU, against the JAX package.

- f(U), the path contribution of explicit primary-sample vectors, against
  the reference's `_f` on the small Cornell box: the bootstrap's vectors
  (which must be bit-equal: the same hashes) and seeded uniform ones.
  Raster positions and radiance agree to RTOL / ATOL.
- The chains lane for lane: from the same seeds, the first STEPS
  Metropolis steps of every chain (large and small mutations, the
  Kelemen-weighted splats, the accept test) against the reference's step,
  restated here with its own f(U) and sample streams: every chain's
  accept decision must match EXACTLY at every step, the chain states and
  the splat plane to STATE_RTOL / STATE_ATOL. One accept that flips reroutes a chain
  for good (the chains are chaotic), so this is the check that holds the
  port to the reference.
- The whole render against the JAX CPU golden `mlt_cornell`
  (tests/torch_golden/make_golden.py: 512 chains, 32 mutations per pixel,
  maxdepth 3) within GOLDEN_MSE (measured value beside it), with the
  same rays.
- The reference's oracles, on the port alone: mlt equals path within 8%
  at maxdepth 1 and 10% at maxdepth 3, and its image correlates with
  path's (> 0.8) where a uniform chain noise would not.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpu_pbrt import scenes as jscenes
from tpu_pbrt.core.sampling import uniform_float as juniform
from tpu_pbrt_torch import scenes as tscenes
from tpu_pbrt_torch.integrators import mlt as tmlt
from tpu_pbrt_torch.scene.api import Options as TOptions
from tpu_pbrt_torch.scene.api import parse_string as tparse_string
from tpu_pbrt_torch.scene.api import pbrt_init as tpbrt_init

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "torch_golden")
sys.path.insert(0, GOLDEN)
from make_golden import lt_api  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
#: the chains' states and splats after STEPS steps (measured: 2.0e-4
#: relative on one radiance value of 1,536, a path through a near-grazing
#: bounce whose direction differs by an ulp)
STATE_RTOL, STATE_ATOL = 1e-3, 1e-5
C, STEPS = 512, 4
#: the render against its golden (measured 1.1e-14: every chain takes the
#: reference's accept decisions, so only float order differs)
GOLDEN_MSE = 1e-12


def _pair(md=3):
    sj, ij = jscenes.compile_api(jscenes.make_cornell(res=16, spp=1, integrator="mlt",
                                                      maxdepth=md))
    st, it = tscenes.compile_api(tscenes.make_cornell(res=16, spp=1, integrator="mlt",
                                                      maxdepth=md, device="cpu"))
    return sj, ij, st, it


@pytest.fixture(scope="module")
def pair():
    sj, ij, st, it = _pair()
    return sj, ij, jax.jit(ij._f), st, it


def _close(t, j, what="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("kind", ["bootstrap", "uniform"])
def test_f_matches_reference(pair, kind):
    sj, ij, jf, st, it = pair
    D = it.n_dims
    if kind == "bootstrap":
        bid = jnp.arange(C, dtype=jnp.int32)
        Uj = jnp.stack([juniform(bid, bid * 7 + 3, jnp.int32(0x8F2), k) for k in range(D)], -1)
        Ut = it._bootstrap_u(C, "cpu")
        np.testing.assert_array_equal(Ut.numpy(), np.asarray(Uj))
    else:
        U = np.random.default_rng(21).uniform(0, 1, (C, D)).astype(np.float32)
        Uj, Ut = jnp.asarray(U), torch.from_numpy(U.copy())
    pj, Lj = jf(sj.dev, Uj)
    pt, Lt = it._f(st.dev, Ut)
    _close(pt, pj, "p_film")
    _close(Lt, Lj, "L")
    assert (np.asarray(Lj).max(-1) > 0).mean() > 0.3


def test_chain_steps_match_reference(pair):
    """The first STEPS steps of C chains, accept decisions lane for lane."""
    sj, ij, jf, st, it = pair
    D, pL, sigma = it.n_dims, it.large_step_prob, it.sigma
    x0, x1, y0, y1 = st.film.sample_bounds()
    w, h = x1 - x0, y1 - y0
    npix = w * h
    U = np.random.default_rng(22).uniform(0, 1, (C, D)).astype(np.float32)
    b = 0.25
    # the reference's mutation step (integrators/mlt.py, render's `one`),
    # with its own f(U) and sample streams
    Uj = jnp.asarray(U)
    pj, Lj = jf(sj.dev, Uj)
    yj = tmlt._luminance(Lj)
    splat_j = jnp.zeros((npix, 3), jnp.float32)
    Ut = torch.from_numpy(U.copy())
    pt, Lt = it._f(st.dev, Ut)
    carry_t = (Ut, pt, Lt, tmlt._luminance(Lt))
    splat_t = torch.zeros((npix + 1, 3))
    n_accept = 0
    for step in range(STEPS):
        cid = jnp.arange(C, dtype=jnp.int32)

        def u(salt):
            return juniform(cid, jnp.int32(step), jnp.int32(0x3D7), salt)

        large = u(0) < pL
        Un = jnp.stack([u(100 + k) for k in range(D)], -1)
        eps = jnp.stack([u(300 + k) for k in range(D)], -1)
        mag = sigma * jnp.exp(-jnp.log(1024.0) * eps)
        U_prop = jnp.where(large[:, None], Un, (Uj + jnp.where(Un < 0.5, mag, -mag)) % 1.0)
        p_prop, L_prop = jf(sj.dev, U_prop)
        y_prop = tmlt._luminance(L_prop)
        a = jnp.minimum(1.0, y_prop / jnp.maximum(yj, 1e-20))
        w_new = (a + large.astype(jnp.float32)) / (y_prop / b + pL)
        w_old = (1.0 - a) / (yj / b + pL)
        for pf, val in ((p_prop, L_prop * w_new[:, None]), (pj, Lj * w_old[:, None])):
            px = jnp.clip(pf[:, 0].astype(jnp.int32) - x0, 0, w - 1)
            py = jnp.clip(pf[:, 1].astype(jnp.int32) - y0, 0, h - 1)
            ok = jnp.isfinite(val).all(-1) & (jnp.max(val, -1) >= 0.0)
            splat_j = splat_j.at[jnp.where(ok, py * w + px, npix)].add(
                jnp.where(ok[:, None], val, 0.0), mode="drop")
        accept = u(700) < a
        Uj = jnp.where(accept[:, None], U_prop, Uj)
        pj = jnp.where(accept[:, None], p_prop, pj)
        Lj = jnp.where(accept[:, None], L_prop, Lj)
        yj = jnp.where(accept, y_prop, yj)

        carry_t, accept_t = it._chain_step(st.dev, carry_t, splat_t, step, b, x0, y0, w, h)
        np.testing.assert_array_equal(accept_t.numpy(), np.asarray(accept), f"step {step}")
        n_accept += int(np.asarray(accept).sum())
        for x, y, f in zip(carry_t, (Uj, pj, Lj, yj), ("U", "p_film", "L", "y")):
            _close(x, y, f"step {step} {f}", STATE_RTOL, STATE_ATOL)
    assert 0 < n_accept < STEPS * C
    _close(splat_t[:npix], splat_j, "splat", STATE_RTOL, STATE_ATOL)


def test_render_matches_jax_golden():
    ref = np.load(os.path.join(GOLDEN, "mlt_cornell.npz"))
    scene, integ = tscenes.compile_api(lt_api(
        "mlt_cornell", tscenes, tparse_string, tpbrt_init, TOptions, tscenes.make_caustic_like,
        tscenes._crown_envmap_path(), device="cpu"))
    res = integ.render(scene)
    img = res.image
    assert img.shape == ref["image"].shape and np.isfinite(img).all()
    mse = float(np.mean((img.astype(np.float64) - ref["image"]) ** 2))
    assert res.rays_traced == int(ref["rays_traced"])
    assert mse <= GOLDEN_MSE, mse
    assert 0.0 < res.stats["acceptance"] < 1.0


def _render(integrator, md, **tweaks):
    scene, integ = tscenes.compile_api(tscenes.make_cornell(
        res=16, spp=32, integrator=integrator, maxdepth=md, device="cpu"))
    for k, v in tweaks.items():
        setattr(integ, k, v)
    return integ.render(scene)


_MLT = dict(n_bootstrap=8192, n_chains=1024, mutations_per_pixel=200)


@pytest.mark.parametrize("md,tol", [(1, 0.08), (3, 0.10)])
def test_mlt_matches_path(md, tol):
    p = _render("path", md).image
    r = _render("mlt", md, **_MLT)
    m = r.image
    assert np.isfinite(m).all() and 0.0 < r.stats["acceptance"] < 1.0
    assert abs(m.mean() - p.mean()) / p.mean() < tol, (m.mean(), p.mean())


def test_mlt_concentrates_on_bright_regions():
    p = _render("path", 2).image.mean(-1).ravel()
    m = _render("mlt", 2, **_MLT).image.mean(-1).ravel()
    assert np.corrcoef(p, m)[0, 1] > 0.8
