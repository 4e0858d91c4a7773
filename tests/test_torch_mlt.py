"""MLT on the CPU, against the JAX package.

- f(U), the path contribution of explicit primary-sample vectors, against
  the reference's `_f` on the small Cornell box: the bootstrap's vectors
  (which must be bit-equal: the same hashes) and seeded uniform ones.
  Raster positions and radiance agree to RTOL / ATOL.
- The chains lane for lane: from the same seeds, the first STEPS
  Metropolis steps of every chain (large and small mutations, the
  Kelemen-weighted splats, the accept test) against the reference's step,
  restated with its own f(U) and sample streams: every chain's
  accept decision must match EXACTLY at every step, the chain states and
  the splat plane to STATE_RTOL / STATE_ATOL. One accept that flips reroutes a chain
  for good (the chains are chaotic), so this is the check that holds the
  port to the reference. The reference's side of both is stored by
  tests/torch_golden/make_module_reference.py (mlt_parts.npz), run as
  the tests would run it.
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

import torch

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


@pytest.fixture(scope="module")
def port():
    """The port's Cornell box under `mlt` (maxdepth 3) and the reference's
    outputs on it (tests/torch_golden/make_module_reference.py:
    mlt_parts.npz, the reference run as under pytest)."""
    st, it = tscenes.compile_api(tscenes.make_cornell(res=16, spp=1, integrator="mlt",
                                                      maxdepth=3, device="cpu"))
    return st, it, np.load(os.path.join(GOLDEN, "mlt_parts.npz"))


def _close(t, j, what="", rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("kind", ["bootstrap", "uniform"])
def test_f_matches_reference(port, kind):
    st, it, ref = port
    Uj = ref[f"f_{kind}_U"]
    assert Uj.shape == (C, it.n_dims)
    if kind == "bootstrap":
        Ut = it._bootstrap_u(C, "cpu")
        np.testing.assert_array_equal(Ut.numpy(), Uj)
    else:
        np.testing.assert_array_equal(
            Uj, np.random.default_rng(21).uniform(0, 1, (C, it.n_dims)).astype(np.float32))
        Ut = torch.from_numpy(Uj.copy())
    pt, Lt = it._f(st.dev, Ut)
    _close(pt, ref[f"f_{kind}_p"], "p_film")
    _close(Lt, ref[f"f_{kind}_L"], "L")
    assert (ref[f"f_{kind}_L"].max(-1) > 0).mean() > 0.3


def test_chain_steps_match_reference(port):
    """The first STEPS steps of C chains, accept decisions lane for lane,
    against the reference's mutation step (integrators/mlt.py, render's
    `one`) with its own f(U) and sample streams."""
    st, it, ref = port
    x0, x1, y0, y1 = st.film.sample_bounds()
    w, h = x1 - x0, y1 - y0
    npix = w * h
    b = 0.25
    U = ref["chain_U0"]
    np.testing.assert_array_equal(
        U, np.random.default_rng(22).uniform(0, 1, (C, it.n_dims)).astype(np.float32))
    Ut = torch.from_numpy(U.copy())
    pt, Lt = it._f(st.dev, Ut)
    carry_t = (Ut, pt, Lt, tmlt._luminance(Lt))
    splat_t = torch.zeros((npix + 1, 3))
    n_accept = 0
    for step in range(STEPS):
        accept = ref[f"chain_{step}_accept"]
        carry_t, accept_t = it._chain_step(st.dev, carry_t, splat_t, step, b, x0, y0, w, h)
        np.testing.assert_array_equal(accept_t.numpy(), accept, f"step {step}")
        n_accept += int(accept.sum())
        for x, f in zip(carry_t, ("U", "p", "L", "y")):
            _close(x, ref[f"chain_{step}_{f}"], f"step {step} {f}", STATE_RTOL, STATE_ATOL)
    assert 0 < n_accept < STEPS * C
    _close(splat_t[:npix], ref["chain_splat"], "splat", STATE_RTOL, STATE_ATOL)


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
