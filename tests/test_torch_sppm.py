"""SPPM on the CPU, against the JAX package.

- `_gather` against the reference's, on the same visible points and
  photon deposits (the port's camera and photon passes on the small
  Cornell box), on two grids: photon counts `m` must match EXACTLY and
  the flux `phi` within rtol PHI_RTOL / atol PHI_ATOL (the reference's
  own permutation tolerance: the sort puts a cell's photons in an order
  of its own, and a visible point's flux sums its slots in that order).
- Renders against the JAX CPU goldens of tests/torch_golden/make_golden.py
  (`LT_CASES`: the small Cornell box and the small caustic, 4 iterations
  of 4,096 photons), to the MSE bound and traced-ray difference of
  GOLDEN_TOL (measured values beside them).
- The reference's oracles, on the port alone: sppm equals path within 5%
  at maxdepth 1 and within 15% at maxdepth 3 (photon density estimation
  carries kernel bias at a finite radius); the radius shrinks where
  photons arrived and stays where none did, and no photon is dropped;
  the gather is invariant under a permutation of the deposits (m exactly,
  phi within PHI_RTOL).
"""

import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpu_pbrt import config as jconfig
from tpu_pbrt import scenes as jscenes
from tpu_pbrt.integrators import sppm as jsppm
from tpu_pbrt_torch import scenes as tscenes
from tpu_pbrt_torch.config import cfg as tcfg
from tpu_pbrt_torch.integrators import sppm as tsppm
from tpu_pbrt_torch.scene.api import Options as TOptions
from tpu_pbrt_torch.scene.api import parse_string as tparse_string
from tpu_pbrt_torch.scene.api import pbrt_init as tpbrt_init

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "torch_golden")
sys.path.insert(0, GOLDEN)
from make_golden import LEAF_TRIS, lt_api  # noqa: E402

PHI_RTOL, PHI_ATOL = 1e-4, 1e-6
#: golden -> (MSE bound, traced-ray difference bound); measured in the comments
GOLDEN_TOL = {
    "sppm_cornell": (1e-12, 0),  # 4.9e-16, rays equal (35,826)
    "sppm_caustic": (1e-10, 0),  # 1.2e-12 (29,842): flux summed in another photon order
}


@pytest.fixture
def small_treelets(monkeypatch):
    """The goldens' 64-triangle treelets, on both packages."""
    monkeypatch.setenv("TPU_PBRT_LEAF_TRIS", str(LEAF_TRIS))
    monkeypatch.setattr(tcfg, "leaf_tris", LEAF_TRIS)
    jconfig.reload()
    yield
    monkeypatch.undo()
    jconfig.reload()


def _cornell(md=3, spp=4, photons=2048, radius=-1.0, integrator="sppm", res=16):
    scene, integ = tscenes.compile_api(tscenes.make_cornell(
        res=res, spp=spp, integrator=integrator, maxdepth=md, device="cpu"))
    if integrator == "sppm":
        integ.n_iterations = spp
        integ.photons_per_iter = photons
        integ.initial_radius = radius
    return scene, integ


def _passes(scene, integ, photons=2048):
    """The port's visible points of 64 pixels and its photon deposits."""
    pix = torch.arange(64, dtype=torch.int32)
    vps, _ = integ._camera_pass(scene.dev, pix % 16, torch.div(pix, 16, rounding_mode="floor"), 0)
    deps = integ._photon_pass(scene.dev, photons, 0)[:4]
    return vps, deps


def _grid(scene, which):
    verts = scene.dev["tri_verts"].numpy().reshape(-1, 3)
    if which == "fine":  # the reference's permutation test's grid
        return np.full(64, 0.01, np.float32), (verts.min(0) - 0.1).astype(np.float32), 0.25
    # the render's first-iteration grid at a radius of 0.15
    r = np.float32(0.15)
    lo = (verts.min(0).astype(np.float32) - r)
    ext = (verts.max(0).astype(np.float32) + r) - lo
    return np.full(64, r * r, np.float32), lo, float(max(np.float32(2) * r, ext.max() / 64))


@pytest.mark.parametrize("grid", ["fine", "render"])
def test_gather_matches_reference(grid):
    scene, integ = _cornell()
    sj, ij = jscenes.compile_api(jscenes.make_cornell(res=16, spp=4, integrator="sppm",
                                                      maxdepth=3))
    vps, deps = _passes(scene, integ)
    assert int((vps.mat >= 0).sum()) > 32 and int(deps[3].sum()) > 500
    r2, lo, cs = _grid(scene, grid)
    phi_t, m_t = integ._gather(scene.dev, vps, *deps, torch.from_numpy(r2),
                               torch.from_numpy(lo), torch.tensor(cs, dtype=torch.float32),
                               (64, 64, 64))
    jv = jsppm._VisiblePoints(*(jnp.asarray(x.numpy()) for x in vps))
    phi_j, m_j, drop = ij._gather(sj.dev, jv, *(jnp.asarray(x.numpy()) for x in deps),
                                  jnp.asarray(r2), jnp.asarray(lo), jnp.float32(cs),
                                  (64, 64, 64))
    assert int(drop) == 0
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    assert m_t.numpy().sum() > 50
    np.testing.assert_allclose(phi_t.numpy(), np.asarray(phi_j), rtol=PHI_RTOL, atol=PHI_ATOL)


def test_gather_photon_permutation_invariance():
    scene, integ = _cornell()
    vps, deps = _passes(scene, integ)
    r2, lo, cs = (torch.from_numpy(x) if isinstance(x, np.ndarray) else torch.tensor(x)
                  for x in _grid(scene, "fine"))
    phi0, m0 = integ._gather(scene.dev, vps, *deps, r2, lo, cs, (64, 64, 64))
    perm = torch.from_numpy(np.random.default_rng(3).permutation(deps[0].shape[0]))
    phi1, m1 = integ._gather(scene.dev, vps, *(x[perm] for x in deps), r2, lo, cs,
                             (64, 64, 64))
    np.testing.assert_array_equal(m0.numpy(), m1.numpy())
    np.testing.assert_allclose(phi0.numpy(), phi1.numpy(), rtol=PHI_RTOL, atol=PHI_ATOL)


def test_radius_shrinks():
    """r2' = r2 (N + gamma M) / (N + M) < r2 where M > 0; nothing changes
    where no photon arrived; a render drops no photon."""
    scene, integ = _cornell(spp=2, photons=2048, radius=0.25)
    dev = scene.dev
    pix = torch.arange(256, dtype=torch.int32)
    px, py = pix % 16, torch.div(pix, 16, rounding_mode="floor")
    state = tsppm._SPPMState(r2=torch.full((256,), 0.0625), n=torch.zeros(256),
                             tau=torch.zeros(256, 3), ld=torch.zeros(256, 3))
    lo = scene.dev["tri_verts"].reshape(-1, 3).min(0).values - 0.25
    for i in range(2):
        vps, _ = integ._camera_pass(dev, px, py, i)
        deps = integ._photon_pass(dev, 2048, i)[:4]
        phi, m = integ._gather(dev, vps, *deps, state.r2, lo, torch.tensor(0.5), (64, 64, 64))
        new = integ._update(state, vps, phi, m)
        got = m > 0
        assert got.float().mean() > 0.5
        assert bool((new.r2[got] < state.r2[got]).all()) and bool((new.n[got] > state.n[got]).all())
        assert torch.equal(new.r2[~got], state.r2[~got])
        state = new
    res = integ.render(scene)
    assert np.isfinite(res.image).all() and res.image.mean() > 1e-4
    assert res.stats["photons_dropped"] == 0 and res.stats["n_drop"] == 0


@pytest.mark.parametrize("md,tol", [(1, 0.05), (3, 0.15)])
def test_sppm_matches_path(md, tol):
    scene, integ = _cornell(md=md, integrator="path", spp=32)
    p = integ.render(scene).image
    scene, integ = _cornell(md=md, spp=8, photons=4096)
    s = integ.render(scene).image
    assert np.isfinite(s).all()
    assert abs(s.mean() - p.mean()) / p.mean() < tol, (s.mean(), p.mean())


@pytest.mark.parametrize("name", list(GOLDEN_TOL))
def test_render_matches_jax_golden(name, small_treelets):
    ref = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    scene, integ = tscenes.compile_api(lt_api(
        name, tscenes, tparse_string, tpbrt_init, TOptions, tscenes.make_caustic_like,
        tscenes._crown_envmap_path(), device="cpu"))
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
