"""The subsurface slice of the port (tpu_pbrt_torch/core/bssrdf.py, the
subsurface / kdsubsurface / fourier lowering of scene/compiler.py and the
BSSRDF probe wave of integrators/path.py) against the JAX package, on
the small variant of the subsurface stand-in
(`scenes.make_subsurface_like(small=True)`: 2,740 triangles in
64-triangle treelets), with stored outputs of the reference
(tests/torch_golden/make_subsurface_reference.py).

Covered, with the tolerance stated in each test:
- the compiled material columns (sub_id, the glass interface of the
  subsurface rows), the Fourier table and the baked BSSRDF rows equal the
  reference's;
- one captured bounce wave on 1,024 rays aimed at the large blob: the
  probe's exit vertex, Sp at the exit, Pdf_Sp's sum pdf_tot and the
  lanes' throughput, which carries w_sss = Sp nFound / pdf_tot, against
  the reference's `_bounce_wave`;
- `path` through the pool and the fixed batch at 16x16, 4 spp against the
  reference's renders (image MSE, traced rays, the pool's waves);
- the pool equals the fixed batch bit for bit at 1 spp;
- `path` without a subsurface row runs no probe wave.
"""

import os

import numpy as np
import pytest
import torch

from tpu_pbrt_torch.config import cfg as tcfg
from tpu_pbrt_torch.core import bssrdf as tbs
from tpu_pbrt_torch.integrators import path as tpath
from tpu_pbrt_torch.scenes import compile_api, make_subsurface_like

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "torch_golden")
LEAF_TRIS, POOL = 64, 256
#: golden -> (image MSE bound, |rays - the reference's| bound); measured
#: 6.862e-12 with rays equal (4,484) for both, since the probe wave rounds
#: its start point and exit direction as the compiled reference does
GOLDEN_TOL = {"subsurface_path_pool": (1e-11, 0), "subsurface_path_fixed": (1e-11, 0)}


@pytest.fixture
def small_treelets(monkeypatch):
    monkeypatch.setattr(tcfg, "leaf_tris", LEAF_TRIS)


@pytest.fixture(scope="module")
def probe():
    return np.load(os.path.join(GOLDEN, "subsurface_probe_wave.npz"))


def _scene(res=16, spp=4):
    return compile_api(make_subsurface_like(res, spp, small=True, device="cpu"))


def test_tables_equal_reference(small_treelets, probe):
    scene, _ = _scene()
    mat = scene.dev["mat"]
    for k in probe.files:
        if k.startswith("mat_"):
            np.testing.assert_array_equal(mat[k[4:]].numpy(), probe[k], err_msg=k)
    assert set(k for k in mat if k != "_fourier") == {k[4:] for k in probe.files
                                                      if k.startswith("mat_")}
    ft = mat["_fourier"]
    for f in ("mu", "cdf", "a", "offset", "m"):
        np.testing.assert_array_equal(getattr(ft, f).numpy(), probe[f"fourier_{f}"], err_msg=f)
    assert (ft.eta, ft.n_channels, ft.m_max) == (float(probe["fourier_eta"]),
                                                 int(probe["fourier_n_channels"]),
                                                 int(probe["fourier_m_max"]))
    for f in tbs.BakedBSSRDF._fields:
        np.testing.assert_array_equal(getattr(scene.dev["bssrdf"], f).numpy(),
                                      probe[f"bssrdf_{f}"], err_msg=f)
    # the subsurface and kdsubsurface rows: sub_id 0 and 1, typed
    # subsurface in the table (glass at the gather)
    np.testing.assert_array_equal(mat["sub_id"].numpy(), [-1, -1, 0, 1])


#: the captured wave's fields -> (rtol, atol), each about 4x what was
#: measured: the hit points differ from the reference's by up to 3.4e-6
#: (the reference's compiled tracer rounds the barycentric sums with fused
#: multiply-adds), and the exit's distance from the entry is 0.01-0.05, on
#: a profile Sr that falls like 1/r, so Sp and pdf_tot move by up to
#: 4.7e-3 / 4.0e-3 relative and the throughput, which carries w_sss =
#: Sp nFound / pdf_tot, by 2.0e-3; the cosine continuation's direction by
#: 5.0e-5 (its draw takes torch's sin, cos and square root near grazing)
PROBE_TOL = {"o": (0, 1e-5), "prev_p": (0, 1e-5), "sh_o": (0, 1e-5), "d": (0, 2e-4),
             "sh_d": (0, 5e-6), "L": (1e-3, 2e-5), "ld_pend": (1e-3, 2e-5), "sh_dist": (1e-6, 0),
             "beta": (1e-2, 0), "prev_pdf": (1e-4, 0), "sp": (2e-2, 0), "pdf_tot": (2e-2, 0)}


def test_probe_wave_matches_reference(small_treelets, probe, monkeypatch):
    """One bounce wave (bounce 0, the fused layout) on the reference's
    rays: the lanes' life, depth, specular flag, eta scale and ray counts
    equal the reference's; the exit vertex (prev_p), continuation (o, d),
    throughput, radiance, queued shadow rays, Sp at the exit and Pdf_Sp's
    sum within PROBE_TOL."""
    scene, integ = _scene()
    seen = {}
    sr_eval, pdf_sp = tbs.sr_eval, tbs.pdf_sp

    def rec_sr(*a):
        seen["sp"] = sr_eval(*a)
        return seen["sp"]

    def rec_pdf(*a):
        seen["pdf_tot"] = pdf_sp(*a)
        return seen["pdf_tot"]

    monkeypatch.setattr(tbs, "sr_eval", rec_sr)
    monkeypatch.setattr(tbs, "pdf_sp", rec_pdf)
    T = torch.from_numpy
    lane, nrays, _ = integ._bounce_wave(
        scene.dev, T(probe["px"]), T(probe["py"]), T(probe["s"]), 0,
        tpath.fresh_lanes(T(probe["o_in"].copy()), T(probe["d_in"].copy())),
        torch.zeros(probe["px"].shape, dtype=torch.int32))
    for f in ("alive", "specular", "depth", "eta_scale"):
        np.testing.assert_array_equal(getattr(lane, f).numpy(), probe[f"lane_{f}"], err_msg=f)
    np.testing.assert_array_equal(nrays.numpy(), probe["nrays"])
    for f, (rtol, atol) in PROBE_TOL.items():
        got = seen[f] if f in seen else getattr(lane, f)
        want = probe[f] if f in seen else probe[f"lane_{f}"]
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol, err_msg=f)
    # the wave really went through the probe: many lanes left their entry
    # point for an exit on the blob, with a throughput Sp nFound / pdf_tot
    moved = np.linalg.norm(probe["lane_prev_p"] - (probe["o_in"] + 0.0), axis=-1) > 0
    assert moved.sum() > 100 and lane.alive.sum() > 500


@pytest.mark.parametrize("name", sorted(GOLDEN_TOL))
def test_render_matches_golden(name, small_treelets, monkeypatch):
    regen = name.endswith("pool")
    monkeypatch.setattr(tcfg, "regen", regen)
    monkeypatch.setattr(tcfg, "pool", POOL if regen else 0)
    scene, integ = _scene()
    res = integ.render(scene)
    ref = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    assert scene.n_tris == int(ref["n_tris"]) == 2740
    assert scene.dev["tstream"].n_treelets == int(ref["n_treelets"])
    assert np.isfinite(res.image).all() and res.stats["n_drop"] == 0
    assert bool(res.stats.get("regen")) == regen
    if regen:
        assert res.stats["n_waves"] == int(ref["n_waves"])
    mse_bar, ray_bar = GOLDEN_TOL[name]
    assert abs(res.rays_traced - int(ref["rays_traced"])) <= ray_bar
    assert float(np.mean((res.image.astype(np.float64) - ref["image"]) ** 2)) <= mse_bar
    assert ref["image"].mean() > 0.05


def test_pool_equals_fixed_bit_for_bit(small_treelets, monkeypatch):
    """At 1 spp the pool's image equals the fixed batch's bit for bit
    (the probe wave's draws are pure functions of the sample and its
    depth, so a regenerated lane makes the fixed batch's choices)."""
    scene, integ = _scene(8, 1)
    out = {}
    for regen in (True, False):
        monkeypatch.setattr(tcfg, "regen", regen)
        out[regen] = integ.render(scene)
    assert out[True].stats["regen"] and out[True].rays_traced == out[False].rays_traced
    np.testing.assert_array_equal(out[True].image, out[False].image)


def test_no_probe_wave_without_subsurface(small_treelets, monkeypatch):
    """A scene without a subsurface row has no BSSRDF table, and the
    bounce wave never enters the probe."""
    from tpu_pbrt_torch.scenes import make_killeroo_like

    scene, integ = compile_api(make_killeroo_like(8, 1, n_theta=12, n_phi=24, device="cpu"))
    assert "bssrdf" not in scene.dev and "sub_id" not in scene.dev["mat"]

    def boom(*a, **k):
        raise AssertionError("probe wave entered")

    monkeypatch.setattr(tpath.PathIntegrator, "_probe_wave", boom)
    assert np.isfinite(integ.render(scene).image).all()


@pytest.mark.parametrize("with_tangent", [False, True])
def test_make_interaction_bit_equal_to_compiled_reference(with_tangent):
    """make_interaction in the port's default rounding against the
    reference's compiled on its own with jax.jit at the renders'
    optimisation level, on seeded hits of 500 random triangles: the
    geometric normal (the cross product's fused components), the shading
    normal (the fused three-term interpolation and norm), the shading
    frame (coordinate_system, or the hair tangent's projection with
    tri_tanT) and the packed ids equal the compiled reference's bit for
    bit. The hit point and uv interpolate as the camera hits of the
    reference's renders round them, fma(b2, v2, fma(b0, v0, b1 v1)): on
    its own the compiled function rounds the point's x and y as fma(b0,
    v0, b1 v1) + b2 v2 (the render's form is pinned by the small
    renders; ROADMAP Queue 3 item 14), so those are held within 2 ulp of
    the sum of their three terms' magnitudes."""
    import jax.numpy as jnp

    from tests.test_torch_xla_math import jit_ref
    from tpu_pbrt.accel.traverse import Hit as RefHit
    from tpu_pbrt.integrators import common as rc
    from tpu_pbrt_torch.accel.traverse import Hit
    from tpu_pbrt_torch.integrators import common as tc

    rng = np.random.default_rng(0)
    T, R = 500, 8192
    tv = (rng.normal(size=(T, 3, 3)) * 3).astype(np.float32)
    tn = rng.normal(size=(T, 3, 3)).astype(np.float32)
    tuv = rng.random(size=(T, 3, 2)).astype(np.float32)
    pack = (rng.integers(0, 5, T) * 4096 + rng.integers(-1, 3, T) + 1).astype(np.float32)
    dev = {"tri_verts": tv, "tri_sh16": np.concatenate(
        [tn.reshape(T, 9), tuv.reshape(T, 6), pack[:, None]], 1).T.copy()}
    if with_tangent:
        dev["tri_tanT"] = rng.normal(size=(3, T)).astype(np.float32)
    prim = rng.integers(-1, T, R).astype(np.int32)
    b0 = rng.random(R).astype(np.float32)
    b1 = (rng.random(R) * (1 - b0)).astype(np.float32)
    o, d = (rng.normal(size=(R, 3)).astype(np.float32) for _ in range(2))
    fields = ("p", "ng", "ns", "ss", "ts", "uv", "mat", "light")

    def ref(dev, prim, b0, b1, o, d):
        it = rc.make_interaction(dev, RefHit(jnp.zeros_like(b0), prim, b0, b1), o, d)
        return tuple(getattr(it, f) for f in fields)

    want = dict(zip(fields, (np.asarray(x) for x in jit_ref(ref)(dev, prim, b0, b1, o, d))))
    got = tc.make_interaction({k: torch.from_numpy(v) for k, v in dev.items()},
                              Hit(torch.zeros(R), *(torch.from_numpy(x) for x in (prim, b0, b1))),
                              torch.from_numpy(o), torch.from_numpy(d))
    for f in ("ng", "ns", "ss", "ts", "mat", "light"):
        g = getattr(got, f).numpy()
        w = want[f].astype(g.dtype)
        np.testing.assert_array_equal(g.view(np.int32) if g.dtype == np.float32 else g,
                                      w.view(np.int32) if w.dtype == np.float32 else w,
                                      err_msg=f)
    pr = np.maximum(prim, 0)
    b = np.stack([b0, b1, 1 - b0 - b1], -1)[..., None]
    for f, verts in (("p", tv[pr]), ("uv", tuv[pr])):
        scale = np.abs(b * verts).sum(axis=-2)
        err = np.abs(getattr(got, f).numpy().astype(np.float64) - want[f])
        assert (err <= 2 * np.spacing(scale.astype(np.float32))).all(), f
