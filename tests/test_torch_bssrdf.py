"""The port's BSSRDF module (tpu_pbrt_torch/core/bssrdf.py) against the
JAX package's (tpu_pbrt/core/bssrdf.py), and the reference's oracles of
tests/test_bssrdf.py (physical invariants) on the port.

Tolerances: the host bake (the Fresnel moments, beam_diffusion_ms / _ss,
bake_profile, effective_albedo_curve, subsurface_from_diffuse) is the
reference's numpy code and equal bit for bit; the device lookups
(sr_eval, sample_sr, pdf_sr, sw_eval) equal the reference bit for bit
on seeded inputs (the same f32 operations; sw_eval's Fresnel term takes
the correctly rounded square root, as XLA's does).
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_pbrt.core import bssrdf as jb
from tpu_pbrt_torch.core import bssrdf as tb
from tests.test_torch_xla_math import JitRef, assert_within_ulp, rounded_apart

torch.set_num_threads(1)

MEDIA = [(2.55, 0.0011, 0.0, 1.33), (0.8, 0.2, 0.3, 1.5), (0.6, 0.4, -0.2, 1.2),
         (1.09, 0.013, 0.0, 1.33)]


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("medium", MEDIA, ids=[f"m{i}" for i in range(len(MEDIA))])
def test_host_bake_equals_reference(medium):
    for a, b in zip(tb.bake_profile(*medium), jb.bake_profile(*medium)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    r = np.geomspace(1e-4, 3.0, 40)
    np.testing.assert_array_equal(tb.beam_diffusion_ms(*medium, r), jb.beam_diffusion_ms(*medium, r))
    np.testing.assert_array_equal(tb.beam_diffusion_ss(*medium, r), jb.beam_diffusion_ss(*medium, r))
    eta = medium[3]
    assert tb.fresnel_moment1(eta) == jb.fresnel_moment1(eta)
    assert tb.fresnel_moment2(eta) == jb.fresnel_moment2(eta)
    assert tb.fresnel_moment1(1.0 / eta) == jb.fresnel_moment1(1.0 / eta)


def test_albedo_inversion_equals_reference():
    for a, b in zip(tb.effective_albedo_curve(0.0, 1.33, n=8),
                    jb.effective_albedo_curve(0.0, 1.33, n=8)):
        np.testing.assert_array_equal(a, b)
    kd, mfp = np.array([0.8, 0.45, 0.3]), np.array([0.0006, 0.0004, 0.0003])
    for a, b in zip(tb.subsurface_from_diffuse(kd, mfp, 0.0, 1.33),
                    jb.subsurface_from_diffuse(kd, mfp, 0.0, 1.33)):
        np.testing.assert_array_equal(a, b)


def test_fresnel_moments_limits():
    assert abs(tb.fresnel_moment1(1.0)) < 5e-3
    assert tb.fresnel_moment1(1.5) > tb.fresnel_moment1(1.2) > 0.0


def test_profile_energy_conserved_and_monotone_in_albedo():
    rho_effs = []
    for rho in (0.2, 0.5, 0.8, 0.95):
        _, prof, cdf, rho_eff, r_max = tb.bake_profile(rho, 1.0 - rho, 0.0, 1.33)
        assert 0.0 < rho_eff < 1.0 and np.all(prof >= 0.0) and r_max > 0.0
        assert np.all(np.diff(cdf) >= -1e-12)
        rho_effs.append(rho_eff)
    assert np.all(np.diff(rho_effs) > 0) and rho_effs[-1] > 0.35


def test_subsurface_from_diffuse_round_trip():
    kd = np.array([0.2, 0.5, 0.7])
    sigma_s, sigma_a = tb.subsurface_from_diffuse(kd, np.ones(3), g=0.0, eta=1.33)
    for c in range(3):
        rho_eff = tb.bake_profile(float(sigma_s[c]), float(sigma_a[c]), 0.0, 1.33)[3]
        assert abs(rho_eff - kd[c]) < 0.05, (c, rho_eff, kd[c])


def _tables(media=MEDIA):
    """The same baked rows as the port's BakedBSSRDF and the reference's."""
    from tpu_pbrt_torch.scene.compiler import bake_bssrdf

    rows = [(np.array([m[0]] * 3), np.array([m[1]] * 3), m[2], m[3]) for m in media]
    host = bake_bssrdf(rows)
    port = tb.BakedBSSRDF(*(torch.from_numpy(a) for a in host))
    ref = jb.BakedBSSRDF(*(jnp.asarray(a) for a in host))
    return port, ref


@rounded_apart
def test_device_lookups_equal_reference():
    _check_device_lookups(jb)


def test_device_lookups_equal_reference_contracted():
    """The port's default rounding against the reference compiled at the
    renders' optimisation level. Compiled on their own, these functions
    fuse products that the port (and the renders' programs) round apart:
    the table lookups land within 2 ulp (sample_sr 1), sw_eval within 5,
    and FresnelMoment1's alternating polynomial, whose terms cancel to a
    result far smaller than they are, within 104; bounded at twice that."""
    _check_device_lookups(JitRef(jb), {"sample_sr": 2, "pdf_sr": 4, "sr_eval": 4,
                                       "sw_eval": 10, "fresnel_moment1": 208})


def _check_device_lookups(jb, ulp=None):
    """`ulp`: {function: bound} in units in the last place; None: bit for bit."""

    def same(got, want, what):
        if ulp is None:
            np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)
        else:
            assert_within_ulp(got, want, ulp[what], what)

    port, ref = _tables()
    rng = np.random.default_rng(3)
    n = 4096
    mid = rng.integers(0, len(MEDIA), n).astype(np.int32)
    ch = rng.integers(0, 3, n).astype(np.int32)
    u = rng.uniform(0, 1, n).astype(np.float32)
    rmax = np.asarray(ref.r_max)[mid, ch]
    r = (rng.uniform(0, 1.2, n) * rmax).astype(np.float32)
    T, J = torch.from_numpy, jnp.asarray
    same(tb.sample_sr(port, T(mid), T(ch), T(u)), jb.sample_sr(ref, J(mid), J(ch), J(u)),
         "sample_sr")
    same(tb.pdf_sr(port, T(mid), T(ch), T(r)), jb.pdf_sr(ref, J(mid), J(ch), J(r)), "pdf_sr")
    same(tb.sr_eval(port, T(mid), T(r)), jb.sr_eval(ref, J(mid), J(r)), "sr_eval")
    eta = np.asarray(ref.eta)[mid]
    cw = rng.uniform(-1, 1, n).astype(np.float32)
    same(tb.sw_eval(T(eta), T(cw)), jb.sw_eval(J(eta), J(cw)), "sw_eval")
    same(tb.fresnel_moment1_torch(T(eta)), jb.fresnel_moment1_jnp(J(eta)), "fresnel_moment1")


def test_sample_sr_matches_density():
    port, _ = _tables([(0.8, 0.2, 0.0, 1.33)])
    n = 4096
    u = torch.from_numpy(((np.arange(n) + 0.5) / n).astype(np.float32))
    z = torch.zeros(n, dtype=torch.int32)
    r_s = tb.sample_sr(port, z, z, u).numpy()
    radii = port.radii[0, 0].double().numpy()
    dens = 2.0 * np.pi * radii * port.profile[0, 0].double().numpy()
    trapz = getattr(np, "trapezoid", None) or np.trapz
    mean_q = trapz(radii * dens, radii) / trapz(dens, radii)
    assert abs(r_s.mean() - mean_q) / mean_q < 0.05, (r_s.mean(), mean_q)


def test_pdf_sr_and_sr_eval_read_the_table():
    port, _ = _tables([(0.6, 0.4, 0.0, 1.33)])
    radii = port.radii[0, 0]
    k = radii[5:50:7].shape[0]
    z = torch.zeros(k, dtype=torch.int32)
    got = tb.pdf_sr(port, z, z, radii[5:50:7]).numpy()
    want = port.profile[0, 0, 5:50:7].numpy() / float(port.rho_eff[0, 0])
    np.testing.assert_allclose(got, want, rtol=1e-3)
    z3 = torch.zeros(3, dtype=torch.int32)
    out = tb.sr_eval(port, z3, radii[[3, 10, 30]]).numpy()
    np.testing.assert_allclose(out, port.profile[0][:, [3, 10, 30]].T.numpy(), rtol=1e-3)


def test_sw_normalization():
    n = 20000
    cos_t = np.sqrt((np.arange(n) + 0.5) / n).astype(np.float32)
    sw = tb.sw_eval(torch.tensor(1.33), torch.from_numpy(cos_t)).numpy()
    assert abs(sw.mean() * np.pi - 1.0) < 0.02


def test_beam_diffusion_ss_exit_fresnel_convention():
    """The single-scatter profile takes the exiting Fresnel
    FrDielectric(-cos, 1, eta), as the reference's oracle requires."""
    sigma_s, sigma_a, g, eta = 0.8, 0.2, 0.3, 1.5
    r = np.geomspace(1e-3, 2.0, 24)

    def reference(exit_sign):
        sigma_t = sigma_a + sigma_s
        t_crit = r * math.sqrt(max(eta * eta - 1.0, 0.0))
        out = np.zeros_like(r)
        for i in range(tb._N_DEPTH):
            ti = t_crit - math.log(1.0 - (i + 0.5) / tb._N_DEPTH) / sigma_t
            d = np.sqrt(r * r + ti * ti)
            cos_o = ti / np.maximum(d, 1e-9)
            denom = 1.0 + g * g + 2.0 * g * (-cos_o)
            phase = (1.0 - g * g) / (4.0 * math.pi * np.maximum(denom, 1e-9) ** 1.5)
            fr_exit = 1.0 - tb._fr_dielectric(exit_sign * cos_o, eta)
            out += (sigma_s / sigma_t * np.exp(-sigma_t * (d + t_crit))
                    / np.maximum(d * d, 1e-12) * phase * fr_exit * cos_o) / tb._N_DEPTH
        return np.maximum(out, 0.0)

    np.testing.assert_allclose(tb.beam_diffusion_ss(sigma_s, sigma_a, g, eta, r), reference(-1.0),
                               rtol=1e-12)
    assert np.max(np.abs(reference(-1.0) - reference(+1.0))) > 1e-6
    ss = tb.beam_diffusion_ss(1.0, 0.1, 0.0, 1.5, np.geomspace(1e-3, 5.0, 40))
    assert np.all(np.isfinite(ss)) and np.all(ss >= 0.0) and ss[-1] < ss[0]


HOST_BAKE = ("fresnel_moment1", "fresnel_moment2", "_fr_dielectric", "beam_diffusion_ms",
             "beam_diffusion_ss", "radial_grid", "bake_profile", "effective_albedo_curve",
             "subsurface_from_diffuse")


def test_host_bake_is_the_reference_code():
    """The host bake is the reference's numpy code, function for function,
    line for line (so the tables it bakes stay the reference's)."""
    import ast
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def functions(path):
        src = open(path).read()
        return {n.name: ast.get_source_segment(src, n) for n in ast.parse(src).body
                if isinstance(n, ast.FunctionDef)}

    ours = functions(os.path.join(root, "tpu_pbrt_torch", "core", "bssrdf.py"))
    ref = functions(os.path.join(root, "tpu_pbrt", "core", "bssrdf.py"))
    for name in HOST_BAKE:
        assert ours[name] == ref[name], name
