"""BSSRDF subsurface transport (port of tpu_pbrt/core/bssrdf.py).

pbrt-v3's SeparableBSSRDF / TabulatedBSSRDF / ComputeBeamDiffusionBSSRDF /
SubsurfaceFromDiffuse (bssrdf.{h,cpp}) and the materials subsurface.cpp
and kdsubsurface.cpp, as the reference reduces them: sigma_a and sigma_s
are per-material constants, so the compiler bakes ONE radial profile per
(subsurface material, RGB channel) on the host (photon beam diffusion,
Habel, Christensen & Jarosz 2013: a 64-radius geometric grid with the
profile Sr(r), its normalized radial CDF, the effective albedo and the
0.999-quantile sampling radius). The host bake below is the reference's
numpy code, copied line for line, so the baked tables are bit-identical;
the device half (linear interpolation on a lane's grid row, CDF
inversion by a dense compare-and-sum over the 64 radii, the radial pdf,
the directional Sw term) is torch. The probe-ray machinery (the axis and
channel choice, the chords, Pdf_Sp) lives in integrators/path.py.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

#: radial samples per profile (bssrdf.cpp uses 64)
N_RADII = 64
#: depth samples of the beam integration (bssrdf.cpp nSamples = 100)
_N_DEPTH = 100


def fresnel_moment1(eta: float) -> float:
    """First angular moment of the Fresnel reflectance (bssrdf.cpp
    FresnelMoment1 — the d'Eon & Irving 2011 polynomial fits)."""
    e2, e3 = eta * eta, eta * eta * eta
    e4, e5 = e2 * e2, e2 * e3
    if eta < 1.0:
        return (
            0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
            + 2.49277 * e4 - 0.68441 * e5
        )
    return (
        -4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
        - 1.27198 * e4 + 0.12746 * e5
    )


def fresnel_moment2(eta: float) -> float:
    """Second Fresnel moment (bssrdf.cpp FresnelMoment2)."""
    e2, e3 = eta * eta, eta * eta * eta
    e4, e5 = e2 * e2, e2 * e3
    if eta < 1.0:
        return (
            0.27614 - 0.87350 * eta + 1.12077 * e2 - 0.65095 * e3
            - 0.07883 * e4 + 0.04860 * e5
        )
    r_1 = -547.033 + 45.3087 / e3 - 218.725 / e2 + 458.843 / eta
    r_1 += 404.557 * eta - 189.519 * e2 + 54.9327 * e3 - 9.00603 * e4
    r_1 += 0.63942 * e5
    return r_1


def _fr_dielectric(cos_i: np.ndarray, eta: float) -> np.ndarray:
    """Unpolarized Fresnel reflectance, numpy (host tables)."""
    cos_i = np.clip(cos_i, -1.0, 1.0)
    entering = cos_i > 0
    eta_i = np.where(entering, 1.0, eta)
    eta_t = np.where(entering, eta, 1.0)
    ci = np.abs(cos_i)
    sin_t2 = (eta_i / eta_t) ** 2 * np.maximum(0.0, 1.0 - ci * ci)
    tir = sin_t2 >= 1.0
    ct = np.sqrt(np.maximum(0.0, 1.0 - sin_t2))
    r_par = (eta_t * ci - eta_i * ct) / np.maximum(eta_t * ci + eta_i * ct, 1e-12)
    r_perp = (eta_i * ci - eta_t * ct) / np.maximum(eta_i * ci + eta_t * ct, 1e-12)
    return np.where(tir, 1.0, 0.5 * (r_par**2 + r_perp**2))


def beam_diffusion_ms(sigma_s: float, sigma_a: float, g: float, eta: float,
                      r: np.ndarray) -> np.ndarray:
    """Multiple-scattering radial profile Sr_ms(r) by photon-beam
    diffusion (bssrdf.cpp BeamDiffusionMS; Habel et al. 2013 eq. 5/11):
    average the classical-dipole diffusion response over _N_DEPTH
    exponentially-distributed beam depths, with Grosjean's
    non-classical diffusion coefficient and the extrapolated boundary
    from the Fresnel moments."""
    r = np.asarray(r, np.float64)
    sigma_t = sigma_a + sigma_s
    if sigma_t <= 0.0:
        return np.zeros_like(r)
    # similarity-reduced coefficients
    sigmap_s = sigma_s * (1.0 - g)
    sigmap_t = sigma_a + sigmap_s
    rhop = sigmap_s / sigmap_t
    # Grosjean's effective diffusion coefficient (non-classical)
    d_g = (2.0 * sigma_a + sigmap_s) / (3.0 * sigmap_t**2)
    sigma_tr = math.sqrt(sigma_a / d_g)
    # linear-extrapolation boundary depth from the Fresnel moments
    fm1, fm2 = fresnel_moment1(eta), fresnel_moment2(eta)
    ze = -2.0 * d_g * (1.0 + 3.0 * fm2) / (1.0 - 2.0 * fm1)
    # exitance scale factors (d'Eon & Irving's hybrid flux+fluence)
    c_phi = 0.25 * (1.0 - 2.0 * fm1)
    c_e = 0.5 * (1.0 - 3.0 * fm2)
    out = np.zeros_like(r)
    for i in range(_N_DEPTH):
        # real source depth sampled from the beam's transmittance
        zr = -math.log(1.0 - (i + 0.5) / _N_DEPTH) / sigmap_t
        # virtual source mirrored across the extrapolated boundary
        zv = -zr + 2.0 * ze
        dr = np.sqrt(r * r + zr * zr)
        dv = np.sqrt(r * r + zv * zv)
        phi_d = (np.exp(-sigma_tr * dr) / np.maximum(dr, 1e-9)
                 - np.exp(-sigma_tr * dv) / np.maximum(dv, 1e-9)) / (
            4.0 * math.pi * d_g
        )
        e_dn = (
            zr * (1.0 + sigma_tr * dr) * np.exp(-sigma_tr * dr)
            / np.maximum(dr, 1e-9) ** 3
            - zv * (1.0 + sigma_tr * dv) * np.exp(-sigma_tr * dv)
            / np.maximum(dv, 1e-9) ** 3
        ) / (4.0 * math.pi)
        # pbrt's source weighting: rhop^2 (one albedo factor for the
        # scattering event creating the source, one for the exitance
        # response) times the kappa correction of Habel et al. eq. 18
        # (suppresses the dipole's overestimate at source depths the
        # beam has not yet reached). Without both, the effective albedo
        # saturates near 0.5 instead of approaching 1 as rho' -> 1.
        kappa = 1.0 - np.exp(-2.0 * sigmap_t * (dr + zr))
        out += (c_phi * phi_d + c_e * e_dn) * kappa * (
            rhop * rhop / _N_DEPTH
        )
    return np.maximum(out, 0.0)


def beam_diffusion_ss(sigma_s: float, sigma_a: float, g: float, eta: float,
                      r: np.ndarray) -> np.ndarray:
    """Single-scattering radial profile (bssrdf.cpp BeamDiffusionSS):
    integrate the one-bounce HG response along the refracted beam,
    sampled at _N_DEPTH transmittance-distributed depths."""
    r = np.asarray(r, np.float64)
    sigma_t = sigma_a + sigma_s
    if sigma_t <= 0.0:
        return np.zeros_like(r)
    rho = sigma_s / sigma_t
    # critical depth: beyond t_crit the exit angle suffers TIR
    t_crit = r * math.sqrt(max(eta * eta - 1.0, 0.0))
    out = np.zeros_like(r)
    for i in range(_N_DEPTH):
        ti = t_crit - math.log(1.0 - (i + 0.5) / _N_DEPTH) / sigma_t
        d = np.sqrt(r * r + ti * ti)
        cos_o = ti / np.maximum(d, 1e-9)
        # HG phase at the single-scatter vertex (deflection from
        # straight-down beam to the exit direction)
        g2 = g * g
        denom = 1.0 + g2 + 2.0 * g * (-cos_o)
        phase = (1.0 - g2) / (4.0 * math.pi * np.maximum(denom, 1e-9) ** 1.5)
        # exit Fresnel at the inside-to-outside crossing: pbrt's
        # BeamDiffusionSS uses FrDielectric(-cosThetaO, 1, eta) — the
        # NEGATIVE cosine selects the eta->1 (exiting) branch. The
        # entering-side convention (+cos_o) overestimates transmission
        # near the critical angle (advisor finding, ISSUE 2 satellite)
        fr_exit = 1.0 - _fr_dielectric(-cos_o, eta)
        out += (
            rho
            * np.exp(-sigma_t * (d + t_crit))
            / np.maximum(d * d, 1e-12)
            * phase
            * fr_exit
            * cos_o
        ) / _N_DEPTH
    return np.maximum(out, 0.0)


class BakedBSSRDF(NamedTuple):
    """Per-scene device tables: one row per (subsurface material id,
    channel)."""

    radii: torch.Tensor    # (M, 3, N_RADII) radius grid (per-channel scale)
    profile: torch.Tensor  # (M, 3, N_RADII) Sr(r) (area density)
    cdf: torch.Tensor      # (M, 3, N_RADII) normalized radial CDF
    rho_eff: torch.Tensor  # (M, 3) total diffuse albedo of the profile
    r_max: torch.Tensor    # (M, 3) 0.999-quantile sampling radius
    eta: torch.Tensor      # (M,)


def radial_grid(sigma_t: float) -> np.ndarray:
    """bssrdf.cpp's radius samples (0, 2.5e-3, *1.2 geometric), scaled
    into physical units by the mean free path 1/sigma_t."""
    r = np.zeros(N_RADII)
    r[1] = 2.5e-3
    for i in range(2, N_RADII):
        r[i] = r[i - 1] * 1.2
    return r / max(sigma_t, 1e-9)


def bake_profile(sigma_s: float, sigma_a: float, g: float, eta: float):
    """One channel's (radii, profile, cdf, rho_eff, r_max). Profile is
    Sr(r) (per-area); the CDF integrates 2*pi*r*Sr piecewise linearly
    (trapezoid — documented deviation from pbrt's spline-exact
    IntegrateCatmullRom; the grid is geometric and dense where Sr
    varies, measured <1% albedo error on the test media)."""
    sigma_t = sigma_s + sigma_a
    radii = radial_grid(sigma_t)
    prof = beam_diffusion_ms(sigma_s, sigma_a, g, eta, radii) + \
        beam_diffusion_ss(sigma_s, sigma_a, g, eta, radii)
    integrand = 2.0 * math.pi * radii * prof
    seg = 0.5 * (integrand[1:] + integrand[:-1]) * np.diff(radii)
    cdf = np.concatenate([[0.0], np.cumsum(seg)])
    rho_eff = float(cdf[-1])
    if rho_eff > 0:
        cdf_n = cdf / rho_eff
    else:
        cdf_n = np.linspace(0.0, 1.0, N_RADII)
    r_max = float(np.interp(0.999, cdf_n, radii))
    return radii, prof, cdf_n, rho_eff, r_max


def effective_albedo_curve(g: float, eta: float, n: int = 48):
    """(rho_single[], rho_eff[]) for SubsurfaceFromDiffuse inversion:
    rho_eff is monotone in the single-scattering albedo. The rho grid
    uses pbrt's exponential spacing (bssrdf.cpp
    ComputeBeamDiffusionBSSRDF): coarse near 0 where the curve is flat,
    dense near 1 where it rises steeply toward rho_eff ~ 1 — a uniform
    grid there makes the linear inversion land ~0.1 off for bright
    diffuse colors."""
    i = np.arange(n, dtype=np.float64)
    rho_s = (1.0 - np.exp(-8.0 * i / (n - 1))) / (1.0 - math.exp(-8.0))
    rho_s = np.clip(rho_s, 1e-4, 0.9999)
    rho_e = np.empty(n)
    for k, rs in enumerate(rho_s):
        # unit sigma_t: profiles scale with mfp, albedo does not
        _, _, _, re, _ = bake_profile(rs, 1.0 - rs, g, eta)
        rho_e[k] = re
    return rho_s, np.maximum.accumulate(rho_e)


def subsurface_from_diffuse(kd: np.ndarray, mfp: np.ndarray, g: float,
                            eta: float):
    """kdsubsurface.cpp: invert the effective-albedo curve so the
    medium's diffusion profile integrates to the given diffuse color,
    with mean free path mfp per channel. Returns (sigma_s, sigma_a)."""
    rho_s_grid, rho_e_grid = effective_albedo_curve(g, eta)
    kd = np.clip(np.asarray(kd, np.float64), 0.0, 0.995)
    rho = np.interp(kd, rho_e_grid, rho_s_grid)
    sigma_t = 1.0 / np.maximum(np.asarray(mfp, np.float64), 1e-6)
    return rho * sigma_t, (1.0 - rho) * sigma_t


# -- device-side lookups ---------------------------------------------------


def _gather_last(a, idx):
    """a[..., idx] per lane (jnp.take_along_axis over the last axis)."""
    return torch.gather(a, -1, idx.long()[..., None])[..., 0]


def _interp_row(radii, values, r):
    """Linear interpolation of values(r) on a per-lane (..., N_RADII) grid
    pair; 0 outside the grid."""
    idx = (r[..., None] >= radii).to(torch.int32).sum(dim=-1, dtype=torch.int32) - 1
    i0 = torch.clamp(idx, 0, N_RADII - 2)
    r0 = _gather_last(radii, i0)
    r1 = _gather_last(radii, i0 + 1)
    v0 = _gather_last(values, i0)
    v1 = _gather_last(values, i0 + 1)
    t = torch.clamp((r - r0) / torch.clamp(r1 - r0, min=1e-20), 0.0, 1.0)
    v = v0 + t * (v1 - v0)
    inside = (r >= radii[..., 0]) & (r <= radii[..., -1])
    return torch.where(inside, v, torch.zeros_like(v))


def _rows(tab, mid):
    return mid.long().clamp(0, tab.radii.shape[0] - 1)


def _channel(t, ch):
    """t[lane, ch[lane], :] of an (R, 3, N) gather."""
    return torch.gather(t, 1, ch.long()[:, None, None].expand(-1, 1, t.shape[-1]))[:, 0, :]


def sr_eval(tab: BakedBSSRDF, mid, r):
    """Sp(r): the (R, 3) profile at distance r (R,) for material rows mid."""
    m = _rows(tab, mid)
    radii = tab.radii[m]  # (R, 3, N)
    prof = tab.profile[m]
    return torch.stack([_interp_row(radii[:, c], prof[:, c], r) for c in range(3)], dim=-1)


def sample_sr(tab: BakedBSSRDF, mid, ch, u):
    """The radius (R,) that inverts channel ch's radial CDF at u (R,), by a
    dense (R, N_RADII) compare-and-sum interval search."""
    m = _rows(tab, mid)
    radii = _channel(tab.radii[m], ch)  # (R, N)
    cdf = _channel(tab.cdf[m], ch)
    idx = (u[..., None] >= cdf).to(torch.int32).sum(dim=-1, dtype=torch.int32) - 1
    i0 = torch.clamp(idx, 0, N_RADII - 2)
    c0 = _gather_last(cdf, i0)
    c1 = _gather_last(cdf, i0 + 1)
    r0 = _gather_last(radii, i0)
    r1 = _gather_last(radii, i0 + 1)
    t = torch.clamp((u - c0) / torch.clamp(c1 - c0, min=1e-20), 0.0, 1.0)
    return r0 + t * (r1 - r0)


def pdf_sr(tab: BakedBSSRDF, mid, ch, r):
    """The radial sampling pdf per unit AREA of channel ch at radius r:
    Sr(r) / rho_eff (bssrdf.cpp Pdf_Sr's per-area form)."""
    m = _rows(tab, mid)
    radii = _channel(tab.radii[m], ch)
    prof = _channel(tab.profile[m], ch)
    rho = _gather_last(tab.rho_eff[m], ch)
    sr = _interp_row(radii, prof, r)
    return sr / torch.clamp(rho, min=1e-9)


def pdf_sp(tab: BakedBSSRDF, mid, ss, ts, ns, dvec, n_exit):
    """Pdf_Sp (bssrdf.cpp): the area density of an exit point at offset
    dvec (R, 3) from the entry, whose normal is n_exit, over the probe's
    3 axes (ss, ts: 1/4 each, ns: 1/2) x 3 channels (1/3 each), each
    axis's radius projected onto its plane and weighted by |cos| of the
    exit normal to the axis."""
    from tpu_pbrt_torch.core import xla_math as xm
    from tpu_pbrt_torch.core.vecmath import dot

    dl = [dot(dvec, ss), dot(dvec, ts), dot(dvec, ns)]
    nl = [dot(n_exit, ss), dot(n_exit, ts), dot(n_exit, ns)]
    rproj = [xm.sqrt(dl[1] * dl[1] + dl[2] * dl[2]), xm.sqrt(dl[2] * dl[2] + dl[0] * dl[0]),
             xm.sqrt(dl[0] * dl[0] + dl[1] * dl[1])]
    ax_prob = (0.25, 0.25, 0.5)
    pdf_tot = torch.zeros_like(dl[0])
    for a in range(3):
        for c in range(3):
            ch = torch.full_like(mid, c)
            pdf_tot = pdf_tot + pdf_sr(tab, mid, ch, rproj[a]) * torch.abs(nl[a]) * (ax_prob[a] / 3.0)
    return pdf_tot


def sw_eval(eta, cos_w):
    """The directional term Sw (bssrdf.h SeparableBSSRDF::Sw): the exit
    crossing's Fresnel transmittance normalized by c = 1 - 2 FM1(1/eta),
    so that the hemispherical integral of Sw cos is 1. The eta^2
    radiance-mode factor is not part of it (the integrator applies it at
    the exit vertex). Its Fresnel term takes the correctly rounded square
    root, as the reference's does."""
    from tpu_pbrt_torch.core import xla_math as xm
    from tpu_pbrt_torch.core.bxdf import fresnel_dielectric

    eta = torch.as_tensor(eta, dtype=torch.float32, device=cos_w.device)
    c = 1.0 - 2.0 * fresnel_moment1_torch(1.0 / eta)
    fr = fresnel_dielectric(torch.abs(cos_w), torch.ones_like(eta), eta)
    return (1.0 - fr) / (c * torch.full_like(c, float(np.float32(np.pi))))


def fresnel_moment1_torch(eta):
    """fresnel_moment1 on a tensor of eta (the reference's
    fresnel_moment1_jnp)."""
    e2, e3 = eta * eta, eta * eta * eta
    e4, e5 = e2 * e2, e2 * e3
    lo = (0.45966 - 1.73965 * eta + 3.37668 * e2 - 3.904945 * e3
          + 2.49277 * e4 - 0.68441 * e5)
    hi = (-4.61686 + 11.1136 * eta - 10.4646 * e2 + 5.11455 * e3
          - 1.27198 * e4 + 0.12746 * e5)
    return torch.where(eta < 1.0, lo, hi)
