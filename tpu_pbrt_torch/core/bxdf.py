"""BSDF evaluation and sampling (port of tpu_pbrt/core/bxdf.py).

Every ray carries its gathered material parameters (an SoA row) and the
whole batch evaluates a fixed set of lobe formulas under masks, as the
reference does: a diffuse lobe (Lambertian, or Oren-Nayar when
sigma > 0) and a glossy lobe (Trowbridge-Reitz / GGX microfacet
reflection with visible-normal sampling) per material, combined with
pbrt's matching-lobe pdf averaging; the specular materials (smooth
glass's Fresnel-weighted reflection or transmission, mirror) and rough
glass (microfacet reflection + transmission) override them per lane.
All directions are in the local shading frame (z = shading normal);
transmission carries the radiance-mode 1/eta^2 scale.

Ported: the lobes that matte, plastic, metal, glass (smooth and rough),
mirror, uber (Lambertian + dielectric-Fresnel GGX, as the reference
lowers it), substrate (FresnelBlend: Ashikhmin-Shirley diffuse and a
Schlick-weighted GGX lobe, half the samples cosine) and translucent (a
diffuse lobe split between reflection (kr) and transmission (kt) plus
the GGX reflection lobe) reach; mix lanes resolve to one sub-material
row before the gather (resolve_mix); the Beckmann distribution is here
as the reference keeps it. The scene compiler rejects the other
materials (disney, hair, fourier, subsurface), so the reference's
branches for them, which it gates on their parameters being present,
have no lane to serve here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_pbrt_torch.core.sampling import cosine_hemisphere_pdf, cosine_sample_hemisphere
from tpu_pbrt_torch.core.vecmath import (
    abs_cos_theta,
    cos2_theta,
    cos_phi,
    cos_theta,
    dot,
    face_forward,
    reflect,
    refract,
    same_hemisphere,
    sin2_theta,
    sin_phi,
    tan2_theta,
    tan_theta,
)

# material type enum (the reference's values)
MAT_NONE = 0
MAT_MATTE = 1
MAT_PLASTIC = 2
MAT_METAL = 3
MAT_GLASS = 4
MAT_MIRROR = 5
MAT_UBER = 6
MAT_SUBSTRATE = 7
MAT_TRANSLUCENT = 8

_INV_PI = 1.0 / np.pi

#: raw roughness above this makes glass a microfacet (non-delta) surface
#: (glass.cpp: rough glass builds MicrofacetReflection/Transmission)
ROUGH_GLASS_MIN = 1e-4


# -------------------------------------------------------------------------
# Fresnel (reflection.cpp FrDielectric / FrConductor)
# -------------------------------------------------------------------------

def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel; entering/exiting by the sign of cos_i."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(cos_i)
    sin_t = ei / et * torch.sqrt(torch.clamp(1.0 - ci * ci, min=0.0))
    tir = sin_t >= 1.0
    ct = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=0.0))
    r_parl = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-20)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-20)
    fr = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


def fresnel_conductor(cos_i, eta, k):
    """reflection.cpp FrConductor, per channel (eta, k: (..., 3))."""
    ci = torch.clamp(torch.abs(cos_i), 0.0, 1.0)[..., None]
    c2 = ci * ci
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * e2 * k2, min=0.0))
    t1 = a2b2 + c2
    a = torch.sqrt(torch.clamp(0.5 * (a2b2 + t0), min=0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-20)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / torch.clamp(t3 + t4, min=1e-20)
    return 0.5 * (rp + rs)


# -------------------------------------------------------------------------
# Trowbridge-Reitz / GGX microfacet distribution (microfacet.cpp)
# -------------------------------------------------------------------------

# -------------------------------------------------------------------------
# Beckmann distribution (microfacet.cpp BeckmannDistribution): D, Lambda
# and the full-distribution half-vector sampling (the !sampleVisibleArea
# branch, exact for isotropic and anisotropic alphas)
# -------------------------------------------------------------------------

def beckmann_d(wh, ax, ay):
    t2 = tan2_theta(wh)
    c2 = cos2_theta(wh)
    c4 = c2 * c2
    cp, sp = cos_phi(wh), sin_phi(wh)
    e = torch.exp(-t2 * (cp * cp / torch.clamp(ax * ax, min=1e-12)
                         + sp * sp / torch.clamp(ay * ay, min=1e-12)))
    d = e / (torch.pi * ax * ay * torch.clamp(c4, min=1e-16))
    return torch.where(torch.isfinite(t2) & (c4 > 1e-16), d, 0.0)


def beckmann_lambda(w, ax, ay):
    abs_tan = torch.abs(tan_theta(w))
    cp, sp = cos_phi(w), sin_phi(w)
    alpha = torch.sqrt(cp * cp * ax * ax + sp * sp * ay * ay)
    a = 1.0 / torch.clamp(alpha * abs_tan, min=1e-12)
    lam = (1.0 - 1.259 * a + 0.396 * a * a) / (3.535 * a + 2.181 * a * a)
    return torch.where(torch.isfinite(abs_tan) & (a < 1.6), lam, 0.0)


def beckmann_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + beckmann_lambda(wo, ax, ay) + beckmann_lambda(wi, ax, ay))


def beckmann_sample_wh(u1, u2, ax, ay):
    """Full-distribution Beckmann Sample_wh: tan2 = -a^2 log(1 - u1) with
    the per-phi alpha of the anisotropic case."""
    log_u = torch.log(torch.clamp(1.0 - u1, min=1e-12))
    phi = torch.atan(ay / ax * torch.tan(2.0 * torch.pi * u2 + 0.5 * torch.pi))
    phi = phi + torch.where(u2 > 0.5, torch.pi, 0.0)
    sp, cp = torch.sin(phi), torch.cos(phi)
    a2 = 1.0 / torch.clamp(cp * cp / torch.clamp(ax * ax, min=1e-12)
                           + sp * sp / torch.clamp(ay * ay, min=1e-12), min=1e-12)
    tan2 = -log_u * a2
    ct = 1.0 / torch.sqrt(1.0 + tan2)
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    return torch.stack([st * cp, st * sp, ct], dim=-1)


def beckmann_pdf(wh, ax, ay):
    """pdf of wh under full-distribution sampling: D(wh) |cos wh|."""
    return beckmann_d(wh, ax, ay) * abs_cos_theta(wh)


def tr_roughness_to_alpha(rough):
    """TrowbridgeReitzDistribution::RoughnessToAlpha."""
    x = torch.log(torch.clamp(rough, min=1e-3))
    return (1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x * x * x
            + 0.000640711 * x * x * x * x)


def tr_d(wh, ax, ay):
    t2 = tan2_theta(wh)
    c2 = cos2_theta(wh)
    c4 = c2 * c2
    cp, sp = cos_phi(wh), sin_phi(wh)
    e = (cp * cp / torch.clamp(ax * ax, min=1e-12) + sp * sp / torch.clamp(ay * ay, min=1e-12)) * t2
    e1 = 1.0 + e
    d = 1.0 / (torch.pi * ax * ay * c4 * (e1 * e1))
    return torch.where(torch.isfinite(t2) & (c4 > 1e-16), d, 0.0)


def tr_lambda(w, ax, ay):
    abs_tan = torch.abs(tan_theta(w))
    cp, sp = cos_phi(w), sin_phi(w)
    alpha = torch.sqrt(cp * cp * ax * ax + sp * sp * ay * ay)
    at = alpha * abs_tan
    lam = (-1.0 + torch.sqrt(1.0 + at * at)) / 2.0
    return torch.where(torch.isfinite(abs_tan), lam, 0.0)


def tr_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay))


def tr_g1(w, ax, ay):
    return 1.0 / (1.0 + tr_lambda(w, ax, ay))


def _tr_sample11(cos_t, u1, u2):
    """TrowbridgeReitzSample11: slopes for visible-normal sampling."""
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    tan_t = sin_t / torch.clamp(cos_t, min=1e-7)
    a = 1.0 / torch.clamp(tan_t, min=1e-12)
    g1 = 2.0 / (1.0 + torch.sqrt(1.0 + 1.0 / torch.clamp(a * a, min=1e-20)))

    # pbrt's TrowbridgeReitzSample11 as written: tmp = 1/(A^2 - 1) is
    # NEGATIVE for |A| < 1, and that sign is load-bearing (negated, every
    # u1 < 0.5 sample would collapse onto the horizon)
    A = 2.0 * u1 / torch.clamp(g1, min=1e-12) - 1.0
    denom = A * A - 1.0
    tiny = torch.where(denom < 0, -1e-12, 1e-12)
    tmp = 1.0 / torch.where(torch.abs(denom) < 1e-12, tiny, denom)
    tmp = torch.clamp(tmp, max=1e10)
    B = tan_t
    D = torch.sqrt(torch.clamp(B * B * tmp * tmp - (A * A - B * B) * tmp, min=0.0))
    slope_x_1 = B * tmp - D
    slope_x_2 = B * tmp + D
    slope_x = torch.where((A < 0) | (slope_x_2 > 1.0 / torch.clamp(tan_t, min=1e-12)),
                          slope_x_1, slope_x_2)

    S = torch.where(u2 > 0.5, 1.0, -1.0)
    u2r = torch.where(u2 > 0.5, 2.0 * (u2 - 0.5), 2.0 * (0.5 - u2))
    z = (u2r * (u2r * (u2r * 0.27385 - 0.73369) + 0.46341)) / (
        u2r * (u2r * (u2r * 0.093073 + 0.309420) - 1.000000) + 0.597999
    )
    slope_y = S * z * torch.sqrt(1.0 + slope_x * slope_x)

    # normal incidence
    r = torch.sqrt(torch.clamp(u1 / torch.clamp(1.0 - u1, min=1e-12), min=0.0))
    phi = 6.28318530718 * u2
    ni = cos_t > 0.9999
    slope_x = torch.where(ni, r * torch.cos(phi), slope_x)
    slope_y = torch.where(ni, r * torch.sin(phi), slope_y)
    return slope_x, slope_y


def tr_sample_wh(wo, u1, u2, ax, ay):
    """Visible-normal sampling (TrowbridgeReitzDistribution::Sample_wh)."""
    flip = cos_theta(wo) < 0.0
    wo_f = torch.where(flip[..., None], -wo, wo)
    wi_s = torch.stack([ax * wo_f[..., 0], ay * wo_f[..., 1], wo_f[..., 2]], dim=-1)
    ln = torch.sqrt(dot(wi_s, wi_s))
    wi_s = wi_s / torch.clamp(ln[..., None], min=1e-20)
    ct = torch.clamp(wi_s[..., 2], -1.0, 1.0)
    s_len = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    small = s_len < 1e-7
    cphi = torch.where(small, 1.0, wi_s[..., 0] / torch.clamp(s_len, min=1e-12))
    sphi = torch.where(small, 0.0, wi_s[..., 1] / torch.clamp(s_len, min=1e-12))
    sx, sy = _tr_sample11(ct, u1, u2)
    # rotate, then unstretch
    tmp = cphi * sx - sphi * sy
    sy = sphi * sx + cphi * sy
    sx = tmp * ax
    sy = sy * ay
    wh = torch.stack([-sx, -sy, torch.ones_like(sx)], dim=-1)
    wh = wh / torch.sqrt(dot(wh, wh))[..., None]
    return torch.where(flip[..., None], -wh, wh)


def tr_pdf(wo, wh, ax, ay):
    """pdf of wh under visible-normal sampling."""
    return (tr_d(wh, ax, ay) * tr_g1(wo, ax, ay) * torch.abs(dot(wo, wh))
            / torch.clamp(abs_cos_theta(wo), min=1e-12))


# -------------------------------------------------------------------------
# Material parameter gather
# -------------------------------------------------------------------------

class MatParams(NamedTuple):
    mtype: torch.Tensor  # (R,) i32
    kd: torch.Tensor  # (R,3)
    ks: torch.Tensor
    kr: torch.Tensor
    kt: torch.Tensor
    eta: torch.Tensor  # (R,3)
    k: torch.Tensor
    ax: torch.Tensor  # (R,) GGX alphas (after the remap)
    ay: torch.Tensor
    sigma: torch.Tensor  # (R,) Oren-Nayar sigma (degrees)
    opacity: torch.Tensor  # (R,3)
    rough_raw: torch.Tensor  # (R,) raw roughness (max of u, v); 0 = smooth


#: the material table's columns (lower_materials builds them), and the
#: mix columns it adds when a scene has a mix material
MAT_COLUMNS = ("type", "kd", "ks", "kr", "kt", "eta", "k", "rough_u", "rough_v", "sigma",
               "opacity", "remap", "kd_tex", "ks_tex", "sigma_tex", "rough_tex", "opacity_tex",
               "bump_tex")
MIX_COLUMNS = ("mix_a", "mix_b", "mix_amt")


def _take(table, idx):
    """table[idx] with idx clamped to the table, as the reference's
    small-table select clamps."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def resolve_mix(mat: dict, mid, u):
    """MixMaterial (mixmat.cpp) resolution: map a mix lane to ONE of its
    sub-material rows with probability `amount` before the parameter
    gather, the one-sample estimator of pbrt's scaled BSDF union. A no-op
    for mix-free scenes (no mix columns) or without a draw. Nested mixes
    resolve through a static 4-level loop; u is rescaled within the
    picked branch (clipped to 0.9999999) so the levels stay independent."""
    if "mix_a" not in mat or u is None:
        return mid
    for _ in range(4):
        ma = _take(mat["mix_a"], mid)
        mb = _take(mat["mix_b"], mid)
        amt = _take(mat["mix_amt"], mid)
        is_mix = ma >= 0
        pick_a = u < amt
        mid = torch.where(is_mix & pick_a, ma, torch.where(is_mix, mb, mid))
        u = torch.clamp(
            torch.where(pick_a, u / torch.clamp(amt, min=1e-8),
                        (u - amt) / torch.clamp(1.0 - amt, min=1e-8)),
            0.0, 0.9999999)
    return mid


def gather_mat(mat: dict, mid) -> MatParams:
    """Material rows for material ids mid, clamped to the table as the
    reference's small-table select clamps, with the roughness remap."""
    n = mat["type"].shape[0]
    idx = mid.long().clamp(0, n - 1)
    remap = mat["remap"][idx]
    ru = mat["rough_u"][idx]
    rv = mat["rough_v"][idx]
    ax = torch.where(remap > 0, tr_roughness_to_alpha(ru), torch.clamp(ru, min=1e-3))
    ay = torch.where(remap > 0, tr_roughness_to_alpha(rv), torch.clamp(rv, min=1e-3))
    return MatParams(
        mtype=mat["type"][idx], kd=mat["kd"][idx], ks=mat["ks"][idx], kr=mat["kr"][idx],
        kt=mat["kt"][idx], eta=mat["eta"][idx], k=mat["k"][idx], ax=ax, ay=ay,
        sigma=mat["sigma"][idx], opacity=mat["opacity"][idx],
        # glass.cpp turns the microfacet lobes on when EITHER axis is rough
        rough_raw=torch.maximum(ru, rv),
    )


def _is_rough_glass(mp: MatParams):
    return (mp.mtype == MAT_GLASS) & (mp.rough_raw > ROUGH_GLASS_MIN)


def _lobe_flags(mp: MatParams):
    """(has_diffuse, has_glossy, is_specular_lobe). Rough glass counts as
    glossy: bsdf_eval/bsdf_sample override its lanes wholesale."""
    t = mp.mtype
    rg = _is_rough_glass(mp)
    diffuse = (t == MAT_MATTE) | (t == MAT_PLASTIC) | (t == MAT_UBER) | (t == MAT_TRANSLUCENT)
    glossy = (t == MAT_PLASTIC) | (t == MAT_METAL) | (t == MAT_UBER) | (t == MAT_SUBSTRATE) | rg
    specular = ((t == MAT_GLASS) & ~rg) | (t == MAT_MIRROR)
    return diffuse, glossy, specular


# -------------------------------------------------------------------------
# Lobe formulas (batched, local frame)
# -------------------------------------------------------------------------

def _diffuse_f(mp: MatParams, wo, wi):
    """Lambertian or Oren-Nayar by sigma on the reflection hemisphere;
    translucent scales it by kr there and transmits kd kt / pi."""
    refl = same_hemisphere(wo, wi)
    sigma = torch.deg2rad(mp.sigma)
    s2 = sigma * sigma
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)
    sin_to = torch.sqrt(sin2_theta(wo))
    sin_ti = torch.sqrt(sin2_theta(wi))
    cos_dphi = cos_phi(wi) * cos_phi(wo) + sin_phi(wi) * sin_phi(wo)
    max_cos = torch.clamp(cos_dphi, min=0.0)
    has_sin = (sin_to > 1e-4) & (sin_ti > 1e-4)
    max_cos = torch.where(has_sin, max_cos, 0.0)
    abs_ci = abs_cos_theta(wi)
    abs_co = abs_cos_theta(wo)
    sin_alpha = torch.where(abs_ci > abs_co, sin_to, sin_ti)
    tan_beta = torch.where(
        abs_ci > abs_co,
        sin_ti / torch.clamp(abs_ci, min=1e-7),
        sin_to / torch.clamp(abs_co, min=1e-7),
    )
    on = a + b * max_cos * sin_alpha * tan_beta
    base = torch.where(mp.sigma > 0.0, on, 1.0)
    transl = (mp.mtype == MAT_TRANSLUCENT)[..., None]
    trans_scale = torch.where(transl, mp.kt, torch.zeros_like(mp.kt))
    refl_scale = torch.where(transl, mp.kr, torch.ones_like(mp.kr))
    f_refl = mp.kd * (_INV_PI * base)[..., None] * refl_scale
    f_trans = mp.kd * _INV_PI * trans_scale
    return torch.where(refl[..., None], f_refl, f_trans)


def _diffuse_pdf(mp: MatParams, wo, wi):
    refl = same_hemisphere(wo, wi)
    pdf_r = cosine_hemisphere_pdf(abs_cos_theta(wi))
    # translucent splits the cosine pdf across both hemispheres
    transl = mp.mtype == MAT_TRANSLUCENT
    half = 0.5 * pdf_r
    return torch.where(refl, torch.where(transl, half, pdf_r),
                       torch.where(transl, half, torch.zeros_like(pdf_r)))


def _glossy_f(mp: MatParams, wo, wi):
    """Microfacet reflection lobe: the conductor Fresnel for metal, the
    dielectric one (scaled by ks) otherwise; FresnelBlend for substrate."""
    refl = same_hemisphere(wo, wi)
    wh = wi + wo
    wh_len = torch.sqrt(dot(wh, wh))
    valid = refl & (wh_len > 1e-12) & (abs_cos_theta(wi) > 1e-7) & (abs_cos_theta(wo) > 1e-7)
    wh = wh / torch.clamp(wh_len[..., None], min=1e-20)
    d = tr_d(wh, mp.ax, mp.ay)
    g = tr_g(wo, wi, mp.ax, mp.ay)
    cos_wh = dot(wi, wh)
    is_metal = mp.mtype == MAT_METAL
    eta_s = mp.eta[..., 0]
    f_cond = fresnel_conductor(cos_wh, mp.eta, mp.k)
    f_diel = fresnel_dielectric(cos_wh, torch.ones_like(eta_s), eta_s)[..., None]
    F = torch.where(is_metal[..., None], f_cond, f_diel)
    scale = torch.where(is_metal[..., None], torch.ones_like(mp.ks), mp.ks)
    denom = 4.0 * abs_cos_theta(wi) * abs_cos_theta(wo)
    f_mf = scale * F * (d * g / torch.clamp(denom, min=1e-12))[..., None]

    # FresnelBlend (substrate): Ashikhmin-Shirley diffuse + specular
    is_sub = mp.mtype == MAT_SUBSTRATE

    def pow5(v):
        return (v * v) * (v * v) * v

    ci, co = abs_cos_theta(wi), abs_cos_theta(wo)
    diff = ((28.0 / (23.0 * np.pi)) * mp.kd * (1.0 - mp.ks)
            * (1.0 - pow5(1.0 - 0.5 * ci))[..., None]
            * (1.0 - pow5(1.0 - 0.5 * co))[..., None])
    schlick = mp.ks + pow5(1.0 - cos_wh)[..., None] * (1.0 - mp.ks)
    spec = (d / torch.clamp(4.0 * torch.abs(cos_wh) * torch.maximum(ci, co), min=1e-12)
            )[..., None] * schlick
    f = torch.where(is_sub[..., None], diff + spec, f_mf)
    return torch.where(valid[..., None], f, 0.0)


def _glossy_pdf(mp: MatParams, wo, wi):
    refl = same_hemisphere(wo, wi)
    wh = wi + wo
    wh_len = torch.sqrt(dot(wh, wh))
    wh = wh / torch.clamp(wh_len[..., None], min=1e-20)
    pdf_wh = tr_pdf(wo, wh, mp.ax, mp.ay)
    pdf = pdf_wh / torch.clamp(4.0 * dot(wo, wh), min=1e-12)
    # FresnelBlend's pdf: the mean of the cosine and half-vector pdfs
    pdf_sub = 0.5 * (cosine_hemisphere_pdf(abs_cos_theta(wi)) + pdf)
    pdf = torch.where(mp.mtype == MAT_SUBSTRATE, pdf_sub, pdf)
    return torch.where(refl & (wh_len > 1e-12), pdf, 0.0)


def _refract_about(wo, wh, eta_rel):
    """Refract wo about the microfacet normal wh (faced toward wo);
    eta_rel = eta_incident / eta_transmitted. Returns (wi, tir)."""
    return refract(wo, face_forward(wh, wo), eta_rel)


def _mf_glass_terms(mp: MatParams, wo, wi, wh):
    """MicrofacetReflection + MicrofacetTransmission (reflection.cpp f/Pdf)
    at an explicit half-vector, shared by bsdf_eval (reconstructed wh) and
    bsdf_sample (the drawn wh) so their MIS pdfs agree. wh is faced to +z
    here; pdfs carry pbrt's uniform 2-lobe weight (0.5 each); transmission
    carries the radiance-mode 1/eta^2.
    Returns (f_refl, pdf_refl, ok_refl, f_trans, pdf_trans, ok_trans)."""
    eta_s = mp.eta[..., 0]
    refl = same_hemisphere(wo, wi)
    ci = abs_cos_theta(wi)
    co = abs_cos_theta(wo)
    ok_angles = (ci > 1e-7) & (co > 1e-7)
    wh_z = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    do_h = dot(wo, wh_z)
    di_h = dot(wi, wh_z)
    d = tr_d(wh_z, mp.ax, mp.ay)
    g = tr_g(wo, wi, mp.ax, mp.ay)
    pdf_wh = tr_pdf(wo, wh_z, mp.ax, mp.ay)
    F = fresnel_dielectric(do_h, torch.ones_like(eta_s), eta_s)

    f_refl = mp.kr * (d * g * F / torch.clamp(4.0 * ci * co, min=1e-12))[..., None]
    pdf_refl = 0.5 * pdf_wh / torch.clamp(4.0 * torch.abs(do_h), min=1e-12)
    ok_refl = refl & ok_angles

    # eta = eta_t / eta_i of the transmitted side (MicrofacetTransmission)
    eta_t = torch.where(cos_theta(wo) > 0.0, eta_s, 1.0 / torch.clamp(eta_s, min=1e-6))
    sqrt_denom = do_h + eta_t * di_h
    factor = 1.0 / torch.clamp(eta_t, min=1e-6)  # radiance transport scale
    f_trans = mp.kt * torch.abs(
        d * g * eta_t * eta_t * (1.0 - F) * torch.abs(di_h) * torch.abs(do_h)
        * factor * factor
        / torch.clamp(ci * co * sqrt_denom * sqrt_denom, min=1e-12)
    )[..., None]
    dwh_dwi = torch.abs(eta_t * eta_t * di_h) / torch.clamp(sqrt_denom * sqrt_denom, min=1e-12)
    pdf_trans = 0.5 * pdf_wh * dwh_dwi
    ok_trans = (~refl) & ok_angles & (do_h * di_h < 0.0)
    return f_refl, pdf_refl, ok_refl, f_trans, pdf_trans, ok_trans


def _rough_glass_f_pdf(mp: MatParams, wo, wi):
    """Rough glass's f and pdf for a given (wo, wi): each lobe's
    half-vector is reconstructed (wo + wi for reflection, the generalized
    wo + eta wi for transmission) and the shared terms evaluated there."""
    eta_s = mp.eta[..., 0]
    wh_r = wi + wo
    whr_len = torch.sqrt(dot(wh_r, wh_r))
    wh_rn = wh_r / torch.clamp(whr_len[..., None], min=1e-20)
    f_r, p_r, ok_r, _, _, _ = _mf_glass_terms(mp, wo, wi, wh_rn)
    ok_r = ok_r & (whr_len > 1e-12)

    eta_t = torch.where(cos_theta(wo) > 0.0, eta_s, 1.0 / torch.clamp(eta_s, min=1e-6))
    wh_t = wo + wi * eta_t[..., None]
    wht_len = torch.sqrt(dot(wh_t, wh_t))
    wh_tn = wh_t / torch.clamp(wht_len[..., None], min=1e-20)
    _, _, _, f_t, p_t, ok_t = _mf_glass_terms(mp, wo, wi, wh_tn)
    ok_t = ok_t & (wht_len > 1e-12)

    f = torch.where(ok_r[..., None], f_r, 0.0) + torch.where(ok_t[..., None], f_t, 0.0)
    pdf = torch.where(ok_r, p_r, 0.0) + torch.where(ok_t, p_t, 0.0)
    return f, pdf


# -------------------------------------------------------------------------
# Public API
# -------------------------------------------------------------------------

def bsdf_eval(mp: MatParams, wo, wi):
    """f(wo, wi) and pdf of the non-specular lobes (pbrt BSDF::f / Pdf with
    BSDF_ALL & ~SPECULAR: specular lobes contribute zero)."""
    has_d, has_g, is_spec = _lobe_flags(mp)
    fd = _diffuse_f(mp, wo, wi)
    pd = _diffuse_pdf(mp, wo, wi)
    fg = _glossy_f(mp, wo, wi)
    pg = _glossy_pdf(mp, wo, wi)
    f = torch.where(has_d[..., None], fd, 0.0) + torch.where(has_g[..., None], fg, 0.0)
    n_lobes = has_d.to(torch.float32) + has_g.to(torch.float32)
    pdf = ((torch.where(has_d, pd, 0.0) + torch.where(has_g, pg, 0.0))
           / torch.clamp(n_lobes, min=1.0))
    # rough (microfacet) glass is a real non-delta BSDF (glass.cpp)
    rg = _is_rough_glass(mp)
    f_rg, pdf_rg = _rough_glass_f_pdf(mp, wo, wi)
    f = torch.where(rg[..., None], f_rg, f)
    pdf = torch.where(rg, pdf_rg, pdf)
    dead = (is_spec & ~rg) | (mp.mtype == MAT_NONE)
    return torch.where(dead[..., None], 0.0, f), torch.where(dead, 0.0, pdf)


class BSDFSample(NamedTuple):
    wi: torch.Tensor  # (R,3) local frame
    f: torch.Tensor  # (R,3)
    pdf: torch.Tensor  # (R,)
    is_specular: torch.Tensor  # (R,) bool
    is_transmission: torch.Tensor  # (R,) bool


def bsdf_sample(mp: MatParams, wo, u_lobe, u1, u2) -> BSDFSample:
    """BSDF::Sample_f over the batch: u_lobe picks among the matching
    lobes (pbrt's uniform component choice), u1, u2 drive the chosen one."""
    has_d, has_g, _ = _lobe_flags(mp)
    n_lobes = has_d.to(torch.int32) + has_g.to(torch.int32)
    pick_g = has_g & ((~has_d) | (u_lobe * n_lobes.to(torch.float32) >= 1.0))
    flip_z = torch.tensor([1.0, 1.0, -1.0], dtype=wo.dtype, device=wo.device)

    # --- diffuse candidate (cosine hemisphere on wo's side) ---------------
    # translucent: u2's lower half picks transmission, and u2 is remapped
    # to [0, 1) so the pick and the disk coordinate stay independent
    is_transl = mp.mtype == MAT_TRANSLUCENT
    low = u2 < 0.5
    flip_t = is_transl & low
    u2d = torch.where(is_transl, torch.where(low, 2.0 * u2, 2.0 * (u2 - 0.5)), u2)
    wi_d = cosine_sample_hemisphere(u1, u2d)
    wi_d = torch.where((cos_theta(wo) < 0.0)[..., None], wi_d * flip_z, wi_d)
    wi_d = torch.where(flip_t[..., None], wi_d * flip_z, wi_d)
    # --- glossy candidate (VNDF half-vector) ------------------------------
    wh = tr_sample_wh(wo, u1, u2, mp.ax, mp.ay)
    wi_g = reflect(wo, wh)
    # substrate: half the samples are cosine (FresnelBlend::Sample_f)
    use_cos = (mp.mtype == MAT_SUBSTRATE) & (u_lobe < 0.5)
    wi_g = torch.where(use_cos[..., None], wi_d, wi_g)
    wi = torch.where(pick_g[..., None], wi_g, wi_d)

    # --- combined f/pdf over the matching non-specular lobes -------------
    f_ns, pdf_ns = bsdf_eval(mp, wo, wi)

    # --- specular materials ---------------------------------------------
    eta_s = mp.eta[..., 0]
    ct_o = cos_theta(wo)
    F = fresnel_dielectric(ct_o, torch.ones_like(eta_s), eta_s)
    is_glass = mp.mtype == MAT_GLASS
    is_mirror = mp.mtype == MAT_MIRROR
    # mirror: perfect reflection, FresnelNoOp
    wi_mirror = torch.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], dim=-1)
    f_mirror = mp.kr / torch.clamp(abs_cos_theta(wi_mirror), min=1e-12)[..., None]
    # glass: reflect or refract by Fresnel, chosen with u_lobe
    reflect_g = u_lobe < F
    entering = ct_o > 0.0
    one = torch.ones_like(ct_o)
    ei = torch.where(entering, one, eta_s)
    et = torch.where(entering, eta_s, one)
    eta_rel = ei / et
    n_loc = torch.stack([torch.zeros_like(ct_o), torch.zeros_like(ct_o),
                         torch.where(entering, one, -one)], dim=-1)
    ci = torch.abs(ct_o)
    sin2_t = eta_rel * eta_rel * torch.clamp(1.0 - ci * ci, min=0.0)
    ct_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wi_refr = eta_rel[..., None] * -wo + (eta_rel * ci - ct_t)[..., None] * n_loc
    f_refl_g = (F / torch.clamp(abs_cos_theta(wi_mirror), min=1e-12))[..., None] * mp.kr
    # radiance transport: the (ei/et)^2 factor
    er = ei / et
    f_trans_g = ((1.0 - F) * (er * er) / torch.clamp(torch.abs(ct_t), min=1e-12))[..., None] * mp.kt
    wi_glass = torch.where(reflect_g[..., None], wi_mirror, wi_refr)
    f_glass = torch.where(reflect_g[..., None], f_refl_g, f_trans_g)
    pdf_glass = torch.where(reflect_g, F, 1.0 - F)

    wi = torch.where(is_mirror[..., None], wi_mirror, wi)
    wi = torch.where(is_glass[..., None], wi_glass, wi)
    f = torch.where(is_mirror[..., None], f_mirror, f_ns)
    f = torch.where(is_glass[..., None], f_glass, f)
    pdf = torch.where(is_mirror, 1.0, pdf_ns)
    pdf = torch.where(is_glass, pdf_glass, pdf)

    # --- rough (microfacet) glass overrides the delta-glass pick ----------
    # f/pdf come from the SAMPLED half-vector (pbrt Microfacet*::Sample_f):
    # reconstructing wh from wi breaks down in f32 at high alpha
    rg = _is_rough_glass(mp)
    wh_rg = tr_sample_wh(wo, u1, u2, mp.ax, mp.ay)
    refl_pick = u_lobe < 0.5  # pbrt's uniform 2-lobe component choice
    wi_rg_r = reflect(wo, wh_rg)
    eta_rel_rg = torch.where(ct_o > 0.0, 1.0 / torch.clamp(eta_s, min=1e-6), eta_s)
    wi_rg_t, tir_rg = _refract_about(wo, wh_rg, eta_rel_rg)
    wi_rg = torch.where(refl_pick[..., None], wi_rg_r, wi_rg_t)

    f_r, p_r, ok_r2, f_t, p_t, ok_t2 = _mf_glass_terms(mp, wo, wi_rg, wh_rg)
    ok_rg = torch.where(refl_pick, ok_r2, ok_t2 & ~tir_rg)
    f_rg = torch.where(refl_pick[..., None], f_r, f_t)
    pdf_rg = torch.where(refl_pick, p_r, p_t)
    wi = torch.where(rg[..., None], wi_rg, wi)
    f = torch.where((rg & ok_rg)[..., None], f_rg, torch.where(rg[..., None], 0.0, f))
    pdf = torch.where(rg, torch.where(ok_rg, pdf_rg, 0.0), pdf)

    is_specular = (is_glass & ~rg) | is_mirror
    is_transmission = ((is_glass & ~rg & ~reflect_g) | (flip_t & ~pick_g)
                       | (rg & ~same_hemisphere(wo, wi)))
    dead = (mp.mtype == MAT_NONE) | (pdf <= 0.0)
    f = torch.where(dead[..., None], 0.0, f)
    pdf = torch.where(dead, 0.0, pdf)
    return BSDFSample(wi, f, pdf, is_specular, is_transmission)
