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
as the reference keeps it. Disney (the eight lobes of disney.cpp) and
hair (Chiang et al.'s HairBSDF of hair.cpp) override their lanes
wholesale, gated, as in the reference, on their parameter columns being
in the table (MatParams.dz / .hz); so do the tabulated Fourier BSDF
(core/fourierbsdf.py, MatParams.fz, the scene's one table) and the
hemisphere-crossing transmission flag of its two-sided sampler. A
subsurface material shades its surface as smooth glass; its lanes carry
their BSSRDF row (MatParams.sub) to the path integrator's probe wave.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from tpu_pbrt_torch.core.sampling import cosine_hemisphere_pdf, cosine_sample_hemisphere
from tpu_pbrt_torch.core import xla_math as xm
from tpu_pbrt_torch.core.fourierbsdf import fourier_f_pdf, fourier_sample_wi
from tpu_pbrt_torch.core.spectrum import luminance
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
MAT_DISNEY = 9
MAT_HAIR = 10
MAT_FOURIER = 11
MAT_SUBSURFACE = 12

_INV_PI = 1.0 / np.pi

#: raw roughness above this makes glass a microfacet (non-delta) surface
#: (glass.cpp: rough glass builds MicrofacetReflection/Transmission)
ROUGH_GLASS_MIN = 1e-4


# -------------------------------------------------------------------------
# Fresnel (reflection.cpp FrDielectric / FrConductor)
# -------------------------------------------------------------------------

def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Unpolarized dielectric Fresnel; entering/exiting by the sign of cos_i.
    1 - cos_i^2, 1 - sin_t^2 and the sum of squares are contracted, as the
    reference's compiled shading step (bsdf_eval and bsdf_sample in one
    program) rounds them."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = torch.where(entering, eta_i, eta_t)
    et = torch.where(entering, eta_t, eta_i)
    ci = torch.abs(cos_i)
    sin_t = ei / et * xm.sqrt(torch.clamp(xm.fmac(-ci, ci, 1.0), min=0.0))
    tir = sin_t >= 1.0
    ct = xm.sqrt(torch.clamp(xm.fmac(-sin_t, sin_t, 1.0), min=0.0))
    r_parl = (et * ci - ei * ct) / torch.clamp(et * ci + ei * ct, min=1e-20)
    r_perp = (ei * ci - et * ct) / torch.clamp(ei * ci + et * ct, min=1e-20)
    fr = 0.5 * xm.fmac(r_parl, r_parl, r_perp * r_perp)
    return torch.where(tir, 1.0, fr)


def fresnel_conductor(cos_i, eta, k):
    """reflection.cpp FrConductor, per channel (eta, k: (..., 3))."""
    ci = torch.clamp(torch.abs(cos_i), 0.0, 1.0)[..., None]
    c2 = ci * ci
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    # rounded as the compiled reference's fusions round them: each fusion
    # recomputes t0 = e2 - k2 - s2, its s2 = 1 - c2 fused; a^2 + b^2's
    # fusion keeps e2 and k2 rounded (they have other uses there) and fuses
    # 4 e2 k2 into the sum, a's fuses e2 - k2; t3 fuses c2 a2b2
    s2f = xm.fmac(-ci, ci, 1.0)
    t0 = e2 - k2 - s2f
    a2b2 = xm.sqrt(torch.clamp(xm.fmac(4.0 * e2, k2, t0 * t0), min=0.0))
    t1 = a2b2 + c2
    a = xm.sqrt(torch.clamp(0.5 * (a2b2 + (xm.fmac(eta, eta, -k2) - s2f)), min=0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / torch.clamp(t1 + t2, min=1e-20)
    t3 = xm.fmac(c2, a2b2, s2 * s2)
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
    alpha = xm.sqrt(cp * cp * ax * ax + sp * sp * ay * ay)
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
    ct = 1.0 / xm.sqrt(1.0 + tan2)
    st = xm.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    return torch.stack([st * cp, st * sp, ct], dim=-1)


def beckmann_pdf(wh, ax, ay):
    """pdf of wh under full-distribution sampling: D(wh) |cos wh|."""
    return beckmann_d(wh, ax, ay) * abs_cos_theta(wh)


def tr_roughness_to_alpha(rough):
    """TrowbridgeReitzDistribution::RoughnessToAlpha."""
    x = xm.log(torch.clamp(rough, min=1e-3))
    # the reference's sum of terms, each product contracted into the add
    # that consumes it
    y = xm.fmac(x, 0.819955, 1.62142)
    y = xm.fmac(0.1734 * x, x, y)
    y = xm.fmac(0.0171201 * x * x, x, y)
    return xm.fmac(0.000640711 * x * x * x, x, y)


def tr_d(wh, ax, ay):
    t2 = tan2_theta(wh)
    c2 = cos2_theta(wh)
    c4 = c2 * c2
    cp, sp = cos_phi(wh), sin_phi(wh)
    # 1 + e with e's product by tan^2 fused into the sum, as compiled
    e1 = xm.fmac(cp * cp / torch.clamp(ax * ax, min=1e-12)
                 + sp * sp / torch.clamp(ay * ay, min=1e-12), t2, 1.0)
    d = 1.0 / (torch.pi * ax * ay * c4 * (e1 * e1))
    return torch.where(torch.isfinite(t2) & (c4 > 1e-16), d, 0.0)


def _sin_theta_fused(w):
    """sin(theta) of w with 1 - cos^2 contracted: where cos^2 has no
    other use, the compiled reference fuses the square into the
    difference (vecmath.sin2_theta rounds them apart)."""
    return xm.sqrt(torch.clamp(xm.fmac(-w[..., 2], w[..., 2], 1.0), min=0.0))


def tr_lambda(w, ax, ay):
    # the trig of w from the fused sin^2; alpha^2's second product and
    # 1 + (alpha tan)^2 fused into their sums, as compiled
    s = _sin_theta_fused(w)
    c = w[..., 2]
    abs_tan = torch.abs(s / torch.where(torch.abs(c) < 1e-8, torch.full_like(c, 1e-8), c))
    zero = s == 0.0
    cp = torch.where(zero, torch.ones_like(s), torch.clamp(w[..., 0] / torch.clamp(s, min=1e-12),
                                                           -1.0, 1.0))
    sp = torch.where(zero, torch.zeros_like(s), torch.clamp(w[..., 1] / torch.clamp(s, min=1e-12),
                                                            -1.0, 1.0))
    alpha = xm.sqrt(xm.fmac(cp * cp * ax, ax, sp * sp * ay * ay))
    at = alpha * abs_tan
    lam = (-1.0 + xm.sqrt(xm.fmac(at, at, 1.0))) / 2.0
    return torch.where(torch.isfinite(abs_tan), lam, 0.0)


def tr_g(wo, wi, ax, ay):
    return 1.0 / (1.0 + tr_lambda(wo, ax, ay) + tr_lambda(wi, ax, ay))


def tr_g1(w, ax, ay):
    return 1.0 / (1.0 + tr_lambda(w, ax, ay))


def _tr_sample11(cos_t, u1, u2):
    """TrowbridgeReitzSample11: slopes for visible-normal sampling. A^2 is
    rounded apart from A^2 - 1 and A^2 - B^2, as the compiled reference
    rounds it inside tr_sample_wh (compiled on its own it fuses them)."""
    # the products contracted into their sums as the reference's compiled
    # program contracts them (xla_math.fmac)
    sin_t = xm.sqrt(torch.clamp(xm.fmac(-cos_t, cos_t, 1.0), min=0.0))
    tan_t = sin_t / torch.clamp(cos_t, min=1e-7)
    a = 1.0 / torch.clamp(tan_t, min=1e-12)
    g1 = 2.0 / (1.0 + xm.sqrt(1.0 + 1.0 / torch.clamp(a * a, min=1e-20)))

    # pbrt's TrowbridgeReitzSample11 as written: tmp = 1/(A^2 - 1) is
    # NEGATIVE for |A| < 1, and that sign is load-bearing (negated, every
    # u1 < 0.5 sample would collapse onto the horizon)
    A = 2.0 * u1 / torch.clamp(g1, min=1e-12) - 1.0
    denom = A * A - 1.0
    tiny = torch.where(denom < 0, -1e-12, 1e-12)
    tmp = 1.0 / torch.where(torch.abs(denom) < 1e-12, tiny, denom)
    tmp = torch.clamp(tmp, max=1e10)
    B = tan_t
    D = xm.sqrt(torch.clamp(xm.fmac(B * B * tmp, tmp, -((A * A - B * B) * tmp)), min=0.0))
    slope_x_1 = B * tmp - D
    slope_x_2 = B * tmp + D
    slope_x = torch.where((A < 0) | (slope_x_2 > 1.0 / torch.clamp(tan_t, min=1e-12)),
                          slope_x_1, slope_x_2)

    S = torch.where(u2 > 0.5, 1.0, -1.0)
    u2r = torch.where(u2 > 0.5, 2.0 * (u2 - 0.5), 2.0 * (0.5 - u2))
    z = (u2r * xm.fmac(u2r, xm.fmac(u2r, 0.27385, -0.73369), 0.46341)) / xm.fmac(
        u2r, xm.fmac(u2r, xm.fmac(u2r, 0.093073, 0.309420), -1.0), 0.597999)
    slope_y = S * z * xm.sqrt(xm.fmac(slope_x, slope_x, 1.0))

    # normal incidence
    r = xm.sqrt(torch.clamp(u1 / torch.clamp(1.0 - u1, min=1e-12), min=0.0))
    phi = 6.28318530718 * u2
    ni = cos_t > 0.9999
    slope_x = torch.where(ni, r * xm.cos(phi), slope_x)
    slope_y = torch.where(ni, r * xm.sin(phi), slope_y)
    return slope_x, slope_y


def tr_sample_wh(wo, u1, u2, ax, ay):
    """Visible-normal sampling (TrowbridgeReitzDistribution::Sample_wh)."""
    flip = cos_theta(wo) < 0.0
    wo_f = torch.where(flip[..., None], -wo, wo)
    wi_s = torch.stack([ax * wo_f[..., 0], ay * wo_f[..., 1], wo_f[..., 2]], dim=-1)
    ln = xm.sqrt(dot(wi_s, wi_s))
    wi_s = wi_s / torch.clamp(ln[..., None], min=1e-20)
    ct = torch.clamp(wi_s[..., 2], -1.0, 1.0)
    s_len = xm.sqrt(torch.clamp(xm.fmac(-ct, ct, 1.0), min=0.0))
    small = s_len < 1e-7
    cphi = torch.where(small, 1.0, wi_s[..., 0] / torch.clamp(s_len, min=1e-12))
    sphi = torch.where(small, 0.0, wi_s[..., 1] / torch.clamp(s_len, min=1e-12))
    sx, sy = _tr_sample11(ct, u1, u2)
    # rotate, then unstretch
    tmp = xm.fmac(cphi, sx, -(sphi * sy))
    sy = xm.fmac(sphi, sx, cphi * sy)
    sx = tmp * ax
    sy = sy * ay
    wh = torch.stack([-sx, -sy, torch.ones_like(sx)], dim=-1)
    wh = wh / xm.sqrt(dot(wh, wh))[..., None]
    return torch.where(flip[..., None], -wh, wh)


def _tr_pdf_parts(wo, wh, ax, ay):
    """tr_pdf as (numerator, denominator): a caller dividing the pdf again
    divides by the product of the denominators, as XLA folds (a / b) / c
    into a / (b c)."""
    return (tr_d(wh, ax, ay) * tr_g1(wo, ax, ay) * torch.abs(dot(wo, wh)),
            torch.clamp(abs_cos_theta(wo), min=1e-12))


def tr_pdf(wo, wh, ax, ay):
    """pdf of wh under visible-normal sampling."""
    num, den = _tr_pdf_parts(wo, wh, ax, ay)
    return num / den


# -------------------------------------------------------------------------
# Material parameter gather
# -------------------------------------------------------------------------

class DisneyParams(NamedTuple):
    """Per-lane Disney 2015 parameters (disney.cpp); gathered only when the
    scene has a disney material (MatParams.dz is None otherwise)."""

    metallic: torch.Tensor  # (R,)
    spectint: torch.Tensor
    aniso: torch.Tensor
    sheen: torch.Tensor
    sheentint: torch.Tensor
    clearcoat: torch.Tensor
    ccgloss: torch.Tensor
    strans: torch.Tensor
    flat: torch.Tensor
    dtrans: torch.Tensor
    thin: torch.Tensor  # (R,) bool
    rough: torch.Tensor  # (R,) raw roughness (disney does not remap)


class HairParams(NamedTuple):
    """Per-lane HairBSDF parameters (hair.cpp); gathered only when the
    scene has a hair material (MatParams.hz is None otherwise)."""

    sigma_a: torch.Tensor  # (R,3)
    beta_m: torch.Tensor  # (R,)
    beta_n: torch.Tensor
    alpha: torch.Tensor  # degrees
    h: torch.Tensor  # (R,) across-width offset, set from the uv at shading time


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
    dz: Optional[DisneyParams] = None
    hz: Optional[HairParams] = None
    fz: Any = None  # the scene's FourierTable (core/fourierbsdf.py), shared by every lane
    sub: Optional[torch.Tensor] = None  # (R,) the lane's BSSRDF table row; -1: none


#: the material table's columns (lower_materials builds them), and the
#: columns it adds when a scene has a mix, a disney or a hair material
MAT_COLUMNS = ("type", "kd", "ks", "kr", "kt", "eta", "k", "rough_u", "rough_v", "sigma",
               "opacity", "remap", "kd_tex", "ks_tex", "sigma_tex", "rough_tex", "opacity_tex",
               "bump_tex")
MIX_COLUMNS = ("mix_a", "mix_b", "mix_amt")
DISNEY_COLUMNS = ("d_metallic", "d_spectint", "d_aniso", "d_sheen", "d_sheentint",
                  "d_clearcoat", "d_ccgloss", "d_strans", "d_flat", "d_dtrans", "d_thin")
HAIR_COLUMNS = ("h_sigma_a", "h_beta_m", "h_beta_n", "h_alpha")
#: the BSSRDF row of each material (a scene with a subsurface material)
SUB_COLUMNS = ("sub_id",)


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
    mtype = mat["type"][idx]
    sub = None
    if "sub_id" in mat:
        # a subsurface surface's BSDF is exactly smooth glass (Fresnel
        # reflection + transmission, subsurface.cpp's specular interface):
        # its lanes shade as MAT_GLASS and the BSSRDF transport is keyed
        # on `sub` (integrators/path.py's probe wave)
        sub = mat["sub_id"][idx]
        mtype = torch.where(mtype == MAT_SUBSURFACE, torch.full_like(mtype, MAT_GLASS), mtype)
    remap = mat["remap"][idx]
    ru = mat["rough_u"][idx]
    rv = mat["rough_v"][idx]
    ax = torch.where(remap > 0, tr_roughness_to_alpha(ru), torch.clamp(ru, min=1e-3))
    ay = torch.where(remap > 0, tr_roughness_to_alpha(rv), torch.clamp(rv, min=1e-3))
    return MatParams(
        mtype=mtype, kd=mat["kd"][idx], ks=mat["ks"][idx], kr=mat["kr"][idx],
        kt=mat["kt"][idx], eta=mat["eta"][idx], k=mat["k"][idx], ax=ax, ay=ay,
        sigma=mat["sigma"][idx], opacity=mat["opacity"][idx],
        # glass.cpp turns the microfacet lobes on when EITHER axis is rough
        rough_raw=torch.maximum(ru, rv),
        dz=DisneyParams(
            metallic=mat["d_metallic"][idx], spectint=mat["d_spectint"][idx],
            aniso=mat["d_aniso"][idx], sheen=mat["d_sheen"][idx],
            sheentint=mat["d_sheentint"][idx], clearcoat=mat["d_clearcoat"][idx],
            ccgloss=mat["d_ccgloss"][idx], strans=mat["d_strans"][idx],
            flat=mat["d_flat"][idx], dtrans=mat["d_dtrans"][idx],
            thin=mat["d_thin"][idx] > 0, rough=ru,
        ) if "d_metallic" in mat else None,
        # h is the shading point's (textured_mat sets it from the uv)
        hz=HairParams(
            sigma_a=mat["h_sigma_a"][idx], beta_m=mat["h_beta_m"][idx],
            beta_n=mat["h_beta_n"][idx], alpha=mat["h_alpha"][idx],
            h=torch.zeros_like(mat["h_beta_m"][idx]),
        ) if "h_beta_m" in mat else None,
        fz=mat.get("_fourier"),
        sub=sub,
    )


def map_params(fn, mp: MatParams) -> MatParams:
    """MatParams with fn applied to every per-lane tensor, the disney and
    hair parameters and `sub` included (the reference's jax.tree.map; None
    stays None). The Fourier table is the scene's, not a lane's, and is
    kept as it is (the reference's tree map would reshape its arrays)."""
    def leaf(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            return type(a)(*(leaf(x) for x in a))
        return fn(a)

    return MatParams(*(a if name == "fz" else leaf(a) for name, a in zip(MatParams._fields, mp)))


def _is_rough_glass(mp: MatParams):
    return (mp.mtype == MAT_GLASS) & (mp.rough_raw > ROUGH_GLASS_MIN)


def _lobe_flags(mp: MatParams):
    """(has_diffuse, has_glossy, is_specular_lobe). Rough glass counts as
    glossy: bsdf_eval/bsdf_sample override its lanes wholesale."""
    t = mp.mtype
    rg = _is_rough_glass(mp)
    diffuse = ((t == MAT_MATTE) | (t == MAT_PLASTIC) | (t == MAT_UBER) | (t == MAT_TRANSLUCENT)
               | (t == MAT_DISNEY) | (t == MAT_HAIR) | (t == MAT_FOURIER) | (t == MAT_SUBSURFACE))
    glossy = ((t == MAT_PLASTIC) | (t == MAT_METAL) | (t == MAT_UBER) | (t == MAT_SUBSTRATE)
              | (t == MAT_DISNEY) | rg)
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
    sin_to = xm.sqrt(sin2_theta(wo))
    sin_ti = xm.sqrt(sin2_theta(wi))
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
    wh_len = xm.sqrt(dot(wh, wh))
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
    wh_len = xm.sqrt(dot(wh, wh))
    wh = wh / torch.clamp(wh_len[..., None], min=1e-20)
    num, den = _tr_pdf_parts(wo, wh, mp.ax, mp.ay)
    pdf = num / (den * torch.clamp(4.0 * dot(wo, wh), min=1e-12))
    # FresnelBlend's pdf: the mean of the cosine and half-vector pdfs
    pdf_sub = 0.5 * (cosine_hemisphere_pdf(abs_cos_theta(wi)) + pdf)
    pdf = torch.where(mp.mtype == MAT_SUBSTRATE, pdf_sub, pdf)
    return torch.where(refl & (wh_len > 1e-12), pdf, 0.0)


def _refract_about(wo, wh, eta_rel):
    """Refract wo about the microfacet normal wh (faced toward wo);
    eta_rel = eta_incident / eta_transmitted. Returns (wi, tir). Rounded
    as the reference's compiled `_refract_about`: the facing test's dot
    product rounded apart, the cosine's fused, and each product fused
    into the sum that consumes it (the transmitted direction's second
    term into the first)."""
    wh_f = torch.where((_dot_apart(wo, wh) < 0.0)[..., None], -wh, wh)
    ci = dot(wo, wh_f)
    sin2i = torch.clamp(xm.fmac(-ci, ci, 1.0), min=0.0)
    e2 = eta_rel * eta_rel
    tir = e2 * sin2i >= 1.0
    ctt = xm.sqrt(torch.clamp(xm.fmac(-e2, sin2i, 1.0), min=0.0))
    k = xm.fmac(eta_rel, ci, -ctt)
    return xm.fmac(k[..., None], wh_f, eta_rel[..., None] * -wo), tir


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
    whr_len = xm.sqrt(dot(wh_r, wh_r))
    wh_rn = wh_r / torch.clamp(whr_len[..., None], min=1e-20)
    f_r, p_r, ok_r, _, _, _ = _mf_glass_terms(mp, wo, wi, wh_rn)
    ok_r = ok_r & (whr_len > 1e-12)

    eta_t = torch.where(cos_theta(wo) > 0.0, eta_s, 1.0 / torch.clamp(eta_s, min=1e-6))
    wh_t = wo + wi * eta_t[..., None]
    wht_len = xm.sqrt(dot(wh_t, wh_t))
    wh_tn = wh_t / torch.clamp(wht_len[..., None], min=1e-20)
    _, _, _, f_t, p_t, ok_t = _mf_glass_terms(mp, wo, wi, wh_tn)
    ok_t = ok_t & (wht_len > 1e-12)

    f = torch.where(ok_r[..., None], f_r, 0.0) + torch.where(ok_t[..., None], f_t, 0.0)
    pdf = torch.where(ok_r, p_r, 0.0) + torch.where(ok_t, p_t, 0.0)
    return f, pdf


# -------------------------------------------------------------------------
# Disney 2015 BSDF (materials/disney.cpp: DisneyDiffuse / FakeSS / Retro /
# Sheen, DisneyMicrofacetDistribution + DisneyFresnel, DisneyClearcoat,
# the MicrofacetTransmission spec-trans lobe, thin LambertianTransmission)
# as the reference writes it; evaluated only where a scene has a disney
# material (MatParams.dz)
# -------------------------------------------------------------------------

def _ipow(x, n: int):
    """x ** n for an integer n > 0 by the binary powering XLA lowers
    integer_pow to (the reference's `x ** 20`)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _dot_apart(a, b):
    """sum(a * b) over the last axis with the products rounded apart: the
    reflections of the disney sampler, whose compiled reduction does not
    fuse its products (vecmath.dot fuses them, as most of the compiled
    reference's dot products do)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _flip_z(v):
    """v * (1, 1, -1) without a device constant (a host-made tensor is a
    copy the host waits for on CUDA): x * 1 is x and x * -1 is -x."""
    return torch.cat([v[..., :2], -v[..., 2:]], dim=-1)


def _sw(c):
    """SchlickWeight: (1 - c)^5, clamped."""
    m = torch.clamp(1.0 - c, 0.0, 1.0)
    return (m * m) * (m * m) * m


def _gtr1_d(cos_h, alpha):
    a2 = alpha * alpha
    denom = torch.pi * xm.log(a2) * xm.fmac((a2 - 1.0) * cos_h, cos_h, 1.0)
    return (a2 - 1.0) / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)


def _smith_g_sep(c, alpha):
    """The separable Smith G1 of the clearcoat's fixed alpha (disney.cpp
    smithG_GGX)."""
    a2 = alpha * alpha
    c2 = c * c
    return 1.0 / (c + xm.sqrt(torch.clamp(a2 + c2 - a2 * c2, min=1e-12)))


def _disney_weights(mp: MatParams):
    """The per-lane quantities every Disney lobe shares."""
    dz = mp.dz
    c = mp.kd
    e = mp.eta[..., 0]
    metallic = dz.metallic
    strans = dz.strans
    dw = (1.0 - metallic) * (1.0 - strans)
    dt = dz.dtrans * 0.5
    lum = luminance(c)
    ctint = torch.where((lum > 0.0)[..., None], c / torch.clamp(lum, min=1e-12)[..., None], 1.0)
    csheen = (1.0 - dz.sheentint)[..., None] + dz.sheentint[..., None] * ctint
    r0 = _ipow((e - 1.0) / (e + 1.0), 2)
    cspec0 = ((1.0 - metallic)[..., None] * r0[..., None]
              * ((1.0 - dz.spectint)[..., None] + dz.spectint[..., None] * ctint)
              + metallic[..., None] * c)
    aspect = xm.sqrt(torch.clamp(xm.fmac(dz.aniso, -0.9, torch.ones_like(dz.aniso)), min=1e-6))
    r2 = dz.rough * dz.rough
    ax = torch.clamp(r2 / aspect, min=1e-3)
    ay = torch.clamp(r2 * aspect, min=1e-3)
    rscaled = xm.fmac(e, 0.65, -0.35) * dz.rough
    rs2 = rscaled * rscaled
    axt = torch.where(dz.thin, torch.clamp(rs2 / aspect, min=1e-3), ax)
    ayt = torch.where(dz.thin, torch.clamp(rs2 * aspect, min=1e-3), ay)
    gloss = 0.1 * (1.0 - dz.ccgloss) + 0.001 * dz.ccgloss
    return c, e, dw, dt, csheen, cspec0, ax, ay, axt, ayt, gloss


def _disney_presence(mp: MatParams):
    """The eight lobes' presence masks (the lobes disney.cpp Add()s) and
    their count."""
    dz = mp.dz
    dw_pos = (1.0 - dz.metallic) * (1.0 - dz.strans) > 0.0
    pr = [
        dw_pos,                      # 0 DisneyDiffuse
        dw_pos & dz.thin,            # 1 DisneyFakeSS
        dw_pos,                      # 2 DisneyRetro
        dw_pos & (dz.sheen > 0.0),   # 3 DisneySheen
        torch.ones_like(dw_pos),     # 4 microfacet reflection
        dz.clearcoat > 0.0,          # 5 clearcoat
        dz.strans > 0.0,             # 6 microfacet spec transmission
        dz.thin,                     # 7 LambertianTransmission
    ]
    n = sum(p.to(torch.int32) for p in pr)
    return pr, n


def _disney_trans_terms(T, e, axt, ayt, wo, wi, wh):
    """MicrofacetTransmission::f / Pdf with Disney's separable G at an
    explicit half-vector (etaA = 1, etaB = e, radiance transport)."""
    ci = abs_cos_theta(wi)
    co = abs_cos_theta(wo)
    ok = (ci > 1e-7) & (co > 1e-7) & ~same_hemisphere(wo, wi)
    eta_t = torch.where(cos_theta(wo) > 0.0, e, 1.0 / torch.clamp(e, min=1e-6))
    wh_z = torch.where((wh[..., 2] < 0.0)[..., None], -wh, wh)
    do_h = dot(wo, wh_z)
    di_h = dot(wi, wh_z)
    ok = ok & (do_h * di_h < 0.0)
    d = tr_d(wh_z, axt, ayt)
    g = tr_g1(wo, axt, ayt) * tr_g1(wi, axt, ayt)
    F = fresnel_dielectric(do_h, torch.ones_like(e), e)
    sqrt_denom = do_h + eta_t * di_h
    factor = 1.0 / torch.clamp(eta_t, min=1e-6)
    f = T * torch.abs(
        d * g * eta_t * eta_t * (1.0 - F) * torch.abs(di_h) * torch.abs(do_h)
        * factor * factor
        / torch.clamp(ci * co * sqrt_denom * sqrt_denom, min=1e-12)
    )[..., None]
    pdf_wh = tr_pdf(wo, wh_z, axt, ayt)
    dwh_dwi = torch.abs(eta_t * eta_t * di_h) / torch.clamp(sqrt_denom * sqrt_denom, min=1e-12)
    pdf = pdf_wh * dwh_dwi
    return torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0), ok


def _disney_f_pdf(mp: MatParams, wo, wi):
    """f and the lobe-averaged pdf over the present lobes (BSDF::f and
    BSDF::Pdf over the Add()ed lobes)."""
    dz = mp.dz
    c, e, dw, dt, csheen, cspec0, ax, ay, axt, ayt, gloss = _disney_weights(mp)
    pr, n = _disney_presence(mp)
    refl = same_hemisphere(wo, wi)
    ci = abs_cos_theta(wi)
    co = abs_cos_theta(wo)
    ok_ang = (ci > 1e-7) & (co > 1e-7)

    wh = wi + wo
    wh_len = xm.sqrt(dot(wh, wh))
    whn = wh / torch.clamp(wh_len[..., None], min=1e-20)
    cos_d = dot(wi, whn)  # cosThetaD
    FL = _sw(ci)
    FV = _sw(co)
    rough = dz.rough

    # 0: DisneyDiffuse
    f0 = (dw * torch.where(dz.thin, (1.0 - dz.flat) * (1.0 - dt), 1.0))[..., None] * c * (
        _INV_PI * (1.0 - 0.5 * FL) * (1.0 - 0.5 * FV))[..., None]
    # 1: DisneyFakeSS
    fss90 = cos_d * cos_d * rough
    fss = (1.0 + (fss90 - 1.0) * FL) * (1.0 + (fss90 - 1.0) * FV)
    ss = 1.25 * (fss * (1.0 / torch.clamp(ci + co, min=1e-7) - 0.5) + 0.5)
    f1 = (dw * dz.flat * (1.0 - dt))[..., None] * c * (_INV_PI * ss)[..., None]
    # 2: DisneyRetro
    rr = 2.0 * rough * cos_d * cos_d
    f2 = dw[..., None] * c * (_INV_PI * rr * (FL + FV + FL * FV * (rr - 1.0)))[..., None]
    # 3: DisneySheen
    f3 = (dw * dz.sheen)[..., None] * csheen * _sw(cos_d)[..., None]
    # 4: microfacet reflection (GGX, Disney's separable G + DisneyFresnel)
    d_mf = tr_d(whn, ax, ay)
    g_mf = tr_g1(wo, ax, ay) * tr_g1(wi, ax, ay)
    fr_diel = fresnel_dielectric(cos_d, torch.ones_like(e), e)
    fr_schlick = cspec0 + _sw(cos_d)[..., None] * (1.0 - cspec0)
    F_mf = ((1.0 - dz.metallic)[..., None] * fr_diel[..., None]
            + dz.metallic[..., None] * fr_schlick)
    f4 = F_mf * (d_mf * g_mf / torch.clamp(4.0 * ci * co, min=1e-12))[..., None]
    # 5: clearcoat (GTR1)
    d_cc = _gtr1_d(torch.abs(whn[..., 2]), gloss)
    f_cc = 0.04 + 0.96 * _sw(cos_d)
    g_cc = _smith_g_sep(ci, 0.25) * _smith_g_sep(co, 0.25)
    f5 = (0.25 * dz.clearcoat * d_cc * f_cc * g_cc)[..., None] * torch.ones_like(c)

    refl_ok = (refl & ok_ang & (wh_len > 1e-12))[..., None]
    f_refl = (torch.where(pr[0][..., None], f0, 0.0)
              + torch.where(pr[1][..., None], f1, 0.0)
              + torch.where(pr[2][..., None], f2, 0.0)
              + torch.where(pr[3][..., None], f3, 0.0)
              + torch.where(pr[4][..., None], f4, 0.0)
              + torch.where(pr[5][..., None], f5, 0.0))
    f = torch.where(refl_ok, f_refl, 0.0)

    # 6: spec transmission at the generalized half-vector
    T6 = dz.strans[..., None] * xm.sqrt(torch.clamp(c, min=0.0))
    eta_t = torch.where(cos_theta(wo) > 0.0, e, 1.0 / torch.clamp(e, min=1e-6))
    wh_t = wo + wi * eta_t[..., None]
    wht_len = xm.sqrt(dot(wh_t, wh_t))
    wh_tn = wh_t / torch.clamp(wht_len[..., None], min=1e-20)
    f6, p6, ok6 = _disney_trans_terms(T6, e, axt, ayt, wo, wi, wh_tn)
    ok6 = ok6 & (wht_len > 1e-12)
    f = f + torch.where((pr[6] & ok6)[..., None], f6, 0.0)
    # 7: thin diffuse transmission
    f7 = dt[..., None] * c * _INV_PI
    f = f + torch.where((pr[7] & ~refl & ok_ang)[..., None], f7, 0.0)

    # pdf: the mean over the present lobes (cosine for 0-3, the VNDF for
    # 4, GTR1 for 5, the transmission Jacobian for 6, the flipped cosine for 7)
    pdf_cos = torch.where(refl, cosine_hemisphere_pdf(ci), 0.0)
    n_cos = sum(p.to(torch.float32) for p in pr[0:4])
    wo_h = torch.clamp(4.0 * torch.abs(dot(wo, whn)), min=1e-12)
    pdf_mf = torch.where(refl & (wh_len > 1e-12), tr_pdf(wo, whn, ax, ay) / wo_h, 0.0)
    pdf_cc = torch.where(refl & (wh_len > 1e-12), torch.abs(d_cc * whn[..., 2]) / wo_h, 0.0)
    pdf_lt = torch.where(~refl, cosine_hemisphere_pdf(ci), 0.0)
    pdf_sum = (n_cos * pdf_cos
               + torch.where(pr[4], pdf_mf, 0.0)
               + torch.where(pr[5], pdf_cc, 0.0)
               + torch.where(pr[6] & ok6, p6, 0.0)
               + torch.where(pr[7], pdf_lt, 0.0))
    pdf = pdf_sum / torch.clamp(n.to(torch.float32), min=1.0)
    dead = ~ok_ang
    return torch.where(dead[..., None], 0.0, f), torch.where(dead, 0.0, pdf)


def _disney_sample_wi(mp: MatParams, wo, u_lobe, u1, u2):
    """wi drawn by picking uniformly among the PRESENT lobes (BSDF::Sample_f's
    component choice); f and pdf then come from _disney_f_pdf. Returns
    (wi, bad): bad marks a total internal reflection of the transmission
    lobe or a degenerate direction."""
    c, e, dw, dt, csheen, cspec0, ax, ay, axt, ayt, gloss = _disney_weights(mp)
    pr, n = _disney_presence(mp)
    nf = n.to(torch.float32)
    k = torch.minimum((u_lobe * nf).to(torch.int32), n - 1)
    # the k-th present lobe: lobe j is chosen where cumsum(pr)[j] - 1 == k
    cum = torch.cumsum(torch.stack([p.to(torch.int32) for p in pr]), dim=0)
    sel = [(cum[j] - 1 == k) & pr[j] for j in range(8)]

    sgn = torch.where(cos_theta(wo) >= 0.0, 1.0, -1.0)
    # the cosine candidates (lobes 0-3 on wo's side, 7 flipped)
    wi_cos = cosine_sample_hemisphere(u1, u2)
    wi_cos = wi_cos * torch.stack([torch.ones_like(sgn), torch.ones_like(sgn), sgn], dim=-1)
    wi_lt = _flip_z(wi_cos)
    # microfacet reflection (VNDF)
    wh_mf = tr_sample_wh(wo, u1, u2, ax, ay)
    wi_mf = xm.fmac(2.0 * _dot_apart(wo, wh_mf)[..., None], wh_mf, -wo)
    # clearcoat's GTR1 half-vector (DisneyClearcoat::Sample_f)
    a2 = gloss * gloss
    ct2 = torch.clamp((1.0 - xm.pow(a2, 1.0 - u1)) / (1.0 - a2), min=0.0)
    ct_h = xm.sqrt(ct2)
    # the compiled reference folds sqrt(q) * sqrt(q) into q
    st_h = xm.sqrt(torch.clamp(1.0 - (ct2 if xm.contracting() else ct_h * ct_h), min=0.0))
    phi = 2.0 * torch.pi * u2
    wh_cc = torch.stack([st_h * xm.cos(phi), st_h * xm.sin(phi), ct_h], -1)
    wh_cc = torch.where(same_hemisphere(wo, wh_cc)[..., None], wh_cc, -wh_cc)
    wi_cc = xm.fmac(2.0 * _dot_apart(wo, wh_cc)[..., None], wh_cc, -wo)
    # spec transmission: the VNDF of the (thin-rescaled) distribution
    wh_st = tr_sample_wh(wo, u1, u2, axt, ayt)
    eta_rel = torch.where(cos_theta(wo) > 0.0, 1.0 / torch.clamp(e, min=1e-6), e)
    wi_st, tir_st = _refract_about(wo, wh_st, eta_rel)

    wi = wi_cos
    wi = torch.where(sel[4][..., None], wi_mf, wi)
    wi = torch.where(sel[5][..., None], wi_cc, wi)
    wi = torch.where(sel[6][..., None], wi_st, wi)
    wi = torch.where(sel[7][..., None], wi_lt, wi)
    ln = xm.sqrt(dot(wi, wi))
    wi = wi / torch.clamp(ln[..., None], min=1e-20)
    bad = (sel[6] & tir_st) | (ln < 1e-12)
    return wi, bad


# -------------------------------------------------------------------------
# Hair BSDF (hair.cpp, Chiang et al. 2016): longitudinal Mp and azimuthal
# trimmed-logistic Np lobes for p = 0..3, the dielectric attenuation Ap
# and the 2-degree scale tilts, as the reference writes it. The local
# frame is pbrt's curve frame: x along the curve tangent, (y, z) the
# azimuthal plane; h in [-1, 1] is the offset across the ribbon
# (-1 + 2v). Evaluated only where a scene has hair (MatParams.hz).
# -------------------------------------------------------------------------

_H_PMAX = 3
_SQRT_PI_OVER_8 = 0.626657069


def _safe_sqrt(x):
    return xm.sqrt(torch.clamp(x, min=0.0))


def _safe_asin(x):
    return xm.asin(torch.clamp(x, -1.0, 1.0))


def _i0(x):
    """The modified Bessel I0 by its 10-term series (hair.cpp I0); each
    term's division by a constant as the compiled reference rounds it
    under `xla_math.contraction(True)`."""
    fold = xm.contracting()
    val = torch.zeros_like(x)
    x2i = torch.ones_like(x)
    ifact = 1.0
    i4 = 1.0
    for i in range(10):
        if i > 1:
            ifact *= i
        c = i4 * ifact * ifact
        if fold and i:
            # the compiled program multiplies by the constant's f32
            # reciprocal and fuses that product into the sum
            val = xm.fma32(x2i, float(np.float32(1.0) / np.float32(c)), val)
        else:
            # a tensor divisor: CUDA divides by a host scalar as a multiply
            # by its reciprocal
            val = val + x2i / torch.full_like(x2i, c)
        x2i = x2i * x * x
        i4 *= 4.0
    return val


#: log(2 pi) as the reference's f32 log of the f32 constant
_LOG_2PI = float(xm.log(torch.tensor(2.0 * np.pi)))


def _log_i0(x):
    big = x > 12.0
    xc = torch.clamp(x, min=1e-12)
    lb = x + 0.5 * (-_LOG_2PI + xm.log(1.0 / xc) + 1.0 / (8.0 * xc))
    ls = xm.log(torch.clamp(_i0(torch.clamp(x, max=12.0)), min=1e-38))
    return torch.where(big, lb, ls)


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    a = cos_ti * cos_to / v
    b = sin_ti * sin_to / v
    small = v <= 0.1
    m_small = xm.exp(_log_i0(a) - b - 1.0 / v + 0.6931 + xm.log(1.0 / (2.0 * v)))
    vb = torch.clamp(v, min=0.05)  # keeps the large-v branch finite under the select
    m_big = (xm.exp(-torch.clamp(b, max=80.0)) * _i0(torch.clamp(a, max=12.0))) / (
        xm.sinh(torch.clamp(1.0 / vb, max=80.0)) * 2.0 * vb)
    return torch.where(small, m_small, m_big)


def _logistic(x, s):
    x = torch.abs(x)
    e = xm.exp(-x / s)
    return xm.ftz(e / (s * _ipow(1.0 + e, 2)))


def _logistic_cdf(x, s):
    # an f32 tensor numerator: torch divides a Python number by a tensor
    # as number * (1 / tensor), which rounds twice
    x = torch.as_tensor(x, dtype=s.dtype, device=s.device)
    return xm.ftz(1.0 / (1.0 + xm.exp(-x / s)))


def _trimmed_logistic(x, s):
    norm = torch.clamp(_logistic_cdf(np.pi, s) - _logistic_cdf(-np.pi, s), min=1e-12)
    if not xm.contracting():
        return _logistic(x, s) / norm
    # the compiled reference folds (a / b) / c into a / (b c)
    x = torch.abs(x)
    e = xm.exp(-x / s)
    return xm.ftz(e / ((s * _ipow(1.0 + e, 2)) * norm))


def _sample_trimmed_logistic(u, s):
    # u k fused into the sum, as the reference's compiled program fuses it
    k = _logistic_cdf(np.pi, s) - _logistic_cdf(-np.pi, s)
    x = -s * xm.log(1.0 / torch.clamp(xm.fmac(u, k, _logistic_cdf(-np.pi, s)), min=1e-12) - 1.0)
    return torch.clamp(x, -np.pi, np.pi)


def _hair_phi_p(p, gamma_o, gamma_t):
    # (2 p) gamma_t fused into the difference, as compiled (exact for p < 3)
    return xm.fmac(gamma_t, 2.0 * p, -2.0 * gamma_o) + p * np.pi


def _wrap_pi(x):
    return xm.remainder(x + np.pi, 2.0 * np.pi) - np.pi


def _hair_setup(mp: MatParams, wo):
    """The per-lane terms HairBSDF::f and ::Pdf share (hair.cpp)."""
    hz = mp.hz
    eta = mp.eta[..., 0]
    h = hz.h
    bm = hz.beta_m
    bn = hz.beta_n
    v0 = _ipow(0.726 * bm + 0.812 * bm * bm + 3.7 * _ipow(bm, 20), 2)
    vs = [v0, 0.25 * v0, 4.0 * v0, 4.0 * v0]
    s = _SQRT_PI_OVER_8 * (0.265 * bn + 1.194 * bn * bn + 5.372 * _ipow(bn, 22))
    a_rad = torch.deg2rad(hz.alpha)
    sin2k = [xm.sin(a_rad)]
    cos2k = [_safe_sqrt(1.0 - _ipow(sin2k[0], 2))]
    for i in range(1, 3):
        sin2k.append(2.0 * cos2k[i - 1] * sin2k[i - 1])
        cos2k.append(xm.fmac(cos2k[i - 1], cos2k[i - 1], -_ipow(sin2k[i - 1], 2)))

    sin_to = wo[..., 0]
    cos_to = _safe_sqrt(1.0 - sin_to * sin_to)
    phi_o = xm.atan2(wo[..., 2], wo[..., 1])
    sin_tt = sin_to / eta
    cos_tt = _safe_sqrt(xm.fmac(-sin_tt, sin_tt, 1.0))
    etap = _safe_sqrt(xm.fmac(eta, eta, -(sin_to * sin_to))) / torch.clamp(cos_to, min=1e-6)
    sin_gt = h / torch.clamp(etap, min=1e-6)
    cos_gt = _safe_sqrt(xm.fmac(-sin_gt, sin_gt, 1.0))
    gamma_t = _safe_asin(sin_gt)
    gamma_o = _safe_asin(h)
    # the transmittance of one internal segment
    T = xm.exp(-hz.sigma_a * (2.0 * cos_gt / torch.clamp(cos_tt, min=1e-6))[..., None])
    # the attenuation Ap (hair.cpp Ap())
    cos_go = _safe_sqrt(xm.fmac(-h, h, 1.0))
    fr = fresnel_dielectric(cos_to * cos_go, torch.ones_like(eta), eta)[..., None]
    ap0 = torch.broadcast_to(fr, T.shape)
    ap1 = _ipow(1.0 - fr, 2) * T
    ap2 = ap1 * T * fr
    ap3 = ap2 * fr * T / torch.clamp(xm.fmac(-T, fr, 1.0), min=1e-4)
    aps = [ap0, ap1, ap2, ap3]

    # the longitudinal angles tilted per p (hair.cpp "account for scales")
    # each a b +- c d contracted as fma(a, b, +-(c d)), but p = 0's cos,
    # which the reference's compiled program rounds apart
    tilts = []
    for p in range(3):
        if p == 0:
            st = xm.fmac(sin_to, cos2k[1], -(cos_to * sin2k[1]))
            ct = cos_to * cos2k[1] + sin_to * sin2k[1]
        elif p == 1:
            st = xm.fmac(sin_to, cos2k[0], cos_to * sin2k[0])
            ct = xm.fmac(cos_to, cos2k[0], -(sin_to * sin2k[0]))
        else:
            st = xm.fmac(sin_to, cos2k[2], cos_to * sin2k[2])
            ct = xm.fmac(cos_to, cos2k[2], -(sin_to * sin2k[2]))
        tilts.append((st, torch.abs(ct)))
    tilts.append((sin_to, cos_to))

    ap_lum = [luminance(a) for a in aps]
    tot = sum(ap_lum)
    ap_pdf = [al / torch.clamp(tot, min=1e-12) for al in ap_lum]
    return eta, s, vs, gamma_o, gamma_t, phi_o, sin_to, cos_to, aps, ap_pdf, tilts


def _hair_f_pdf(mp: MatParams, wo, wi):
    """HairBSDF::f and ::Pdf."""
    (eta, s, vs, gamma_o, gamma_t, phi_o, sin_to, cos_to, aps, ap_pdf,
     tilts) = _hair_setup(mp, wo)
    sin_ti = wi[..., 0]
    cos_ti = _safe_sqrt(xm.fmac(-sin_ti, sin_ti, 1.0))
    phi_i = xm.atan2(wi[..., 2], wi[..., 1])
    phi = phi_i - phi_o
    fsum = torch.zeros_like(mp.kd)
    pdf = torch.zeros_like(sin_to)
    for p in range(_H_PMAX):
        st, ct = tilts[p]
        m = _mp(cos_ti, ct, sin_ti, st, vs[p])
        n = _trimmed_logistic(_wrap_pi(phi - _hair_phi_p(p, gamma_o, gamma_t)), s)
        fsum = xm.fmac(aps[p], (m * n)[..., None], fsum)
        pdf = pdf + ap_pdf[p] * m * n
    st, ct = tilts[_H_PMAX]
    m_last = _mp(cos_ti, ct, sin_ti, st, vs[_H_PMAX])
    inv2pi = 1.0 / (2.0 * np.pi)
    fsum = fsum + aps[_H_PMAX] * (m_last * inv2pi)[..., None]
    pdf = pdf + ap_pdf[_H_PMAX] * m_last * inv2pi
    f = fsum / torch.clamp(abs_cos_theta(wi), min=1e-6)[..., None]
    ok = torch.isfinite(pdf) & torch.isfinite(f).all(dim=-1)
    return torch.where(ok[..., None], f, 0.0), torch.where(ok, pdf, 0.0)


def _hair_sample_wi(mp: MatParams, wo, u_lobe, u1, u2):
    """HairBSDF::Sample_f's direction: p picked by the attenuation pdf,
    Mp sampled longitudinally and the trimmed logistic azimuthally; the
    remainder of u_lobe after the p pick drives the azimuthal sample (as
    pbrt demuxes one sample)."""
    (eta, s, vs, gamma_o, gamma_t, phi_o, sin_to, cos_to, aps, ap_pdf,
     tilts) = _hair_setup(mp, wo)
    c0 = ap_pdf[0]
    c1 = c0 + ap_pdf[1]
    c2 = c1 + ap_pdf[2]
    p_idx = ((u_lobe >= c0).to(torch.int32) + (u_lobe >= c1).to(torch.int32)
             + (u_lobe >= c2).to(torch.int32))
    prev = torch.where(p_idx == 0, 0.0, torch.where(p_idx == 1, c0, torch.where(p_idx == 2, c1, c2)))
    width = torch.where(p_idx == 0, c0, torch.where(
        p_idx == 1, c1 - c0, torch.where(p_idx == 2, c2 - c1, 1.0 - c2)))
    u_np = torch.clamp((u_lobe - prev) / torch.clamp(width, min=1e-9), 0.0, 0.9999)

    def sel(vals):
        out = vals[0]
        for p in range(1, 4):
            out = torch.where(p_idx == p, vals[p], out)
        return out

    v_p = sel(vs)
    st_p = sel([t[0] for t in tilts])
    ct_p = sel([t[1] for t in tilts])
    u1c = torch.clamp(u1, min=1e-5)
    # the products contracted into their sums as the reference's compiled
    # program contracts them
    cos_t = xm.fmac(v_p, xm.log(
        u1c + (1.0 - u1c) * xm.exp(-torch.clamp(2.0 / torch.clamp(v_p, min=1e-6), max=80.0))),
        1.0)
    sin_t = _safe_sqrt(xm.fmac(-cos_t, cos_t, 1.0))
    cos_phi_s = xm.cos(2.0 * np.pi * u2)
    sin_ti = xm.fmac(sin_t * cos_phi_s, ct_p, -cos_t * st_p)
    cos_ti = _safe_sqrt(xm.fmac(-sin_ti, sin_ti, 1.0))
    dphi_smooth = sel([_hair_phi_p(p, gamma_o, gamma_t) for p in range(4)]) \
        + _sample_trimmed_logistic(u_np, s)
    dphi = torch.where(p_idx < _H_PMAX, dphi_smooth, 2.0 * np.pi * u_np)
    phi_i = phi_o + dphi
    return torch.stack([sin_ti, cos_ti * xm.cos(phi_i), cos_ti * xm.sin(phi_i)], dim=-1)


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
    if mp.dz is not None:
        dzl = mp.mtype == MAT_DISNEY
        f_dz, pdf_dz = _disney_f_pdf(mp, wo, wi)
        f = torch.where(dzl[..., None], f_dz, f)
        pdf = torch.where(dzl, pdf_dz, pdf)
    if mp.hz is not None:
        hl = mp.mtype == MAT_HAIR
        f_h, pdf_h = _hair_f_pdf(mp, wo, wi)
        f = torch.where(hl[..., None], f_h, f)
        pdf = torch.where(hl, pdf_h, pdf)
    if mp.fz is not None:
        fl = mp.mtype == MAT_FOURIER
        f_fo, pdf_fo = fourier_f_pdf(mp.fz, wo, wi)
        f = torch.where(fl[..., None], f_fo, f)
        pdf = torch.where(fl, pdf_fo, pdf)
    dead = (is_spec & ~rg) | (mp.mtype == MAT_NONE)
    return torch.where(dead[..., None], 0.0, f), torch.where(dead, 0.0, pdf)


class BSDFSample(NamedTuple):
    wi: torch.Tensor  # (R,3) local frame
    f: torch.Tensor  # (R,3)
    pdf: torch.Tensor  # (R,)
    is_specular: torch.Tensor  # (R,) bool
    is_transmission: torch.Tensor  # (R,) bool


def _reflect_fused(wo, wh):
    """-wo + 2 (wo . wh) wh with the product fused into the sum, as the
    compiled reference's bsdf_sample rounds its half-vector reflections
    (vecmath.reflect rounds them apart)."""
    return xm.fmac(2.0 * dot(wo, wh)[..., None], wh, -wo)


def bsdf_sample(mp: MatParams, wo, u_lobe, u1, u2) -> BSDFSample:
    """BSDF::Sample_f over the batch: u_lobe picks among the matching
    lobes (pbrt's uniform component choice), u1, u2 drive the chosen one."""
    has_d, has_g, _ = _lobe_flags(mp)
    n_lobes = has_d.to(torch.int32) + has_g.to(torch.int32)
    pick_g = has_g & ((~has_d) | (u_lobe * n_lobes.to(torch.float32) >= 1.0))

    # --- diffuse candidate (cosine hemisphere on wo's side) ---------------
    # translucent: u2's lower half picks transmission, and u2 is remapped
    # to [0, 1) so the pick and the disk coordinate stay independent
    is_transl = mp.mtype == MAT_TRANSLUCENT
    low = u2 < 0.5
    flip_t = is_transl & low
    u2d = torch.where(is_transl, torch.where(low, 2.0 * u2, 2.0 * (u2 - 0.5)), u2)
    wi_d = cosine_sample_hemisphere(u1, u2d)
    wi_d = torch.where((cos_theta(wo) < 0.0)[..., None], _flip_z(wi_d), wi_d)
    wi_d = torch.where(flip_t[..., None], _flip_z(wi_d), wi_d)
    # --- glossy candidate (VNDF half-vector) ------------------------------
    wh = tr_sample_wh(wo, u1, u2, mp.ax, mp.ay)
    wi_g = _reflect_fused(wo, wh)
    # substrate: half the samples are cosine (FresnelBlend::Sample_f)
    use_cos = (mp.mtype == MAT_SUBSTRATE) & (u_lobe < 0.5)
    wi_g = torch.where(use_cos[..., None], wi_d, wi_g)
    wi = torch.where(pick_g[..., None], wi_g, wi_d)

    dz_bad = None
    if mp.dz is not None:
        dzl = mp.mtype == MAT_DISNEY
        wi_dz, bad_dz = _disney_sample_wi(mp, wo, u_lobe, u1, u2)
        wi = torch.where(dzl[..., None], wi_dz, wi)
        dz_bad = dzl & bad_dz
    if mp.hz is not None:
        wi = torch.where((mp.mtype == MAT_HAIR)[..., None], _hair_sample_wi(mp, wo, u_lobe, u1, u2),
                         wi)
    if mp.fz is not None:
        wi = torch.where((mp.mtype == MAT_FOURIER)[..., None],
                         fourier_sample_wi(wo, u_lobe, u1, u2), wi)

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
    # 1 - ci^2, 1 - sin^2(t), eta ci - cos(t) and the refracted direction's
    # first product fused into their sums, as compiled
    e2 = eta_rel * eta_rel
    ct_t = xm.sqrt(torch.clamp(xm.fmac(-e2, torch.clamp(xm.fmac(-ci, ci, 1.0), min=0.0), 1.0),
                               min=0.0))
    wi_refr = xm.fmac(eta_rel[..., None], -wo,
                      xm.fmac(eta_rel, ci, -ct_t)[..., None] * n_loc)
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
    if dz_bad is not None:
        pdf = torch.where(dz_bad, 0.0, pdf)
        is_transmission = torch.where(mp.mtype == MAT_DISNEY, ~same_hemisphere(wo, wi),
                                      is_transmission)
    if mp.hz is not None:
        # hair scales no radiance on transmission: eta_scale stays as it is
        is_transmission = is_transmission & (mp.mtype != MAT_HAIR)
    if mp.fz is not None:
        # the two-sided fourier sampler crosses hemispheres: medium
        # interfaces switch as for any transmitted ray
        is_transmission = torch.where(mp.mtype == MAT_FOURIER, ~same_hemisphere(wo, wi),
                                      is_transmission)
    dead = (mp.mtype == MAT_NONE) | (pdf <= 0.0)
    f = torch.where(dead[..., None], 0.0, f)
    pdf = torch.where(dead, 0.0, pdf)
    return BSDFSample(wi, f, pdf, is_specular, is_transmission)
