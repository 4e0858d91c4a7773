"""BSDF evaluation and sampling: the diffuse lobe (port of tpu_pbrt/core/bxdf.py).

Every ray carries its gathered material parameters (an SoA row) and the
batch evaluates the lobe formulas under masks. This slice ports the
matte material: the Lambertian lobe, or Oren-Nayar when sigma > 0, with
the cosine-hemisphere sampler. For a matte row the reference's
bsdf_eval/bsdf_sample reduce to exactly these formulas (one diffuse lobe,
no glossy or specular lobe), so the port computes the same values. The
scene compiler rejects every other material.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_pbrt_torch.core.sampling import cosine_hemisphere_pdf, cosine_sample_hemisphere
from tpu_pbrt_torch.core.vecmath import (
    abs_cos_theta,
    cos_phi,
    cos_theta,
    same_hemisphere,
    sin2_theta,
    sin_phi,
)

# material type enum (the reference's values)
MAT_NONE = 0
MAT_MATTE = 1

_INV_PI = 1.0 / np.pi


class MatParams(NamedTuple):
    mtype: torch.Tensor  # (R,) i32
    kd: torch.Tensor  # (R,3)
    sigma: torch.Tensor  # (R,) Oren-Nayar sigma (degrees)
    eta: torch.Tensor  # (R,3) (the path integrator's RR eta^2 tracking)


def gather_mat(mat: dict, mid) -> MatParams:
    """Material rows for material ids mid (clamped, as the reference's
    small-table select clamps)."""
    n = mat["type"].shape[0]
    idx = mid.long().clamp(0, n - 1)
    return MatParams(
        mtype=mat["type"][idx],
        kd=mat["kd"][idx],
        sigma=mat["sigma"][idx],
        eta=mat["eta"][idx],
    )


def _diffuse_f(mp: MatParams, wo, wi):
    """Lambertian or Oren-Nayar by sigma; reflection hemisphere only."""
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
    max_cos = torch.where(has_sin, max_cos, torch.zeros_like(max_cos))
    abs_ci = abs_cos_theta(wi)
    abs_co = abs_cos_theta(wo)
    sin_alpha = torch.where(abs_ci > abs_co, sin_to, sin_ti)
    tan_beta = torch.where(
        abs_ci > abs_co,
        sin_ti / torch.clamp(abs_ci, min=1e-7),
        sin_to / torch.clamp(abs_co, min=1e-7),
    )
    on = a + b * max_cos * sin_alpha * tan_beta
    base = torch.where(mp.sigma > 0.0, on, torch.ones_like(on))
    # matte: the reflection scale is 1 and there is no transmission
    f_refl = mp.kd * (_INV_PI * base)[..., None] * torch.ones_like(mp.kd)
    return torch.where(refl[..., None], f_refl, torch.zeros_like(f_refl))


def _diffuse_pdf(wo, wi):
    refl = same_hemisphere(wo, wi)
    pdf_r = cosine_hemisphere_pdf(abs_cos_theta(wi))
    return torch.where(refl, pdf_r, torch.zeros_like(pdf_r))


def bsdf_eval(mp: MatParams, wo, wi):
    """f(wo, wi) and pdf of the non-specular lobes (pbrt BSDF::f/Pdf)."""
    f = _diffuse_f(mp, wo, wi)
    pdf = _diffuse_pdf(wo, wi)
    has_d = mp.mtype == MAT_MATTE
    f = torch.where(has_d[..., None], f, torch.zeros_like(f))
    pdf = torch.where(has_d, pdf, torch.zeros_like(pdf))
    return f, pdf


class BSDFSample(NamedTuple):
    wi: torch.Tensor  # (R,3) local frame
    f: torch.Tensor  # (R,3)
    pdf: torch.Tensor  # (R,)
    is_specular: torch.Tensor  # (R,) bool
    is_transmission: torch.Tensor  # (R,) bool


def bsdf_sample(mp: MatParams, wo, u_lobe, u1, u2) -> BSDFSample:
    """BSDF::Sample_f: cosine-weighted direction on wo's side."""
    del u_lobe  # one lobe: no component choice
    wi = cosine_sample_hemisphere(u1, u2)
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=wi.dtype, device=wi.device)
    wi = torch.where((cos_theta(wo) < 0.0)[..., None], wi * flip, wi)
    f, pdf = bsdf_eval(mp, wo, wi)
    dead = (mp.mtype == MAT_NONE) | (pdf <= 0.0)
    f = torch.where(dead[..., None], torch.zeros_like(f), f)
    pdf = torch.where(dead, torch.zeros_like(pdf), pdf)
    false = torch.zeros_like(dead)
    return BSDFSample(wi, f, pdf, false, false)
