"""Light sampling for next-event estimation (port of tpu_pbrt/core/lights_dev.py).

Lights are rows of a tagged-union SoA table; area lights are one row per
emissive triangle (pbrt's one DiffuseAreaLight per Triangle). This slice
ports the point and area-triangle rows, the spatial (per-voxel) light
pick distribution, emission of hit area lights and its MIS pdf. The
scene compiler rejects every other light type.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpu_pbrt_torch.core.sampling import uniform_sample_triangle
from tpu_pbrt_torch.core.vecmath import cross, dot

# light type enum (the reference's values)
LIGHT_POINT = 0
LIGHT_AREA = 3


class LightSample(NamedTuple):
    li: torch.Tensor  # (R,3) incident radiance (pre-visibility)
    wi: torch.Tensor  # (R,3) world direction to light
    pdf: torch.Tensor  # (R,) solid-angle pdf x light-pick pmf
    dist: torch.Tensor  # (R,) shadow-ray length
    is_delta: torch.Tensor  # (R,) delta light (no MIS vs BSDF)
    li_idx: Optional[torch.Tensor] = None  # (R,) sampled light row


def _take(table, idx):
    """table[idx] with idx clamped to the table (the reference's clamp)."""
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def sample_triangle_point(tv, u1, u2):
    """Uniform point + unit geometric normal on (...,3,3) triangles."""
    b0, b1 = uniform_sample_triangle(u1, u2)
    p = (
        b0[..., None] * tv[..., 0, :]
        + b1[..., None] * tv[..., 1, :]
        + (1.0 - b0 - b1)[..., None] * tv[..., 2, :]
    )
    n = cross(tv[..., 1, :] - tv[..., 0, :], tv[..., 2, :] - tv[..., 0, :])
    n = n / torch.clamp(torch.sqrt(dot(n, n))[..., None], min=1e-20)
    return p, n


def sample_light_rows(dev, li_idx, ref_p, u1, u2) -> LightSample:
    """Sample_Li for explicit light rows li_idx (R,) — no pick pmf folded."""
    lt = dev["light"]
    ltype = _take(lt["type"], li_idx)
    lp = _take(lt["p"], li_idx)
    lL = _take(lt["L"], li_idx)
    twosided = _take(lt["twosided"], li_idx)
    area = _take(lt["area"], li_idx)

    # -- point ------------------------------------------------------------
    to_l = lp - ref_p
    d2 = torch.clamp(dot(to_l, to_l), min=1e-20)
    dist_pt = torch.sqrt(d2)
    wi_pt = to_l / dist_pt[..., None]
    li_pt = lL / d2[..., None]

    # -- area (triangle) --------------------------------------------------
    tv = _take(lt["tri_v"], li_idx)  # (R,3,3)
    p_l, n_l = sample_triangle_point(tv, u1, u2)
    to_a = p_l - ref_p
    d2a = torch.clamp(dot(to_a, to_a), min=1e-12)
    dist_a = torch.sqrt(d2a)
    wi_a = to_a / dist_a[..., None]
    cos_l = dot(n_l, -wi_a)
    emits = (cos_l > 0.0) | (twosided > 0)
    li_a = torch.where(emits[..., None], lL, torch.zeros_like(lL))
    pdf_a = d2a / torch.clamp(torch.abs(cos_l) * area, min=1e-12)

    is_pt = ltype == LIGHT_POINT
    is_area = ltype == LIGHT_AREA
    wi = torch.where(is_area[..., None], wi_a, wi_pt)
    li = torch.where(is_area[..., None], li_a, li_pt)
    pdf = torch.where(is_area, pdf_a, torch.ones_like(pdf_a))
    dist = torch.where(is_area, dist_a, dist_pt)
    li = torch.where((pdf > 0.0)[..., None], li, torch.zeros_like(li))
    return LightSample(li, wi, pdf, dist, is_pt, li_idx)


class SpatialLightDistribution(NamedTuple):
    """lightdistrib.cpp SpatialLightDistribution, precomputed dense: one
    inclusive light-pick CDF per voxel of an 8^3 grid over the scene."""

    cdf: torch.Tensor  # (V, L) inclusive per-voxel CDF
    mean_pmf: torch.Tensor  # (L,) scene-wide marginal
    lo: torch.Tensor  # (3,)
    inv_cs: torch.Tensor  # (3,)
    res: tuple  # (nx, ny, nz)

    def _voxel(self, p):
        nx, ny, nz = self.res
        v = torch.floor((p - self.lo) * self.inv_cs)
        # float -> int: NaN/huge coordinates of masked lanes clamp like any other
        v = torch.nan_to_num(v, nan=0.0).clamp(-1.0, float(max(self.res))).to(torch.int64)
        hi = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=torch.int64, device=p.device)
        v = torch.minimum(torch.clamp(v, min=0), hi)
        return v[..., 0] + nx * (v[..., 1] + ny * v[..., 2])

    def sample_discrete_at(self, u, p):
        row = self.cdf[self._voxel(p)]  # (..., L)
        idx = (u[..., None] >= row).sum(dim=-1)
        idx = torch.clamp(idx, max=row.shape[-1] - 1)
        prev = torch.where(
            idx > 0, torch.gather(row, -1, (idx - 1).clamp(min=0)[..., None])[..., 0],
            torch.zeros_like(u),
        )
        pmf = torch.gather(row, -1, idx[..., None])[..., 0] - prev
        return idx, torch.clamp(pmf, min=1e-12)

    def discrete_pdf_at(self, idx, p):
        row = self.cdf[self._voxel(p)]
        idx = idx.long().clamp(0, row.shape[-1] - 1)
        prev = torch.where(
            idx > 0, torch.gather(row, -1, (idx - 1).clamp(min=0)[..., None])[..., 0],
            torch.zeros(idx.shape, dtype=row.dtype, device=row.device),
        )
        return torch.clamp(torch.gather(row, -1, idx[..., None])[..., 0] - prev, min=1e-12)


def sample_one_light(dev, light_distr, ref_p, u_pick, u1, u2) -> LightSample:
    """UniformSampleOneLight: pick a light row, then Sample_Li. light_distr
    is None (uniform pick), a Distribution1D (power) or a
    SpatialLightDistribution; the returned pdf includes the pick pmf."""
    n = dev["light"]["type"].shape[0]
    if light_distr is None:
        li_idx = torch.clamp((u_pick * n).to(torch.int64), max=n - 1)
        pick_pmf = torch.full(u_pick.shape, 1.0 / n, dtype=torch.float32, device=u_pick.device)
    elif isinstance(light_distr, SpatialLightDistribution):
        li_idx, pick_pmf = light_distr.sample_discrete_at(u_pick, ref_p)
    else:
        li_idx, pick_pmf = light_distr.sample_discrete(u_pick)
    ls = sample_light_rows(dev, li_idx, ref_p, u1, u2)
    return LightSample(ls.li, ls.wi, ls.pdf * pick_pmf, ls.dist, ls.is_delta, li_idx)


def light_pick_pmf(dev, light_distr, li_idx, ref_p=None):
    """Pick pmf of light row li_idx under the integrator's distribution."""
    n = dev["light"]["type"].shape[0]
    idx = li_idx.long().clamp(min=0)
    if light_distr is None:
        return torch.full(li_idx.shape, 1.0 / n, dtype=torch.float32, device=li_idx.device)
    if isinstance(light_distr, SpatialLightDistribution):
        if ref_p is None:
            return torch.clamp(light_distr.mean_pmf[idx], min=1e-12)
        return light_distr.discrete_pdf_at(idx, ref_p)
    return light_distr.discrete_pdf(idx)


def emitted_pdf(dev, light_distr, ref_p, hit_p, light_idx, n_l):
    """Solid-angle pdf (incl. pick pmf) of light-sampling the point hit_p
    on area light `light_idx` from ref_p."""
    area = _take(dev["light"]["area"], light_idx.clamp(min=0))
    to_h = hit_p - ref_p
    d2 = torch.clamp(dot(to_h, to_h), min=1e-12)
    wi = to_h / torch.sqrt(d2)[..., None]
    cos_l = torch.abs(dot(n_l, -wi))
    pdf_sa = d2 / torch.clamp(cos_l * area, min=1e-12)
    return pdf_sa * light_pick_pmf(dev, light_distr, light_idx, ref_p)


def emitted_radiance(dev, tri_light, wo_world, n_g):
    """L_e of an intersected emissive triangle (DiffuseAreaLight::L):
    emits from the front side unless twosided."""
    lt = dev["light"]
    idx = tri_light.clamp(min=0)
    lL = _take(lt["L"], idx)
    two = _take(lt["twosided"], idx)
    front = dot(n_g, wo_world) > 0.0
    emit = (tri_light >= 0) & (front | (two > 0))
    return torch.where(emit[..., None], lL, torch.zeros_like(lL))

