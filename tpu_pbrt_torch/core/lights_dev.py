"""Light sampling for next-event estimation (port of tpu_pbrt/core/lights_dev.py).

Lights are rows of a tagged-union SoA table; area lights are one row per
emissive triangle (pbrt's one DiffuseAreaLight per Triangle). This slice
ports the point, area-triangle and infinite (HDR environment map) rows:
Sample_Li of each, the environment's Le and its 2D-CDF pdf, emission of
hit area lights and its MIS pdf, and the power and spatial (per-voxel)
light-pick distributions, in which the environment's row is position-
independent. The scene compiler rejects every other light type.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpu_pbrt_torch.core.sampling import uniform_sample_triangle
from tpu_pbrt_torch.core.vecmath import (
    cross,
    dot,
    normalize,
    spherical_direction,
    spherical_phi,
    spherical_theta,
)

# light type enum (the reference's values)
LIGHT_POINT = 0
LIGHT_AREA = 3
LIGHT_INFINITE = 4


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


def _env_uv(dev, d_world):
    """(phi, theta) of world directions in the environment's light frame."""
    wl = normalize(d_world @ dev["env_w2l"].T)
    return spherical_phi(wl), spherical_theta(wl)


def env_lookup(dev, d_world):
    """InfiniteAreaLight::Le for world directions: a bilinear lookup in the
    lat-long map, wrapping in phi (floor-mod) and clamping in theta."""
    env = dev["envmap"]
    h, w = env.shape[:2]
    phi, theta = _env_uv(dev, d_world)
    x = phi * (0.5 / torch.pi) * w - 0.5
    y = theta / torch.pi * h - 0.5
    # f32 -> int saturates like XLA's convert (NaN of a masked lane -> 0)
    x0 = torch.nan_to_num(torch.floor(x), nan=0.0).clamp(-2.0**31, 2.0**31 - 1).to(torch.int64)
    y0 = torch.nan_to_num(torch.floor(y), nan=0.0).clamp(-2.0**31, 2.0**31 - 1).to(torch.int64)
    fx = (x - x0.to(torch.float32))[..., None]
    fy = (y - y0.to(torch.float32))[..., None]
    x0w = torch.remainder(x0, w)
    x1w = torch.remainder(x0 + 1, w)
    y0c = y0.clamp(0, h - 1)
    y1c = (y0 + 1).clamp(0, h - 1)
    c00 = env[y0c, x0w]
    c10 = env[y0c, x1w]
    c01 = env[y1c, x0w]
    c11 = env[y1c, x1w]
    return (c00 * (1 - fx) + c10 * fx) * (1 - fy) + (c01 * (1 - fx) + c11 * fx) * fy


def env_pdf(dev, d_world):
    """Solid-angle pdf of sampling the world direction d by the map's
    importance distribution."""
    phi, theta = _env_uv(dev, d_world)
    sin_t = torch.sin(theta)
    p_uv = dev["env_distr"].pdf(phi * (0.5 / torch.pi), theta / torch.pi)
    pdf = p_uv / (2.0 * torch.pi * torch.pi * torch.clamp(sin_t, min=1e-9))
    return torch.where(sin_t > 1e-7, pdf, torch.zeros_like(pdf))


def _env_sample(dev, u1, u2):
    """A direction from the map's distribution -> (wi, pdf, Le)."""
    (u, v), pdf_uv = dev["env_distr"].sample_continuous(u1, u2)
    theta = v * torch.pi
    phi = u * 2.0 * torch.pi
    sin_t = torch.sin(theta)
    # env_w2l is the world -> light rotation; its transpose maps back
    wi = spherical_direction(sin_t, torch.cos(theta), phi) @ dev["env_w2l"]
    pdf = pdf_uv / (2.0 * torch.pi * torch.pi * torch.clamp(sin_t, min=1e-9))
    pdf = torch.where(sin_t > 1e-7, pdf, torch.zeros_like(pdf))
    return wi, pdf, env_lookup(dev, wi)


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

    # -- infinite: the shadow ray spans the scene -----------------------------
    if "envmap" in dev:
        is_env = ltype == LIGHT_INFINITE
        wi_env, pdf_env, li_env = _env_sample(dev, u1, u2)
        wi = torch.where(is_env[..., None], wi_env, wi)
        li = torch.where(is_env[..., None], li_env, li)
        pdf = torch.where(is_env, pdf_env, pdf)
        dist = torch.where(is_env, 2.0 * dev["world_radius"] * torch.ones_like(dist), dist)
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


def infinite_pdf(dev, light_distr, wi, ref_p=None):
    """Pdf_Li x pick pmf of the environment for escaped (BSDF-sampled)
    rays. ref_p is the scattering position, which the spatial strategy's
    pick pmf needs (None: the scene-wide marginal)."""
    lt = dev["light"]
    n = lt["type"].shape[0]
    if "envmap" not in dev:
        return torch.zeros(wi.shape[:-1], dtype=torch.float32, device=wi.device)
    p = env_pdf(dev, wi)
    is_env = lt["type"] == LIGHT_INFINITE
    if light_distr is None:
        return p * (is_env.to(torch.float32).sum() / n)
    idx = torch.argmax(is_env.to(torch.int32))
    if isinstance(light_distr, SpatialLightDistribution):
        if ref_p is None:
            return p * light_distr.mean_pmf[idx]
        return p * light_distr.discrete_pdf_at(idx.expand(wi.shape[:-1]), ref_p)
    return p * light_distr.discrete_pdf(idx)


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

