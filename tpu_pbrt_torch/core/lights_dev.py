"""Light sampling for next-event estimation (port of tpu_pbrt/core/lights_dev.py).

Lights are rows of a tagged-union SoA table; area lights are one row per
emissive triangle (pbrt's one DiffuseAreaLight per Triangle). The port
compiles every light type of the reference: point, spot (the cone's
quartic falloff, spot.cpp), distant, area-triangle,
infinite (HDR environment map), and the goniometric and projection lights,
whose intensity an image in the shared light atlas modulates by direction
(`_light_map_scale`). This module holds Sample_Li of each, the
environment's Le and its 2D-CDF pdf, emission of hit area lights and its
MIS pdf, the power and spatial (per-voxel) light-pick distributions, in
which the distant and environment rows are position-independent, and the
emission side that BDPT and SPPM start light subpaths from (Sample_Le,
Pdf_Le).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_pbrt_torch.core.sampling import (
    _div,
    concentric_sample_disk,
    cosine_sample_hemisphere,
    uniform_cone_pdf,
    uniform_sample_cone,
    uniform_sample_sphere,
    uniform_sample_triangle,
)
from tpu_pbrt_torch.core.vecmath import (
    coordinate_system,
    cross,
    dot,
    dot_rows,
    normalize,
    spherical_direction,
    spherical_phi,
    spherical_theta,
)
from tpu_pbrt_torch.core import xla_math as _xm
from tpu_pbrt_torch.core.xla_math import fmac as _fmac, sqrt as _sqrt

# light type enum (the reference's values)
LIGHT_POINT = 0
LIGHT_SPOT = 1
LIGHT_DISTANT = 2
LIGHT_AREA = 3
LIGHT_INFINITE = 4
LIGHT_GONIO = 5
LIGHT_PROJECTION = 6


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


def _to_index(x):
    """f32 -> int64 as XLA's convert saturates (NaN of a masked lane -> 0)."""
    return torch.nan_to_num(x, nan=0.0).clamp(-2.0**31, 2.0**31 - 1).to(torch.int64)


def _spot_falloff(cos_w, cos_falloff_start, cos_total_width):
    d = torch.clamp(
        (cos_w - cos_total_width)
        / torch.clamp(cos_falloff_start - cos_total_width, min=1e-9), 0.0, 1.0)
    return torch.where(cos_w < cos_total_width, torch.zeros_like(d),
                       torch.where(cos_w > cos_falloff_start, torch.ones_like(d), d * d * d * d))


def _env_uv(dev, d_world):
    """(phi, theta) of world directions in the environment's light frame."""
    wl = normalize(dot_rows(d_world, dev["env_w2l"]))
    return spherical_phi(wl), spherical_theta(wl)


def _env_scales(w: int, h: int):
    """(w / 2 pi, h / pi) as the f32 constants XLA folds (phi (1 / 2 pi)) w
    and (theta / pi) h into."""
    f32 = np.float32
    return float(f32(f32(0.5 / np.pi) * f32(w))), float(f32(f32(h) / f32(np.pi)))


def env_lookup(dev, d_world):
    """InfiniteAreaLight::Le for world directions: a bilinear lookup in the
    lat-long map, wrapping in phi (floor-mod) and clamping in theta."""
    env = dev["envmap"]
    h, w = env.shape[:2]
    phi, theta = _env_uv(dev, d_world)
    # phi / 2 pi * w - 0.5 and theta / pi * h - 0.5; a compiled program
    # folds the constant factors into one and contracts the product into
    # the sum
    if _xm.contracting():
        sx, sy = _env_scales(w, h)
        x = _fmac(phi, sx, -0.5)
        y = _fmac(theta, sy, -0.5)
    else:
        x = phi * (0.5 / torch.pi) * w - 0.5
        y = theta / torch.pi * h - 0.5
    x0 = _to_index(torch.floor(x))
    y0 = _to_index(torch.floor(y))
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
    top = _fmac(c00, 1 - fx, c10 * fx)
    return _fmac(top, 1 - fy, _fmac(c01, 1 - fx, c11 * fx) * fy)


def env_pdf(dev, d_world):
    """Solid-angle pdf of sampling the world direction d by the map's
    importance distribution."""
    phi, theta = _env_uv(dev, d_world)
    sin_t = _xm.sin(theta)
    p_uv = dev["env_distr"].pdf(phi * (0.5 / torch.pi), _div(theta, torch.pi))
    pdf = p_uv / (2.0 * torch.pi * torch.pi * torch.clamp(sin_t, min=1e-9))
    return torch.where(sin_t > 1e-7, pdf, torch.zeros_like(pdf))


def _env_sample(dev, u1, u2):
    """A direction from the map's distribution -> (wi, pdf, Le)."""
    (u, v), pdf_uv = dev["env_distr"].sample_continuous(u1, u2)
    theta = v * torch.pi
    phi = u * 2.0 * torch.pi
    sin_t = _xm.sin(theta)
    # env_w2l is the world -> light rotation; its transpose maps back
    wi = dot_rows(spherical_direction(sin_t, _xm.cos(theta), phi), dev["env_w2l"].T)
    pdf = pdf_uv / (2.0 * torch.pi * torch.pi * torch.clamp(sin_t, min=1e-9))
    pdf = torch.where(sin_t > 1e-7, pdf, torch.zeros_like(pdf))
    return wi, pdf, env_lookup(dev, wi)


def sample_triangle_point(tv, u1, u2):
    """Uniform point + unit geometric normal on (...,3,3) triangles."""
    b0, b1 = uniform_sample_triangle(u1, u2)
    # b0 v0 + b1 v1 + b2 v2 contracted as compiled: fma(b2, v2, fma(b0, v0, b1 v1))
    p = _fmac((1.0 - b0 - b1)[..., None], tv[..., 2, :],
               _fmac(b0[..., None], tv[..., 0, :], b1[..., None] * tv[..., 1, :]))
    n = cross(tv[..., 1, :] - tv[..., 0, :], tv[..., 2, :] - tv[..., 0, :])
    n = n / torch.clamp(_sqrt(dot(n, n))[..., None], min=1e-20)
    return p, n


def triangle_normal(tv):
    """Unit geometric normal of (...,3,3) triangles."""
    n = cross(tv[..., 1, :] - tv[..., 0, :], tv[..., 2, :] - tv[..., 0, :])
    return n / torch.clamp(_sqrt(dot(n, n))[..., None], min=1e-20)


def _light_map_scale(dev, lt, li_idx, w_from_light, is_gonio, is_proj):
    """The image factor of goniometric and projection lights
    (goniometric.h Scale, projection.cpp Projection) for the world
    direction FROM the light toward the shading point: each row carries
    its world-to-light rotation and its (offset, width, height) window into
    the shared light atlas; a bilinear lookup whose taps clamp to the
    row's own extent (and to offset 0 for rows without a map). The
    goniometric diagram is lat-long about the light's Y axis; the
    projection's picture covers the fov frustum (0 outside it)."""
    atlas = dev["light_atlas"]
    w2l = _take(lt["w2l"], li_idx).reshape(li_idx.shape + (3, 3))
    img = _take(lt["img"], li_idx).long()  # (..., 3): offset, width, height
    off, iw, ih = img[..., 0], img[..., 1], img[..., 2]
    w = w_from_light
    dl = normalize(torch.stack(
        [(w2l[..., i, 0] * w[..., 0] + w2l[..., i, 1] * w[..., 1]) + w2l[..., i, 2] * w[..., 2]
         for i in range(3)], dim=-1))

    # goniometric: Scale() swaps y and z before SphericalTheta / Phi
    theta = torch.acos(torch.clamp(dl[..., 1], -1.0, 1.0))
    phi = torch.atan2(dl[..., 2], dl[..., 0])
    phi = torch.where(phi < 0, phi + 2 * torch.pi, phi)
    u_g = _div(phi, 2 * torch.pi)
    v_g = _div(theta, torch.pi)

    # projection: the perspective divide into the fov screen window
    tan_half = torch.clamp(_take(lt["cos0"], li_idx), min=1e-6)
    aspect = _take(lt["cos1"], li_idx)
    z = dl[..., 2]
    inside_z = z > 1e-3
    zs = torch.where(inside_z, z, torch.ones_like(z))
    sx = dl[..., 0] / (zs * tan_half)
    sy = dl[..., 1] / (zs * tan_half)
    u_p = (sx / torch.clamp(aspect, min=1.0) + 1.0) * 0.5
    v_p = (sy * torch.clamp(aspect, max=1.0) + 1.0) * 0.5
    in_win = inside_z & (u_p >= 0) & (u_p < 1) & (v_p >= 0) & (v_p < 1)

    u = torch.where(is_proj, u_p, u_g)
    v = torch.where(is_proj, v_p, v_g)
    x = u * iw.to(torch.float32) - 0.5
    y = v * ih.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    base = torch.clamp(off, min=0)

    def tap(ix, iy):
        ix = torch.minimum(torch.clamp(_to_index(ix), min=0), torch.clamp(iw - 1, min=0))
        iy = torch.minimum(torch.clamp(_to_index(iy), min=0), torch.clamp(ih - 1, min=0))
        return atlas[base + iy * iw + ix]

    c = (tap(x0, y0) * ((1 - fx) * (1 - fy))[..., None]
         + tap(x0 + 1, y0) * (fx * (1 - fy))[..., None]
         + tap(x0, y0 + 1) * ((1 - fx) * fy)[..., None]
         + tap(x0 + 1, y0 + 1) * (fx * fy)[..., None])
    use = (is_gonio | (is_proj & in_win)) & (off >= 0)
    outside = torch.where(is_proj, torch.zeros_like(u), torch.ones_like(u))[..., None]
    return torch.where(use[..., None], c, outside)


def sample_light_rows(dev, li_idx, ref_p, u1, u2) -> LightSample:
    """Sample_Li for explicit light rows li_idx (R,) — no pick pmf folded."""
    lt = dev["light"]
    ltype = _take(lt["type"], li_idx)
    lp = _take(lt["p"], li_idx)
    lL = _take(lt["L"], li_idx)
    twosided = _take(lt["twosided"], li_idx)
    area = _take(lt["area"], li_idx)

    # -- point (and the position of spot and image lights) ----------------
    to_l = lp - ref_p
    d2 = torch.clamp(dot(to_l, to_l), min=1e-20)
    dist_pt = _sqrt(d2)
    wi_pt = to_l / dist_pt[..., None]
    li_pt = lL / d2[..., None]

    # -- area (triangle) --------------------------------------------------
    tv = _take(lt["tri_v"], li_idx)  # (R,3,3)
    p_l, n_l = sample_triangle_point(tv, u1, u2)
    to_a = p_l - ref_p
    d2a = torch.clamp(dot(to_a, to_a), min=1e-12)
    dist_a = _sqrt(d2a)
    wi_a = to_a / dist_a[..., None]
    cos_l = dot(n_l, -wi_a)
    emits = (cos_l > 0.0) | (twosided > 0)
    li_a = torch.where(emits[..., None], lL, torch.zeros_like(lL))
    pdf_a = d2a / torch.clamp(torch.abs(cos_l) * area, min=1e-12)

    is_pt = ltype == LIGHT_POINT
    is_spot = ltype == LIGHT_SPOT
    is_distant = ltype == LIGHT_DISTANT
    is_area = ltype == LIGHT_AREA
    is_gonio = ltype == LIGHT_GONIO
    is_proj = ltype == LIGHT_PROJECTION
    wi = torch.where(is_area[..., None], wi_a, wi_pt)
    li = torch.where(is_area[..., None], li_a, li_pt)
    pdf = torch.where(is_area, pdf_a, torch.ones_like(pdf_a))
    dist = torch.where(is_area, dist_a, dist_pt)

    # -- spot: the cone's falloff about the row's axis ---------------------
    fall = _spot_falloff(dot(-wi_pt, _take(lt["dir"], li_idx)), _take(lt["cos0"], li_idx),
                         _take(lt["cos1"], li_idx))
    li = torch.where(is_spot[..., None], li_pt * fall[..., None], li)

    # -- goniometric / projection: the point intensity times the map ----------
    if "light_atlas" in dev:
        li_img = li_pt * _light_map_scale(dev, lt, li_idx, -wi_pt, is_gonio, is_proj)
    else:
        li_img = li_pt
    li = torch.where((is_gonio | is_proj)[..., None], li_img, li)

    # -- distant: the direction toward the light, a shadow ray across the
    # scene (every compiled scene carries its radius; a bare table of
    # point and area rows needs none)
    if "world_radius" in dev:
        wi = torch.where(is_distant[..., None], _take(lt["dir"], li_idx), wi)
        li = torch.where(is_distant[..., None], lL, li)
        dist = torch.where(is_distant, 2.0 * dev["world_radius"] * torch.ones_like(dist), dist)

    # -- infinite: the shadow ray spans the scene -----------------------------
    if "envmap" in dev:
        is_env = ltype == LIGHT_INFINITE
        wi_env, pdf_env, li_env = _env_sample(dev, u1, u2)
        wi = torch.where(is_env[..., None], wi_env, wi)
        li = torch.where(is_env[..., None], li_env, li)
        pdf = torch.where(is_env, pdf_env, pdf)
        dist = torch.where(is_env, 2.0 * dev["world_radius"] * torch.ones_like(dist), dist)
    li = torch.where((pdf > 0.0)[..., None], li, torch.zeros_like(li))
    return LightSample(li, wi, pdf, dist, is_pt | is_spot | is_distant | is_gonio | is_proj,
                       li_idx)


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
        vx, vy, vz = (v[..., k].clamp(0, n - 1) for k, n in enumerate((nx, ny, nz)))
        return vx + nx * (vy + ny * vz)

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
    wi = to_h / _sqrt(d2)[..., None]
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



class LeSample(NamedTuple):
    """One sampled emission ray per lane (Light::Sample_Le)."""

    li_idx: torch.Tensor  # (R,) light row
    pmf: torch.Tensor  # (R,) pick pmf
    p: torch.Tensor  # (R,3) emission origin
    n: torch.Tensor  # (R,3) emission normal (the light's forward direction for deltas)
    d: torch.Tensor  # (R,3) emission direction
    le: torch.Tensor  # (R,3) emitted radiance / intensity
    pdf_pos: torch.Tensor  # (R,) area-measure position pdf (1 for delta positions)
    pdf_dir: torch.Tensor  # (R,) solid-angle direction pdf
    is_delta: torch.Tensor  # (R,) delta light (point, spot, image lights, distant)
    supported: torch.Tensor  # (R,) the row's type has an emission model


def sample_le(dev, light_distr, u_pick, up1, up2, ud1, ud2) -> LeSample:
    """Light::Sample_Le for BDPT/SPPM light subpaths (point.cpp,
    spot.cpp, diffuse.cpp, distant.cpp, infinite.cpp Sample_Le), batched
    with masked type dispatch. Distant and infinite lights emit from the
    scene-spanning disk behind their direction."""
    lt = dev["light"]
    n_lights = lt["type"].shape[0]
    if light_distr is None:
        li_idx = torch.clamp((u_pick * n_lights).to(torch.int64), max=n_lights - 1)
        pmf = torch.full(u_pick.shape, 1.0 / n_lights, dtype=torch.float32, device=u_pick.device)
    elif isinstance(light_distr, SpatialLightDistribution):
        # emission has no receiver position: pick by the scene marginal
        cdf = torch.cumsum(light_distr.mean_pmf, dim=0)
        li_idx = torch.clamp((u_pick[..., None] >= cdf).sum(dim=-1), max=n_lights - 1)
        pmf = torch.clamp(_take(light_distr.mean_pmf, li_idx), min=1e-12)
    else:
        li_idx, pmf = light_distr.sample_discrete(u_pick)
    ltype = _take(lt["type"], li_idx)
    lp = _take(lt["p"], li_idx)
    lL = _take(lt["L"], li_idx)
    ldir = _take(lt["dir"], li_idx)
    cos0 = _take(lt["cos0"], li_idx)
    cos1 = _take(lt["cos1"], li_idx)
    twosided = _take(lt["twosided"], li_idx)
    area = _take(lt["area"], li_idx)
    ones = torch.ones_like(ud1)

    # -- point: uniform sphere --------------------------------------------
    d_pt = uniform_sample_sphere(ud1, ud2)
    pdf_dir_pt = torch.full_like(ud1, 1.0 / (4.0 * torch.pi))

    # -- spot: uniform cone of the total width -----------------------------
    d_cone = uniform_sample_cone(ud1, ud2, cos1)  # local frame, +z axis
    s1, s2 = coordinate_system(ldir)
    d_spot = d_cone[..., 0:1] * s1 + d_cone[..., 1:2] * s2 + d_cone[..., 2:3] * ldir
    pdf_dir_spot = uniform_cone_pdf(cos1)
    le_spot = lL * _spot_falloff(d_cone[..., 2], cos0, cos1)[..., None]

    # -- area: uniform point on the triangle + cosine hemisphere; twosided
    # lights pick the emission side with a remapped ud1 and halve the
    # direction pdf (diffuse.cpp Sample_Le / Pdf_Le)
    tv = _take(lt["tri_v"], li_idx)
    p_a, n_front = sample_triangle_point(tv, up1, up2)
    two = twosided > 0
    flip = two & (ud1 >= 0.5)
    ud1_a = torch.where(two, torch.clamp(torch.remainder(ud1 * 2.0, 1.0), max=0.999999), ud1)
    n_a = torch.where(flip[..., None], -n_front, n_front)
    d_loc = cosine_sample_hemisphere(ud1_a, ud2)
    t1, t2 = coordinate_system(n_a)
    d_a = d_loc[..., 0:1] * t1 + d_loc[..., 1:2] * t2 + d_loc[..., 2:3] * n_a
    pdf_dir_a = torch.abs(d_loc[..., 2]) / torch.pi
    pdf_dir_a = torch.where(two, pdf_dir_a * 0.5, pdf_dir_a)
    pdf_pos_a = 1.0 / torch.clamp(area, min=1e-20)

    is_pt = ltype == LIGHT_POINT
    is_spot = ltype == LIGHT_SPOT
    is_area = ltype == LIGHT_AREA
    is_img = (ltype == LIGHT_GONIO) | (ltype == LIGHT_PROJECTION)
    is_distant = ltype == LIGHT_DISTANT
    is_env = ltype == LIGHT_INFINITE

    # -- distant: the row's dir points TOWARD the light (from - to), so
    # photons travel along -dir from a world-spanning disk a radius toward
    # the light; pdf_pos 1/(pi r^2), pdf_dir 1 (a delta direction)
    wr = dev["world_radius"]
    wc = dev["world_center"]
    dx_d, dy_d = concentric_sample_disk(up1, up2)
    v1d, v2d = coordinate_system(ldir)
    p_dist = wc + wr * (dx_d[..., None] * v1d + dy_d[..., None] * v2d) + ldir * wr
    pdf_pos_dist = 1.0 / (torch.pi * wr * wr)

    # -- infinite: a direction from the map's distribution (photons travel
    # -wi), the origin on the tangent disk behind it
    if "envmap" in dev:
        wi_e, pdf_e, le_e = _env_sample(dev, ud1, ud2)
        d_env = -wi_e
        dx_e, dy_e = concentric_sample_disk(up1, up2)
        v1e, v2e = coordinate_system(d_env)
        p_env = wc + wr * (dx_e[..., None] * v1e + dy_e[..., None] * v2e) - d_env * wr
        pdf_dir_env = pdf_e
        le_env = le_e
    else:  # no row of type infinite without a map: keep such lanes inert
        d_env = d_pt
        p_env = torch.broadcast_to(wc, d_pt.shape)
        pdf_dir_env = torch.zeros_like(ud1)
        le_env = torch.zeros_like(lL)
    supported = is_pt | is_spot | is_area | is_img | is_distant | is_env

    def pick(mask, a, b):
        return torch.where(mask[..., None] if a.dim() > mask.dim() else mask, a, b)

    p = pick(is_area, p_a, lp)
    p = pick(is_distant, p_dist, p)
    p = pick(is_env, p_env, p)
    n = pick(is_area, n_a, ldir)
    n = pick(is_distant, -ldir, n)
    n = pick(is_env, d_env, n)
    d = pick(is_area, d_a, d_pt)
    d = pick(is_spot, d_spot, d)
    d = pick(is_distant, -ldir, d)
    d = pick(is_env, d_env, d)
    le = pick(is_spot, le_spot, lL)
    le = pick(is_env, le_env, le)
    if "light_atlas" in dev:
        # image lights emit over the sphere with the map's factor
        le_img = lL * _light_map_scale(dev, lt, li_idx, d, ltype == LIGHT_GONIO,
                                       ltype == LIGHT_PROJECTION)
        le = pick(is_img, le_img, le)
    pdf_pos = torch.where(is_area, pdf_pos_a, ones)
    pdf_pos = torch.where(is_distant | is_env, pdf_pos_dist * ones, pdf_pos)
    pdf_dir = torch.where(is_area, pdf_dir_a, pdf_dir_pt)
    pdf_dir = torch.where(is_spot, pdf_dir_spot, pdf_dir)
    pdf_dir = torch.where(is_distant, ones, pdf_dir)
    pdf_dir = torch.where(is_env, pdf_dir_env, pdf_dir)
    is_delta = is_pt | is_spot | is_img | is_distant
    le = torch.where(supported[..., None], le, torch.zeros_like(le))
    return LeSample(li_idx, pmf, p, n, d, le, pdf_pos, pdf_dir, is_delta, supported)


def le_pdfs(dev, li_idx, n_emit, w):
    """Light::Pdf_Le for an emission configuration: the position pdf (area
    measure) and the direction pdf (solid angle) of emitting along w from
    light row li_idx whose surface normal is n_emit. Twosided area lights
    emit from either face at half the one-sided cosine pdf; a distant
    light's direction is a delta (pdf 0, which BDPT's MIS ratio walk
    remaps like any delta junction)."""
    lt = dev["light"]
    idx = li_idx.long()
    ltype = lt["type"][idx]
    cos1 = lt["cos1"][idx]
    area = lt["area"][idx]
    two = lt["twosided"][idx] > 0
    is_pt = ltype == LIGHT_POINT
    is_spot = ltype == LIGHT_SPOT
    is_area = ltype == LIGHT_AREA
    cos_l = dot(n_emit, w)
    pdf_area = torch.where(two, 0.5 * torch.abs(cos_l) / torch.pi,
                           torch.clamp(cos_l, min=0.0) / torch.pi)
    zero = torch.zeros_like(cos_l)
    pdf_dir = torch.where(is_pt, zero + 1.0 / (4.0 * torch.pi), zero)
    pdf_dir = torch.where(is_spot, uniform_cone_pdf(cos1), pdf_dir)
    pdf_dir = torch.where(is_area, pdf_area, pdf_dir)
    pdf_pos = torch.where(is_area, 1.0 / torch.clamp(area, min=1e-20), zero + 1.0)
    is_distant = ltype == LIGHT_DISTANT
    is_env = ltype == LIGHT_INFINITE
    wr = dev["world_radius"]
    disk_pdf = 1.0 / (torch.pi * wr * wr)
    pdf_pos = torch.where(is_distant | is_env, disk_pdf * (zero + 1.0), pdf_pos)
    pdf_dir = torch.where(is_distant, zero, pdf_dir)
    if "envmap" in dev:
        pdf_dir = torch.where(is_env, env_pdf(dev, -w), pdf_dir)
    return pdf_pos, pdf_dir
