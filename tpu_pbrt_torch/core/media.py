"""Participating media: transmittance, distance sampling, phase functions
(port of tpu_pbrt/core/media.py).

- the Henyey-Greenstein phase function (`hg_p`) and its sampling
  (`hg_sample`), as pbrt-v3's medium.cpp;
- homogeneous media (homogeneous.cpp): closed-form Beer-Lambert Tr, and
  distance sampling on a spectral channel picked uniformly, weighted by
  the channel-average pdf;
- grid media (grid.cpp GridDensityMedium): trilinear density, ratio
  tracking for Tr and delta tracking for distance sampling against the
  grid's majorant, over at most _MAX_TRACKING_STEPS steps.

Media are a SoA table (type enum, sigma_a, sigma_s, g) plus one density
grid; a ray carries the id of its current medium (-1: vacuum). Every
random number is the reference's draw: `uniform_float(px, py, s, salt
+ k)` with the reference's offsets k. The expression order is the
reference's. A tracking step's draws depend only on its index, so the
loops stop once no lane they serve can change (one host read per step):
the steps after that would change nothing.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tpu_pbrt_torch.core.sampling import _div, uniform_float
from tpu_pbrt_torch.core.vecmath import coordinate_system
from tpu_pbrt_torch.core.xla_math import sqrt as _sqrt

MEDIUM_NONE = -1
MEDIUM_HOMOGENEOUS = 0
MEDIUM_GRID = 1

# pbrt medium.cpp SubsurfaceParameterTable (sigma_prime_s, sigma_a): the
# entries the reference carries
MEDIUM_PRESETS = {
    "milk": (np.array([2.55, 3.21, 3.77]), np.array([0.0011, 0.0024, 0.014])),
    "skimmilk": (np.array([0.70, 1.22, 1.90]), np.array([0.0014, 0.0025, 0.0142])),
    "wholemilk": (np.array([2.55, 3.21, 3.77]), np.array([0.0011, 0.0024, 0.014])),
    "skin1": (np.array([0.74, 0.88, 1.01]), np.array([0.032, 0.17, 0.48])),
    "skin2": (np.array([1.09, 1.59, 1.79]), np.array([0.013, 0.070, 0.145])),
    "marble": (np.array([2.19, 2.62, 3.00]), np.array([0.0021, 0.0041, 0.0071])),
    "cream": (np.array([7.38, 5.47, 3.15]), np.array([0.0002, 0.0028, 0.0163])),
    "ketchup": (np.array([0.18, 0.07, 0.03]), np.array([0.061, 0.97, 1.45])),
    "coke": (np.array([0.01, 0.01, 0.01]), np.array([0.10014, 0.16503, 0.2468])),
}

#: the reference's bound on the tracking loops' steps
_MAX_TRACKING_STEPS = 256


class MediumTable(NamedTuple):
    """Device SoA of media rows, with one density grid (the reference's
    single grid slot)."""

    mtype: torch.Tensor  # (M,) int32
    sigma_a: torch.Tensor  # (M, 3)
    sigma_s: torch.Tensor  # (M, 3)
    g: torch.Tensor  # (M,)
    grid_id: torch.Tensor  # (M,) -1 or 0
    density: torch.Tensor  # (D, H, W), or (1, 1, 1) without a grid
    world_to_medium: torch.Tensor  # (4, 4)
    sigma_t_max: torch.Tensor  # () majorant for the tracking loops


def medium_table_numpy(rows, density=None, world_to_medium=None, sigma_t_max=0.0) -> tuple:
    """The table's fields in order, as numpy arrays, from the compiler's
    rows (dicts with type, sa, ss, g, grid); no rows: the empty table."""
    if not rows:
        rows = [dict(type=MEDIUM_HOMOGENEOUS, sa=np.zeros(3), ss=np.zeros(3), g=0.0, grid=-1)]
    return (
        np.asarray([r["type"] for r in rows], np.int32),
        np.asarray(np.array([r["sa"] for r in rows]), np.float32),
        np.asarray(np.array([r["ss"] for r in rows]), np.float32),
        np.asarray([r["g"] for r in rows], np.float32),
        np.asarray([r["grid"] for r in rows], np.int32),
        np.asarray(density if density is not None else np.zeros((1, 1, 1)), np.float32),
        np.asarray(world_to_medium if world_to_medium is not None else np.eye(4), np.float32),
        np.float32(sigma_t_max),
    )


def empty_medium_table(device="cpu") -> MediumTable:
    return MediumTable(*(torch.as_tensor(a).to(device) for a in medium_table_numpy([])))


# -- Henyey-Greenstein (medium.cpp) -----------------------------------------

def hg_p(cos_theta, g):
    denom = 1.0 + g * g + 2.0 * g * cos_theta
    return (1.0 / (4.0 * math.pi)) * (1.0 - g * g) / (
        denom * _sqrt(torch.clamp(denom, min=1e-9)))


def hg_sample(wo, g, u1, u2):
    """HenyeyGreenstein::Sample_p around wo: returns (wi, pdf = p)."""
    small = torch.abs(g) < 1e-3
    g_safe = torch.where(small, torch.where(g < 0, -1e-3, 1e-3), g)
    sq = (1.0 - g_safe * g_safe) / (1.0 + g_safe - 2.0 * g_safe * u1)
    cos_theta_hg = -(1.0 + g_safe * g_safe - sq * sq) / (2.0 * g_safe)
    cos_theta = torch.where(small, 1.0 - 2.0 * u1, cos_theta_hg)
    sin_theta = _sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * math.pi * u2
    v1, v2 = coordinate_system(wo)
    wi = (sin_theta[..., None] * torch.cos(phi)[..., None] * v1
          + sin_theta[..., None] * torch.sin(phi)[..., None] * v2
          + cos_theta[..., None] * wo)
    return wi, hg_p(cos_theta, g)


# -- grid density (grid.cpp GridDensityMedium::Density) ----------------------

def grid_density(mt: MediumTable, p_world):
    """Trilinear density at world points; taps outside the grid read 0,
    and points outside the medium's [0,1]^3 read 0."""
    m = mt.world_to_medium
    px, py, pz = p_world[..., 0], p_world[..., 1], p_world[..., 2]
    # the affine transform term by term, in the order of a 3-term dot
    p = [px * m[r, 0] + py * m[r, 1] + pz * m[r, 2] + m[r, 3] for r in range(3)]
    d, h, w = mt.density.shape
    gx = p[0] * w - 0.5
    gy = p[1] * h - 0.5
    gz = p[2] * d - 0.5

    def cell(g):
        # floor, then an int cast that saturates where the float is out of
        # range (such points lie outside the medium and read 0 anyway)
        return torch.clamp(torch.floor(g), -(2.0 ** 30), 2.0 ** 30).to(torch.int64)

    x0, y0, z0 = cell(gx), cell(gy), cell(gz)
    fx, fy, fz = gx - x0, gy - y0, gz - z0
    flat = mt.density.reshape(-1)

    def tap(xi, yi, zi):
        inb = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h) & (zi >= 0) & (zi < d)
        k = (zi.clamp(0, d - 1) * h + yi.clamp(0, h - 1)) * w + xi.clamp(0, w - 1)
        v = flat[k]
        return torch.where(inb, v, torch.zeros_like(v))

    d00 = tap(x0, y0, z0) * (1 - fx) + tap(x0 + 1, y0, z0) * fx
    d10 = tap(x0, y0 + 1, z0) * (1 - fx) + tap(x0 + 1, y0 + 1, z0) * fx
    d01 = tap(x0, y0, z0 + 1) * (1 - fx) + tap(x0 + 1, y0, z0 + 1) * fx
    d11 = tap(x0, y0 + 1, z0 + 1) * (1 - fx) + tap(x0 + 1, y0 + 1, z0 + 1) * fx
    d0 = d00 * (1 - fy) + d10 * fy
    d1 = d01 * (1 - fy) + d11 * fy
    inside = ((p[0] >= 0) & (p[0] <= 1) & (p[1] >= 0) & (p[1] <= 1)
              & (p[2] >= 0) & (p[2] <= 1))
    val = d0 * (1 - fz) + d1 * fz
    return torch.where(inside, val, torch.zeros_like(val))


def _has_grid(mt: MediumTable) -> bool:
    return mt.density.numel() > 1


def medium_tr(mt: MediumTable, med_id, o, d, t_max, px, py, s, salt):
    """Medium::Tr along [0, t_max] in each ray's current medium (1 for
    vacuum): Beer-Lambert for homogeneous rows, ratio tracking against the
    majorant for the grid row. Returns (R, 3)."""
    active = med_id >= 0
    idx = med_id.clamp(min=0).long()
    sig_t = mt.sigma_a[idx] + mt.sigma_s[idx]
    t_cl = torch.clamp(t_max, max=1e7)  # avoid inf * 0
    tr = torch.exp(-sig_t * t_cl[..., None])

    if _has_grid(mt):
        inv_max = 1.0 / torch.clamp(mt.sigma_t_max, min=1e-9)
        sig_t1 = sig_t[..., 0]  # grid media are monochromatic in sigma
        is_grid = mt.mtype[idx] == MEDIUM_GRID
        need = active & is_grid
        t = torch.zeros_like(t_cl)
        tr_grid = torch.ones_like(t_cl)
        for i in range(_MAX_TRACKING_STEPS):
            u = uniform_float(px, py, s, salt + 3000 + i)
            t = t - torch.log(1.0 - u) * inv_max
            dens = grid_density(mt, o + t[..., None] * d)
            live = t < t_max
            tr_grid = torch.where(
                live, tr_grid * (1.0 - torch.clamp(dens * sig_t1 * inv_max, min=0.0)), tr_grid)
            # t only grows: a lane past t_max never changes again
            if not bool((live & need).any()):
                break
        tr = torch.where(is_grid[..., None], tr_grid[..., None], tr)
    return torch.where(active[..., None], tr, torch.ones_like(tr))


class MediumSample(NamedTuple):
    sampled_medium: torch.Tensor  # (R,) bool: the interaction is inside the medium
    t: torch.Tensor  # (R,) interaction distance
    weight: torch.Tensor  # (R, 3) beta multiplier (Tr*sigma_s/pdf or Tr/pdf)


def _mean3(x):
    """The mean over the last (RGB) axis: ((x0 + x1) + x2) / 3, an IEEE
    division on every device."""
    return _div(x[..., 0] + x[..., 1] + x[..., 2], 3)


def medium_sample(mt: MediumTable, med_id, o, d, t_hit, px, py, s, salt) -> MediumSample:
    """Medium::Sample along a segment ending at the surface hit t_hit
    (inf: no surface). Homogeneous: a channel picked uniformly, an
    exponential distance in it, Tr*sigma_s/pdf inside the medium or
    Tr/pdf at the surface, the pdfs averaged over the channels. Grid:
    delta tracking against the majorant."""
    active = med_id >= 0
    idx = med_id.clamp(min=0).long()
    sig_a = mt.sigma_a[idx]
    sig_s = mt.sigma_s[idx]
    sig_t = sig_a + sig_s
    t_end = torch.clamp(t_hit, max=1e7)

    # ---- homogeneous ------------------------------------------------------
    uc = uniform_float(px, py, s, salt)
    ud = uniform_float(px, py, s, salt + 1)
    ch = torch.clamp((uc * 3).to(torch.int32), max=2)
    sig_ch = torch.gather(sig_t, -1, ch.long()[..., None])[..., 0]
    t_s = -torch.log(torch.clamp(1.0 - ud, min=1e-20)) / torch.clamp(sig_ch, min=1e-20)
    in_medium = (t_s < t_end) & (sig_ch > 0)
    t_m = torch.minimum(t_s, t_end)
    tr = torch.exp(-sig_t * t_m[..., None])
    pdf_m = _mean3(sig_t * tr)
    pdf_surf = _mean3(tr)
    w_medium = tr * sig_s / torch.clamp(pdf_m, min=1e-20)[..., None]
    w_surface = tr / torch.clamp(pdf_surf, min=1e-20)[..., None]
    weight = torch.where(in_medium[..., None], w_medium, w_surface)

    if _has_grid(mt):
        # ---- grid: delta tracking ------------------------------------------
        inv_max = 1.0 / torch.clamp(mt.sigma_t_max, min=1e-9)
        sig_t1 = sig_t[..., 0]
        albedo = sig_s[..., 0] / torch.clamp(sig_t1, min=1e-20)
        is_grid = mt.mtype[idx] == MEDIUM_GRID
        need = active & is_grid
        t = torch.zeros_like(t_end)
        done = torch.zeros_like(t_end, dtype=torch.bool)
        hit_med = torch.zeros_like(done)
        for i in range(_MAX_TRACKING_STEPS):
            u1 = uniform_float(px, py, s, salt + 5000 + 2 * i)
            u2 = uniform_float(px, py, s, salt + 5001 + 2 * i)
            t_new = t - torch.log(1.0 - u1) * inv_max
            esc = t_new >= t_end
            dens = grid_density(mt, o + t_new[..., None] * d)
            real = u2 < dens * sig_t1 * inv_max
            hit_med = hit_med | (~done & real & ~esc)
            t = torch.where(done, t, t_new)
            done = done | esc | real
            # a finished lane keeps its t and its verdict
            if not bool((~done & need).any()):
                break
        in_medium = torch.where(is_grid, hit_med, in_medium)
        t_m = torch.where(is_grid, torch.minimum(t, t_end), t_m)
        # delta tracking's weight: sigma_s/sigma_t on a real collision, 1 on escape
        w_grid = torch.where(hit_med[..., None], albedo[..., None].expand(albedo.shape + (3,)),
                             torch.ones_like(weight))
        weight = torch.where(is_grid[..., None], w_grid, weight)

    in_medium = in_medium & active
    weight = torch.where(active[..., None], weight, torch.ones_like(weight))
    return MediumSample(in_medium, t_m, weight)
