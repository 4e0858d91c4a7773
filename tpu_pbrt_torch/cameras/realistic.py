"""RealisticCamera: spherical lens-element tracing with exit-pupil
bounds (port of tpu_pbrt/cameras/realistic.py; pbrt-v3
src/cameras/realistic.cpp).

The host side is the reference's numpy, copied: the lens prescription
(a pbrt lens .dat file, or the built-in doublet when there is none), the
aperture-stop diameter, the autofocus (bisection on the traced axial
crossing, float64) and the exit-pupil bounds table (64 radial segments,
seeded samples). The device side traces a batch of film rays through
the element stack, rear to front, in one static Python loop over the
few surfaces: dense vector math per surface (sphere or stop plane
intersection, aperture test, Snell refraction), and a lane that misses
an aperture or is totally internally reflected carries a failure mask
(weight 0 downstream) instead of returning early.

Geometry: the film sits on z = 0 looking down +z; surface i has its
vertex at z_apex[i] > 0, ordered rear (nearest the film) to front; a
surface of curvature 0 is the aperture stop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_pbrt_torch.core.vecmath import dot
from tpu_pbrt_torch.utils.error import Warning

#: radial segments of the exit-pupil bounds table (realistic.cpp uses 64)
N_PUPIL_SEGMENTS = 64
#: samples per segment for the host-side pupil bound estimation
_PUPIL_SAMPLES = 1024


class CompiledLens(NamedTuple):
    """The lens stack, rear (film side) to front: the surfaces as host f32
    arrays (the device trace's per-surface scalars), the pupil table on
    the render device."""

    z_apex: np.ndarray        # (N,) surface vertex z (camera space, > 0)
    radius: np.ndarray        # (N,) curvature radius; 0 = planar stop
    eta_ratio: np.ndarray     # (N,) eta_incident / eta_transmitted
    ap2: np.ndarray           # (N,) aperture radius squared
    rear_z: float             # z of the rear surface vertex
    rear_ap: float            # rear surface aperture radius
    pupil: torch.Tensor       # (N_PUPIL_SEGMENTS, 4) [x0, y0, x1, y1]
    film_diag: float          # film diagonal (m) the pupil table spans


# -- prescription ----------------------------------------------------------


def parse_lens_file(path: str) -> np.ndarray:
    """pbrt lens .dat: `radius thickness eta aperture-diameter` per row,
    millimeters, FRONT to REAR. Returns the same rows in meters."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            vals = [float(v) for v in line.split()]
            if len(vals) != 4:
                raise ValueError(f"lens row needs 4 values: {line!r}")
            rows.append(vals)
    if not rows:
        raise ValueError("empty lens file")
    out = np.asarray(rows, np.float64)
    out[:, [0, 1, 3]] *= 1e-3  # mm -> m; eta stays dimensionless
    return out


def builtin_doublet(focal: float = 0.050, ap_diam: float = 0.025) -> np.ndarray:
    """A symmetric biconvex crown singlet + planar stop with the requested
    focal length (lensmaker: 1/f = (n-1)(1/R1 - 1/R2)), used when no
    lensfile is available. Front-to-rear pbrt rows, meters."""
    n = 1.517  # BK7
    r = 2.0 * (n - 1.0) * focal  # symmetric biconvex: R1 = -R2 = r
    thick = 0.006
    return np.asarray(
        [
            # radius   thickness  eta   aperture diameter
            [r, thick, n, ap_diam * 1.4],        # front surface (air->glass)
            [-r, 0.004, 1.0, ap_diam * 1.4],     # rear surface (glass->air)
            [0.0, 0.010, 1.0, ap_diam],          # aperture stop
        ],
        np.float64,
    )


def apply_aperture_diameter(rows: np.ndarray, ap_diam: float) -> np.ndarray:
    """realistic.cpp constructor: the aperture-stop rows (curvature 0)
    take the requested "aperturediameter" unless it exceeds the stop's
    physical bound, in which case the prescription's diameter stands
    (with a warning, as pbrt does). rows are meters (parse_lens_file
    output); ap_diam is meters."""
    rows = np.array(rows, np.float64, copy=True)
    stop = rows[:, 0] == 0.0
    too_big = stop & (rows[:, 3] < ap_diam)
    if too_big.any():
        Warning(
            f"aperture diameter {ap_diam * 1000.0:.3f} mm is greater than "
            f"the lens stop's maximum {rows[too_big, 3].max() * 1000.0:.3f} "
            "mm; clamping to the stop"
        )
    rows[:, 3] = np.where(stop & ~too_big, ap_diam, rows[:, 3])
    return rows


def _stack_from_rows(rows: np.ndarray):
    """pbrt front-to-rear rows -> rear-to-front numpy arrays with
    absolute z apex positions (film at z=0; rear vertex z set later by
    focusing). Returns dict of host arrays (z offsets relative to the
    REAR vertex, which sits at z = film_distance)."""
    rows = np.asarray(rows, np.float64)
    n = len(rows)
    eta_med = np.where(rows[:, 2] > 0.0, rows[:, 2], 1.0)
    # z position of each surface, front surface at the largest z:
    # thickness[i] is the distance from surface i to surface i+1 (next
    # toward the film). Walk front->rear accumulating.
    z_rel = np.zeros(n)
    for i in range(1, n):
        z_rel[i] = z_rel[i - 1] - rows[i - 1, 1]
    # rearmost surface index n-1 has the smallest z; shift so rear = 0
    z_rel = z_rel - z_rel[-1]
    # rear-to-front ordering
    order = np.arange(n)[::-1]
    radius = rows[order, 0]
    ap_r = rows[order, 3] / 2.0
    z_off = z_rel[order]
    # medium eta on the FILM side of each surface (what the ray is in
    # before crossing, tracing film->front): for surface i (rear-to-
    # front), the incident medium is the medium between it and the
    # previous (more rearward) surface = eta listed on the surface
    # behind it in front-to-rear order (rows[order[i]] eta is the
    # medium BEHIND surface order[i], i.e. toward the film — pbrt's
    # convention: row eta is the medium on the z-negative side)
    eta_behind = eta_med[order]  # medium between this surface and film side
    eta_front = np.empty(n)
    # the medium in front of surface i (rear-to-front) is the medium
    # behind surface i+1; in front of the frontmost surface is air
    eta_front[:-1] = eta_behind[1:]
    eta_front[-1] = 1.0
    eta_ratio = eta_behind / eta_front  # incident/transmitted, film->scene
    return {
        "radius": radius,
        "ap_r": ap_r,
        "z_off": z_off,  # relative to rear vertex
        "eta_ratio": eta_ratio,
    }


# -- host-side ray trace (numpy, used for focusing + pupil precompute) -----


def _trace_np(stack, film_dist, o, d):
    """Trace rays (film space: film z=0, +z toward scene) through the
    stack. o: (R,3), d: (R,3) normalized-ish. Returns (ok, o, d)."""
    o = o.copy()
    d = d.copy()
    ok = np.ones(len(o), bool)
    for i in range(len(stack["radius"])):
        z_v = film_dist + stack["z_off"][i]
        R = stack["radius"][i]
        ap2 = stack["ap_r"][i] ** 2
        if R == 0.0:
            t = (z_v - o[:, 2]) / np.where(d[:, 2] == 0, 1e-12, d[:, 2])
            p = o + t[:, None] * d
            ok &= (t > 0) & (p[:, 0] ** 2 + p[:, 1] ** 2 <= ap2)
            o = p
            continue
        c = np.array([0.0, 0.0, z_v + R])
        oc = o - c
        b = np.sum(oc * d, axis=1)
        cc = np.sum(oc * oc, axis=1) - R * R
        disc = b * b - cc
        valid = disc >= 0
        sq = np.sqrt(np.maximum(disc, 0.0))
        # realistic.cpp IntersectSphericalElement root choice: use the
        # CLOSER root when (d.z > 0) ^ (R < 0), the farther one otherwise
        use_closer = (d[:, 2] > 0) ^ (R < 0)
        t = np.where(use_closer, -b - sq, -b + sq)
        valid &= t > 1e-9
        p = o + t[:, None] * d
        valid &= p[:, 0] ** 2 + p[:, 1] ** 2 <= ap2
        n = (p - c) / R  # outward when R>0 — orient against the ray below
        n = np.where(np.sum(n * d, axis=1)[:, None] > 0, -n, n)
        eta = stack["eta_ratio"][i]
        if eta != 1.0:
            cos_i = -np.sum(n * d, axis=1)
            s2 = np.maximum(0.0, 1.0 - cos_i**2) * eta * eta
            tir = s2 > 1.0
            valid &= ~tir
            cos_t = np.sqrt(np.maximum(0.0, 1.0 - s2))
            d_new = eta * d + (eta * cos_i - cos_t)[:, None] * n
            nl = np.linalg.norm(d_new, axis=1, keepdims=True)
            d = np.where(valid[:, None], d_new / np.maximum(nl, 1e-12), d)
        o = np.where(valid[:, None], p, o)
        ok &= valid
    return ok, o, d


def _focus(stack, focus_dist: float) -> float:
    """Film-to-rear-vertex distance that focuses a point at focus_dist
    (measured from the film plane) onto the film: bisection on the axial
    crossing of near-axis rays traced BACK from the object point
    (numerical thick-lens focus — same answer as realistic.cpp's
    FocusThickLens cardinal-point algebra, without needing the paraxial
    matrices)."""

    lens_span = float(stack["z_off"][0] - stack["z_off"][-1]) + 0.0
    lo, hi = 1e-4, max(0.5, 10.0 * lens_span + 0.3)

    # Trace from an on-axis film point forward and find where the exit
    # rays re-cross the axis; bisect film_dist until that conjugate
    # lands at focus_dist.
    def converge_z(film_dist):
        # two rays from the on-axis film point through different pupil
        # heights; after the lens they cross at the conjugate object
        # distance for THIS film_dist
        h1 = stack["ap_r"][0] * 0.15
        h2 = stack["ap_r"][0] * 0.3
        rear_z = film_dist
        o = np.zeros((2, 3))
        d = np.array([[h1, 0.0, rear_z], [h2, 0.0, rear_z]])
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        ok, o2, d2 = _trace_np(stack, film_dist, o, d)
        if not ok.all():
            return None
        # crossing of each exit ray with the axis (x = 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = -o2[:, 0] / d2[:, 0]
        z = o2[:, 2] + t * d2[:, 2]
        if not np.all(np.isfinite(z)) or np.any(t <= 0):
            return None
        return float(z.mean())

    best = None
    # bisection on f(film_dist) = converge_z - focus_dist (monotone
    # decreasing in film_dist for a converging lens)
    flo, fhi = None, None
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        z = converge_z(mid)
        if z is None:
            hi = mid  # vignetted/diverged: shrink
            continue
        err = z - focus_dist
        if best is None or abs(err) < best[1]:
            best = (mid, abs(err))
        if err > 0:
            lo = mid
        else:
            hi = mid
    return best[0] if best else 0.05


def _exit_pupil(stack, film_dist: float, film_diag: float) -> np.ndarray:
    """(N_PUPIL_SEGMENTS, 4) bounding boxes (on the rear-element plane)
    of ray directions that make it through the lens, per radial film
    position r in [0, film_diag/2] (realistic.cpp ComputeExitPupilBounds):
    sample the rear aperture square, trace, bound the survivors."""
    rng = np.random.default_rng(7)
    rear_ap = float(stack["ap_r"][0])  # rear-to-front index 0 = rear
    half = rear_ap * 1.5
    bounds = np.zeros((N_PUPIL_SEGMENTS, 4), np.float32)
    for i in range(N_PUPIL_SEGMENTS):
        r = (i + 0.5) / N_PUPIL_SEGMENTS * (film_diag / 2.0)
        px = rng.uniform(-half, half, _PUPIL_SAMPLES)
        py = rng.uniform(-half, half, _PUPIL_SAMPLES)
        o = np.stack([np.full_like(px, r), np.zeros_like(px),
                      np.zeros_like(px)], axis=1)
        tgt = np.stack([px, py, np.full_like(px, film_dist)], axis=1)
        d = tgt - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        ok, _, _ = _trace_np(stack, film_dist, o, d)
        if ok.any():
            bounds[i] = [px[ok].min(), py[ok].min(), px[ok].max(), py[ok].max()]
        else:
            # vignetted segment: keep the previous segment's bounds so
            # sampling still draws (weight masks the failures)
            bounds[i] = bounds[i - 1] if i else [-half, -half, half, half]
    # widen by one sample spacing (pbrt expands by the sample diagonal)
    pad = 2.0 * half / np.sqrt(_PUPIL_SAMPLES)
    bounds += np.array([-pad, -pad, pad, pad], np.float32)
    return bounds


def compile_lens(rows: np.ndarray, focus_dist: float, film_diag: float,
                 device="cpu") -> CompiledLens:
    """The prescription focused at focus_dist, its pupil table, on `device`."""
    stack = _stack_from_rows(rows)
    film_dist = _focus(stack, focus_dist)
    pupil = _exit_pupil(stack, film_dist, film_diag)
    return CompiledLens(
        z_apex=np.asarray(film_dist + stack["z_off"], np.float32),
        radius=np.asarray(stack["radius"], np.float32),
        eta_ratio=np.asarray(stack["eta_ratio"], np.float32),
        ap2=np.asarray(stack["ap_r"] ** 2, np.float32),
        rear_z=float(film_dist), rear_ap=float(stack["ap_r"][0]),
        pupil=torch.from_numpy(pupil).to(device), film_diag=float(film_diag),
    )


# -- device side ----------------------------------------------------------------


def _full(x, v: float):
    return torch.full_like(x, v)


def trace_lenses(lens: CompiledLens, o, d):
    """Batched film -> scene trace in camera space. o, d: (..., 3).
    Returns (ok, o', d'); a failed lane's o and d are left where it
    failed. The reference's per-surface formulas, with each surface's
    constants as f32 scalars."""
    ok = torch.ones(o.shape[:-1], dtype=torch.bool, device=o.device)
    for z_v, R, eta, ap2 in zip(*(a.tolist() for a in lens[:4])):
        planar = R == 0.0
        dz = d[..., 2]
        dz = torch.where(dz == 0.0, _full(dz, 1e-12), dz)
        t_plane = (_full(dz, z_v) - o[..., 2]) / dz
        c = torch.tensor([0.0, 0.0, np.float32(z_v) + np.float32(R)], dtype=torch.float32,
                         device=o.device)
        oc = o - c
        b = dot(oc, d)
        cc = dot(oc, oc) - np.float32(R) * np.float32(R)
        disc = b * b - cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        # realistic.cpp root choice: the closer root when (d.z > 0) ^ (R < 0)
        use_closer = (d[..., 2] > 0.0) ^ (R < 0.0)
        t_sph = torch.where(use_closer, -b - sq, -b + sq)
        t = t_plane if planar else t_sph
        valid = t > 1e-9
        if not planar:
            valid = valid & (disc >= 0.0)
        p = o + t[..., None] * d
        valid = valid & (p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] <= ap2)
        if not planar and abs(eta - 1.0) > 1e-6:
            nrm = (p - c) / torch.full_like(p, R)
            nrm = torch.where((dot(nrm, d) > 0.0)[..., None], -nrm, nrm)
            cos_i = -dot(nrm, d)
            s2 = torch.clamp(1.0 - cos_i * cos_i, min=0.0) * np.float32(eta) * np.float32(eta)
            cos_t = torch.sqrt(torch.clamp(1.0 - s2, min=0.0))
            d_ref = np.float32(eta) * d + (np.float32(eta) * cos_i - cos_t)[..., None] * nrm
            d_ref = d_ref / torch.clamp(torch.sqrt(dot(d_ref, d_ref))[..., None], min=1e-12)
            valid = valid & ~(s2 > 1.0)
            d = torch.where(valid[..., None], d_ref, d)
        o = torch.where(valid[..., None], p, o)
        ok = ok & valid
    return ok, o, d


def sample_pupil(lens: CompiledLens, p_film_cam, u_lens):
    """realistic.cpp SampleExitPupil: the film point's radial segment's
    bounds box, sampled by u_lens and rotated to the point's azimuth.
    Returns (p_rear (..., 3), area (...,) of the sampled box)."""
    r = torch.sqrt(p_film_cam[..., 0] * p_film_cam[..., 0]
                   + p_film_cam[..., 1] * p_film_cam[..., 1])
    fi = torch.clamp(r / _full(r, lens.film_diag / 2.0) * N_PUPIL_SEGMENTS, 0.0,
                     N_PUPIL_SEGMENTS - 1.0)
    box = lens.pupil[fi.to(torch.int64)]  # (..., 4)
    x = box[..., 0] + u_lens[..., 0] * (box[..., 2] - box[..., 0])
    y = box[..., 1] + u_lens[..., 1] * (box[..., 3] - box[..., 1])
    area = (box[..., 2] - box[..., 0]) * (box[..., 3] - box[..., 1])
    rs = torch.clamp(r, min=1e-12)
    sin_a = torch.where(r > 1e-12, p_film_cam[..., 1] / rs, torch.zeros_like(r))
    cos_a = torch.where(r > 1e-12, p_film_cam[..., 0] / rs, torch.ones_like(r))
    px = cos_a * x - sin_a * y
    py = sin_a * x + cos_a * y
    return torch.stack([px, py, _full(px, lens.rear_z)], dim=-1), area
