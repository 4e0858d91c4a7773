"""Cameras: host construction + batched ray generation (port of
tpu_pbrt/cameras/__init__.py: the perspective, orthographic, environment
and realistic cameras).

The projective chain (screen window -> raster -> camera) is built on the
host exactly as pbrt's ProjectiveCamera constructor (and the reference)
does; ray generation is one vectorized pass over a batch of film points,
with the thin-lens model when lensradius > 0 (the orthographic camera
keeps its z origin under the lens), the lat-long sphere for the
environment camera, and the element-stack trace of cameras/realistic.py
for the realistic camera, whose vignetted lanes carry weight 0. Point
transforms are written out term by term in the reference's summation
order. The importance side that BDPT's camera strategies read (We's pdf,
Sample_Wi and the world-to-raster projection) is the reference's pinhole
formula for every camera type (for the realistic camera its projective
matrices hold a thin-lens proxy, as in the reference); the inverse
matrices that projection needs are taken on the host whatever the render
device, as the reference's CPU inverse takes them, so every device lands
a splat in the same pixel. `ray_differentials` gives the one-pixel
offset rays' deltas that the texture footprint of a camera hit reads.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from tpu_pbrt_torch.core import transform as xf
from tpu_pbrt_torch.core.sampling import _div, concentric_sample_disk
from tpu_pbrt_torch.core.vecmath import dot, normalize
from tpu_pbrt_torch.utils.error import Error, Warning

CAM_PERSPECTIVE = 0
CAM_ORTHOGRAPHIC = 1
CAM_ENVIRONMENT = 2
CAM_REALISTIC = 3


class CompiledCamera(NamedTuple):
    cam_type: int
    raster_to_camera: torch.Tensor  # (4,4) f32
    camera_to_world: torch.Tensor  # (4,4) f32
    lens_radius: float
    focal_distance: float
    shutter_open: float
    shutter_close: float
    full_res: tuple  # (x, y)
    lens: object = None  # realistic.CompiledLens for CAM_REALISTIC


def _screen_window(aspect: float, params) -> tuple:
    sw = params.find_float("screenwindow")
    if aspect > 1.0:
        screen = [-aspect, aspect, -1.0, 1.0]
    else:
        screen = [-1.0, 1.0, -1.0 / aspect, 1.0 / aspect]
    if sw is not None:
        if len(sw) == 4:
            screen = [sw[0], sw[1], sw[2], sw[3]]
        else:
            Error('"screenwindow" should have four values')
    return screen


def make_camera(name: str, params, cam_to_world: xf.Transform, full_res,
                shutter=(0.0, 1.0), film_diag: float = 0.035, scene_dir: str = ".",
                device="cpu") -> CompiledCamera:
    """api.cpp MakeCamera: the perspective, orthographic, environment and
    realistic cameras; an unknown name takes "perspective" with the
    reference's warning. For the realistic camera the projective
    matrices hold the reference's thin-lens proxy (a fov from the focused
    film distance), which only the pinhole-approximated importance side
    reads."""
    res_x, res_y = full_res
    aspect = params.find_one_float("frameaspectratio", res_x / res_y)
    lens_radius = params.find_one_float("lensradius", 0.0)
    focal = params.find_one_float("focaldistance", 1e6)
    lens = None
    if name in ("perspective", "realistic"):
        if name == "realistic":
            from tpu_pbrt_torch.cameras.realistic import (
                apply_aperture_diameter,
                builtin_doublet,
                compile_lens,
                parse_lens_file,
            )
            from tpu_pbrt_torch.utils.fileutil import resolve_filename

            ap_diam = params.find_one_float("aperturediameter", 1.0) / 1000.0
            focal = params.find_one_float("focusdistance", 10.0)
            lens_file = params.find_one_string("lensfile", "")
            rows = None
            if lens_file:
                try:
                    rows = apply_aperture_diameter(
                        parse_lens_file(resolve_filename(lens_file, scene_dir)), ap_diam)
                except Exception as e:  # noqa: BLE001 - the reference substitutes on any failure
                    Warning(f'realistic: could not read lensfile "{lens_file}" ({e}); '
                            "using the built-in doublet")
            if rows is None:
                rows = builtin_doublet(ap_diam=max(ap_diam, 1e-4))
            lens = compile_lens(rows, focal, film_diag, device=device)
            ctype = CAM_REALISTIC
            fov = math.degrees(2.0 * math.atan(0.5 * film_diag / max(lens.rear_z, 1e-4)))
            lens_radius = ap_diam / 2.0
        else:
            fov = params.find_one_float("fov", 90.0)
            halffov = params.find_one_float("halffov", -1.0)
            if halffov > 0:
                fov = 2.0 * halffov
            ctype = CAM_PERSPECTIVE
        screen = _screen_window(aspect, params)
        cam_to_screen = xf.perspective(fov, 1e-2, 1000.0)
    elif name == "orthographic":
        screen = _screen_window(aspect, params)
        cam_to_screen = xf.orthographic(0.0, 1.0)
        ctype = CAM_ORTHOGRAPHIC
    elif name == "environment":
        screen = [-1.0, 1.0, -1.0, 1.0]
        cam_to_screen = xf.Transform()
        ctype = CAM_ENVIRONMENT
    else:
        Warning(f'Camera "{name}" unknown; using "perspective".')
        return make_camera("perspective", params, cam_to_world, full_res, shutter,
                           device=device)
    x0, x1, y0, y1 = screen
    screen_to_raster = (
        xf.scale(res_x, res_y, 1.0)
        * xf.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0)
        * xf.translate([-x0, -y1, 0.0])
    )
    raster_to_camera = cam_to_screen.inverse() * screen_to_raster.inverse()
    return CompiledCamera(
        cam_type=ctype,
        raster_to_camera=torch.from_numpy(
            np.asarray(raster_to_camera.m, np.float32)).to(device),
        camera_to_world=torch.from_numpy(
            np.asarray(cam_to_world.m, np.float32)).to(device),
        lens_radius=float(np.float32(lens_radius)),
        focal_distance=float(np.float32(focal)),
        shutter_open=shutter[0],
        shutter_close=shutter[1],
        full_res=(res_x, res_y),
        lens=lens,
    )


def _xform_point(m, p):
    r = [((p[..., 0] * m[i, 0] + p[..., 1] * m[i, 1]) + p[..., 2] * m[i, 2]) + m[i, 3]
         for i in range(3)]
    w = ((p[..., 0] * m[3, 0] + p[..., 1] * m[3, 1]) + p[..., 2] * m[3, 2]) + m[3, 3]
    w = torch.where(w == 0.0, torch.ones_like(w), w)
    return torch.stack(r, dim=-1) / w[..., None]


def _xform_vector(m, v):
    return torch.stack(
        [(v[..., 0] * m[i, 0] + v[..., 1] * m[i, 1]) + v[..., 2] * m[i, 2] for i in range(3)],
        dim=-1,
    )


def _realistic_rays(cam: CompiledCamera, p_film, u_lens):
    """realistic.cpp GenerateRay: raster -> physical film point (x
    negated, pbrt's film orientation), an exit-pupil sample, the element
    trace; the weight is cos^4 x the sampled pupil box's area over the
    on-axis box's (exposure-normalized simple weighting), 0 where the
    lens vignettes the ray."""
    from tpu_pbrt_torch.cameras.realistic import sample_pupil, trace_lenses

    lens = cam.lens
    rx, ry = cam.full_res
    a = ry / rx
    fx = np.float32(np.sqrt(lens.film_diag ** 2 / (1.0 + a * a)))
    fy = np.float32(a * fx)
    sx = _div(p_film[..., 0], rx)
    sy = _div(p_film[..., 1], ry)
    pf = torch.stack([-(sx - 0.5) * fx, (sy - 0.5) * fy, torch.zeros_like(sx)], dim=-1)
    p_rear, area = sample_pupil(lens, pf, u_lens)
    d0 = normalize(p_rear - pf)
    ok, o_c, d_c = trace_lenses(lens, pf, d0)
    c = torch.clamp(d0[..., 2], min=0.0)
    c2 = c * c
    area0 = (lens.pupil[0, 2] - lens.pupil[0, 0]) * (lens.pupil[0, 3] - lens.pupil[0, 1])
    weight = torch.where(ok, c2 * c2 * area / torch.clamp(area0, min=1e-20),
                         torch.zeros_like(c))
    o_w = _xform_point(cam.camera_to_world, o_c)
    d_w = normalize(_xform_vector(cam.camera_to_world, d_c))
    return o_w, d_w, weight


def generate_rays(cam: CompiledCamera, p_film, u_lens):
    """Batched Camera::GenerateRay. p_film: (...,2) raster-space sample
    points; u_lens: (...,2) in [0,1). Returns world (o, d, weight)."""
    if cam.cam_type == CAM_REALISTIC:
        return _realistic_rays(cam, p_film, u_lens)
    p_raster = torch.cat([p_film, torch.zeros_like(p_film[..., :1])], dim=-1)
    p_cam = _xform_point(cam.raster_to_camera, p_raster)
    if cam.cam_type == CAM_PERSPECTIVE:
        o = torch.zeros_like(p_cam)
        d = normalize(p_cam)
    elif cam.cam_type == CAM_ORTHOGRAPHIC:
        o = p_cam
        d = torch.zeros_like(p_cam)
        d[..., 2] = 1.0
    else:  # environment: lat-long over the whole sphere (environment.cpp)
        theta = _div(torch.pi * p_film[..., 1], cam.full_res[1])
        phi = _div(2.0 * torch.pi * p_film[..., 0], cam.full_res[0])
        sin_t = torch.sin(theta)
        d = torch.stack([sin_t * torch.cos(phi), torch.cos(theta), sin_t * torch.sin(phi)],
                        dim=-1)
        o = torch.zeros_like(d)
    if cam.cam_type != CAM_ENVIRONMENT and cam.lens_radius > 0.0:
        # thin-lens depth of field (ProjectiveCamera lens code); the
        # orthographic camera keeps its z origin
        lx, ly = concentric_sample_disk(u_lens[..., 0], u_lens[..., 1])
        p_lens = cam.lens_radius * torch.stack([lx, ly], dim=-1)
        dz = d[..., 2]
        ft = cam.focal_distance / torch.where(dz == 0.0, torch.ones_like(dz), dz)
        p_focus = o + ft[..., None] * d
        o_new = torch.cat([p_lens, torch.zeros_like(p_lens[..., :1])], dim=-1)
        if cam.cam_type == CAM_ORTHOGRAPHIC:
            o_new = o_new + o * torch.tensor([0.0, 0.0, 1.0], device=o.device)
        d = normalize(p_focus - o_new)
        o = o_new
    o_w = _xform_point(cam.camera_to_world, o)
    d_w = normalize(_xform_vector(cam.camera_to_world, d))
    weight = torch.ones(p_film.shape[:-1], dtype=torch.float32, device=p_film.device)
    return o_w, d_w, weight


def ray_differentials(cam: CompiledCamera, p_film):
    """Camera::GenerateRayDifferential's offset-ray deltas (camera.cpp):
    world-space (d_origin/dx, d_dir/dx, d_origin/dy, d_dir/dy) for a
    +1-raster-pixel step, pinhole-analytic as in the reference (the
    thin-lens jitter is ignored, as pbrt's differentials assume the
    primary ray; the realistic camera takes its thin-lens proxy)."""
    zero = torch.zeros(p_film.shape[:-1] + (3,), dtype=torch.float32, device=p_film.device)
    if cam.cam_type == CAM_ENVIRONMENT:
        x, y = p_film[..., 0], p_film[..., 1]

        def dir_at(xx, yy):
            theta = _div(torch.pi * yy, cam.full_res[1])
            phi = _div(2.0 * torch.pi * xx, cam.full_res[0])
            d = torch.stack([torch.sin(theta) * torch.cos(phi), torch.cos(theta),
                             torch.sin(theta) * torch.sin(phi)], dim=-1)
            return normalize(_xform_vector(cam.camera_to_world, d))

        base = dir_at(x, y)
        return zero, dir_at(x + 1.0, y) - base, zero, dir_at(x, y + 1.0) - base

    p_raster = torch.cat([p_film, torch.zeros_like(p_film[..., :1])], dim=-1)
    p_cam = _xform_point(cam.raster_to_camera, p_raster)
    # raster steps as projected point differences (camera.cpp shifts the
    # CameraSample by one pixel; raster_to_camera is projective)
    step_x = torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=p_film.device)
    step_y = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=p_film.device)
    dx_cam = _xform_point(cam.raster_to_camera, p_raster + step_x) - p_cam
    dy_cam = _xform_point(cam.raster_to_camera, p_raster + step_y) - p_cam
    if cam.cam_type in (CAM_PERSPECTIVE, CAM_REALISTIC):
        d0 = normalize(p_cam)
        ddx = _xform_vector(cam.camera_to_world, normalize(p_cam + dx_cam) - d0)
        ddy = _xform_vector(cam.camera_to_world, normalize(p_cam + dy_cam) - d0)
        return zero, ddx, zero, ddy
    # orthographic: the direction is constant, the origin shifts
    dox = _xform_vector(cam.camera_to_world, dx_cam)
    doy = _xform_vector(cam.camera_to_world, dy_cam)
    return dox, zero, doy, zero


def _inverse(m):
    """The inverse of a (4,4) f32 camera matrix, taken on the host as the
    reference's CPU inverse takes it (LAPACK sgetrf, then the two
    triangular solves of the permuted identity, through scipy's LAPACK
    and BLAS, bit for bit; torch.linalg.inv differs by an ulp in some
    entries), and moved to m's device."""
    from scipy.linalg import blas, lapack

    a = m.detach().cpu().numpy().astype(np.float32)
    lu, piv, _ = lapack.sgetrf(a)
    perm = np.arange(a.shape[0])
    for i, p in enumerate(piv):
        perm[i], perm[p] = perm[p], perm[i]
    x = np.eye(a.shape[0], dtype=np.float32)[perm]
    x = blas.strsm(1.0, lu, x, side=0, lower=1, diag=1)
    x = blas.strsm(1.0, lu, x, side=0, lower=0, diag=0)
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(m.device)


def _screen_area_z1(cam: CompiledCamera):
    """Area of the perspective screen window projected to the z=1 plane in
    camera space (PerspectiveCamera's A)."""
    rx, ry = cam.full_res
    corners = torch.tensor([[0.0, 0.0, 0.0], [rx, ry, 0.0]], dtype=torch.float32,
                           device=cam.raster_to_camera.device)
    p = _xform_point(cam.raster_to_camera, corners)
    p = p / p[:, 2:3]
    return torch.abs((p[1, 0] - p[0, 0]) * (p[1, 1] - p[0, 1]))


def camera_world_frame(cam: CompiledCamera):
    """(origin, forward) of the camera in world space."""
    dv = cam.camera_to_world.device
    o = _xform_point(cam.camera_to_world, torch.zeros((1, 3), dtype=torch.float32, device=dv))[0]
    fwd = normalize(_xform_vector(
        cam.camera_to_world, torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float32, device=dv)))[0]
    return o, fwd


def project_to_raster(cam: CompiledCamera, p_world):
    """World points -> raster coordinates and the in-front / in-bounds
    mask (the pinhole's inverse of generate_rays, for BDPT's t=1
    strategies)."""
    p_cam = _xform_point(_inverse(cam.camera_to_world), p_world)
    in_front = p_cam[..., 2] > 1e-6
    p_safe = torch.where(in_front[..., None], p_cam, torch.ones_like(p_cam))
    p_ras = _xform_point(_inverse(cam.raster_to_camera), p_safe)
    rx, ry = cam.full_res
    in_b = (in_front & (p_ras[..., 0] >= 0.0) & (p_ras[..., 0] < rx)
            & (p_ras[..., 1] >= 0.0) & (p_ras[..., 1] < ry))
    return p_ras[..., :2], in_b


def _pow3(c):
    return c * (c * c)


def camera_pdf_we(cam: CompiledCamera, d_world):
    """PerspectiveCamera::Pdf_We: (pdf_pos, pdf_dir) of a camera ray in
    direction d_world; the pinhole's delta position gives pdf_pos 1."""
    _, fwd = camera_world_frame(cam)
    a = _screen_area_z1(cam)
    cos_t = torch.clamp(dot(d_world, fwd), min=0.0)
    pdf_dir = torch.where(cos_t > 1e-6, 1.0 / (a * _pow3(torch.clamp(cos_t, min=1e-9))),
                          torch.zeros_like(cos_t))
    return torch.ones_like(pdf_dir), pdf_dir


def camera_sample_wi(cam: CompiledCamera, ref_p):
    """PerspectiveCamera::Sample_Wi for a pinhole: the direction to the
    camera, its distance, the solid-angle pdf at ref_p, the importance We
    that connection carries, its raster position and whether it lands on
    the film. Returns (wi, dist, pdf, we, raster_xy, in_bounds)."""
    cam_p, fwd = camera_world_frame(cam)
    a = _screen_area_z1(cam)
    to_cam = cam_p - ref_p
    dist = torch.clamp(torch.sqrt(dot(to_cam, to_cam)), min=1e-12)
    wi = to_cam / dist[..., None]
    cos_t = torch.clamp(dot(-wi, fwd), min=0.0)  # the ray camera -> ref_p
    pdf = dist * dist / torch.clamp(cos_t, min=1e-9)
    c = torch.clamp(cos_t, min=1e-9)
    c2 = c * c
    we = torch.where(cos_t > 1e-6, 1.0 / (a * (c2 * c2)), torch.zeros_like(cos_t))
    raster, in_b = project_to_raster(cam, ref_p)
    we = torch.where(in_b, we, torch.zeros_like(we))
    return wi, dist, pdf, we, raster, in_b
