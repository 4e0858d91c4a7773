"""Vector math on SoA float32 tensors (port of tpu_pbrt/core/vecmath.py).

Every function takes tensors whose last axis is xyz. Dot products and
cross products are written out term by term in the reference's order
((x + y) + z), so the port rounds exactly as the reference does on the
CPU.
"""

from __future__ import annotations

import torch

# float32 machine epsilon / 2 (pbrt MachineEpsilon)
MACHINE_EPS = 5.960464477539063e-08


def gamma(n: int) -> float:
    """pbrt gamma(n): bound on accumulated fp rounding error."""
    return (n * MACHINE_EPS) / (1 - n * MACHINE_EPS)


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def length(v):
    return torch.sqrt(dot(v, v))


def normalize(v):
    return v / torch.clamp(length(v)[..., None], min=1e-20)


def face_forward(n, v):
    """Flip n to lie in the hemisphere of v (pbrt Faceforward)."""
    return torch.where(dot(n, v)[..., None] < 0.0, -n, n)


def coordinate_system(v):
    """Branchless orthonormal basis (Duff et al. 2017). v must be
    normalized. Returns (t, b)."""
    z = v[..., 2]
    sign = torch.where(z >= 0.0, torch.ones_like(z), -torch.ones_like(z))
    a = -1.0 / (sign + z)
    b = v[..., 0] * v[..., 1] * a
    t1 = torch.stack(
        [1.0 + sign * v[..., 0] * v[..., 0] * a, sign * b, -sign * v[..., 0]], dim=-1
    )
    t2 = torch.stack([b, sign + v[..., 1] * v[..., 1] * a, -v[..., 1]], dim=-1)
    return t1, t2


def to_local(v, t, b, n):
    """World -> shading frame (pbrt BSDF::WorldToLocal)."""
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def to_world(v, t, b, n):
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def offset_ray_origin(p, n, d):
    """Robust secondary-ray origin: offset along the geometric normal by a
    scale-adaptive epsilon, into the hemisphere of d."""
    eps = 1e-4 * torch.clamp(torch.abs(p).amax(dim=-1), min=1.0)
    sign = torch.where(dot(n, d) >= 0.0, 1.0, -1.0)
    return p + (sign * eps)[..., None] * n


# -- shading-frame trig (directions in the local frame, n = (0,0,1)) -------

def cos_theta(w):
    return w[..., 2]


def cos2_theta(w):
    return w[..., 2] * w[..., 2]


def abs_cos_theta(w):
    return torch.abs(w[..., 2])


def sin2_theta(w):
    return torch.clamp(1.0 - cos2_theta(w), min=0.0)


def sin_theta(w):
    return torch.sqrt(sin2_theta(w))


def tan_theta(w):
    c = cos_theta(w)
    return sin_theta(w) / torch.where(torch.abs(c) < 1e-8, torch.full_like(c, 1e-8), c)


def tan2_theta(w):
    return sin2_theta(w) / torch.clamp(cos2_theta(w), min=1e-12)


def cos_phi(w):
    s = torch.sqrt(sin2_theta(w))
    return torch.where(s == 0.0, torch.ones_like(s),
                       torch.clamp(w[..., 0] / torch.clamp(s, min=1e-12), -1.0, 1.0))


def sin_phi(w):
    s = torch.sqrt(sin2_theta(w))
    return torch.where(s == 0.0, torch.zeros_like(s),
                       torch.clamp(w[..., 1] / torch.clamp(s, min=1e-12), -1.0, 1.0))


def same_hemisphere(w, wp):
    return w[..., 2] * wp[..., 2] > 0.0


def reflect(wo, n):
    """pbrt Reflect: mirror wo about n (both pointing away from the surface)."""
    return -wo + 2.0 * dot(wo, n)[..., None] * n


def refract(wi, n, eta):
    """pbrt Refract -> (refracted direction, total-internal-reflection mask);
    eta = eta_i / eta_t (a tensor of wi's batch shape), n on wi's side."""
    cos_i = dot(n, wi)
    sin2_t = eta * eta * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    return eta[..., None] * -wi + (eta * cos_i - cos_t)[..., None] * n, tir


def spherical_direction(sin_t, cos_t, phi):
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=-1)


def spherical_theta(v):
    return torch.acos(torch.clamp(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = torch.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + 2.0 * torch.pi, p)
