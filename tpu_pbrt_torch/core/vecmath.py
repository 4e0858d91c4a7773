"""Vector math on SoA float32 tensors (port of tpu_pbrt/core/vecmath.py).

Every function takes tensors whose last axis is xyz, and rounds as the
reference's compiled CPU programs round it. XLA fuses a product with the
add or subtract that consumes it, and LLVM contracts the pair into one
fused multiply-add (`core/xla_math.py::fmac`):

- `dot` is the reference's jnp.sum(a * b, axis=-1), a reduce loop:
  fma(a2, b2, fma(a1, b1, a0 b0));
- `cross`'s components a_j b_k - a_k b_j are fma(a_j, b_k, -(a_k b_j));
- `to_world`'s v0 t + v1 b + v2 n is fma(v2, n, fma(v0, t, v1 b));
- `length` takes the correctly rounded square root of XLA's vsqrtps
  (torch's CPU sqrt misrounds about one value in 140);
- the spherical angles take the reference's atan2, acos, sin and cos;
- `dot_rows` is XLA's dot of a batch of directions by a 3x3 matrix.
"""

from __future__ import annotations

import torch

from tpu_pbrt_torch.core import xla_math as _xm
from tpu_pbrt_torch.core.xla_math import fma32, fmac, sqrt as _sqrt

# float32 machine epsilon / 2 (pbrt MachineEpsilon)
MACHINE_EPS = 5.960464477539063e-08


def gamma(n: int) -> float:
    """pbrt gamma(n): bound on accumulated fp rounding error."""
    return (n * MACHINE_EPS) / (1 - n * MACHINE_EPS)


def dot(a, b):
    return fmac(a[..., 2], b[..., 2], fmac(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def cross(a, b):
    return torch.stack(
        [
            fmac(a[..., 1], b[..., 2], -(a[..., 2] * b[..., 1])),
            fmac(a[..., 2], b[..., 0], -(a[..., 0] * b[..., 2])),
            fmac(a[..., 0], b[..., 1], -(a[..., 1] * b[..., 0])),
        ],
        dim=-1,
    )


def length(v):
    return _sqrt(dot(v, v))


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
        [fmac(sign * v[..., 0] * v[..., 0], a, 1.0), sign * b, -sign * v[..., 0]], dim=-1
    )
    t2 = torch.stack([b, fmac(v[..., 1] * v[..., 1], a, sign), -v[..., 1]], dim=-1)
    return t1, t2


def to_local(v, t, b, n):
    """World -> shading frame (pbrt BSDF::WorldToLocal)."""
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def to_world(v, t, b, n):
    return fmac(v[..., 2:3], n, fmac(v[..., 0:1], t, v[..., 1:2] * b))


def offset_ray_origin(p, n, d):
    """Robust secondary-ray origin: offset along the geometric normal by a
    scale-adaptive epsilon, into the hemisphere of d."""
    eps = 1e-4 * torch.clamp(torch.abs(p).amax(dim=-1), min=1.0)
    sign = torch.where(dot(n, d) >= 0.0, 1.0, -1.0)
    return fmac((sign * eps)[..., None], n, p)


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
    return _sqrt(sin2_theta(w))


def tan_theta(w):
    c = cos_theta(w)
    return sin_theta(w) / torch.where(torch.abs(c) < 1e-8, torch.full_like(c, 1e-8), c)


def tan2_theta(w):
    return sin2_theta(w) / torch.clamp(cos2_theta(w), min=1e-12)


def cos_phi(w):
    s = _sqrt(sin2_theta(w))
    return torch.where(s == 0.0, torch.ones_like(s),
                       torch.clamp(w[..., 0] / torch.clamp(s, min=1e-12), -1.0, 1.0))


def sin_phi(w):
    s = _sqrt(sin2_theta(w))
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
    cos_t = _sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    return eta[..., None] * -wi + (eta * cos_i - cos_t)[..., None] * n, tir


def spherical_direction(sin_t, cos_t, phi):
    return torch.stack([sin_t * _xm.cos(phi), sin_t * _xm.sin(phi), cos_t], dim=-1)


def spherical_theta(v):
    return _xm.acos(torch.clamp(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = _xm.atan2(v[..., 1], v[..., 0])
    return torch.where(p < 0.0, p + 2.0 * torch.pi, p)


def dot_rows(v, m):
    """v @ m[:3, :3].T for directions v (..., 3), rounded as XLA's CPU
    backend emits that dot: its elemental dot kernel for an (R, 3) x
    (3, 3) product (read from the compiled `PathIntegrator.pool_chunk`,
    held at every R from 5 to 2^17). The rows are vectorized eight at a
    time; there the first two output columns are products rounded apart
    and summed in order, (v0 m_j0 + 0) + v1 m_j1 + v2 m_j2, and the third
    a chain of fused multiply-adds, fma(v2, m_22, fma(v1, m_21, fma(v0,
    m_20, 0))). The R mod 8 rows past the last full vector run the scalar
    loop, fused in every column. So a row's rounding follows R: the same
    direction can round apart in a batch of another size."""
    shape = v.shape
    v = v.reshape(-1, 3)
    n = v.shape[0]
    zero = torch.zeros((), dtype=v.dtype, device=v.device)
    fused = [fma32(v[:, 2], m[j, 2], fma32(v[:, 1], m[j, 1], fma32(v[:, 0], m[j, 0], zero)))
             for j in range(3)]
    plain = [((v[:, 0] * m[j, 0] + 0.0) + v[:, 1] * m[j, 1]) + v[:, 2] * m[j, 2]
             for j in range(2)]
    tail = torch.arange(n, dtype=torch.int64, device=v.device) >= (n // 8) * 8
    out = [torch.where(tail, fused[j], plain[j]) for j in range(2)] + [fused[2]]
    return torch.stack(out, dim=-1).reshape(shape)
