"""Triangle intersection as a feature product (port of tpu_pbrt/accel/mxu.py).

Every Moller-Trumbore quantity is a bilinear form in (ray, triangle):
with the 16-dim ray feature phi(o, d) = [o_i d_j (9, i-major), d (3),
o (3), 1] and per-triangle weights W (16 x 4T, columns [det | u*det |
v*det | t*det]), all four outputs for T triangles are one product
phi @ W. Rays and vertices are re-centered (per treelet on the stream
path, on the world center for the brute path) to bound the f32
cancellation of the o_i d_j terms.

The weight builders are host numpy, identical to the reference's, so
both packages upload the same bits. `decode_outputs` and
`brute_feature_intersect` are the torch counterparts of the device half.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_pbrt_torch.accel.traverse import Hit

#: relative barycentric tolerance: widens each triangle by ~1e-6 so shared
#: edges cannot crack open under f32 rounding (double hits resolve by t)
EDGE_EPS = 1e-6

#: scenes at or below this triangle count skip the treelet hierarchy and
#: test every triangle in one feature product (Cornell-class scenes)
BRUTE_MAX_TRIS = 256


def tri_feature_weights_raw(verts: np.ndarray, center) -> np.ndarray:
    """(T,3,3) triangle vertices + re-centering point(s) -> (T, 16, 4)
    per-triangle weights (outputs: det, u*det, v*det, t*det).

    `center` broadcasts against (T,3,3) — pass (3,) for a shared center or
    (T,1,3) for per-triangle centers. Degenerate (zero-area) triangles —
    including padding rows — produce all-zero weights, so det == 0 and
    they can never hit.
    """
    v = np.asarray(verts, np.float64) - np.asarray(center, np.float64)
    v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)  # (T,3)
    T = len(v)

    eps = np.zeros((3, 3, 3))
    eps[0, 1, 2] = eps[1, 2, 0] = eps[2, 0, 1] = 1.0
    eps[0, 2, 1] = eps[2, 1, 0] = eps[1, 0, 2] = -1.0

    W = np.zeros((T, 16, 4), np.float64)
    # det = d . (e2 x e1) = -d . n
    W[:, 9:12, 0] = -n
    # u*det = sum o'_i d_j eps_ijk e2_k  -  d . (e2 x v0')
    W[:, :9, 1] = np.einsum("ijk,tk->tij", eps, e2).reshape(T, 9)
    W[:, 9:12, 1] = -np.cross(e2, v0)
    # v*det = sum o'_i d_j (-eps_ijk e1_k)  -  d . (v0' x e1)
    W[:, :9, 2] = -np.einsum("ijk,tk->tij", eps, e1).reshape(T, 9)
    W[:, 9:12, 2] = -np.cross(v0, e1)
    # t*det = o' . n - v0' . n
    W[:, 12:15, 3] = n
    W[:, 15, 3] = -np.sum(v0 * n, axis=-1)
    return W.astype(np.float32)


def tri_feature_weights_motion(v0: np.ndarray, v1: np.ndarray, center,
                               raw: bool = False) -> np.ndarray:
    """Motion-blur weights: vertices lerp over the shutter, so every output
    is a cubic in the ray time; the 4 monomial coefficient blocks are fit
    exactly from the static weights at 4 nodes (inverse Vandermonde, f64).
    The product then consumes phi(o, d) (x) [1, t, t^2, t^3] (64 rows).

    raw=False -> (64, 4T) table; raw=True -> (T, 64, 4)."""
    nodes = np.array([0.0, 1.0 / 3.0, 2.0 / 3.0, 1.0])
    vand_inv = np.linalg.inv(np.vander(nodes, 4, increasing=True))  # (4,4)
    ws = []
    for t in nodes:
        vt = (1.0 - t) * np.asarray(v0, np.float64) + t * np.asarray(v1, np.float64)
        ws.append(tri_feature_weights_raw(vt, center).astype(np.float64))
    wstack = np.stack(ws, axis=0)  # (4, T, 16, 4) values at nodes
    coeffs = np.einsum("kn,ntfo->ktfo", vand_inv, wstack)  # (4, T, 16, 4)
    wt = np.concatenate([coeffs[k] for k in range(4)], axis=1)
    if raw:
        return wt.astype(np.float32)
    T = len(wt)
    return np.ascontiguousarray(
        wt.transpose(1, 2, 0).reshape(64, 4 * T)
    ).astype(np.float32)


def tri_feature_weights(verts: np.ndarray, center) -> np.ndarray:
    """(T,3,3) + shared center -> (16, 4T) weights with column layout
    [det (T) | u*det (T) | v*det (T) | t*det (T)]."""
    W = tri_feature_weights_raw(verts, center)
    T = len(W)
    return np.ascontiguousarray(W.transpose(1, 2, 0).reshape(16, 4 * T))


def ray_features(o_c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Re-centered origins (...,3) + directions (...,3) -> phi (...,16)."""
    od = o_c[..., :, None] * d[..., None, :]  # (...,3,3) i-major
    one = torch.ones(o_c.shape[:-1] + (1,), dtype=o_c.dtype, device=o_c.device)
    return torch.cat([od.reshape(od.shape[:-2] + (9,)), d, o_c, one], dim=-1)


def decode_outputs(out: torch.Tensor, n_tris: int, t_max):
    """Product output (..., 4T) -> per-ray closest hit over the T columns.

    Returns (t, k, b0, b1): k is the LOCAL triangle index in [0, T) (0 on
    a miss, where t == +inf); argmin keeps the lowest index among equal
    t, as the reference does."""
    T = n_tris
    det = out[..., 0 * T: 1 * T]
    udet = out[..., 1 * T: 2 * T]
    vdet = out[..., 2 * T: 3 * T]
    tdet = out[..., 3 * T: 4 * T]
    inv = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    u = udet * inv
    v = vdet * inv
    t = tdet * inv
    tm = t_max[..., None] if torch.is_tensor(t_max) and t_max.dim() else t_max
    hit = (
        (det != 0.0)
        & (u >= -EDGE_EPS)
        & (v >= -EDGE_EPS)
        & (u + v <= 1.0 + EDGE_EPS)
        & (t > 0.0)
        & (t < tm)
    )
    t = torch.where(hit, t, torch.full_like(t, float("inf")))
    k = torch.argmin(t, dim=-1)
    kk = k[..., None]
    t_best = torch.gather(t, -1, kk)[..., 0]
    u_best = torch.gather(u, -1, kk)[..., 0]
    v_best = torch.gather(v, -1, kk)[..., 0]
    b0 = 1.0 - u_best - v_best
    b1 = u_best
    return t_best, k, b0, b1


def brute_feature_intersect(feat, center, n_tris: int, o, d, t_max,
                            chunk: int = 32768) -> Hit:
    """Closest hit of rays (R,3) against ALL n_tris triangles via one
    feature product per ray slab (the small-scene path: Cornell-class
    scenes need no hierarchy). feat: (16, 4T) f32 tensor."""
    t_max = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=o.device), o.shape[:-1]
    )
    ts, ps, b0s, b1s = [], [], [], []
    for i in range(0, o.shape[0], chunk):
        oo, dd, tt = o[i:i + chunk], d[i:i + chunk], t_max[i:i + chunk]
        phi = ray_features(oo - center, dd)
        out = phi @ feat
        t, k, b0, b1 = decode_outputs(out, n_tris, tt)
        ts.append(t)
        ps.append(torch.where(torch.isfinite(t), k.to(torch.int32), -1))
        b0s.append(b0)
        b1s.append(b1)
    return Hit(torch.cat(ts), torch.cat(ps), torch.cat(b0s), torch.cat(b1s))
