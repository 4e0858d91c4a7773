"""Spline and Fourier interpolation (port of tpu_pbrt/core/interpolation.py).

pbrt-v3's interpolation.{h,cpp}: `CatmullRomWeights`, `CatmullRom`,
`IntegrateCatmullRom`, `SampleCatmullRom` and `Fourier`, the numeric
machinery of the Fourier BSDF, batched over tensors as the reference
batches them over jnp arrays: the interval search is a fixed-round
masked binary search, every index is clamped as the reference's gathers
clamp it, and `integrate_catmull_rom` is the reference's host (numpy,
float64) precomputation.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_pbrt_torch.core import xla_math as xm


def _take(xs, idx):
    """xs[idx] with idx clamped to xs (jnp's gather clamps)."""
    return xs[idx.long().clamp(0, xs.shape[0] - 1)]


def find_interval(xs, x):
    """pbrt FindInterval: the largest i with xs[i] <= x, clamped to
    [0, len - 2]. xs: (N,) sorted; x: (...,)."""
    n = xs.shape[0]
    x = torch.as_tensor(x, dtype=xs.dtype, device=xs.device)
    lo = torch.zeros(x.shape, dtype=torch.int32, device=xs.device)
    hi = torch.full(x.shape, n - 1, dtype=torch.int32, device=xs.device)
    rounds = max(int(np.ceil(np.log2(max(n, 2)))) + 1, 1)
    for _ in range(rounds):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        go_up = _take(xs, mid) <= x
        lo = torch.where(go_up, mid, lo)
        hi = torch.where(go_up, hi, mid)
    return torch.clamp(lo, 0, n - 2)


def catmull_rom_weights(xs, x):
    """CatmullRomWeights: (offset, w0..w3) of the not-a-knot cubic through
    the 4 samples around x. An x outside the nodes clamps to the boundary
    interval."""
    i = find_interval(xs, x)
    x0 = _take(xs, i)
    x1 = _take(xs, i + 1)
    one = torch.ones_like(x0)
    t = (x - x0) / torch.where(x1 == x0, one, x1 - x0)
    t = torch.clamp(t, 0.0, 1.0)
    t2 = t * t
    t3 = t2 * t
    w1 = 2.0 * t3 - 3.0 * t2 + 1.0
    w2 = -2.0 * t3 + 3.0 * t2
    # the endpoint-derivative terms: interior nodes spread the derivative
    # weight onto the previous / next sample, boundary intervals fold it
    # into the one-sided difference
    n = xs.shape[0]
    has_prev = i > 0
    has_next = i + 2 < n
    x_prev = _take(xs, torch.clamp(i - 1, min=0))
    x_next = _take(xs, torch.clamp(i + 2, max=n - 1))
    d0_scale = (x1 - x0) / torch.where(has_prev, x1 - x_prev, one)
    d1_scale = (x1 - x0) / torch.where(has_next, x_next - x0, one)
    w0s = t3 - 2.0 * t2 + t
    w3s = t3 - t2
    zero = torch.zeros_like(t)
    w0 = torch.where(has_prev, -(w0s * d0_scale), zero)
    w1 = w1 - torch.where(has_prev, zero, w0s)
    w2 = w2 + torch.where(has_prev, w0s * d0_scale, w0s)
    w3 = torch.where(has_next, w3s * d1_scale, zero)
    w1 = w1 - torch.where(has_next, w3s * d1_scale, w3s)
    w2 = w2 + torch.where(has_next, zero, w3s)
    return i, w0, w1, w2, w3


def catmull_rom(xs, fs, x):
    """CatmullRom: the spline through samples fs at nodes xs, at x."""
    i, w0, w1, w2, w3 = catmull_rom_weights(xs, x)
    n = xs.shape[0]
    f_prev = _take(fs, torch.clamp(i - 1, min=0))
    f0 = _take(fs, i)
    f1 = _take(fs, i + 1)
    f_next = _take(fs, torch.clamp(i + 2, max=n - 1))
    return w0 * f_prev + w1 * f0 + w2 * f1 + w3 * f_next


def integrate_catmull_rom(xs, fs):
    """IntegrateCatmullRom (host, float64): the running integral of the
    spline at each node. Returns (cdf (N,), total)."""
    xs = np.asarray(xs, np.float64)
    fs = np.asarray(fs, np.float64)
    n = len(xs)
    cdf = np.zeros(n)
    total = 0.0
    for i in range(n - 1):
        x0, x1 = xs[i], xs[i + 1]
        f0, f1 = fs[i], fs[i + 1]
        width = x1 - x0
        # the spline's derivative estimates (the same not-a-knot ends)
        if i > 0:
            d0 = width * (f1 - fs[i - 1]) / (x1 - xs[i - 1])
        else:
            d0 = f1 - f0
        if i + 2 < n:
            d1 = width * (fs[i + 2] - f0) / (xs[i + 2] - x0)
        else:
            d1 = f1 - f0
        total += ((d0 - d1) / 12.0 + (f0 + f1) * 0.5) * width
        cdf[i + 1] = total
    return cdf, total


def _f32(a, device):
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           dtype=torch.float32, device=device)


def sample_catmull_rom(xs, fs, cdf, u):
    """SampleCatmullRom: x drawn proportionally to the (non-negative)
    spline by inverting its integral with 12 fixed Newton-bisection rounds
    (pbrt's do-while). xs, fs, cdf: (N,) (cdf unnormalized, from
    integrate_catmull_rom); u: (...,). Returns (x, f(x), pdf)."""
    u = torch.as_tensor(u, dtype=torch.float32)
    xs, fs, cdf = (_f32(a, u.device) for a in (xs, fs, cdf))
    total = cdf[-1]
    uu = u * total
    i = find_interval(cdf, uu)
    x0 = _take(xs, i)
    x1 = _take(xs, i + 1)
    f0 = _take(fs, i)
    f1 = _take(fs, i + 1)
    width = x1 - x0
    n = xs.shape[0]
    im = torch.clamp(i - 1, min=0)
    ip = torch.clamp(i + 2, max=n - 1)
    d0 = torch.where(i > 0, width * (f1 - _take(fs, im)) / (x1 - _take(xs, im)), f1 - f0)
    d1 = torch.where(i + 2 < n, width * (_take(fs, ip) - f0) / (_take(xs, ip) - x0), f1 - f0)
    ulocal = (uu - _take(cdf, i)) / torch.clamp(width, min=1e-20)
    t = torch.where(
        f0 != f1,
        (f0 - xm.sqrt(torch.clamp(f0 * f0 + 2.0 * ulocal * (f1 - f0), min=0.0))) / (f0 - f1),
        ulocal / torch.clamp(f0, min=1e-20))
    t = torch.clamp(t, 0.0, 1.0)
    a = torch.zeros_like(t)
    b = torch.ones_like(t)
    c2 = -2.0 * d0 - d1 + 3.0 * (f1 - f0)
    c3 = d0 + d1 + 2.0 * (f0 - f1)
    # a tensor divisor: CUDA divides by a host scalar as a multiply by its
    # reciprocal, which rounds twice
    three = torch.full_like(t, 3.0)
    for _ in range(12):
        t2 = t * t
        t3 = t2 * t
        # the cubic Hermite integral F(t) and value f(t)
        F = f0 * t + d0 * t2 / 2.0 + c2 * t3 / three + c3 * t2 * t2 / 4.0
        fval = f0 + d0 * t + c2 * t2 + c3 * t3
        too_big = F > ulocal
        b = torch.where(too_big, t, b)
        a = torch.where(too_big, a, t)
        newton = t - (F - ulocal) / torch.where(torch.abs(fval) < 1e-6,
                                                torch.full_like(fval, 1e-6), fval)
        in_bracket = (newton > a) & (newton < b)
        t = torch.where(in_bracket, newton, 0.5 * (a + b))
    t2 = t * t
    t3 = t2 * t
    fval = f0 + d0 * t + c2 * t2 + c3 * t3
    x = x0 + width * t
    pdf = torch.clamp(fval, min=0.0) / torch.clamp(total, min=1e-20)
    return x, fval, pdf


def fourier(a, cos_phi, m: int):
    """Fourier: sum_{k<m} a[..., k] cos(k phi) by the double-angle
    recurrence. a: (..., m_max) coefficient rows; cos_phi: (...); m: the
    number of orders (a Python int)."""
    a = torch.as_tensor(a, dtype=torch.float32)
    cos_phi = torch.as_tensor(cos_phi, dtype=torch.float32, device=a.device)
    value = torch.zeros(cos_phi.shape, dtype=torch.float32, device=a.device)
    cos_k_minus = torch.ones_like(value) * cos_phi  # cos(1 phi)
    cos_k = torch.ones_like(value)  # cos(0 phi)
    for k in range(m):
        value = value + a[..., k] * cos_k
        cos_next = 2.0 * cos_phi * cos_k_minus - cos_k
        cos_k = cos_k_minus
        cos_k_minus = cos_next
    return value
