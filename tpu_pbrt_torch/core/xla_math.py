"""f32 transcendentals rounded as the reference's compiled CPU programs round them.

jax 0.9.0 compiles `jnp.log`, `jnp.exp` and `jnp.sinh` on the CPU to
XLA's own polynomial expansions (range reduction on the exponent bits, a
Cephes-style polynomial), which LLVM contracts into fused multiply-adds,
and `jnp.arctan2` / `jnp.arcsin` to calls of the C library's `atan2f`
(glibc's fdlibm-derived single-precision code, no contraction). torch's
versions (SLEEF on the CPU, CUDA's libdevice on the card) round a few
ulps apart from those, and the hair lobes amplify such an ulp into a
different sampled direction. The functions here copy the reference's
operation sequence as plain torch ops, so the CPU and the card give the
reference's bits:

- every multiply and add is a separate f32 op (torch never contracts
  them, on either device);
- where the reference's compiled code has a fused multiply-add, `fma32`
  rounds a*b + c once: the f32 product is exact in f64, and the f64 sum
  rounded to f32 is the fused result but for a double-rounding tie (as
  `accel/stream.py::keyframe_lerp` rounds the reference's fused lerp).

- the reference's CPU programs run with denormals flushed: a subnormal
  input reads as a signed zero and a subnormal result becomes zero
  (`_daz`, `ftz`);
- `sqrt` is correctly rounded (torch's CPU kernel is not always).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

_F32 = torch.float32

# XLA's exp/log/tanh constants: the f32 values of the dumped IR's
# operands (xla/service/cpu's elemental IR emitter)
_LOG2E = 1.4426950216293335
_LN2_HI = 0.693359375
_LN2_LO = -0.00021219444170128554
_EXP_P = (0.00019875691214110702, 0.001398199936375022, 0.008333452045917511,
          0.04166579619050026, 0.1666666567325592, 0.5)
_EXP_LO, _EXP_HI = -87.80000305175781, 88.80000305175781
_SQRTHF = 0.7071067690849304
_LOG_P = (0.07037683576345444, -0.11514610052108765, 0.11676998436450958,
          -0.12420140951871872, 0.14249323308467865, -0.16668057441711426,
          0.2000071406364441, -0.24999994039535522, 0.3333333134651184)
_TANH_A = (-2.7607683663038313e-16, 2.0001879384549948e-13, -8.604671836165423e-11,
           5.122297253024044e-08, 1.4857223504805006e-05, 0.0006372619536705315,
           0.004893524572253227)
_TANH_B = (1.1982583600911312e-06, 0.00011853470641653985, 0.0022684347350150347,
           0.0048935250379145145)
_TANH_CLAMP = 7.998811721801758
_TANH_TINY = 0.00039999998989515007
_LN2 = -0.6931471824645996

# glibc's atanf / atan2f (sysdeps/ieee754/flt-32/{s_atanf,e_atan2f}.c)
_ATANHI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01, 1.5707962513e+00)
_ATANLO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08, 7.5497894159e-08)
_AT = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01, -1.1111110449e-01,
       9.0908870101e-02, -7.6918758452e-02, 6.6610731184e-02, -5.8335702866e-02,
       4.9768779427e-02, -3.6531571299e-02, 1.6285819933e-02)
_PI = 3.1415927410e+00
_PI_O_2 = 1.5707963705e+00
_PI_LO = -8.7422776573e-08
# glibc's constant expressions, rounded in f32 as its code rounds them
_ATAN_INF = float(np.float32(_ATANHI[3]) + np.float32(_ATANLO[3]))
_PI_O_2_BIG = float(np.float32(_PI_O_2) + np.float32(0.5) * np.float32(_PI_LO))
_PI_O_4 = float(np.float32(7.8539818525e-01))
_PI_3O4 = float(np.float32(3.0) * np.float32(7.8539818525e-01))


_MIN_NORMAL = 1.1754943508222875e-38


def _daz(x):
    """A subnormal input reads as a zero of its sign."""
    x = torch.as_tensor(x, dtype=_F32)
    return torch.where(torch.abs(x) < _MIN_NORMAL, x * 0.0, x)


def ftz(y):
    """A subnormal result is flushed to a zero of its sign (as the
    reference's CPU programs flush every f32 operation's result)."""
    return torch.where(torch.abs(y) < _MIN_NORMAL, y * 0.0, y)


def sqrt(x):
    """Correctly rounded f32 square root (as the reference's vsqrtps): on
    the CPU the f64 root of the flushed input, which rounds to the f32
    root without double rounding; on CUDA torch's own, correctly rounded
    there, in one launch (a subnormal input is not flushed)."""
    if torch.is_tensor(x) and x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(_daz(x).double()).to(_F32)


#: whether `fmac` contracts: the reference's compiled programs fuse a
#: product into the add that consumes it, its op-by-op (eager) evaluation
#: rounds them apart
_CONTRACT = [True]


@contextlib.contextmanager
def contraction(enabled: bool):
    """Round `fmac` (and the compiler's folds that go with it) as the
    reference's compiled programs do (True, the default: every render) or
    as its op-by-op evaluation does (False: a comparison with the
    reference's functions called eagerly)."""
    prev = _CONTRACT[0]
    _CONTRACT[0] = bool(enabled)
    try:
        yield
    finally:
        _CONTRACT[0] = prev


def contracting() -> bool:
    return _CONTRACT[0]


def fmac(a, b, c):
    """a * b + c where the reference's XLA program fuses the product into
    the sum that consumes it (LLVM contracts the pair into one fused
    multiply-add): `fma32` under `contraction(True)`, two roundings
    otherwise."""
    if _CONTRACT[0]:
        return fma32(a, b, c)
    return a * b + c


def _fma_f64(a, b, c):
    """a * b + c through f64: the f32 product is exact there, and the f64
    sum rounded to f32 is the fused result but where the sum's own
    rounding lands it exactly on an f32 midpoint (at most one sum in
    2^29; none in the sweeps of tests/test_torch_xla_math.py)."""
    return (a.double() * b + c).to(_F32)


def fma32(a, b, c):
    """a * b + c rounded to f32 as one fused multiply-add: a is an f32
    tensor, b and c f32 tensors or Python floats (taken as the f32 values
    nearest them, as the reference's programs hold their constants). On
    CUDA one torch.addcmul, a fused multiply-add there (chip_smoke.py
    `[samplers]` holds it to the f64 form bit for bit); on the CPU
    `_fma_f64`."""
    if a.is_cuda:
        b = b if torch.is_tensor(b) else a.new_full((), b)
        c = c if torch.is_tensor(c) else a.new_full((), c)
        return torch.addcmul(c, a, b)
    b = b if torch.is_tensor(b) else float(np.float32(b))
    c = c if torch.is_tensor(c) else float(np.float32(c))
    return _fma_f64(a, b, c)


def _exp_core(x):
    """XLA's exp on an f32 tensor: (1 + r + p(r) r^2) 2^n with n the
    rounded x log2(e) and r the two-constant reduced argument. Returns
    (the polynomial value, 2^n) so callers can fold the final product."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.floor(fma32(x, _LOG2E, 0.5))
    n = torch.clamp(n, -127.0, 127.0)
    r = fma32(-n, _LN2_HI, x)
    r = fma32(n, -_LN2_LO, r)
    p = fma32(r, _EXP_P[0], _EXP_P[1])
    for k in _EXP_P[2:]:
        p = fma32(p, r, k)
    y = fma32(p, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(_F32)
    return y, scale


def exp(x):
    """jnp.exp (f32) as jax 0.9.0 compiles it on the CPU."""
    y, scale = _exp_core(_daz(x))
    return ftz(y * scale)


def log(x):
    """jnp.log (f32) as jax 0.9.0 compiles it on the CPU: x = m 2^e with
    m in [sqrt(1/2), sqrt(2)), log = (m - 1) - (m - 1)^2 / 2 + P(m - 1)
    + e ln 2 in two parts; log(0) = -inf, log(inf) = inf, NaN below 0."""
    x = _daz(x)
    xc = torch.clamp(x, min=_MIN_NORMAL)
    bits = xc.view(torch.int32)
    e = ((bits >> 23) - 127).to(_F32) + 1.0
    m = ((bits & -2139095041) | 1056964608).view(_F32)  # mantissa in [0.5, 1)
    lt = m < _SQRTHF
    t = m - 1.0
    t = t + torch.where(lt, m, torch.zeros_like(m))
    e = e - torch.where(lt, torch.ones_like(e), torch.zeros_like(e))
    z = t * t
    t3 = z * t
    p0 = fma32(fma32(t, _LOG_P[0], _LOG_P[1]), t, _LOG_P[2])
    p1 = fma32(fma32(t, _LOG_P[3], _LOG_P[4]), t, _LOG_P[5])
    p1 = fma32(p0, t3, p1)
    p2 = fma32(fma32(t, _LOG_P[6], _LOG_P[7]), t, _LOG_P[8])
    p1 = fma32(t3, p1, p2)
    y = fma32(p1, t3, e * _LN2_LO)
    y = fma32(z, -0.5, t) + y
    y = fma32(e, _LN2_HI, y)
    y = torch.where(x == float("inf"), x, y)
    y = torch.where(x == 0.0, torch.full_like(y, float("-inf")), y)
    return torch.where((x < 0.0) | torch.isnan(x), torch.full_like(y, float("nan")), y)


def _tanh_rational(x):
    """XLA's f32 tanh rational approximation."""
    c = torch.clamp(x, -_TANH_CLAMP, _TANH_CLAMP)
    z = c * c
    num = fma32(z, _TANH_A[0], _TANH_A[1])
    for k in _TANH_A[2:]:
        num = fma32(z, num, k)
    num = c * num
    den = fma32(z, _TANH_B[0], _TANH_B[1])
    for k in _TANH_B[2:]:
        den = fma32(z, den, k)
    t = num / den
    t = torch.where(torch.abs(x) < _TANH_TINY, x, t)
    return torch.where(torch.abs(x) >= 20.0, torch.copysign(torch.ones_like(x), x), t)


def sinh(x):
    """jnp.sinh (f32) as jax 0.9.0 compiles it on the CPU: for |x| < 1,
    (expm1(x) + expm1(x) / (expm1(x) + 1)) / 2 with XLA's expm1 (e^x - 1
    above |x| = 1/2, tanh(x/2) (e^x + 1) below); otherwise e^(x - ln 2) -
    e^(-ln 2 - x)."""
    x = _daz(x)
    y, scale = _exp_core(x)
    ex = ftz(y * scale)
    half = x * 0.5
    em1 = torch.where(torch.abs(x) > 0.5, ex - 1.0, _tanh_rational(half) * (ex + 1.0))
    em1 = torch.where(half == 0.0, x, em1)
    small = (em1 + em1 / (em1 + 1.0)) * 0.5
    ya, sa = _exp_core(x + _LN2)
    yb, sb = _exp_core(_LN2 - x)
    big = fma32(ya, sa, -(yb * sb))
    return ftz(torch.where(torch.abs(x) < 1.0, small, big))


def _by_index(idx, vals):
    """vals[idx] for an index tensor in [0, 4) and four Python constants."""
    return torch.where(idx < 2, torch.where(idx == 0, vals[0], vals[1]),
                       torch.where(idx == 2, vals[2], vals[3]))


def _atanf_reduced(ax):
    """glibc's atanf on |x| (the reduction by the atan(0.5), atan(1),
    atan(1.5) and atan(inf) breakpoints, then the odd/even polynomial)."""
    ix = ax.view(torch.int32)
    idx = torch.where(ix < 0x3f980000, torch.where(ix < 0x3f300000, 0, 1),
                      torch.where(ix < 0x401c0000, 2, 3))
    small = ix < 0x3ee00000
    xr = torch.where(idx == 0, (2.0 * ax - 1.0) / (2.0 + ax),
                     torch.where(idx == 1, (ax - 1.0) / (ax + 1.0),
                                 torch.where(idx == 2, (ax - 1.5) / (1.5 * ax + 1.0),
                                             -1.0 / ax)))
    xr = torch.where(small, ax, xr)
    z = xr * xr
    w = z * z
    s1 = _AT[8] + w * _AT[10]
    for k in (6, 4, 2, 0):
        s1 = _AT[k] + w * s1
    s1 = z * s1
    s2 = _AT[7] + w * _AT[9]
    for k in (5, 3, 1):
        s2 = _AT[k] + w * s2
    s2 = w * s2
    hi, lo = _by_index(idx, _ATANHI), _by_index(idx, _ATANLO)
    r = torch.where(small, xr - xr * (s1 + s2), hi - ((xr * (s1 + s2) - lo) - xr))
    r = torch.where(ix < 0x31000000, ax, r)
    return torch.where(ix >= 0x4c000000, _ATAN_INF, r)


def atan2(y, x):
    """jnp.arctan2 (f32) as jax 0.9.0 calls it on the CPU: glibc 2.36's
    atan2f, with its quadrant and zero/infinity/NaN cases."""
    y = torch.as_tensor(y, dtype=_F32)
    x = torch.as_tensor(x, dtype=_F32, device=y.device)
    y, x = torch.broadcast_tensors(y, x)
    # the branches read the raw bits; the arithmetic sees subnormals as 0
    hx = x.view(torch.int32)
    hy = y.view(torch.int32)
    ix = hx & 0x7fffffff
    iy = hy & 0x7fffffff
    ax, ay = torch.abs(_daz(x)), torch.abs(_daz(y))
    k = (iy - ix) >> 23
    z = _atanf_reduced(torch.where(ix == 0, 1.0, ay / ax))
    z = torch.where(k > 60, _PI_O_2_BIG, z)
    z = torch.where((hx < 0) & (k < -60), 0.0, z)
    yneg, xneg = hy < 0, hx < 0
    r = torch.where(xneg, torch.where(yneg, (z - _PI_LO) - _PI, _PI - (z - _PI_LO)),
                    torch.where(yneg, -z, z))
    # x or y infinite (e_atan2f.c's table), y = 0, x = 0, NaN
    xinf, yinf = ix == 0x7f800000, iy == 0x7f800000
    r_xinf = torch.where(yinf, torch.where(xneg, _PI_3O4, _PI_O_4),
                         torch.where(xneg, _PI, 0.0))
    r = torch.where(xinf, torch.where(yneg, -r_xinf, r_xinf), r)
    r = torch.where((yinf & ~xinf) | ((ix == 0) & (iy != 0)),
                    torch.where(yneg, -_PI_O_2, _PI_O_2), r)
    r = torch.where(iy == 0, torch.where(xneg, torch.where(yneg, -_PI, _PI), y), r)
    r = ftz(torch.where((ix > 0x7f800000) | (iy > 0x7f800000), x + y, r))
    # x = 1 returns atanf(y), which hands a tiny y back untouched
    return torch.where((hx == 0x3f800000) & (iy < 0x31000000), y, r)


def remainder(x, y):
    """jnp.remainder (f32): C fmod, moved to the divisor's sign."""
    x = torch.as_tensor(x, dtype=_F32)
    y = torch.as_tensor(y, dtype=_F32, device=x.device)
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def acos(x):
    """jnp.arccos (f32) as jax 0.9.0 compiles it on the CPU:
    atan2(sqrt((1 - x)(1 + x)), x), a subnormal x passed to atan2f as it
    is."""
    x = torch.as_tensor(x, dtype=_F32)
    return atan2(sqrt((1.0 - x) * (1.0 + x)), x)


def asin(x):
    """jnp.arcsin (f32) as jax 0.9.0 compiles it on the CPU:
    2 atan2(x, 1 + sqrt((1 - x)(1 + x)))."""
    x = _daz(x)
    return 2.0 * atan2(x, 1.0 + sqrt((1.0 - x) * (1.0 + x)))


# glibc's sinf / cosf (sysdeps/ieee754/flt-32/{s_sinf,s_cosf,sincosf}.{c,h}):
# the argument in f64, the quadrant by the 2/pi * 2^24 fixed-point
# product, f64 polynomials, one rounding to f32 at the end
_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")
_HPI = float.fromhex("0x1.921FB54442D18p0")
# pi/2 in a 26-bit head and its tail: n * head is exact, so the
# reduction x - n pi/2 rounds once, as the reference's fused
# multiply-subtract does
_HPI_HEAD = float.fromhex("0x1.921FB54p0")
_HPI_TAIL = _HPI - _HPI_HEAD
_SC_C = tuple(float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5", "-0x1.6c087e89a359dp-10",
    "0x1.99343027bf8c3p-16"))
_SC_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7", "-0x1.994eb3774cf24p-13"))
_ABSTOP_PIO4 = 0x3f4   # abstop12(0x1.921FB6p-1f)
_ABSTOP_TINY = 0x398   # abstop12(0x1p-12f)
_ABSTOP_120 = 0x42f    # abstop12(120.0f)


def _sincos_poly(x, x2, n, neg_cos):
    """sinf_poly: the sine polynomial for even n, the cosine one (its
    coefficients negated in quadrants 2 and 3) for odd n; all in f64."""
    x3 = x * x2
    sin_v = (x + x3 * _SC_S[0]) + (x3 * x2) * (_SC_S[1] + x2 * _SC_S[2])
    sgn = torch.where(neg_cos, -1.0, 1.0).to(torch.float64)
    x4 = x2 * x2
    c2 = sgn * _SC_C[3] + x2 * (sgn * _SC_C[4])
    c1 = sgn * _SC_C[0] + x2 * (sgn * _SC_C[1])
    c = c1 + x4 * (sgn * _SC_C[2])
    cos_v = c + (x4 * x2) * c2
    return torch.where((n & 1) == 0, sin_v, cos_v)


def _sincos(y, cosine: bool):
    y = torch.as_tensor(y, dtype=_F32)
    top = (y.view(torch.int32) >> 20) & 0x7ff
    x = y.double()
    # |y| < pi/4: the polynomial on y itself
    n0 = torch.full_like(top, 1 if cosine else 0)
    small = _sincos_poly(x, x * x, n0, torch.zeros_like(top, dtype=torch.bool))
    # |y| < 120: one fixed-point reduction by pi/2
    r = x * _HPI_INV
    n = ((r.to(torch.int32) + 0x800000) >> 24)
    xr = (x - n.double() * _HPI_HEAD) - n.double() * _HPI_TAIL
    sgn = torch.where(((n & 3) == 1) | ((n & 3) == 2), -1.0, 1.0).to(torch.float64)
    red = _sincos_poly(xr * sgn, xr * xr, n ^ 1 if cosine else n, (n & 2) != 0)
    out = torch.where(top < _ABSTOP_PIO4, small, red).to(_F32)
    tiny = torch.ones_like(y) if cosine else y
    out = torch.where(top < _ABSTOP_TINY, tiny, out)
    # beyond |y| = 120 the reference reduces in multiple precision; the
    # port's callers never go there and take torch's value
    far = torch.cos(y) if cosine else torch.sin(y)
    return torch.where(top < _ABSTOP_120, out, far)


def sin(x):
    """jnp.sin (f32) as jax 0.9.0 calls it on the CPU: glibc's sinf."""
    return _sincos(x, False)


def cos(x):
    """jnp.cos (f32) as jax 0.9.0 calls it on the CPU: glibc's cosf."""
    return _sincos(x, True)
