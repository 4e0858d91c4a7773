"""The port's copies of the reference's f32 transcendentals
(tpu_pbrt_torch/core/xla_math.py) against jax.numpy's on the CPU, bit for
bit, on dense sweeps of f32 inputs: 2^19 evenly strided bit patterns of
the function's range, both signs (every exponent), the exponent edges
(each power of two and its neighbours), the clamp and branch edges of
each function, signed zeros, subnormals, infinities and NaN.

The reference compiles log, exp and sinh to XLA's own polynomials (with
fused multiply-adds) and calls glibc's atan2f, sinf and cosf; asin is
2 atan2(x, 1 + sqrt((1 - x)(1 + x))) and acos atan2(sqrt((1 - x)(1 + x)),
x); its programs flush subnormals. `fmac` rounds a product and the sum
that consumes it once under `contraction(True)` (the reference's
compiled programs) and apart under `contraction(False)`.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_pbrt_torch.core import xla_math as xm

torch.set_num_threads(1)


def rounded_apart(fn):
    """Run a test (or a fixture) with the port rounding every product and
    sum apart (`xla_math.contraction(False)`): the reference functions it
    is held to run on their own there, op by op, where no product is
    fused into the sum that consumes it. Renders, held to the reference's
    compiled programs, keep the default contraction."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with xm.contraction(False):
            return fn(*args, **kwargs)

    return run


#: XLA's default CPU backend optimisation level, at which the reference's
#: renders compile (tests/conftest.py lowers the suite's to 0, where LLVM
#: fuses fewer products into their sums)
RENDER_OPT_LEVEL = 3


def jit_ref(fn):
    """The reference function `fn` as its compiled programs round it: under
    jax.jit at the renders' optimisation level, where XLA fuses a product
    into the sum that consumes it (the port's default `contraction(True)`).
    Array leaves of the arguments are traced; every other leaf (an int,
    bool, string or None) is held static."""

    def call(*args, **kwargs):
        leaves, tree = jax.tree.flatten((args, kwargs))
        traced = [isinstance(x, (jax.Array, np.ndarray, np.generic)) for x in leaves]

        def inner(arrs):
            it = iter(arrs)
            a, k = jax.tree.unflatten(tree, [next(it) if t else x for x, t in zip(leaves, traced)])
            return fn(*a, **k)

        arrs = [x for x, t in zip(leaves, traced) if t]
        opts = {"xla_backend_optimization_level": RENDER_OPT_LEVEL}
        return jax.jit(inner).lower(arrs).compile(compiler_options=opts)(arrs)

    return call


def assert_within_ulp(got, want, max_ulp: int, what: str = ""):
    """Every f32 of `got` (a tensor or array) within `max_ulp` units in the
    last place of `want`'s, counted on the ordered integer line of the
    bit patterns (a sign change counts the steps through zero); NaN only
    where `want` is NaN."""
    a = np.asarray(got.numpy() if torch.is_tensor(got) else got, np.float32).ravel()
    b = np.asarray(want, np.float32).ravel()
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    ia, ib = (x.view(np.int32).astype(np.int64) for x in (a, b))
    ia, ib = (np.where(x < 0, -(x & 0x7FFFFFFF), x) for x in (ia, ib))
    d = np.where(np.isnan(b), 0, np.abs(ia - ib))
    assert d.max(initial=0) <= max_ulp, f"{what}: {int(d.max())} ulp apart (bound {max_ulp})"


class JitRef:
    """A reference module whose functions run under `jit_ref`."""

    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        fn = getattr(self._module, name)
        return jit_ref(fn) if callable(fn) and not isinstance(fn, type) else fn


def _pattern_sweep(lo_bits: int, hi_bits: int) -> np.ndarray:
    """2^19 evenly strided positive f32 bit patterns in [lo_bits, hi_bits)
    (an odd stride, so every low-bit pattern occurs), both signs, and each
    power of two in the range with its neighbours."""
    stride = max(1, (hi_bits - lo_bits) >> 19) | 1
    pos = np.arange(lo_bits, hi_bits, stride, dtype=np.int64)
    edges = np.arange((lo_bits >> 23) << 23, hi_bits, 1 << 23, dtype=np.int64)
    edges = np.concatenate([edges - 1, edges, edges + 1])
    bits = np.concatenate([pos, edges])
    bits = bits[(bits >= 0) & (bits < 0x7f800000)].astype(np.int32)
    x = bits.view(np.float32)
    return np.concatenate([x, -x])


_SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 1.17549435e-38,
                     -1.17549435e-38, 1.0, -1.0, 0.5, -0.5, 2.0, 88.8, 88.9, -87.8, -87.9,
                     87.33656, -87.33656, 0.0004, 20.0, -20.0, 120.0, -120.0, 0.78539818,
                     2.4375, 1.1875, 0.4375, 0.6875], np.float32)


def _same(got, want, x):
    g = np.asarray(got, np.float32).view(np.int32)
    w = np.asarray(want, np.float32).view(np.int32)
    both_nan = np.isnan(np.asarray(got)) & np.isnan(np.asarray(want))
    bad = (g != w) & ~both_nan
    assert not bad.any(), f"{bad.sum()} of {bad.size} differ, e.g. at {x[bad][:5]}"


#: function -> (port, reference, the bit range swept)
CASES = {
    "log": (xm.log, jnp.log, (0x00800000, 0x7f800000)),
    "exp": (xm.exp, jnp.exp, (0x30000000, 0x42b40000)),
    "sinh": (xm.sinh, jnp.sinh, (0x30000000, 0x42b40000)),
    "sin": (xm.sin, jnp.sin, (0x30000000, 0x42f00000)),
    "cos": (xm.cos, jnp.cos, (0x30000000, 0x42f00000)),
    "asin": (xm.asin, jnp.arcsin, (0x30000000, 0x3f800001)),
    "acos": (xm.acos, jnp.arccos, (0x30000000, 0x3f800001)),
    "sqrt": (xm.sqrt, jnp.sqrt, (0x00800000, 0x7f800000)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_unary_function_bit_equal_to_reference(name):
    port, ref, (lo, hi) = CASES[name]
    x = np.concatenate([_pattern_sweep(lo, hi), _SPECIAL])
    if name == "sqrt":
        x = np.abs(x)
    _same(port(torch.from_numpy(x)), jax.jit(ref)(x), x)


def test_atan2_bit_equal_to_reference():
    rng = np.random.default_rng(9)
    n = 1 << 20
    y = (rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))).astype(np.float32)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-20, 20, n))).astype(np.float32)
    # the quadrant, zero, infinity and NaN cases, and the reduction's
    # breakpoints |y / x| = 7/16, 11/16, 19/16, 39/16 and 2^+-60
    sp = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 0.4375, 0.6875, 1.1875,
                   2.4375, 2.0**60, 2.0**-60, 1e-40], np.float32)
    y = np.concatenate([y, np.repeat(sp, len(sp)), np.float32(0.4375) * x[:1000]])
    x = np.concatenate([x, np.tile(sp, len(sp)), x[:1000]])
    _same(xm.atan2(torch.from_numpy(y), torch.from_numpy(x)), jax.jit(jnp.arctan2)(y, x),
          np.stack([y, x], -1))


def test_remainder_and_fma_bit_equal():
    """jnp.remainder's sign rule, and fma32 against the exact fused
    multiply-add of f32 inputs: where the f64 sum of the exact f64
    product is itself exact, rounding it once to f32 is the fused result,
    so the two must agree bit for bit there (fma32's one documented
    difference, a sum whose own rounding lands on an f32 midpoint, needs
    an inexact f64 sum)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(1 << 16) * 10).astype(np.float32)
    y = np.where(rng.uniform(size=1 << 16) < 0.5, 2 * np.pi, -1.7).astype(np.float32)
    _same(xm.remainder(torch.from_numpy(x), torch.from_numpy(y)), jnp.remainder(x, y), x)
    a, b, c = (rng.standard_normal(1 << 16).astype(np.float32) for _ in range(3))
    got = xm.fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    p = a.astype(np.float64) * b.astype(np.float64)
    s = p + c.astype(np.float64)
    exact = (s - p) == c.astype(np.float64)
    assert exact.mean() > 0.9
    np.testing.assert_array_equal(got[exact], s[exact].astype(np.float32))
    # Python-float operands (the polynomials' coefficients) act as f32 values
    np.testing.assert_array_equal(xm.fma32(torch.from_numpy(a), 0.5, 0.25).numpy(),
                                  (a.astype(np.float64) * 0.5 + 0.25).astype(np.float32))


def test_fmac_follows_the_contraction_mode():
    rng = np.random.default_rng(5)
    a, b, c = (torch.from_numpy(rng.standard_normal(1 << 14).astype(np.float32))
               for _ in range(3))
    assert xm.contracting()
    np.testing.assert_array_equal(xm.fmac(a, b, c).numpy(), xm.fma32(a, b, c).numpy())
    with xm.contraction(False):
        assert not xm.contracting()
        apart = xm.fmac(a, b, c)
        np.testing.assert_array_equal(apart.numpy(), (a * b + c).numpy())
        with xm.contraction(True):
            assert xm.contracting()
        assert not xm.contracting()
    assert xm.contracting()
    # the two roundings differ somewhere, or the mode would be moot
    assert (apart != xm.fma32(a, b, c)).any()
