"""The port's spline and Fourier interpolation
(tpu_pbrt_torch/core/interpolation.py) against the JAX package's
(tpu_pbrt/core/interpolation.py) on the same seeded numpy inputs, and
the reference's own oracles of tests/test_interpolation.py on the port.

Tolerances: find_interval's indices are equal; catmull_rom_weights,
catmull_rom and fourier equal the reference bit for bit (the same f32
operations in the same order); integrate_catmull_rom is the reference's
float64 host code and equal; sample_catmull_rom's x, f(x) and pdf agree
within 2e-6 absolute (its first guess takes a square root, which XLA
rounds correctly and the port matches, and 12 Newton rounds; measured
equal on every lane).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_pbrt.core import interpolation as ji
from tpu_pbrt_torch.core import interpolation as ti

torch.set_num_threads(1)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _xs(rng, n):
    return np.sort(np.concatenate([[0.0], rng.uniform(0.0, 1.0, n - 2), [1.0]])).astype(np.float32)


def test_find_interval_matches_reference_and_oracle():
    xs = np.asarray([0.0, 1.0, 2.0, 5.0, 9.0], np.float32)
    x = np.asarray([-1.0, 0.0, 0.5, 1.0, 4.9, 9.0, 20.0], np.float32)
    got = ti.find_interval(torch.from_numpy(xs), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, [0, 0, 0, 1, 2, 3, 3])
    rng = np.random.default_rng(1)
    for n in (2, 3, 17, 64):
        xs = _xs(rng, n)
        x = rng.uniform(-0.2, 1.2, 4096).astype(np.float32)
        np.testing.assert_array_equal(ti.find_interval(torch.from_numpy(xs), torch.from_numpy(x)),
                                      np.asarray(ji.find_interval(jnp.asarray(xs), jnp.asarray(x))))


@pytest.mark.parametrize("n", [2, 4, 9, 33])
def test_catmull_rom_weights_and_spline_bit_equal(n):
    rng = np.random.default_rng(n)
    xs = _xs(rng, n)
    fs = rng.normal(size=n).astype(np.float32)
    x = rng.uniform(-0.1, 1.1, 4096).astype(np.float32)
    got = ti.catmull_rom_weights(torch.from_numpy(xs), torch.from_numpy(x))
    want = ji.catmull_rom_weights(jnp.asarray(xs), jnp.asarray(x))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    np.testing.assert_array_equal(
        _bits(ti.catmull_rom(torch.from_numpy(xs), torch.from_numpy(fs), torch.from_numpy(x))),
        _bits(ji.catmull_rom(jnp.asarray(xs), jnp.asarray(fs), jnp.asarray(x))))


def test_catmull_rom_interpolates_nodes_and_smooth():
    """tests/test_interpolation.py's oracle on the port."""
    xs = np.linspace(0.0, 1.0, 9).astype(np.float32)
    fs = (np.sin(2 * np.pi * xs) + 2.0).astype(np.float32)
    out = ti.catmull_rom(torch.from_numpy(xs), torch.from_numpy(fs), torch.from_numpy(xs)).numpy()
    np.testing.assert_allclose(out, fs, atol=1e-5)
    xq = np.linspace(0.05, 0.95, 50).astype(np.float32)
    out = ti.catmull_rom(torch.from_numpy(xs), torch.from_numpy(fs), torch.from_numpy(xq)).numpy()
    np.testing.assert_allclose(out, np.sin(2 * np.pi * xq) + 2.0, atol=0.03)


def test_integrate_catmull_rom_equals_reference():
    rng = np.random.default_rng(4)
    xs = _xs(rng, 17).astype(np.float64)
    fs = 0.2 + (xs - 0.3) ** 2 + rng.uniform(0, 0.1, 17)
    (cg, tg), (cw, tw) = ti.integrate_catmull_rom(xs, fs), ji.integrate_catmull_rom(xs, fs)
    np.testing.assert_array_equal(cg, cw)
    assert tg == tw


def test_sample_catmull_rom_matches_reference_and_density():
    xs = np.linspace(0.0, 1.0, 17)
    fs = 0.2 + (xs - 0.3) ** 2  # positive, non-uniform
    cdf, total = ti.integrate_catmull_rom(xs, fs)
    rng = np.random.default_rng(5)
    u = rng.uniform(size=50_000).astype(np.float32)
    x, fval, pdf = ti.sample_catmull_rom(xs, fs, cdf, torch.from_numpy(u))
    xj, fj, pj = ji.sample_catmull_rom(xs, fs, cdf, jnp.asarray(u))
    for a, b in ((x, xj), (fval, fj), (pdf, pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-6)
    x = x.numpy()
    assert (x >= 0).all() and (x <= 1).all()
    hist, edges = np.histogram(x, bins=16, range=(0, 1), density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    np.testing.assert_allclose(hist, (0.2 + (centers - 0.3) ** 2) / total, rtol=0.08)
    est = np.mean((0.2 + (x - 0.3) ** 2) / np.maximum(pdf.numpy(), 1e-9))
    np.testing.assert_allclose(est, total, rtol=0.05)


@pytest.mark.parametrize("m", [1, 4, 12])
def test_fourier_matches_reference_and_direct_sum(m):
    rng = np.random.default_rng(7 + m)
    a = rng.normal(size=(512, m)).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, 512)
    c = np.cos(phi).astype(np.float32)
    got = ti.fourier(torch.from_numpy(a), torch.from_numpy(c), m).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ji.fourier(jnp.asarray(a), jnp.asarray(c), m)))
    direct = np.sum(a * np.cos(np.arange(m)[None, :] * phi[:, None]), axis=1)
    np.testing.assert_allclose(got, direct, atol=1e-3)
