"""The port's samplers (tpu_pbrt_torch/core/sampling.py) against the
reference's (tpu_pbrt/core/sampling.py), eager JAX on the CPU.

Every draw of every kind ("random", "02", "stratified", "halton",
"sobol") is a pure function of (px, py, sample, dimension salt), so the
port's draws must equal the reference's BIT FOR BIT on a seeded grid of
work items, at spp 1, 4, 12 and 64, for int salts and for per-lane
tensor salts (the pool's). The reference's Halton pair dispatch takes
only a scalar salt (lax.switch), so the port's per-lane Halton draws are
held against the reference's draws at each lane's own int salt. Also:
the Sobol' direction numbers and pixel-remap tables, the film jitter
under Sobol', the Sobol' downgrade to the (0,2)-sequence, and the sampler
name normalisation with its substitution warnings.
"""

from types import SimpleNamespace

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpu_pbrt.core import sampling as J
from tpu_pbrt.integrators.common import WavefrontIntegrator as JWavefront
from tpu_pbrt_torch.core import sampling as T
from tpu_pbrt_torch.integrators.common import WavefrontIntegrator as TWavefront
from tpu_pbrt_torch.utils import error as terror

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

KINDS = ("random", "02", "stratified", "halton", "sobol")
N = 512


def _grid(spp, seed):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 1024, N).astype(np.int32)
    py = rng.integers(0, 1024, N).astype(np.int32)
    s = rng.integers(0, spp, N).astype(np.int32)
    salt = rng.integers(0, 400, N).astype(np.int32)
    return px, py, s, salt


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.uint32)


def _both(kind, spp, px, py, s, salt_j, salt_t):
    """(reference, port) of sample_1d and both halves of sample_2d."""
    jargs = (jnp.asarray(px), jnp.asarray(py), jnp.asarray(s), salt_j)
    targs = (torch.from_numpy(px), torch.from_numpy(py), torch.from_numpy(s), salt_t)
    ref = [J.sample_1d(kind, spp, *jargs), *J.sample_2d(kind, spp, *jargs)]
    got = [T.sample_1d(kind, spp, *targs), *T.sample_2d(kind, spp, *targs)]
    return [_bits(a) for a in ref], [_bits(b.numpy()) for b in got]


@pytest.mark.parametrize("spp", [1, 4, 12, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_draws_match_reference_bit_for_bit(kind, spp):
    px, py, s, salt = _grid(spp, seed=spp)
    for k in (0, 5, 23, 77, 1016):  # int salts: lens, light, bsdf, offset, lights
        ref, got = _both(kind, spp, px, py, s, k, k)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(b, a, err_msg=f"{kind} spp {spp} salt {k}")
    # per-lane tensor salts (the persistent pool's)
    if kind == "halton":
        got = [_bits(x.numpy()) for x in (
            T.sample_1d(kind, spp, *map(torch.from_numpy, (px, py, s, salt))),
            *T.sample_2d(kind, spp, *map(torch.from_numpy, (px, py, s, salt))))]
        for k in np.unique(salt)[:12]:
            # the reference's draws with the int salt k on every lane (one
            # shape, so its operations compile once), held on the lanes
            # whose salt is k
            lane = salt == k
            ref, _ = _both(kind, spp, px, py, s, int(k), int(k))
            for a, b in zip(ref, got):
                np.testing.assert_array_equal(b[lane], a[lane], err_msg=f"halton lane salt {k}")
    else:
        ref, got = _both(kind, spp, px, py, s, jnp.asarray(salt), torch.from_numpy(salt))
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(b, a, err_msg=f"{kind} spp {spp} tensor salts")
    if spp > 1 and kind in ("stratified", "sobol", "halton", "02"):
        # the draws of one pixel's samples are a permutation, not a repeat
        u = T.sample_1d(kind, spp, torch.zeros(spp, dtype=torch.int32),
                        torch.zeros(spp, dtype=torch.int32),
                        torch.arange(spp, dtype=torch.int32), 9)
        assert len(np.unique(u.numpy())) == spp


def test_sobol_tables_match_reference():
    np.testing.assert_array_equal(T._sobol_matrices(), J._SOBOL_V)
    for m in (1, 4, 9):
        hi, inv = J._RemapTables.get(m)
        hi_t, inv_t = T._remap_tables(m)
        assert list(hi_t) == [int(x) for x in hi] and list(inv_t) == [int(x) for x in inv]


@pytest.mark.parametrize("res", [1, 16, 200, 512])
def test_sobol_film_jitter_matches_reference(res):
    """film_jitter under Sobol': the global index remap lands sample s of
    pixel (px, py) inside that pixel; the offsets equal the reference's."""
    m = J.sobol_resolution_log2((res, res))
    assert T.sobol_resolution_log2((res, res)) == m
    rng = np.random.default_rng(res)
    px = rng.integers(0, res, N).astype(np.int32)
    py = rng.integers(0, res, N).astype(np.int32)
    s = rng.integers(0, 64, N).astype(np.int32)
    self_ = SimpleNamespace(skind="sobol", _sobol_m=m)
    fj = JWavefront.film_jitter(self_, jnp.asarray(px), jnp.asarray(py), jnp.asarray(s))
    ft = TWavefront.film_jitter(self_, *map(torch.from_numpy, (px, py, s)))
    for a, b in zip(fj, ft):
        np.testing.assert_array_equal(_bits(b.numpy()), _bits(a))
        assert (b >= 0).all() and (b < 1).all()


def _prepared(cls, res, spp):
    self_ = SimpleNamespace(skind="sobol", spp=spp,
                            scene=SimpleNamespace(film=SimpleNamespace(full_resolution=res)))
    cls._prepare_sampler(self_)
    return self_.skind, self_._sobol_m


@pytest.mark.parametrize("res,spp", [((4096, 2048), 512), ((4096, 2048), 64), ((300, 20), 16)])
def test_sobol_downgrade_matches_reference(res, spp):
    """spp * 4^m >= 2^31 substitutes the (0,2)-sequence, with a warning."""
    n0 = terror._n_warnings
    got = _prepared(TWavefront, res, spp)
    assert got == _prepared(JWavefront, res, spp)
    m = got[1]
    assert got[0] == ("02" if spp << (2 * m) >= (1 << 31) else "sobol")
    assert terror._n_warnings - n0 == (got[0] == "02")


@pytest.mark.parametrize("name", ["random", "Stratified", "halton", "sobol", "lowdiscrepancy",
                                  "02sequence", "zerotwosequence", "maxmindist", "pmj02bn", ""])
def test_sampler_names_normalise_as_the_reference(name):
    n0 = terror._n_warnings
    assert T.normalize_sampler_name(name) == J.normalize_sampler_name(name)
    warned = terror._n_warnings - n0
    assert warned == (name.lower() not in ("random", "stratified", "halton", "sobol",
                                           "lowdiscrepancy", "02sequence", "zerotwosequence"))


def test_uniform_hemisphere_matches_reference():
    """The warp ao's uniform sampling uses. Its cos/sin are XLA's and
    PyTorch's own CPU implementations, which differ by up to 1 ulp."""
    rng = np.random.default_rng(3)
    u1, u2 = rng.uniform(0, 1, (2, N)).astype(np.float32)
    a = np.asarray(J.uniform_sample_hemisphere(jnp.asarray(u1), jnp.asarray(u2)))
    b = T.uniform_sample_hemisphere(torch.from_numpy(u1), torch.from_numpy(u2)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-7)
    assert np.float32(T.UNIFORM_HEMISPHERE_PDF) == np.float32(J.UNIFORM_HEMISPHERE_PDF)


@pytest.mark.parametrize("sampler", ["sobol", "stratified", "halton"])
def test_path_pool_equals_fixed_batch_under_sampler(sampler, monkeypatch):
    """`path` through the persistent pool draws with per-lane salts, the
    fixed batch with int salts: the same rays and the same image up to
    the deposit's float order. Halton keeps the fixed batch (its pair
    dispatch takes one salt per call), as in the reference."""
    from tpu_pbrt_torch.config import cfg
    from tpu_pbrt_torch.scenes import compile_api, make_cornell

    out = []
    for regen in (True, False):
        monkeypatch.setattr(cfg, "regen", regen)
        scene, integ = compile_api(make_cornell(res=8, spp=4, integrator="path",
                                                sampler=sampler, device="cpu"))
        out.append(integ.render(scene, chunk=128))
    pool, fixed = out
    assert bool(pool.stats.get("regen")) == (sampler != "halton")
    assert pool.rays_traced == fixed.rays_traced > 8 * 8 * 4
    np.testing.assert_allclose(pool.image, fixed.image, rtol=1e-4, atol=1e-5)
