"""The port's stream tracer (tpu_pbrt_torch/accel/stream.py) against the
reference's (tpu_pbrt/accel/stream.py, its jnp path on the CPU), on the
same ~2000-triangle TreeletPack carried across through scene/bridge.py
and the same 400 seeded rays.

Tolerances: hit mask and prim exact, except a flip at a near-tie (the
two candidates' t within 1e-6 relative, where a 1-ulp difference of the
f32 contraction may pick either); t, b0 and b1 within 1e-5 (absolute:
unit-scale scene, f32 barycentric solve); the traversal counters
(pairs expanded, block-slot tests, drops, iterations) exact — same
worklist, same keys, same sort order — with no pair dropped.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpu_pbrt.accel import build as jbuild
from tpu_pbrt.accel import stream as jstream
from tpu_pbrt.accel.treelet import build_treelet_pack as jbuild_pack
from tpu_pbrt_torch.accel import stream as tstream
from tpu_pbrt_torch.scene.bridge import treelet_pack_from_numpy
from tests.test_torch_xla_math import JitRef, rounded_apart

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(31)
    n = 2000
    tris = (rng.uniform(-2, 2, (n, 1, 3)) + rng.uniform(-0.25, 0.25, (n, 3, 3)))
    tris = tris.astype(np.float32)
    bvh = jbuild.build_bvh(*jbuild.triangle_bounds(tris), method="sah")
    tris_perm = tris[bvh.prim_order]
    tp_j = jbuild_pack(tris_perm, bvh, leaf_tris=128)
    tp_np = jax.tree.map(np.asarray, tp_j)
    tp_t = treelet_pack_from_numpy(tp_np, "cpu")
    # rays from a shell around the soup toward points inside it
    o = rng.normal(size=(400, 3))
    o = (5.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)).astype(np.float32)
    d = (rng.uniform(-2, 2, (400, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = np.where(rng.uniform(size=400) < 0.1, -1.0,
                     np.where(rng.uniform(size=400) < 0.5, 1e30, 4.0)).astype(np.float32)
    return tp_j, tp_t, tris_perm, o, d, t_max


@rounded_apart
def test_stream_intersect_matches_reference(case):
    _check_stream_intersect(case, jstream)


def test_stream_intersect_matches_reference_contracted(case):
    """The port's default rounding (the fused barycentric products of
    `_finalize_hits`) against the reference compiled at the renders'
    optimisation level, with the same bounds."""
    _check_stream_intersect(case, JitRef(jstream))


def _check_stream_intersect(case, jstream):
    tp_j, tp_t, tris, o, d, t_max = case
    hj = jstream.stream_intersect(tp_j, jnp.asarray(tris), jnp.asarray(o), jnp.asarray(d),
                                  jnp.asarray(t_max))
    ht = tstream.stream_intersect(tp_t, torch.from_numpy(tris), torch.from_numpy(o),
                                  torch.from_numpy(d), torch.from_numpy(t_max))
    pj, pt = np.asarray(hj.prim), ht.prim.numpy()
    tj, tt = np.asarray(hj.t), ht.t.numpy()
    assert (pj >= 0).sum() > 100  # the test bites
    np.testing.assert_array_equal(pj >= 0, pt >= 0)
    # a prim flip is allowed only at a near-tie, and under 0.1% of rays
    flips = pj != pt
    with np.errstate(invalid="ignore"):
        near = np.abs(tt.astype(np.float64) - tj) <= 1e-6 * np.abs(tj.astype(np.float64))
    assert (near | ~flips).all()
    assert flips.sum() <= int(0.001 * len(pj))
    same = ~flips
    np.testing.assert_allclose(tt[same], tj[same], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ht.b0.numpy()[same], np.asarray(hj.b0)[same], rtol=0, atol=1e-5)
    np.testing.assert_allclose(ht.b1.numpy()[same], np.asarray(hj.b1)[same], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ht.tv.numpy()[same], np.asarray(hj.tv)[same])


def test_stream_intersect_p_matches_reference(case):
    tp_j, tp_t, _, o, d, t_max = case
    pj = np.asarray(jstream.stream_intersect_p(tp_j, jnp.asarray(o), jnp.asarray(d),
                                               jnp.asarray(t_max)))
    pt = tstream.stream_intersect_p(tp_t, torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(t_max)).numpy()
    assert 100 < pj.sum() < len(pj)
    np.testing.assert_array_equal(pt, pj)


@pytest.mark.parametrize("any_hit", [False, True])
def test_stream_traverse_stats_match_reference(case, any_hit):
    tp_j, tp_t, _, o, d, t_max = case
    sj = [int(x) for x in jstream.stream_traverse_stats(
        tp_j, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max), any_hit=any_hit)]
    st = list(tstream.stream_traverse_stats(
        tp_t, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(t_max),
        any_hit=any_hit))
    assert st == sj  # (n_exp, n_tl, n_drop, iters)
    assert st[2] == 0
    assert st[3] > 2  # several expand steps and flushes


@pytest.fixture(scope="module")
def fine_pack():
    """A ~10k-triangle blob cut into 8-triangle treelets: 1,261 of them,
    more than a 2^21-ray wave's packed flush key can carry (2^(31-21))."""
    from tpu_pbrt_torch.accel.build import build_bvh, triangle_bounds
    from tpu_pbrt_torch.accel.treelet import build_treelet_pack_numpy, pack_from_numpy
    from tpu_pbrt_torch.scenes import _displaced_sphere

    V, F, _ = _displaced_sphere(36, 144)
    tris = V[F].astype(np.float64)
    bvh = build_bvh(*triangle_bounds(tris), method="sah")
    tris = tris[bvh.prim_order]
    return pack_from_numpy(build_treelet_pack_numpy(tris, bvh, leaf_tris=8), "cpu")


def test_unpacked_flush_key_matches_packed(fine_pack):
    """The flush sorts (treelet, ray) pairs by ONE packed int32 key while
    C < 2^(31 - ray bits), else by treelet id alone in a stable sort that
    carries the ray ids: the same 300 live rays traced in a 2^21-ray wave
    (unpacked) and a 2^19-ray wave (packed), every other lane dead, must
    find the same (t, prim), with no pair dropped."""
    tp = fine_pack
    C = tp.n_treelets
    assert C >= 1 << (31 - 21) and C < 1 << (31 - 19)
    rng = np.random.default_rng(77)
    k = 300
    o = rng.normal(size=(k, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.8, 0.8, (k, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    out = []
    for R in (1 << 21, 1 << 19):
        oo = torch.zeros((R, 3))
        dd = torch.zeros((R, 3))
        dd[:, 2] = 1.0
        oo[:k] = torch.from_numpy(o.astype(np.float32))
        dd[:k] = torch.from_numpy(d.astype(np.float32))
        t_max = torch.full((R,), -1.0)
        t_max[:k] = float("inf")
        s = tstream._traverse(tp, oo, dd, t_max, False)
        assert int(s.n_drop) == 0
        out.append((s.rayF[6][:k].clone(), s.prim[:k].clone(), s.prim[k:]))
    (t_u, p_u, rest_u), (t_p, p_p, rest_p) = out
    assert (p_u >= 0).sum() > k // 2  # the test bites
    assert bool((rest_u < 0).all()) and bool((rest_p < 0).all())
    np.testing.assert_array_equal(p_u.numpy(), p_p.numpy())
    np.testing.assert_array_equal(t_u.numpy().view(np.uint32), t_p.numpy().view(np.uint32))
