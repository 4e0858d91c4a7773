"""The plain versions of the port's two stream-tracer kernels against the
reference's Pallas kernels run in interpret mode on the CPU.

- kernels.flush.flush_chunk_plain vs accel.fusedwave.fused_flush_chunk:
  t must agree to 2 ulp (the plain contraction and the reference's f32 dot
  both sum the F products in order; 2 ulp absorbs a different rounding of
  a product library), prim exactly, except at near-ties where the two
  best t of a ray are within 1e-6 relative — a 1-ulp wobble may pick
  either triangle there; such flips must stay under 0.1% of rays.
- kernels.expand.expand_plain vs accel.fusedwave.fused_expand: the keys,
  candidate codes and live flags are integers and must match EXACTLY.

Inputs are made from a seed with numpy and handed to both sides.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpu_pbrt.accel import fusedwave
from tpu_pbrt.accel import stream as jstream
from tpu_pbrt_torch.accel import stream as tstream
from tpu_pbrt_torch.accel.mxu import tri_feature_weights_motion, tri_feature_weights_raw
from tpu_pbrt_torch.accel.treelet import build_treelet_pack_numpy
from tpu_pbrt_torch.accel import build as tbuild
from tpu_pbrt_torch.kernels.expand import expand, expand_plain
from tpu_pbrt_torch.kernels.flush import flush_chunk, flush_chunk_plain

I32_MAX = 2**31 - 1


@pytest.fixture(autouse=True)
def _pallas_compiler_params(monkeypatch):
    """The reference kernels name pltpu.TPUCompilerParams, which newer JAX
    releases call CompilerParams; alias it for this test process so the
    reference's Pallas kernels run unchanged in interpret mode."""
    from jax.experimental.pallas import tpu as pltpu

    if "TPUCompilerParams" not in vars(pltpu):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams, raising=False)


def _ulp_diff(a, b):
    """Distance in f32 ulps (same-sign finite values; inf == inf -> 0)."""
    ai = a.view(np.int32).astype(np.int64)
    bi = b.view(np.int32).astype(np.int64)
    d = np.abs(ai - bi)
    return np.where((a == b), 0, d)


def _flush_inputs(F: int, seed: int = 3):
    """C=4 treelets of L=64 triangles, CH=6 blocks (one dead, -1 slots),
    R=300 rays. Treelet 3 is a copy of treelet 1 (same features and
    center, other prim offset) and triangle 5 of treelet 0 repeats
    triangle 2: both force exact t ties."""
    rng = np.random.default_rng(seed)
    C, L, R, CH = 4, 64, 300, 6
    centers = rng.uniform(-1.0, 1.0, (C, 3)).astype(np.float32)
    v0 = (centers[:, None, None, :] + rng.uniform(-0.6, 0.6, (C, L, 3, 3))).astype(np.float32)
    v0[0, 5] = v0[0, 2]
    v0[3] = v0[1]
    centers[3] = centers[1]
    if F == 16:
        W = tri_feature_weights_raw(v0.reshape(C * L, 3, 3),
                                    np.repeat(centers, L, axis=0)[:, None, :])
        W = W.reshape(C, L, 16, 4)
    else:
        v1 = (v0 + rng.uniform(-0.05, 0.05, v0.shape)).astype(np.float32)
        v1[0, 5] = v1[0, 2]
        v1[3] = v1[1]
        W = tri_feature_weights_motion(
            v0.reshape(C * L, 3, 3), v1.reshape(C * L, 3, 3),
            np.repeat(centers, L, axis=0)[:, None, :], raw=True,
        ).reshape(C, L, 64, 4)
    featT = np.ascontiguousarray(W.transpose(0, 3, 1, 2).reshape(C, 4 * L, F).transpose(0, 2, 1))
    offset = np.array([0, 64, 128, 700], np.int32)

    # rays aimed at triangle centroids from outside: rays 0..7 at the
    # duplicated triangle (0, 2), rays 8..47 at treelet 1 (= treelet 3)
    cent = v0.mean(axis=2)  # (C, L, 3)
    nrm = np.cross(v0[..., 1, :] - v0[..., 0, :], v0[..., 2, :] - v0[..., 0, :])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tgt = cent.reshape(-1, 3)[rng.integers(0, C * L, R)]
    o = (tgt + rng.normal(size=(R, 3)) * 2.0).astype(np.float32)
    d = tgt - o + rng.normal(size=(R, 3)).astype(np.float32) * 0.01
    # the tie rays start just off their target triangle, facing it
    k1 = rng.integers(0, L, 40)
    tgt[:8], tgt[8:48] = cent[0, 2], cent[1, k1]
    n_t = np.concatenate([np.repeat(nrm[0, 2][None], 8, 0), nrm[1, k1]])
    o[:48] = tgt[:48] + 1e-3 * n_t
    d[:48] = -n_t
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    t_row = np.where(rng.uniform(size=R) < 0.7, np.inf,
                     rng.uniform(0.5, 6.0, R)).astype(np.float32)
    t_row[:48] = np.inf
    prim = np.where(np.isinf(t_row), -1, rng.integers(0, 900, R)).astype(np.int32)
    time = rng.uniform(0.0, 1.0, R).astype(np.float32)
    rayF = np.stack([*o.T, *d.T, t_row, time]).astype(np.float32)

    tids = np.array([0, 1, 2, 3, 1, 0], np.int32)
    live = np.array([1, 1, 1, 1, 0, 1], np.int32)
    rid = np.full((CH, 128), -1, np.int32)
    for b in range(CH):
        pool = rng.permutation(np.arange(48, R))
        n = rng.integers(40, 81)
        rid[b, :n] = pool[:n]
    rid[0, 100:108] = np.arange(8)
    rid[1, 81:121] = np.arange(8, 48)
    rid[3, 81:121] = np.arange(8, 48)  # same rays, identical treelet: ties
    rid[4, 81:121] = np.arange(8, 48)  # the dead block must not count
    rid = np.stack([rng.permutation(r) for r in rid]).astype(np.int32)
    cbits = centers.view(np.int32)
    meta = np.zeros((CH, 8), np.int32)
    meta[:, 0] = tids
    meta[:, 1] = offset[tids]
    meta[:, 2:5] = cbits[tids]
    meta[:, 5] = live
    return featT, meta, rid, rayF, t_row, prim


@pytest.mark.parametrize("F", [16, 64])
def test_flush_plain_matches_fused_flush_interpret(F):
    featT, meta, rid, rayF, t_row, prim = _flush_inputs(F)
    tj, pj = fusedwave.fused_flush_chunk(
        jnp.asarray(featT), jnp.asarray(meta), jnp.asarray(rid), jnp.asarray(rayF),
        jnp.asarray(t_row), jnp.asarray(prim), interpret=True,
    )
    tj, pj = np.asarray(tj), np.asarray(pj)
    tt, pt = flush_chunk(*(torch.from_numpy(x) for x in (featT, meta, rid, rayF, t_row, prim)))
    tt, pt = tt.numpy(), pt.numpy()

    changed = (pj != prim) | (tj != t_row)
    assert changed.sum() > 30  # the test bites: many rays found new hits
    assert np.array_equal(np.isfinite(tj), np.isfinite(tt))
    assert _ulp_diff(tj, tt).max() <= 2
    # a prim flip is allowed only at a near-tie, and under 0.1% of rays
    flips = pj != pt
    with np.errstate(invalid="ignore"):
        near = np.abs(tj.astype(np.float64) - tt) <= 1e-6 * np.abs(tj.astype(np.float64))
    assert (near | ~flips).all()
    assert flips.sum() <= int(0.001 * len(prim))
    for p in (pj, pt):
        # the duplicated triangle resolves to its lowest local index ...
        assert (p[:8] == 2).sum() >= 4 and not (p == 5).any()
        # ... and the duplicated treelet to the earlier block (offset 64)
        tie = p[8:48]
        assert ((tie >= 64) & (tie < 128)).sum() >= 20
        assert not ((tie >= 700) & (tie < 764)).any()


def test_flush_wrapper_checks_inputs():
    featT, meta, rid, rayF, t_row, prim = _flush_inputs(16)
    args = [torch.from_numpy(x) for x in (featT, meta, rid, rayF, t_row, prim)]
    with pytest.raises(TypeError):
        flush_chunk(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        flush_chunk(args[0], args[1][:, :5].contiguous(), *args[2:])
    # the plain version is what a CPU tensor gets
    a = flush_chunk(*args)
    b = flush_chunk_plain(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _expand_inputs(seed: int = 9, S: int = 1500):
    rng = np.random.default_rng(seed)
    tris = (rng.uniform(-2, 2, (1500, 1, 3)) + rng.uniform(-0.25, 0.25, (1500, 3, 3)))
    tris = tris.astype(np.float32)
    bvh = tbuild.build_bvh(*tbuild.triangle_bounds(tris), method="sah")
    pk = build_treelet_pack_numpy(tris[bvh.prim_order], bvh, leaf_tris=16)
    N = pk["top_idx"].shape[0]
    R = 300
    tb = jstream._tn_bits(R)
    assert tb == tstream._tn_bits(R)
    o = rng.uniform(-4, 4, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:5, 0] = 0.0  # inv_d = inf on one axis: the 0 * inf NaN slab rule
    t = np.where(rng.uniform(size=R) < 0.6, np.inf, rng.uniform(0.1, 8.0, R)).astype(np.float32)
    with np.errstate(divide="ignore"):
        inv_d = (1.0 / d).astype(np.float32)
    rayE = np.stack([*o.T, *inv_d.T, t, np.zeros(R, np.float32)]).astype(np.float32)
    prim = np.where(rng.uniform(size=R) < 0.5, -1, rng.integers(0, 1500, R)).astype(np.int32)
    rid = rng.integers(0, R, S)
    comp = rng.integers(0, 1 << tb, S)
    key_in = ((1 << 30) + (rid << tb) + comp).astype(np.int32)
    key_in[rng.uniform(size=S) < 0.1] = I32_MAX
    node = rng.integers(0, N, S).astype(np.int32)
    node[key_in == I32_MAX] = 0
    boxT = np.concatenate([pk["top_bmin"], pk["top_bmax"]], axis=-1).transpose(2, 1, 0)
    cidT = np.ascontiguousarray(pk["top_idx"].T)
    return key_in, node, rayE, prim, boxT, cidT, tb


@pytest.mark.parametrize("use_onehot", [True, False])
@pytest.mark.parametrize("any_hit", [False, True])
def test_expand_plain_matches_fused_expand_interpret(use_onehot, any_hit):
    key_in, node, rayE, prim, boxT, cidT, tb = _expand_inputs()
    S, N = key_in.shape[0], boxT.shape[2]
    assert S % fusedwave.EXPAND_TILE
    if use_onehot:
        tab64 = np.asarray(jstream._node_table(jnp.asarray(boxT), jnp.asarray(cidT)))
        args_j = (jnp.asarray(tab64), None, None)
        # the port gathers from the same clamped table; codes reassembled
        box48 = tab64[:48]
        lo = np.rint(tab64[48:56]).astype(np.int64)
        hi = np.rint(tab64[56:64]).astype(np.int64)
        cid = ((hi << 16) | lo).astype(np.uint32).view(np.int32)
        assert np.array_equal(cid, cidT)
    else:
        box48 = np.ascontiguousarray(boxT.reshape(48, N))
        cid = cidT
        args_j = (None, jnp.asarray(box48), jnp.asarray(cidT))
    kj, cj, lj = fusedwave.fused_expand(
        jnp.asarray(key_in), jnp.asarray(node), jnp.asarray(rayE), jnp.asarray(prim),
        *args_j, tb=tb, use_onehot=use_onehot, any_hit=any_hit, interpret=True,
    )
    kj, cj, lj = np.asarray(kj), np.asarray(cj), np.asarray(lj)
    assert (kj[:, S:] == I32_MAX).all()  # the reference's pad lanes are dead
    kt, ct, lt = expand(
        *(torch.from_numpy(np.array(x)) for x in (key_in, node, rayE, prim, box48, cid)),
        tb, any_hit,
    )
    assert kt.shape == (8, S) and ct.shape == (8, S) and lt.shape == (S,)
    np.testing.assert_array_equal(kt.numpy(), kj[:, :S])
    np.testing.assert_array_equal(ct.numpy(), cj[:, :S])
    np.testing.assert_array_equal(lt.numpy(), lj[:S])
    # the test bites: leaves, interiors and culled pairs all occur
    k = kt.numpy()
    assert (k < (1 << 30)).any() and ((k >= (1 << 30)) & (k != I32_MAX)).any()
    assert 0 < lt.numpy().sum() < S


def test_expand_wrapper_uses_plain_on_cpu():
    key_in, node, rayE, prim, boxT, cidT, tb = _expand_inputs(S=700)
    box48 = np.ascontiguousarray(boxT.reshape(48, -1))
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in (key_in, node, rayE, prim,
                                                                box48, cidT)]
    a = expand(*args, tb, False)
    b = expand_plain(*args, tb, False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(TypeError):
        expand(args[0].long(), *args[1:], tb, False)
    with pytest.raises(ValueError):
        expand(*args, 31, False)  # the key's shift would be undefined
