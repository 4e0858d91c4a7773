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
from tpu_pbrt_torch.accel.treelet import build_treelet_pack_numpy
from tpu_pbrt_torch.accel import build as tbuild
from tpu_pbrt_torch.kernels.expand import expand, expand_plain
from tpu_pbrt_torch.kernels.fixtures import flush_inputs
from tpu_pbrt_torch.kernels.flush import flush_chunk, flush_chunk_plain

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

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


# L = 512 is the main path's treelet size: the duplicated triangles 2 and
# L-3 then lie in different warps' (and thread blocks') triangle ranges
@pytest.mark.parametrize("F,L", [
    pytest.param(16, 64, id="16"), pytest.param(64, 64, id="64"),
    pytest.param(16, 512, id="16-L512"), pytest.param(64, 512, id="64-L512"),
])
def test_flush_plain_matches_fused_flush_interpret(F, L):
    featT, meta, rid, rayF, t_row, prim = flush_inputs(F, L)
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
        assert (p[:8] == 2).sum() >= 4 and not (p == L - 3).any()
        # ... and the duplicated treelet to the earlier block (offset L)
        tie = p[8:48]
        assert ((tie >= L) & (tie < 2 * L)).sum() >= 20
        assert not ((tie >= 11 * L) & (tie < 12 * L)).any()


def test_flush_wrapper_checks_inputs():
    featT, meta, rid, rayF, t_row, prim = flush_inputs(16)
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
