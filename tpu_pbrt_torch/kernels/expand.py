"""EXPAND: child slab tests + packed push keys for a popped stack slab.

`expand` is the port of tpu_pbrt/accel/fusedwave.py::fused_expand. On CUDA
tensors it launches csrc/expand.cu; on CPU tensors it runs `expand_plain`,
the reference's jnp expansion middle (accel/stream.py::_expand with
_fetch_children) ported op for op, the node fetch as a plain gather.

Interface: key_in, node (S,) i32 popped packed keys and node ids (invalid
lanes masked to INT32_MAX / 0 by the caller); rayE (8, R) f32 lane-major
[o | inv_d | t | pad]; prim (R,) i32 current hits (read in any-hit mode);
box48 (48, N) f32 child boxes, row = component * 8 + child (components
bmin xyz, bmax xyz) and cid (8, N) i32 child codes; tb the key's
entry-distance bits. Returns key8 (8, S) i32, cand8 (8, S) i32 and
live (S,) i32 — exactly S lanes, no padding.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_pbrt_torch.accel.treelet import decode_top_leaf
from tpu_pbrt_torch.accel.wide import _BOX_EPS, _EMPTY, slab_test_lane_major
from tpu_pbrt_torch.kernels import LAUNCHES, kernel_call

I32_MAX = 2**31 - 1
_BOX_EPS_F32 = float(np.float32(_BOX_EPS))


def _check(key_in, node, rayE, prim, box48, cid):
    dev = rayE.device
    for name, x, dt, nd in (
        ("key_in", key_in, torch.int32, 1),
        ("node", node, torch.int32, 1),
        ("rayE", rayE, torch.float32, 2),
        ("prim", prim, torch.int32, 1),
        ("box48", box48, torch.float32, 2),
        ("cid", cid, torch.int32, 2),
    ):
        if x.dtype != dt or x.dim() != nd:
            raise TypeError(f"expand: {name} must be {nd}-D {dt}, got {x.dim()}-D {x.dtype}")
        if x.device != dev:
            raise ValueError(f"expand: {name} is on {x.device}, rayE on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"expand: {name} must be contiguous")
    R = rayE.shape[1]
    N = box48.shape[1]
    if rayE.shape[0] != 8 or prim.shape != (R,):
        raise ValueError("expand: rayE must be (8, R) and prim (R,)")
    if box48.shape[0] != 48 or cid.shape != (8, N):
        raise ValueError("expand: box48 must be (48, N) and cid (8, N)")
    if node.shape != key_in.shape:
        raise ValueError("expand: key_in and node must have the same shape")


def expand_work(key_in, node, rayE, prim, box48, cid, tb: int, any_hit: bool):
    """(FP32 operations, bytes) of one expand step, for the bound of
    chip_smoke.py and the charge of the cost model (analysis/cost.py): the
    popped pairs, their ray rows (and current hits in any-hit mode), the
    node table once, the (8, S) x 2 + (S,) outputs; the slab tests, 3 axes
    x (2 sub, 3 mul, 2 select/min) per child."""
    S, N = key_in.shape[0], box48.shape[1]
    nbytes = S * 8 + S * 7 * 4 + (S * 4 if any_hit else 0) + 56 * N * 4 + S * 17 * 4
    return S * 8 * 24.0, float(nbytes)


def expand(key_in, node, rayE, prim, box48, cid, tb: int, any_hit: bool):
    """Child candidates of a popped stack slab (see module doc)."""
    _check(key_in, node, rayE, prim, box48, cid)
    if not 0 <= int(tb) <= 28:
        raise ValueError(f"expand: tb must be in [0, 28] (the key's entry-distance bits), got {tb}")
    args = (key_in, node, rayE, prim, box48, cid, tb, any_hit)
    with kernel_call("expand", args):
        if rayE.device.type == "cpu":
            return expand_plain(*args)
        return _launch(*args)


def _launch(key_in, node, rayE, prim, box48, cid, tb: int, any_hit: bool):
    if rayE.device.type != "cuda":
        raise ValueError(f"expand: unsupported device {rayE.device}")
    from tpu_pbrt_torch.kernels.build import check, load

    lib = load("expand")
    fn = lib.expand_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    S = key_in.shape[0]
    key8 = torch.empty((8, S), dtype=torch.int32, device=rayE.device)
    cand8 = torch.empty((8, S), dtype=torch.int32, device=rayE.device)
    live = torch.empty((S,), dtype=torch.int32, device=rayE.device)
    with torch.cuda.device(rayE.device):
        stream = torch.cuda.current_stream(rayE.device).cuda_stream
        err = fn(
            key_in.data_ptr(), node.data_ptr(), rayE.data_ptr(), prim.data_ptr(),
            box48.data_ptr(), cid.data_ptr(), key8.data_ptr(), cand8.data_ptr(),
            live.data_ptr(), S, rayE.shape[1], box48.shape[1], int(tb),
            int(bool(any_hit)), _BOX_EPS_F32, stream,
        )
    if err:
        lib.expand_error_string.restype = ctypes.c_char_p
        lib.expand_error_string.argtypes = [ctypes.c_int]
        check(err, f"expand ({lib.expand_error_string(err).decode()})")
    LAUNCHES["expand"] += 1
    return key8, cand8, live


def expand_plain(key_in, node, rayE, prim, box48, cid, tb: int, any_hit: bool):
    """The reference's jnp expansion middle, op for op."""
    S = key_in.shape[0]
    R = rayE.shape[1]
    N = box48.shape[1]
    # stack entries are interiors: ray id at key bits [tb, tb+rb); the low
    # tb bits hold the complemented quantized entry distance, rebuilt here
    # with the mantissa tail zero-filled (a conservative underestimate)
    rid = ((key_in - (1 << 30)) >> tb).clamp(0, R - 1)
    if tb:
        comp = (key_in - (1 << 30)) & ((1 << tb) - 1)
        tn_in = (((1 << tb) - 1 - comp) << (31 - tb)).view(torch.float32)
    else:
        tn_in = torch.zeros(key_in.shape, dtype=torch.float32, device=key_in.device)
    valid = key_in != I32_MAX
    tn_in = torch.where(valid, tn_in, torch.full_like(tn_in, float("inf")))
    rows = rayE[:, rid.long()]  # (8, S)
    t_r = rows[6]
    live = valid & (tn_in <= t_r)
    if any_hit:
        live = live & (prim[rid.long()] < 0)

    nd = node.clamp(0, N - 1).long()
    nb = box48[:, nd].reshape(6, 8, S)
    cids = cid[:, nd]  # (8, S)
    ray6 = rows[0:6]
    tx0, tx1 = slab_test_lane_major(nb[0], nb[3], ray6[0][None, :], ray6[3][None, :])
    ty0, ty1 = slab_test_lane_major(nb[1], nb[4], ray6[1][None, :], ray6[4][None, :])
    tz0, tz1 = slab_test_lane_major(nb[2], nb[5], ray6[2][None, :], ray6[5][None, :])
    tn8 = torch.maximum(torch.maximum(tx0, ty0), torch.maximum(tz0, torch.zeros_like(tz0)))
    tf8 = torch.minimum(
        torch.minimum(tx1, ty1), torch.minimum(tz1, t_r[None, :].expand_as(tz1))
    )
    in_slab = tn8 <= tf8
    hit8 = live[None, :] & in_slab & (cids != int(_EMPTY))
    is_int = hit8 & (cids >= 0)
    is_leaf = hit8 & (cids < 0)
    rid8 = rid[None, :].expand(8, S)
    if tb:
        # logical shift of the f32 bits (torch's int32 >> is arithmetic)
        qtn = ((tn8.view(torch.int32).long() & 0xFFFFFFFF) >> (31 - tb)).to(torch.int32)
    else:
        qtn = torch.zeros_like(rid8)
    key_int = (1 << 30) + (rid8 << tb) + (((1 << tb) - 1) - qtn)
    key8 = torch.where(
        is_leaf, rid8, torch.where(is_int, key_int, torch.full_like(key_int, I32_MAX))
    )
    cand8 = torch.where(is_leaf, decode_top_leaf(cids), cids)
    return key8.contiguous(), cand8.contiguous(), live.to(torch.int32)
