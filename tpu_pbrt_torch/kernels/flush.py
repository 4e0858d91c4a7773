"""FLUSH chunk: leaf-block triangle tests + per-ray closest-hit merge.

`flush_chunk` is the port of tpu_pbrt/accel/fusedwave.py::fused_flush_chunk:
for CH leaf blocks (one treelet x 128 ray slots each) it folds every
slot's closest triangle hit into the (R,) winners (t_row, prim). On CUDA
tensors it launches csrc/flush.cu; on CPU tensors it runs
`flush_chunk_plain`, the reference's jnp flush body (accel/stream.py
chunk_body + _merge_chunk) ported op for op onto the same interface.

Interface (the reference kernel's):
  feat_table (C, F, 4L) f32, F in {16, 64}; meta (CH, 8) i32 rows
  [treelet id, prim offset, center xyz as f32 bits, block live flag, 0, 0];
  rid_rows (CH, 128) i32 ray ids, -1 = empty slot; rayF (8, R) f32
  lane-major [o | d | t | time]; t_row (R,) f32 and prim (R,) i32 the
  current winners. Returns the updated (t_row, prim) as new tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from tpu_pbrt_torch.accel.mxu import EDGE_EPS, decode_outputs
from tpu_pbrt_torch.kernels import LAUNCHES

BLOCK = 128

_NEG_EDGE = float(np.float32(-EDGE_EPS))
_ONE_EDGE = float(np.float32(1.0 + EDGE_EPS))


def _check(feat_table, meta, rid_rows, rayF, t_row, prim):
    dev = rayF.device
    for name, x, dt, nd in (
        ("feat_table", feat_table, torch.float32, 3),
        ("meta", meta, torch.int32, 2),
        ("rid_rows", rid_rows, torch.int32, 2),
        ("rayF", rayF, torch.float32, 2),
        ("t_row", t_row, torch.float32, 1),
        ("prim", prim, torch.int32, 1),
    ):
        if x.dtype != dt or x.dim() != nd:
            raise TypeError(f"flush_chunk: {name} must be {nd}-D {dt}, got {x.dim()}-D {x.dtype}")
        if x.device != dev:
            raise ValueError(f"flush_chunk: {name} is on {x.device}, rayF on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"flush_chunk: {name} must be contiguous")
    _, F, four_l = feat_table.shape
    R = rayF.shape[1]
    if F not in (16, 64) or four_l % 4:
        raise ValueError(f"flush_chunk: feat_table must be (C, 16|64, 4L), got {tuple(feat_table.shape)}")
    if meta.shape[1] != 8 or rid_rows.shape != (meta.shape[0], BLOCK):
        raise ValueError("flush_chunk: meta must be (CH, 8) and rid_rows (CH, 128)")
    if rayF.shape[0] != 8 or t_row.shape != (R,) or prim.shape != (R,):
        raise ValueError("flush_chunk: rayF must be (8, R) with t_row, prim (R,)")
    CH = meta.shape[0]
    if dev.type == "cuda" and (four_l % 16 or CH * (four_l // 4) >= 2**32 - 1):
        raise ValueError(f"flush_chunk: the CUDA kernel needs L = {four_l // 4} a multiple of 4 "
                         f"(16-byte rows) and CH * L < 2^32 - 1 (CH = {CH})")


def flush_chunk(feat_table, meta, rid_rows, rayF, t_row, prim):
    """Fold one chunk of leaf blocks into the per-ray best (t, prim)."""
    _check(feat_table, meta, rid_rows, rayF, t_row, prim)
    if rayF.device.type == "cpu":
        return flush_chunk_plain(feat_table, meta, rid_rows, rayF, t_row, prim)
    if rayF.device.type != "cuda":
        raise ValueError(f"flush_chunk: unsupported device {rayF.device}")
    CH = meta.shape[0]
    _, F, four_l = feat_table.shape
    from tpu_pbrt_torch.kernels.build import check, load

    lib = load("flush")
    fn = lib.flush_chunk_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
    ]
    R = rayF.shape[1]
    t_out = torch.empty_like(t_row)
    p_out = torch.empty_like(prim)
    keys = torch.empty((R,), dtype=torch.int64, device=rayF.device)
    with torch.cuda.device(rayF.device):
        stream = torch.cuda.current_stream(rayF.device).cuda_stream
        err = fn(
            feat_table.data_ptr(), meta.data_ptr(), rid_rows.data_ptr(),
            rayF.data_ptr(), t_row.data_ptr(), prim.data_ptr(),
            t_out.data_ptr(), p_out.data_ptr(), keys.data_ptr(),
            CH, F, four_l // 4, R, _NEG_EDGE, _ONE_EDGE, stream,
        )
    if err:
        lib.flush_error_string.restype = ctypes.c_char_p
        lib.flush_error_string.argtypes = [ctypes.c_int]
        check(err, f"flush_chunk ({lib.flush_error_string(err).decode()})")
    LAUNCHES["flush_chunk"] += 1
    return t_out, p_out


def flush_chunk_plain(feat_table, meta, rid_rows, rayF, t_row, prim):
    """The reference's jnp flush body (stream.py chunk_body + _merge_chunk)
    on the kernel's interface: gather + re-center + phi build, one batched
    f32 product, decode with the t < t_row pre-cull, sort-based merge."""
    CH = meta.shape[0]
    _, F, four_l = feat_table.shape
    L = four_l // 4
    R = rayF.shape[1]
    tids = meta[:, 0].long()
    off = meta[:, 1]
    ctr = meta[:, 2:5].contiguous().view(torch.float32)  # (CH, 3)
    has_ray = (rid_rows >= 0) & (meta[:, 5] > 0)[:, None]
    rid = torch.where(has_ray, rid_rows, torch.zeros_like(rid_rows)).clamp(0, R - 1)
    rr = rayF[:, rid.reshape(-1)]  # (8, CH*BLOCK)
    rrows = rr.reshape(8, CH, BLOCK).transpose(0, 1)  # (CH, 8, BLOCK)
    # dead slots: t < -inf fails every candidate
    t_b = torch.where(has_ray, t_row[rid], torch.full_like(t_row[rid], -float("inf")))
    oc = [rrows[:, i] - ctr[:, i][:, None] for i in range(3)]
    dc = [rrows[:, 3 + i] for i in range(3)]
    phiT = torch.stack(
        [oc[i] * dc[j] for i in range(3) for j in range(3)]
        + dc + oc + [torch.ones_like(oc[0])],
        dim=1,
    )  # (CH, 16, BLOCK)
    if F == 64:
        tm = rrows[:, 7]
        phiT = torch.cat(
            [phiT, phiT * tm[:, None, :], phiT * (tm * tm)[:, None, :],
             phiT * (tm * tm * tm)[:, None, :]],
            dim=1,
        )  # (CH, 64, BLOCK)
    featT = feat_table[tids]  # (CH, F, 4L)
    out = torch.einsum("cfb,cfk->cbk", phiT, featT)
    t_loc, k_loc, _, _ = decode_outputs(out, L, t_b)
    won = has_ray & torch.isfinite(t_loc)
    return merge_chunk(t_row, prim, rid, t_loc, k_loc, off, won, R)


def merge_chunk(t_row, prim, rid, t_loc, k_loc, off, won, R):
    """Port of stream.py::_merge_chunk: stable-sort the chunk's candidates
    on (ray, t bits) — positive f32 bits order like the values — and
    scatter each ray run's head (its argmin) when it beats the stored t.
    Stability keeps the earliest block among equal (ray, t), as the
    reference's sequential strict-< merge does. Index R is the drop slot."""
    prim_cand = (off[:, None] + k_loc.to(torch.int32)).reshape(-1)
    key_ray = torch.where(won, rid, torch.full_like(rid, R)).reshape(-1).long()
    key_t = torch.where(won, t_loc, torch.full_like(t_loc, float("inf")))
    key_t = key_t.contiguous().view(torch.int32).reshape(-1).long()
    # lexicographic (ray, signed t bits) as one int64 key
    order = torch.sort((key_ray << 32) + (key_t + (1 << 31)), stable=True).indices
    r_s = key_ray[order]
    t_s = key_t[order].to(torch.int32).view(torch.float32)
    p_s = prim_cand[order]
    head = torch.ones_like(r_s, dtype=torch.bool)
    head[1:] = r_s[1:] != r_s[:-1]
    head &= r_s < R
    old = t_row[r_s.clamp(0, R - 1)]
    win = head & (t_s < old)
    t_ext = torch.cat([t_row, t_row.new_full((1,), float("inf"))])
    t_ext.scatter_reduce_(0, torch.where(head, r_s, R), t_s, "amin", include_self=True)
    p_ext = torch.cat([prim, prim.new_zeros((1,))])
    p_ext[torch.where(win, r_s, R)] = p_s
    return t_ext[:R], p_ext[:R]
