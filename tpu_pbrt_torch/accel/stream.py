"""Stream (sort/compaction wavefront) BVH traversal — port of tpu_pbrt/accel/stream.py.

Same algorithm, same packed keys, same worklist sizes, so every wave
takes the reference's steps: traversal state is one flat LIFO worklist
of (ray, node, t_entry) pairs shared by the whole wave. EXPAND pops a
slab of pairs, culls those whose entry distance exceeds their ray's
current hit, slab-tests each pair's 8 child boxes and compacts the 8S
candidates with ONE stable int32 sort of the packed key

    leaf:     ray                                  (sorts first)
    interior: 2^30 + (ray << TN_BITS) + ~quant(t_entry)
    dead:     INT32_MAX

so leaves append to the leaf buffer and interiors are pushed grouped by
ray, each ray's nearest children on top. FLUSH runs when the leaf buffer
is nearly full (or the stack empties): it sorts the buffered (treelet,
ray) pairs into 128-ray blocks per treelet and folds each block's
closest triangle hits into the per-ray winners.

The two dense middles are the port's hand-written kernels, called at the
reference's two seams: `_expand` calls kernels.expand (fused_expand's
seam, stream.py:327-329), `_flush` calls kernels.flush_chunk once per
chunk of blocks (fused_flush_chunk's seam, stream.py:598-622). On CPU
tensors they run their plain versions. The reference's lax.while_loops
(the traversal loop and the flush's chunk loop) are Python loops whose
exit tests read a few scalars back to the host — one sync per traversal
iteration and one per flush; `stream_traverse_stats` reports the
iteration count of a wave.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_pbrt_torch.accel.traverse import Hit
from tpu_pbrt_torch.accel.treelet import TreeletPack
from tpu_pbrt_torch.config import cfg
from tpu_pbrt_torch.core.xla_math import fmac
from tpu_pbrt_torch.kernels.expand import expand
from tpu_pbrt_torch.kernels.flush import flush_chunk

#: triangles per treelet for the stream path (feature row = 4*this columns)
STREAM_LEAF_TRIS = 512
#: rays per leaf block
BLOCK = 128
#: leaf blocks processed per flush chunk (bounds the plain version's
#: transient (CHUNK, BLOCK, 4L) product)
CHUNK = 512
#: safety bound on traversal iterations (real waves take tens to hundreds)
_MAX_ITERS = 1 << 16
#: node tables up to this size are clamped to +-3e38 exactly as the
#: reference's one-hot-matmul table is, so culling is bit-identical
_ONEHOT_MAX_NODES = 512

_I32_MAX = 2**31 - 1



class WaveTally:
    """Host-side counts over the waves traced since the last `reset()`:
    waves, loop iterations (expand steps + flushes), the largest
    iteration count of one wave, the traversal's host reads (the loop's
    counter reads and each flush's block count) and the integrator
    loop's own host reads (one per bounce or pool wave, `add_loop_read`).
    `drops` sums the waves' n_drop (pairs lost to worklist capacity) on
    the device, so counting them costs no host read. `by_mode` splits
    waves, iterations, host reads and kernel-wrapper calls (expand,
    flush_chunk) between closest-hit and any-hit (shadow) waves, whose
    loops end differently. The render loop resets and reads it."""

    __slots__ = ("waves", "iters", "iters_max", "host_reads", "loop_reads", "drops", "by_mode")

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.waves = self.iters = self.iters_max = self.host_reads = self.loop_reads = 0
        self.drops = 0
        self.by_mode = {}

    def add(self, iters: int, host_reads: int, n_drop=0, any_hit: bool = False,
            expand_calls: int = 0, flush_calls: int = 0) -> None:
        self.waves += 1
        self.iters += iters
        self.iters_max = max(self.iters_max, iters)
        self.host_reads += host_reads
        self.drops = self.drops + n_drop
        m = self.by_mode.setdefault("any_hit" if any_hit else "closest_hit", {
            "waves": 0, "iters": 0, "host_reads": 0, "expand_calls": 0, "flush_calls": 0})
        m["waves"] += 1
        m["iters"] += iters
        m["host_reads"] += host_reads
        m["expand_calls"] += expand_calls
        m["flush_calls"] += flush_calls

    def mode_stats(self) -> dict:
        """Per-mode totals with their per-wave means."""
        out = {}
        for mode, m in self.by_mode.items():
            w = max(m["waves"], 1)
            out[mode] = dict(m, iters_per_wave_mean=m["iters"] / w,
                             host_reads_per_wave_mean=m["host_reads"] / w,
                             expand_calls_per_wave_mean=m["expand_calls"] / w,
                             flush_calls_per_wave_mean=m["flush_calls"] / w)
        return out

    def add_loop_read(self) -> None:
        self.loop_reads += 1


#: the process's wave tally (counts only: constant size however many waves)
WAVES = WaveTally()


class _SState(NamedTuple):
    # lane-major per-ray tables: rayE for EXPAND [o(0:3) inv_d(3:6) t(6) pad],
    # rayF for FLUSH [o(0:3) d(3:6) t(6) time(7)]; row 6 (the ray's current
    # closest hit) is kept identical in both
    rayE: torch.Tensor  # (8, R) f32
    rayF: torch.Tensor  # (8, R) f32
    prim: torch.Tensor  # (R,) i32 global leaf-order triangle id, -1 miss
    stk_key: torch.Tensor  # (W + headroom,) i32 packed (2^30 | ray<<TN | ~qtn)
    stk_code: torch.Tensor  # (W + headroom,) i32 top-tree node id
    n_stk: torch.Tensor  # i32
    lf_ray: torch.Tensor  # (LB + headroom,) i32 ray ids
    lf_tid: torch.Tensor  # (LB + headroom,) i32 treelet ids
    n_lf: torch.Tensor  # i32
    n_drop: torch.Tensor  # i32 pairs lost to capacity (tests assert 0)
    n_exp: torch.Tensor  # i32 stat: pairs expanded
    n_tl: torch.Tensor  # i32 stat: (ray, treelet) block-slot tests
    iters: int  # loop iterations (host count)
    flush_calls: int  # flush_chunk calls (host count)


def _sizes(R: int):
    """Worklist sizes for a wave of R rays (the reference's formula)."""
    cap = int(cfg.slab)
    slab = int(min(max(R // 4, 4096), cap))
    head = float(cfg.headroom)
    w = R + max(int(24 * slab * head), slab // 2)
    lb = max(int(12 * slab * head), 9 * slab)
    return slab, w, lb


def flush_geometry(R: int, n_treelets: int) -> dict:
    """Flush-phase shape for a wave of R rays: worklist sizes and the
    per-flush block capacity (the reference's flush_geometry)."""
    slab, w, lb = _sizes(R)
    b_cap = lb // BLOCK + n_treelets + 2
    return {"slab": slab, "worklist": w, "leaf_buffer": lb,
            "blocks_per_flush": b_cap, "chunk": min(CHUNK, b_cap)}


def _ray_bits(R: int) -> int:
    rb = max(1, int(np.ceil(np.log2(max(R, 2)))))
    if rb > 29:
        raise ValueError(
            f"stream tracer waves are capped at 2^29 rays (got {R}); "
            "chunk the wave at the integrator level"
        )
    return rb


def _tn_bits(R: int) -> int:
    # interior keys live in [2^30, 2^30 + 2^(rb+tn)), below INT32_MAX
    return max(0, min(12, 29 - _ray_bits(R)))


def node_tables(tp: TreeletPack):
    """(box48 (48, N) f32, cid (8, N) i32) of the top tree: rows are
    component-major over the (6, 8, N) child boxes. Tables of at most
    _ONEHOT_MAX_NODES nodes are clamped to +-3e38 like the reference's
    one-hot table (inf * 0.0 would poison a one-hot sum there)."""
    boxT = torch.cat([tp.top.child_bmin, tp.top.child_bmax], dim=-1).permute(2, 1, 0)
    N = boxT.shape[2]
    box48 = boxT.reshape(48, N)
    if N <= _ONEHOT_MAX_NODES:
        box48 = box48.clamp(-3e38, 3e38)
    cid = tp.top.child_idx.T
    return box48.contiguous(), cid.contiguous()


def _write(buf, start: int, vals):
    """dynamic_update_slice with the reference's start clamp."""
    start = min(max(start, 0), buf.shape[0] - vals.shape[0])
    buf[start:start + vals.shape[0]] = vals


def _expand(tp: TreeletPack, box48, cid, s: _SState, n_stk: int, n_lf: int,
            slab: int, w: int, lb: int, any_hit: bool) -> _SState:
    R = s.rayE.shape[1]
    tb = _tn_bits(R)
    dev = s.rayE.device
    start = max(n_stk - slab, 0)
    k = torch.arange(slab, dtype=torch.int32, device=dev)
    valid = k < (n_stk - start)
    key_in = torch.where(valid, s.stk_key[start:start + slab],
                         torch.full_like(k, _I32_MAX)).contiguous()
    node = torch.where(valid, s.stk_code[start:start + slab],
                       torch.zeros_like(k)).contiguous()
    key8, cand8, live = expand(key_in, node, s.rayE, s.prim, box48, cid, tb, any_hit)
    key = key8.reshape(-1)
    cand = cand8.reshape(-1)
    n_leaf = (key < (1 << 30)).sum(dtype=torch.int32)
    n_int = ((key >= (1 << 30)) & (key != _I32_MAX)).sum(dtype=torch.int32)
    key_s, perm = torch.sort(key, stable=True)
    code_s = cand[perm]
    return _expand_push(s, key_s, code_s, n_leaf, n_int, live, start, n_lf, w, lb, 8 * slab)


def _expand_push(s: _SState, key_s, code_s, n_leaf, n_int, live, start: int,
                 n_lf: int, w: int, lb: int, s8: int) -> _SState:
    """Append the sorted leaf prefix to the leaf buffer, push the interior
    span onto the stack, roll the counters."""
    lf_ray, lf_tid = s.lf_ray, s.lf_tid
    _write(lf_ray, n_lf, key_s)
    _write(lf_tid, n_lf, code_s)
    n_lf_new = s.n_lf + n_leaf
    dropped = torch.clamp(n_lf_new - lb, min=0)
    n_lf_new = torch.clamp(n_lf_new, max=lb)

    # the interior span [n_leaf, n_leaf + n_int) of the (padded) sorted
    # arrays, sliced at the device-side offset n_leaf by a gather
    idx = n_leaf + torch.arange(s8, dtype=torch.int32, device=key_s.device)
    pad = torch.full((s8,), _I32_MAX, dtype=torch.int32, device=key_s.device)
    int_key = torch.cat([key_s, pad])[idx.long()]
    int_code = torch.cat([code_s, pad])[idx.long()]
    stk_key, stk_code = s.stk_key, s.stk_code
    _write(stk_key, start, int_key)
    _write(stk_code, start, int_code)
    n_stk_new = start + n_int
    dropped = dropped + torch.clamp(n_stk_new - w, min=0)
    n_stk_new = torch.clamp(n_stk_new, max=w)

    return s._replace(
        stk_key=stk_key, stk_code=stk_code, n_stk=n_stk_new,
        lf_ray=lf_ray, lf_tid=lf_tid, n_lf=n_lf_new,
        n_drop=s.n_drop + dropped,
        n_exp=s.n_exp + live.sum(dtype=torch.int32),
        iters=s.iters + 1,
    )


def _slice_rows(a, starts, width: int):
    """(CH,) starts -> (CH, width) contiguous slices of 1-D a, the start
    clamped into [0, len - width] (the reference's CLIP gather)."""
    st = starts.long().clamp(0, a.shape[0] - width)
    return a[st[:, None] + torch.arange(width, device=a.device)[None, :]]


def _flush(tp: TreeletPack, s: _SState, lb: int, any_hit: bool) -> _SState:
    R = s.rayE.shape[1]
    rb = _ray_bits(R)
    C = tp.n_treelets
    dev = s.rayE.device
    lb_v = min(lb, s.lf_tid.shape[0])
    b_cap = lb_v // BLOCK + C + 2
    chunk = min(CHUNK, b_cap)
    packed_key = C < (1 << max(31 - rb, 0))

    idx = torch.arange(lb_v, dtype=torch.int32, device=dev)
    ray_c = s.lf_ray[:lb_v].clamp(0, R - 1)
    live = (idx < s.n_lf) & (s.lf_tid[:lb_v] >= 0)
    if any_hit:
        # shadow waves drop pairs whose ray already has its answer
        live = live & (s.prim[ray_c.long()] < 0)
    if packed_key:
        key = torch.where(live, (s.lf_tid[:lb_v] << rb) + ray_c,
                          torch.full_like(ray_c, C << rb))
        key_s = torch.sort(key).values
        tid_s = key_s >> rb
        rid_s = key_s & ((1 << rb) - 1)
    else:
        key = torch.where(live, s.lf_tid[:lb_v], torch.full_like(ray_c, C))
        tid_s, perm = torch.sort(key, stable=True)
        rid_s = ray_c[perm]
    valid_s = tid_s < C
    prev = torch.cat([torch.full((1,), -1, dtype=tid_s.dtype, device=dev), tid_s[:-1]])
    newrun = valid_s & (tid_s != prev)
    # block breaks at run starts OR 128-aligned positions: every block
    # stays within one treelet run and spans at most BLOCK pairs
    brk = newrun | (valid_s & (idx % BLOCK == 0))
    blk_of = torch.cumsum(brk.to(torch.int32), 0, dtype=torch.int32) - 1
    n_blocks_t = torch.where(valid_s, blk_of, torch.full_like(blk_of, -1)).max() + 1
    # block b starts at the position of the b-th set bit of brk
    start_sorted = torch.sort(torch.where(brk, idx, torch.full_like(idx, _I32_MAX))).values
    block_start = start_sorted[:b_cap]
    n_blocks = int(n_blocks_t)  # host sync: the chunk loop's bound

    offset = tp.offset
    center_bits = tp.center.contiguous().view(torch.int32)  # (C, 3)
    t_row = s.rayF[6].clone()
    prim = s.prim
    n_tl = s.n_tl
    ar = torch.arange(chunk, dtype=torch.int32, device=dev)
    for cstart in range(0, n_blocks, chunk):
        # the host knows n_blocks, so the last chunk holds only live blocks
        # (the reference pads it with dead ones, which change nothing)
        bids = cstart + ar[:min(chunk, n_blocks - cstart)]
        starts = block_start[torch.clamp(bids, max=b_cap - 1).long()]
        starts_w = torch.clamp(starts, max=lb_v - BLOCK)
        blk_row = _slice_rows(blk_of, starts_w, BLOCK)
        rid_row = _slice_rows(rid_s, starts_w, BLOCK)
        in_blk = blk_row == bids[:, None]
        rows = torch.where(in_blk, rid_row, torch.full_like(rid_row, -1)).contiguous()
        tids = torch.where(
            bids < n_blocks_t, tid_s[torch.clamp(starts, max=lb_v - 1).long()],
            torch.zeros_like(bids),
        ).clamp(0, C - 1).long()
        meta = torch.stack(
            [
                tids.to(torch.int32),
                offset[tids],
                center_bits[tids, 0],
                center_bits[tids, 1],
                center_bits[tids, 2],
                (bids < n_blocks_t).to(torch.int32),
                torch.zeros_like(bids),
                torch.zeros_like(bids),
            ],
            dim=1,
        ).contiguous()  # (CH, 8) per-block scalars for the kernel
        t_row, prim = flush_chunk(tp.featT, meta, rows, s.rayF, t_row, prim)
        n_tl = n_tl + (rows >= 0).sum(dtype=torch.int32)
    # the winner t row goes back into BOTH ray tables once per flush
    rayE, rayF = s.rayE, s.rayF
    rayE[6] = t_row
    rayF[6] = t_row
    return s._replace(
        rayE=rayE, rayF=rayF, prim=prim,
        n_lf=torch.zeros_like(s.n_lf), n_tl=n_tl, iters=s.iters + 1,
        flush_calls=s.flush_calls + -(-n_blocks // chunk),
    )


def _traverse(tp: TreeletPack, o, d, t_max, any_hit: bool, time=None) -> _SState:
    R = o.shape[0]
    dev = o.device
    tb = _tn_bits(R)
    slab, w, lb = _sizes(R)
    s8 = 8 * slab
    box48, cid = node_tables(tp)

    inv_d = 1.0 / d
    t_max = t_max.to(torch.float32)
    # row 7: rayE's pad and rayF's per-ray shutter time, which a motion
    # pack's (F = 64) features take in powers (0 without a time)
    zrow = torch.zeros((1, R), dtype=torch.float32, device=dev)
    trow = zrow if time is None else torch.broadcast_to(
        torch.as_tensor(time, dtype=torch.float32, device=dev), (R,))[None, :]
    rayE = torch.cat([o.T, inv_d.T, t_max[None, :], zrow], dim=0).contiguous()
    rayF = torch.cat([o.T, d.T, t_max[None, :], trow], dim=0).contiguous()
    alive0 = t_max > 0.0
    rid0 = torch.arange(R, dtype=torch.int32, device=dev)
    # seed: one root pair per LIVE ray (tn = 0 -> complement = max); dead
    # lanes sort to the back and are excluded from n_stk
    key0 = torch.where(alive0, (1 << 30) + (rid0 << tb) + ((1 << tb) - 1),
                       torch.full_like(rid0, _I32_MAX))
    key0_s = torch.sort(key0).values
    stk_key = torch.full((w + s8,), _I32_MAX, dtype=torch.int32, device=dev)
    stk_key[:R] = key0_s
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    s = _SState(
        rayE=rayE,
        rayF=rayF,
        prim=torch.full((R,), -1, dtype=torch.int32, device=dev),
        stk_key=stk_key,
        stk_code=torch.zeros((w + s8,), dtype=torch.int32, device=dev),
        n_stk=alive0.sum(dtype=torch.int32),
        lf_ray=torch.zeros((lb + s8,), dtype=torch.int32, device=dev),
        lf_tid=torch.full((lb + s8,), -1, dtype=torch.int32, device=dev),
        n_lf=zero,
        n_drop=zero, n_exp=zero, n_tl=zero,
        iters=0, flush_calls=0,
    )
    dead = t_max <= 0.0
    reads = expands = 0
    while s.iters < _MAX_ITERS:
        # the loop test: one host read of the worklist counters per
        # iteration (plus, for shadow waves, whether every live ray is done)
        if any_hit:
            done = ((s.prim >= 0) | dead).all().to(torch.int32)
            n_stk, n_lf, all_done = torch.stack([s.n_stk, s.n_lf, done]).tolist()
            if all_done:
                break
        else:
            n_stk, n_lf = torch.stack([s.n_stk, s.n_lf]).tolist()
        reads += 1
        if n_stk == 0 and n_lf == 0:
            break
        if n_lf > lb - s8 or n_stk == 0:
            s = _flush(tp, s, lb, any_hit)
            reads += 1  # the flush's block count
        else:
            s = _expand(tp, box48, cid, s, n_stk, n_lf, slab, w, lb, any_hit)
            expands += 1
    WAVES.add(s.iters, reads, s.n_drop, any_hit=any_hit, expand_calls=expands,
              flush_calls=s.flush_calls)
    return s


def _finalize_hits(tri_verts, o, d, t_raw, prim, time=None, tri_verts1=None, tv9T=None,
                   tv9T1=None) -> Hit:
    """(t, prim) -> full Hit: one vertex-row fetch per ray recovers the
    winner's barycentrics; the vertices ride along in Hit.tv. A motion
    scene (tri_verts1 and a time) lerps the two keyframes at each ray's
    time."""
    hit = prim >= 0
    t = torch.where(hit, t_raw, torch.full_like(t_raw, float("inf")))
    T = tri_verts.shape[0]
    if tv9T is None:
        tv9T = tri_verts.reshape(T, 9).T
    pidx = prim.clamp(min=0).long()
    tv = tv9T[:, pidx].T.reshape(-1, 3, 3)  # (R, 3, 3)
    if tri_verts1 is not None and time is not None:
        if tv9T1 is None:
            tv9T1 = tri_verts1.reshape(T, 9).T
        tv1 = tv9T1[:, pidx].T.reshape(-1, 3, 3)
        tv = keyframe_lerp(tv, tv1, time)
    v0, v1, v2 = tv[:, 0], tv[:, 1], tv[:, 2]
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    sv = o - v0
    u = _dot(sv, pvec) * inv
    qvec = _cross(sv, e1)
    # b0 = 1 - u - v with v = dot(d, qvec) inv, as every consumer fusion of
    # the reference's compiled program recomputes it: fma(-dot, inv, 1 - u)
    b0 = fmac(-_dot(d, qvec), inv, 1.0 - u)
    zero = torch.zeros_like(u)
    b0 = torch.where(hit, b0, zero)
    b1 = torch.where(hit, u, zero)
    return Hit(t, prim, b0, b1, tv)


def keyframe_lerp(v0, v1, time):
    """The vertices (R, 3, 3) at each ray's shutter time (R,): (1 - t) v0 +
    t v1 rounded as the reference's compiled lerp rounds it, one fused
    multiply-add fma(1 - t, v0, t v1): the f32 product (1 - t) v0 is exact
    in f64, so one f64 sum rounded to f32 gives the fused result (but for
    a double-rounding tie)."""
    tm = torch.as_tensor(time, dtype=torch.float32, device=v0.device).reshape(-1, 1, 1)
    fused = (1.0 - tm).double() * v0.double() + (tm * v1).double()
    return fused.to(torch.float32)


def _dot(a, b):
    """The hit's dot products as the reference's compiled `_finalize_hits`
    rounds them (its multiply-reduce fusions): fma(a2, b2, fma(a1, b1,
    a0 b0))."""
    return fmac(a[..., 2], b[..., 2], fmac(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _cross(a, b):
    """The hit's cross products as the reference's compiled program rounds
    them: a_j b_k - a_k b_j = fma(a_j, b_k, -(a_k b_j))."""
    return torch.stack(
        [
            fmac(a[..., 1], b[..., 2], -(a[..., 2] * b[..., 1])),
            fmac(a[..., 2], b[..., 0], -(a[..., 0] * b[..., 2])),
            fmac(a[..., 0], b[..., 1], -(a[..., 1] * b[..., 0])),
        ],
        dim=-1,
    )


def _t_max_rows(o, t_max):
    return torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=o.device), o.shape[:-1]
    ).contiguous()


def stream_intersect(tp: TreeletPack, tri_verts, o, d, t_max, time=None, tri_verts1=None,
                     tv9T=None, tv9T1=None) -> Hit:
    """Closest hit for a flat ray batch. o, d: (R, 3); t_max scalar or (R,).
    Returns Hit with global leaf-order triangle ids and the hit vertices.
    time (R,) / tri_verts1: motion blur (each ray's shutter time; the
    shutter-end keyframe its hit vertices lerp toward)."""
    s = _traverse(tp, o, d, _t_max_rows(o, t_max), False, time=time)
    return _finalize_hits(tri_verts, o, d, s.rayF[6], s.prim, time=time,
                          tri_verts1=tri_verts1, tv9T=tv9T, tv9T1=tv9T1)


def stream_intersect_split(tp: TreeletPack, tri_verts, o, d, t_max, n_finalize: int,
                           time=None, tri_verts1=None, tv9T=None, tv9T1=None):
    """Fused-wave closest hit: traverse ALL rays, but build the full Hit
    only for the first n_finalize; the tail (the integrator's queued
    shadow rays) returns its bare prim ids (R - n_finalize,)."""
    s = _traverse(tp, o, d, _t_max_rows(o, t_max), False, time=time)
    n = n_finalize
    hit = _finalize_hits(tri_verts, o[:n], d[:n], s.rayF[6][:n], s.prim[:n],
                         time=None if time is None else time[:n], tri_verts1=tri_verts1,
                         tv9T=tv9T, tv9T1=tv9T1)
    return hit, s.prim[n:]


def stream_intersect_p(tp: TreeletPack, o, d, t_max, time=None):
    """Any-hit (shadow) predicate -> bool (R,)."""
    return _traverse(tp, o, d, _t_max_rows(o, t_max), True, time=time).prim >= 0


def stream_traverse_stats(tp: TreeletPack, o, d, t_max, any_hit: bool = False):
    """(pairs expanded, leaf block-slot tests, pairs dropped, loop iters)."""
    s = _traverse(tp, o, d, _t_max_rows(o, t_max), any_hit)
    return int(s.n_exp), int(s.n_tl), int(s.n_drop), int(s.iters)
