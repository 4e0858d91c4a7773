"""Packet traversal of the two-level treelet BVH (port of tpu_pbrt/accel/packet.py).

`TORCH_PBRT_BVH=packet` on scenes above BRUTE_MAX_TRIS triangles: the
ray batch is cut into packets of LANE = 128 rays that share one
traversal stack.

- A pop expands one top-tree node for the whole packet: every lane is
  slab-tested against the node's 8 children, and a child hit by any lane
  is pushed with the packet's least entry distance. A pop whose entry
  distance lies past the packet's farthest current hit is dropped.
- Treelet leaves are queued per packet (LEAF_QUEUE entries), and the
  queue is flushed front to back once a pop could overflow it, or when
  the stack is empty: a stable sort by entry distance, then one feature
  product (128, 16) x (16, 4L) per (packet, treelet) pair, the lanes'
  closest hits folded in. A flush stops for a packet at the first
  treelet that lies past its farthest hit.

The reference's three nested `lax.while_loop`s are Python loops over the
whole batch of packets, each step masked per packet; each exit test is
one host read, counted in `traverse.WALKS`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpu_pbrt_torch.accel.mxu import decode_outputs, ray_features
from tpu_pbrt_torch.accel.traverse import WALKS, Hit, _t_max_rows, slab_test
from tpu_pbrt_torch.accel.treelet import TreeletPack, decode_top_leaf
from tpu_pbrt_torch.accel.wide import _EMPTY, MAX_STACK

LANE = 128
LEAF_QUEUE = 64
_FLUSH_AT = LEAF_QUEUE - 8  # a pop can append up to 8 leaves


class _State(NamedTuple):
    sp: torch.Tensor  # (P,) stack depth
    stk_c: torch.Tensor  # (P, S + 8) i32 interior node codes (8 columns take dropped pushes)
    stk_t: torch.Tensor  # (P, S + 8) f32 packet-min entry distance
    nleaf: torch.Tensor  # (P,) queued leaf count
    leaf_id: torch.Tensor  # (P, Q + 8) i32 treelet ids
    leaf_tn: torch.Tensor  # (P, Q + 8) f32 entry distances
    t: torch.Tensor  # (P, LANE) current closest hit (or t_max)
    prim: torch.Tensor  # (P, LANE) i32 global leaf-order triangle id, -1 miss
    b0: torch.Tensor  # (P, LANE)
    b1: torch.Tensor  # (P, LANE)
    n_pop: torch.Tensor  # (P,) stat: interior pops (BVHAccel nodes visited)
    n_tl: torch.Tensor  # (P,) stat: treelet (leaf product) tests


def _packet_done(s: _State, dead, any_hit: bool):
    if not any_hit:
        return torch.zeros(s.sp.shape, dtype=torch.bool, device=s.sp.device)
    return ((s.prim >= 0) | dead).all(dim=-1)


def _push(buf, pos, vals, n_cols: int):
    """buf[p, pos[p, j]] = vals[p, j], a position >= n_cols dropped."""
    out = buf.clone()
    col = torch.clamp(pos, max=n_cols).long()
    out.scatter_(1, col, torch.where(pos < n_cols, vals, out.gather(1, col)))
    return out


def _traverse(tp: TreeletPack, o, d, t_max, any_hit: bool) -> _State:
    """o, d: (P, LANE, 3); t_max: (P, LANE). Returns the final state."""
    P = o.shape[0]
    dev = o.device
    L = tp.leaf_tris
    inv_d = 1.0 / d
    dead = t_max <= 0.0
    p_idx = torch.arange(P, dtype=torch.int64, device=dev)
    top = tp.top
    inf = float("inf")
    reads = [0]

    def any_(x) -> bool:
        reads[0] += 1
        return bool(x.any())  # torchlint: disable=JL-SYNC (the packet walk's loop tests)

    def interior_step(s: _State) -> _State:
        active = (s.sp > 0) & (s.nleaf <= _FLUSH_AT) & ~_packet_done(s, dead, any_hit)
        sp1 = torch.clamp(s.sp - 1, min=0)
        code = s.stk_c[p_idx, sp1.long()]
        tn_top = s.stk_t[p_idx, sp1.long()]
        sp_new = torch.where(active, sp1, s.sp)
        t_pkt = s.t.amax(dim=-1)  # the packet's farthest current hit
        expand = active & (tn_top <= t_pkt)
        node = torch.where(expand, code, torch.zeros_like(code)).long()
        cids = top.child_idx[node]  # (P, 8)
        # every lane against all 8 children, the far plane clamped by the
        # lane's current hit
        tn, _, lane_hit = slab_test(top.child_bmin[node][:, None], top.child_bmax[node][:, None],
                                    o[:, :, None, :], inv_d[:, :, None, :], s.t[:, :, None])
        hit8 = lane_hit.any(dim=1) & (cids != int(_EMPTY)) & expand[:, None]
        tn_pkt = torch.where(lane_hit, tn, torch.full_like(tn, inf)).amin(dim=1)  # (P, 8)
        is_int = hit8 & (cids >= 0)
        is_leaf = hit8 & (cids < 0)
        npush = torch.cumsum(is_int.to(torch.int32), dim=-1)
        pos = torch.where(is_int, sp_new[:, None] + npush - 1,
                          torch.full_like(npush, MAX_STACK + 7))
        stk_c = _push(s.stk_c, pos, cids, MAX_STACK)
        stk_t = _push(s.stk_t, pos, tn_pkt, MAX_STACK)
        sp_out = sp_new + npush[:, -1]
        tids = decode_top_leaf(cids)
        nq = torch.cumsum(is_leaf.to(torch.int32), dim=-1)
        qpos = torch.where(is_leaf, s.nleaf[:, None] + nq - 1,
                           torch.full_like(nq, LEAF_QUEUE + 7))
        leaf_id = _push(s.leaf_id, qpos, tids, LEAF_QUEUE)
        leaf_tn = _push(s.leaf_tn, qpos, tn_pkt, LEAF_QUEUE)
        return s._replace(sp=sp_out, stk_c=stk_c, stk_t=stk_t, nleaf=s.nleaf + nq[:, -1],
                          leaf_id=leaf_id, leaf_tn=leaf_tn,
                          n_pop=s.n_pop + active.to(torch.int32))

    def leaf_step(k: int, s: _State) -> _State:
        valid = (k < s.nleaf) & ~_packet_done(s, dead, any_hit)
        t_pkt = s.t.amax(dim=-1)
        tid = torch.where(valid, s.leaf_id[:, k], torch.zeros_like(s.leaf_id[:, k]))
        # the queue is sorted by entry distance: once the packet's next
        # treelet lies past its farthest hit, every later one does too
        live = valid & (s.leaf_tn[:, k] <= t_pkt) & (tid >= 0)
        sel = torch.where(live, tid, torch.zeros_like(tid)).long()
        WT = tp.featT[sel]  # (P, 16, 4L)
        ctr = tp.center[sel]  # (P, 3)
        off = tp.offset[sel]  # (P,)
        phi = ray_features(o - ctr[:, None, :], d)  # (P, LANE, 16)
        out = torch.bmm(phi, WT)
        t_new, k_loc, b0, b1 = decode_outputs(out, L, s.t)
        better = live[:, None] & torch.isfinite(t_new) & (t_new < s.t)
        return s._replace(
            t=torch.where(better, t_new, s.t),
            prim=torch.where(better, off[:, None] + k_loc.to(torch.int32), s.prim),
            b0=torch.where(better, b0, s.b0),
            b1=torch.where(better, b1, s.b1),
            n_tl=s.n_tl + live.to(torch.int32),
        )

    def flush(s: _State) -> _State:
        """Sort the leaf queue by entry distance, intersect front to back."""
        q = torch.arange(LEAF_QUEUE, dtype=torch.int64, device=dev)
        key = torch.where(q[None, :] < s.nleaf[:, None], s.leaf_tn[:, :LEAF_QUEUE],
                          torch.full_like(s.leaf_tn[:, :LEAF_QUEUE], inf))
        key_s, order = torch.sort(key, dim=1, stable=True)
        id_s = torch.gather(s.leaf_id[:, :LEAF_QUEUE], 1, order)
        s = s._replace(leaf_tn=torch.cat([key_s, s.leaf_tn[:, LEAF_QUEUE:]], 1),
                       leaf_id=torch.cat([id_s, s.leaf_id[:, LEAF_QUEUE:]], 1))
        k = 0
        while k < LEAF_QUEUE:
            t_pkt = s.t.amax(dim=-1)
            live = ((k < s.nleaf) & (s.leaf_tn[:, k] <= t_pkt)
                    & ~_packet_done(s, dead, any_hit))
            if not any_(live):
                break
            s = leaf_step(k, s)
            k += 1
        return s._replace(nleaf=torch.zeros_like(s.nleaf))

    s = _State(
        sp=torch.ones(P, dtype=torch.int32, device=dev),
        stk_c=torch.zeros((P, MAX_STACK + 8), dtype=torch.int32, device=dev),  # [0]: the root
        stk_t=torch.zeros((P, MAX_STACK + 8), dtype=torch.float32, device=dev),
        nleaf=torch.zeros(P, dtype=torch.int32, device=dev),
        leaf_id=torch.full((P, LEAF_QUEUE + 8), -1, dtype=torch.int32, device=dev),
        leaf_tn=torch.full((P, LEAF_QUEUE + 8), inf, dtype=torch.float32, device=dev),
        t=t_max,
        prim=torch.full((P, LANE), -1, dtype=torch.int32, device=dev),
        b0=torch.zeros((P, LANE), dtype=torch.float32, device=dev),
        b1=torch.zeros((P, LANE), dtype=torch.float32, device=dev),
        n_pop=torch.zeros(P, dtype=torch.int32, device=dev),
        n_tl=torch.zeros(P, dtype=torch.int32, device=dev),
    )
    steps = 0
    while any_(((s.sp > 0) | (s.nleaf > 0)) & ~_packet_done(s, dead, any_hit)):
        while any_((s.sp > 0) & (s.nleaf <= _FLUSH_AT) & ~_packet_done(s, dead, any_hit)):
            s = interior_step(s)
            steps += 1
        s = flush(s)
    WALKS.add(steps, reads[0])
    return s


def _to_packets(o, d, t_max):
    R = o.shape[0]
    P = (R + LANE - 1) // LANE
    pad = P * LANE - R
    if pad:
        o = torch.cat([o, torch.zeros((pad, 3), dtype=o.dtype, device=o.device)])
        d = torch.cat([d, torch.ones((pad, 3), dtype=d.dtype, device=d.device)])
        t_max = torch.cat([t_max, torch.full((pad,), -1.0, dtype=t_max.dtype,
                                             device=t_max.device)])
    return o.reshape(P, LANE, 3), d.reshape(P, LANE, 3), t_max.reshape(P, LANE), R


def packet_traverse_stats(tp: TreeletPack, o, d, t_max, any_hit: bool = False):
    """Per-packet traversal statistics: (interior pops, treelet tests)."""
    op, dp, tm, _ = _to_packets(o, d, _t_max_rows(o, t_max))
    s = _traverse(tp, op, dp, tm, any_hit)
    return s.n_pop, s.n_tl


def packet_intersect(tp: TreeletPack, o, d, t_max, any_hit: bool = False) -> Hit:
    """Closest hit (or the any-hit predicate's source) for a flat ray
    batch: o, d (R, 3); t_max scalar or (R,). Returns global leaf-order
    triangle ids; a miss has t = inf."""
    op, dp, tm, R = _to_packets(o, d, _t_max_rows(o, t_max))
    s = _traverse(tp, op, dp, tm, any_hit)
    t = s.t.reshape(-1)[:R]
    prim = s.prim.reshape(-1)[:R]
    t = torch.where(prim >= 0, t, torch.full_like(t, float("inf")))
    return Hit(t, prim, s.b0.reshape(-1)[:R], s.b1.reshape(-1)[:R])


def packet_intersect_p(tp: TreeletPack, o, d, t_max) -> torch.Tensor:
    """Any-hit (shadow) predicate -> bool (R,)."""
    return packet_intersect(tp, o, d, t_max, any_hit=True).prim >= 0
