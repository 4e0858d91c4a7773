"""8-wide BVH: the build, the slab tests and the wide walker (port of
tpu_pbrt/accel/wide.py).

`build_wide_numpy` collapses the flattened binary BVH into nodes of up to 8
children on the host, exactly as the reference does (same traversal of
the binary tree, same largest-area-first expansion, same leaf encoding),
so the stream tracer's top tree is bit-identical in both packages.

`wide_intersect` / `wide_intersect_p` (`TORCH_PBRT_BVH=wide`) walk that
tree per ray: a pop slab-tests all 8 children of a node from one row,
pushes the hit ones far to near (a stable argsort of their entry
distances, so near subtrees pop first), and a leaf pop tests its
MAX_LEAF_PRIMS triangles at once against the ray's current hit. As the
binary walker (accel/traverse.py), the per-ray `lax.while_loop` is a
masked step over the whole batch, its exit flag read back every
`traverse.CHECK_EVERY` steps.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_pbrt_torch.accel.build import MAX_LEAF_PRIMS, BVHArrays
from tpu_pbrt_torch.accel.traverse import (_BOX_EPS, WALKS, Hit, _dispatch, intersect_triangle,
                                           slab_test, walk_loop)

WIDTH = 8
# worst-case occupancy of a per-ray stack walk is (WIDTH-1)*depth + 1; the
# build keeps the reference's loud check so both packages accept the same
# scenes
MAX_STACK = 128
# wide-leaf encoding in child_idx: >= 0 interior node id;
# < 0 leaf: -(1 + prim_offset * (MAX_LEAF_PRIMS+1) + n_prims)
_LEAF_STRIDE = MAX_LEAF_PRIMS + 1
_EMPTY = np.int32(2**30)  # empty slot: bounds are +inf/-inf, never hit


def slab_test_lane_major(b_lo, b_hi, o_c, inv_c):
    """Per-AXIS half of the watertight slab test (traverse.slab_test) for
    lane-major layouts:
    this axis's (t0, t1) with the _BOX_EPS widening of the far distance
    and the 0*inf NaN treated as inside the slab. Callers combine the
    three axes and clamp t_near to 0 / t_far to the ray's current hit."""
    neg = inv_c < 0
    lo = torch.where(neg, b_hi, b_lo)
    hi = torch.where(neg, b_lo, b_hi)
    t0 = (lo - o_c) * inv_c
    t1 = (hi - o_c) * inv_c * _BOX_EPS
    t0 = torch.where(torch.isnan(t0), torch.full_like(t0, -float("inf")), t0)
    t1 = torch.where(torch.isnan(t1), torch.full_like(t1, float("inf")), t1)
    return t0, t1


class WideBVH(NamedTuple):
    child_bmin: torch.Tensor  # (N, 8, 3) f32
    child_bmax: torch.Tensor  # (N, 8, 3) f32
    child_idx: torch.Tensor  # (N, 8) i32 encoded


def _area(bmin, bmax):
    d = np.maximum(bmax - bmin, 0)
    return 2 * (d[0] * d[1] + d[0] * d[2] + d[1] * d[2])


def build_wide_numpy(bvh: BVHArrays):
    """Collapse the flattened binary BVH into 8-wide nodes (host numpy).
    Returns (child_bmin (N,8,3), child_bmax (N,8,3), child_idx (N,8))."""
    n_prims_b = bvh.n_prims
    second = bvh.second_child
    bmin_b = bvh.bounds_min
    bmax_b = bvh.bounds_max
    off_b = bvh.prim_offset

    def leaf_code(b):
        return -(1 + int(off_b[b]) * _LEAF_STRIDE + int(n_prims_b[b]))

    def is_interior(b):
        # the Morton builder pads its complete tree with empty leaves
        # (n_prims == 0, second == 0, inf/-inf bounds); only a forward
        # second-child pointer marks a real interior node
        return n_prims_b[b] == 0 and int(second[b]) > b

    def is_empty_leaf(b):
        return n_prims_b[b] == 0 and int(second[b]) <= b

    wide_nodes = []  # each: list of (binary node id or leaf-code, bmin, bmax)
    wide_id_of: dict = {}  # binary node id -> wide node id

    if n_prims_b[0] > 0:
        # degenerate single-leaf tree
        wide_nodes.append([(leaf_code(0), bmin_b[0], bmax_b[0])])
    else:
        wide_id_of[0] = 0
        wide_nodes.append(None)  # placeholder
        queue = [0]
        while queue:
            b = queue.pop()
            # expand b's children until 8 slots: keep a worklist of binary
            # subtree roots, split the largest-area interior one each step
            slots = [b + 1, int(second[b])]
            while len(slots) < WIDTH:
                best = -1
                best_a = -1.0
                for i, sb in enumerate(slots):
                    if is_interior(sb):
                        a = _area(bmin_b[sb], bmax_b[sb])
                        if a > best_a:
                            best_a = a
                            best = i
                if best < 0:
                    break
                sb = slots.pop(best)
                slots.append(sb + 1)
                slots.append(int(second[sb]))
            children = []
            for sb in slots:
                if is_empty_leaf(sb):
                    continue  # unhittable padding: no slot at all
                if n_prims_b[sb] > 0:
                    children.append((leaf_code(sb), bmin_b[sb], bmax_b[sb]))
                else:
                    wid = wide_id_of.get(sb)
                    if wid is None:
                        wid = len(wide_nodes)
                        wide_id_of[sb] = wid
                        wide_nodes.append(None)
                        queue.append(sb)
                    children.append((wid, bmin_b[sb], bmax_b[sb]))
            wide_nodes[wide_id_of[b]] = children

    n = len(wide_nodes)
    cmin = np.full((n, WIDTH, 3), np.inf, np.float32)
    cmax = np.full((n, WIDTH, 3), -np.inf, np.float32)
    cidx = np.full((n, WIDTH), _EMPTY, np.int32)
    for i, children in enumerate(wide_nodes):
        for k, (code, bmn, bmx) in enumerate(children):
            cidx[i, k] = code
            cmin[i, k] = bmn
            cmax[i, k] = bmx

    # children always get larger wide ids than their parent, so a reverse
    # pass computes interior depth
    depth = np.ones(n, np.int64)
    for i in range(n - 1, -1, -1):
        for code, _, _ in wide_nodes[i]:
            if code >= 0:
                depth[i] = max(depth[i], 1 + depth[code])
    worst = (WIDTH - 1) * int(depth[0]) + 1
    if worst > MAX_STACK:
        raise ValueError(
            f"wide BVH depth {int(depth[0])} needs stack {worst} > MAX_STACK="
            f"{MAX_STACK}; raise MAX_STACK in accel/wide.py"
        )
    return cmin, cmax, cidx


def pad_tri_verts(tri_verts_leaf_order: np.ndarray) -> np.ndarray:
    """Pad the leaf-order (T,3,3) vertex array with MAX_LEAF_PRIMS zero rows
    (degenerate, never hit) — the reference's upload layout, kept so both
    packages' vertex tables have the same shape."""
    tv = np.ascontiguousarray(tri_verts_leaf_order, dtype=np.float32)
    return np.concatenate([tv, np.zeros((MAX_LEAF_PRIMS, 3, 3), np.float32)], axis=0)


def wide_as_device(tables, device) -> WideBVH:
    """build_wide_numpy's three tables -> the walker's WideBVH on `device`."""
    cmin, cmax, cidx = tables
    return WideBVH(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (cmin, cmax, cidx)))


# -------------------------------------------------------------------------
# The wide walker
# -------------------------------------------------------------------------

#: safety bound on a walk's steps (real traversals finish in hundreds)
_MAX_ITERS = 16384


class _WState(NamedTuple):
    sp: torch.Tensor
    stack: torch.Tensor  # (R, MAX_STACK + 1): the last column takes no-op writes
    t: torch.Tensor
    prim: torch.Tensor
    b0: torch.Tensor
    b1: torch.Tensor
    iters: torch.Tensor


def _ray_traverse_wide(w: WideBVH, tri_verts, o, d, t_max, any_hit: bool) -> Hit:
    R = o.shape[0]
    dev = o.device
    inv_d = 1.0 / d
    rows = torch.arange(R, dtype=torch.int64, device=dev)
    lanes = torch.arange(MAX_LEAF_PRIMS, dtype=torch.int64, device=dev)
    n_rows = tri_verts.shape[0]
    empty = int(_EMPTY)

    def live_of(s: _WState):
        return (s.sp > 0) & (s.iters < _MAX_ITERS)

    def step(s: _WState) -> _WState:
        live = live_of(s)
        sp = s.sp - 1
        code = s.stack[rows, torch.clamp(sp, min=0).long()]
        is_leaf = code < 0
        # ---- leaf: its MAX_LEAF_PRIMS triangles in one block ----------
        leaf_dec = -(code + 1)
        off = torch.where(is_leaf, leaf_dec // _LEAF_STRIDE, torch.zeros_like(code))
        cnt = torch.where(is_leaf, leaf_dec % _LEAF_STRIDE, torch.zeros_like(code))
        # the reference's dynamic_slice start, clamped so the block fits
        start = torch.clamp(off, max=n_rows - MAX_LEAF_PRIMS).long()
        blk = tri_verts[start[:, None] + lanes[None, :]]  # (R, 4, 3, 3)
        h, th, b0h, b1h = intersect_triangle(o[:, None, :], d[:, None, :], blk[:, :, 0],
                                             blk[:, :, 1], blk[:, :, 2], s.t[:, None])
        take = (is_leaf & live)[:, None] & (lanes[None, :] < cnt[:, None]) & h
        th_m = torch.where(take, th, torch.full_like(th, float("inf")))
        k = torch.argmin(th_m, dim=1)
        tk = th_m[rows, k]
        better = tk < s.t
        t_new = torch.where(better, tk, s.t)
        prim_new = torch.where(better, off + k.to(torch.int32), s.prim)
        b0_new = torch.where(better, b0h[rows, k], s.b0)
        b1_new = torch.where(better, b1h[rows, k], s.b1)
        # ---- interior: 8-wide slab test and the ordered push ----------
        node = torch.where(is_leaf, torch.zeros_like(code), code).long()
        cids = w.child_idx[node]  # (R, 8)
        tn, _, in_slab = slab_test(w.child_bmin[node], w.child_bmax[node], o[:, None, :],
                                   inv_d[:, None, :], t_new[:, None])
        hit8 = (~is_leaf & live)[:, None] & in_slab & (cids != empty)
        key = torch.where(hit8, tn, torch.full_like(tn, -float("inf")))
        order = torch.argsort(key, dim=1, stable=True)  # misses first, then near..far
        hit_s = torch.gather(hit8, 1, order)
        cid_s = torch.gather(cids, 1, order)
        # slot j (far .. near, j = 7 .. 0) lands above every hit slot after it
        after = torch.flip(torch.cumsum(torch.flip(hit_s.to(torch.int32), [1]), 1), [1]) \
            - hit_s.to(torch.int32)
        sp_base = torch.where(live, sp, s.sp)
        col = torch.where(hit_s, sp_base[:, None] + after, torch.full_like(after, MAX_STACK))
        stack = s.stack.clone()
        stack.scatter_(1, col.long(), torch.where(hit_s, cid_s, torch.zeros_like(cid_s)))
        stack[:, MAX_STACK] = 0
        sp_new = sp_base + hit_s.to(torch.int32).sum(dim=1, dtype=torch.int32)
        if any_hit:
            sp_new = torch.where(prim_new >= 0, torch.zeros_like(sp_new), sp_new)
        sp_out = torch.where(live, sp_new, s.sp)
        return _WState(sp_out, stack, t_new, prim_new, b0_new, b1_new,
                       s.iters + live.to(torch.int32))

    init = _WState(
        sp=torch.ones(R, dtype=torch.int32, device=dev),
        stack=torch.zeros((R, MAX_STACK + 1), dtype=torch.int32, device=dev),  # [0]: the root
        t=t_max.clone(),
        prim=torch.full((R,), -1, dtype=torch.int32, device=dev),
        b0=torch.zeros(R, dtype=torch.float32, device=dev),
        b1=torch.zeros(R, dtype=torch.float32, device=dev),
        iters=torch.zeros(R, dtype=torch.int32, device=dev),
    )
    out, steps, reads = walk_loop(step, live_of, init, _MAX_ITERS)
    WALKS.add(steps, reads)
    return Hit(out.t, out.prim, out.b0, out.b1)


def wide_intersect(w: WideBVH, tri_verts, o, d, t_max) -> Hit:
    """Closest hit over a ray batch against the wide BVH. tri_verts is the
    padded leaf-order vertex table (pad_tri_verts). A miss keeps t = t_max."""
    return _dispatch(lambda oo, dd, tt: _ray_traverse_wide(w, tri_verts, oo, dd, tt, False),
                     o, d, t_max)


def wide_intersect_p(w: WideBVH, tri_verts, o, d, t_max) -> torch.Tensor:
    """Any-hit (shadow) predicate over a ray batch -> bool (R,)."""
    hit = _dispatch(lambda oo, dd, tt: _ray_traverse_wide(w, tri_verts, oo, dd, tt, True),
                    o, d, t_max)
    return hit.prim >= 0
