"""Host-side BVH construction -> flattened LinearBVHNode SoA.

Capability match for pbrt-v3 src/accelerators/bvh.{h,cpp} BVHAccel: binned
SAH build (12 buckets, pbrt's leaf/split cost model), plus a Morton-ordered
build standing in for HLBVH, plus 'middle' and 'equal' split methods; the
result is the depth-first flattened LinearBVHNode layout (first child
adjacent, second-child offset, split axis for front-to-back traversal).

TPU-first design: the builder is numpy on the host (scene compile step); the
flattened SoA arrays are uploaded once to HBM and traversed by the device
kernel in accel/traverse.py. The Morton path is fully vectorized (no
per-primitive Python) so multi-million-triangle scenes (crown: ~3.5M) build
in seconds, mirroring HLBVH's role upstream.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_N_BUCKETS = 12
_TRAVERSAL_COST = 0.125  # relative cost: pbrt uses 1/8 node traversal vs isect

# Hard cap on primitives per leaf: the device traversal unrolls exactly this
# many masked triangle tests per leaf visit, so every builder must respect it.
MAX_LEAF_PRIMS = 4


@dataclass
class BVHArrays:
    """Flattened BVH, structure-of-arrays (the LinearBVHNode[] equivalent)."""

    bounds_min: np.ndarray  # (M,3) f32
    bounds_max: np.ndarray  # (M,3) f32
    prim_offset: np.ndarray  # (M,) i32 — first primitive if leaf
    n_prims: np.ndarray  # (M,) i32 — 0 for interior nodes
    second_child: np.ndarray  # (M,) i32 — offset of far child if interior
    axis: np.ndarray  # (M,) i32 — split axis if interior
    prim_order: np.ndarray  # (T,) i64 — permutation old->leaf order

    @property
    def n_nodes(self):
        return len(self.n_prims)


def build_bvh(
    bmin: np.ndarray,
    bmax: np.ndarray,
    method: str = "auto",
    max_leaf_prims: int = 4,
    sah_threshold: int = 262144,
) -> BVHArrays:
    """Build over per-primitive AABBs (T,3)+(T,3).

    method: 'sah' | 'hlbvh' (morton) | 'middle' | 'equal' | 'auto'
    (auto = sah below sah_threshold prims, morton above, matching pbrt's
    guidance that HLBVH trades quality for build speed on huge scenes).
    """
    n = len(bmin)
    assert n > 0, "BVH over zero primitives"
    max_leaf_prims = min(max_leaf_prims, MAX_LEAF_PRIMS)
    bmin = np.asarray(bmin, dtype=np.float64)
    bmax = np.asarray(bmax, dtype=np.float64)
    if method == "auto":
        # with the native builder available, SAH is fast enough for every
        # scene size (crown-class included); only the pure-Python SAH needs
        # the Morton escape hatch above the threshold
        from tpu_pbrt_torch.accel.native import get_lib

        if get_lib() is not None:
            method = "sah"
        else:
            method = "sah" if n <= sah_threshold else "hlbvh"
    if method in ("hlbvh", "lbvh", "morton"):
        return _build_morton(bmin, bmax, max_leaf_prims)
    if method == "sah":
        from tpu_pbrt_torch.accel.native import native_build_sah

        out = native_build_sah(bmin, bmax, max_leaf_prims)
        if out is not None:
            return out
    if method in ("sah", "middle", "equal", "equalcounts"):
        return _build_recursive(bmin, bmax, max_leaf_prims, method)
    raise ValueError(f"unknown BVH split method {method!r}")


# -------------------------------------------------------------------------
# Recursive binned-SAH / middle / equal builder (pbrt recursiveBuild),
# emitting nodes directly in depth-first flattened order.
# -------------------------------------------------------------------------

def _build_recursive(bmin, bmax, max_leaf, method) -> BVHArrays:
    n = len(bmin)
    centroids = 0.5 * (bmin + bmax)

    cap = 2 * n + 1
    out_min = np.empty((cap, 3), dtype=np.float32)
    out_max = np.empty((cap, 3), dtype=np.float32)
    out_prim_off = np.zeros(cap, dtype=np.int32)
    out_nprims = np.zeros(cap, dtype=np.int32)
    out_second = np.zeros(cap, dtype=np.int32)
    out_axis = np.zeros(cap, dtype=np.int32)
    order: list = []
    slot = 0

    # explicit stack of (prim index array, parent_slot or -1 meaning no patch)
    # pushing right-then-left yields pbrt's DFS layout: left child at parent+1
    stack = [(np.arange(n), -1)]
    while stack:
        idx, patch_parent = stack.pop()
        my_slot = slot
        slot += 1
        if patch_parent >= 0:
            out_second[patch_parent] = my_slot
        nb_min = bmin[idx].min(axis=0)
        nb_max = bmax[idx].max(axis=0)
        out_min[my_slot] = nb_min
        out_max[my_slot] = nb_max

        def make_leaf():
            out_prim_off[my_slot] = len(order)
            out_nprims[my_slot] = len(idx)
            order.extend(idx.tolist())

        if len(idx) == 1:
            make_leaf()
            continue
        c = centroids[idx]
        cb_min, cb_max = c.min(axis=0), c.max(axis=0)
        ext = cb_max - cb_min
        dim = int(np.argmax(ext))
        if ext[dim] <= 0:
            # degenerate centroid cluster: leaf if it fits, else force an
            # equal split so no leaf ever exceeds max_leaf (the traversal
            # unrolls exactly that many prim tests)
            if len(idx) <= max_leaf:
                make_leaf()
                continue
            mid = len(idx) // 2
            out_axis[my_slot] = dim
            out_nprims[my_slot] = 0
            stack.append((idx[mid:], my_slot))
            stack.append((idx[:mid], -1))
            continue

        mid = None
        if method == "middle":
            pmid = 0.5 * (cb_min[dim] + cb_max[dim])
            left = c[:, dim] < pmid
            mid = int(left.sum())
            if mid == 0 or mid == len(idx):
                mid = None  # fall through to equal
        if method in ("equal", "equalcounts") or (method == "middle" and mid is None):
            mid = len(idx) // 2
            part = np.argpartition(c[:, dim], mid)
            idx = idx[part]
        elif method == "middle":
            ordr = np.argsort(left)[::-1]  # lefts first
            idx = idx[ordr]
        else:  # SAH
            if len(idx) <= 2:
                mid = len(idx) // 2
                part = np.argpartition(c[:, dim], mid)
                idx = idx[part]
            else:
                t = (c[:, dim] - cb_min[dim]) / ext[dim]
                b = np.minimum((_N_BUCKETS * t).astype(np.int32), _N_BUCKETS - 1)
                # per-bucket counts and bounds
                counts = np.bincount(b, minlength=_N_BUCKETS)
                bk_min = np.full((_N_BUCKETS, 3), np.inf)
                bk_max = np.full((_N_BUCKETS, 3), -np.inf)
                np.minimum.at(bk_min, b, bmin[idx])
                np.maximum.at(bk_max, b, bmax[idx])
                # prefix/suffix accumulation of bounds+counts
                cmin_f = np.minimum.accumulate(bk_min, axis=0)
                cmax_f = np.maximum.accumulate(bk_max, axis=0)
                cnt_f = np.cumsum(counts)
                cmin_b = np.minimum.accumulate(bk_min[::-1], axis=0)[::-1]
                cmax_b = np.maximum.accumulate(bk_max[::-1], axis=0)[::-1]
                cnt_b = np.cumsum(counts[::-1])[::-1]

                def area(mn, mx):
                    d = np.maximum(mx - mn, 0)
                    return 2 * (d[..., 0] * d[..., 1] + d[..., 0] * d[..., 2] + d[..., 1] * d[..., 2])

                a0 = area(cmin_f[:-1], cmax_f[:-1])
                a1 = area(cmin_b[1:], cmax_b[1:])
                total_area = max(area(nb_min, nb_max), 1e-30)
                cost = _TRAVERSAL_COST + (cnt_f[:-1] * a0 + cnt_b[1:] * a1) / total_area
                valid = (cnt_f[:-1] > 0) & (cnt_b[1:] > 0)
                cost = np.where(valid, cost, np.inf)
                best = int(np.argmin(cost))
                leaf_cost = float(len(idx))
                if len(idx) > max_leaf or cost[best] < leaf_cost:
                    if not valid.any():
                        mid = len(idx) // 2
                        part = np.argpartition(c[:, dim], mid)
                        idx = idx[part]
                    else:
                        left = b <= best
                        mid = int(left.sum())
                        idx = idx[np.argsort(~left, kind="stable")]
                else:
                    make_leaf()
                    continue
        out_axis[my_slot] = dim
        out_nprims[my_slot] = 0
        stack.append((idx[mid:], my_slot))  # right (far) — patched later
        stack.append((idx[:mid], -1))  # left — next slot
    return BVHArrays(
        bounds_min=out_min[:slot].copy(),
        bounds_max=out_max[:slot].copy(),
        prim_offset=out_prim_off[:slot].copy(),
        n_prims=out_nprims[:slot].copy(),
        second_child=out_second[:slot].copy(),
        axis=out_axis[:slot].copy(),
        prim_order=np.asarray(order, dtype=np.int64),
    )


# -------------------------------------------------------------------------
# Morton build (HLBVH stand-in): sort by 30-bit Morton code, complete
# binary tree over equal-count runs, bounds by level reduction, DFS
# numbering computed level-by-level — all vectorized.
# -------------------------------------------------------------------------

def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread 10 bits to every 3rd position (pbrt LeftShift3)."""
    v = v.astype(np.uint64)
    v = (v | (v << 16)) & np.uint64(0x30000FF)
    v = (v | (v << 8)) & np.uint64(0x300F00F)
    v = (v | (v << 4)) & np.uint64(0x30C30C3)
    v = (v | (v << 2)) & np.uint64(0x9249249)
    return v


def morton_codes(points: np.ndarray, scene_min, scene_max) -> np.ndarray:
    """30-bit 3D Morton codes of points within [scene_min, scene_max]."""
    ext = np.maximum(np.asarray(scene_max) - np.asarray(scene_min), 1e-30)
    q = np.clip((points - scene_min) / ext * 1024.0, 0, 1023).astype(np.uint32)
    return (
        (_expand_bits(q[:, 2]) << np.uint64(2))
        | (_expand_bits(q[:, 1]) << np.uint64(1))
        | _expand_bits(q[:, 0])
    )


def _build_morton(bmin, bmax, max_leaf) -> BVHArrays:
    n = len(bmin)
    centroids = 0.5 * (bmin + bmax)
    codes = morton_codes(centroids, bmin.min(axis=0), bmax.max(axis=0))
    order = np.argsort(codes, kind="stable").astype(np.int64)

    # leaves: contiguous runs of max_leaf prims in morton order
    n_leaves = (n + max_leaf - 1) // max_leaf
    depth = max(1, int(np.ceil(np.log2(max(n_leaves, 2)))))
    full = 1 << depth  # complete tree with `full` leaf slots

    # pad: empty leaf slots get degenerate bounds and 0 prims
    leaf_starts = np.arange(n_leaves) * max_leaf
    leaf_counts = np.minimum(max_leaf, n - leaf_starts).astype(np.int32)

    sm = bmin[order].astype(np.float32)
    sx = bmax[order].astype(np.float32)
    # per-leaf bounds via reduceat
    lmin = np.minimum.reduceat(sm, leaf_starts, axis=0)
    lmax = np.maximum.reduceat(sx, leaf_starts, axis=0)

    pad = full - n_leaves
    if pad:
        lmin = np.vstack([lmin, np.full((pad, 3), np.inf, np.float32)])
        lmax = np.vstack([lmax, np.full((pad, 3), -np.inf, np.float32)])
        leaf_starts = np.concatenate([leaf_starts, np.full(pad, n)])
        leaf_counts = np.concatenate([leaf_counts, np.zeros(pad, np.int32)])

    # level bounds bottom-up: levels[d] has 2^d nodes
    lv_min = [lmin]
    lv_max = [lmax]
    for _ in range(depth):
        lv_min.append(np.minimum(lv_min[-1][0::2], lv_min[-1][1::2]))
        lv_max.append(np.maximum(lv_max[-1][0::2], lv_max[-1][1::2]))
    lv_min.reverse()
    lv_max.reverse()  # lv_min[0] = root level (1 node) ... lv_min[depth] = leaves

    # DFS numbering: every interior node has subtree size 2*half_leaves-1 where
    # the tree below is complete; dfs(left)=dfs(v)+1, dfs(right)=dfs(v)+1+size(left)
    m_total = 2 * full - 1
    dfs = [np.zeros(1, dtype=np.int64)]
    for d in range(depth):
        size_child = (1 << (depth - d)) - 1  # subtree size of each child
        child = np.empty(2 << d, dtype=np.int64)
        child[0::2] = dfs[d] + 1
        child[1::2] = dfs[d] + 1 + size_child
        dfs.append(child)

    out_min = np.empty((m_total, 3), np.float32)
    out_max = np.empty((m_total, 3), np.float32)
    out_prim_off = np.zeros(m_total, np.int32)
    out_nprims = np.zeros(m_total, np.int32)
    out_second = np.zeros(m_total, np.int32)
    out_axis = np.zeros(m_total, np.int32)
    for d in range(depth + 1):
        ids = dfs[d]
        out_min[ids] = lv_min[d]
        out_max[ids] = lv_max[d]
        if d < depth:
            out_second[ids] = dfs[d + 1][1::2]
            # split axis: largest extent of the node bounds (approximation;
            # morton splits cycle xyz but extent ordering works for traversal)
            out_axis[ids] = np.argmax(lv_max[d] - lv_min[d], axis=1)
        else:
            out_prim_off[ids] = leaf_starts
            out_nprims[ids] = leaf_counts
    # empty padded leaves keep inf/-inf bounds -> never hit by slab test
    return BVHArrays(out_min, out_max, out_prim_off, out_nprims, out_second, out_axis, order)


def triangle_bounds(verts: np.ndarray):
    """(T,3,3) world-space triangle vertices -> AABB arrays (T,3),(T,3)."""
    return verts.min(axis=1), verts.max(axis=1)
