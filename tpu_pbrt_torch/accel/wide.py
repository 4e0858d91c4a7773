"""8-wide BVH build and the lane-major slab test (port of tpu_pbrt/accel/wide.py).

`build_wide_numpy` collapses the flattened binary BVH into nodes of up to 8
children on the host, exactly as the reference does (same traversal of
the binary tree, same largest-area-first expansion, same leaf encoding),
so the stream tracer's top tree is bit-identical in both packages. The
per-ray wide walker of the reference is not ported; the stream tracer
(accel/stream.py) is the port's traversal.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpu_pbrt_torch.accel.build import MAX_LEAF_PRIMS, BVHArrays

WIDTH = 8
# worst-case occupancy of a per-ray stack walk is (WIDTH-1)*depth + 1; the
# build keeps the reference's loud check so both packages accept the same
# scenes
MAX_STACK = 128
# float32 machine epsilon / 2 (pbrt MachineEpsilon) and pbrt's gamma(3)
_MACHINE_EPS = 5.960464477539063e-08
_BOX_EPS = 1.0 + 2.0 * ((3 * _MACHINE_EPS) / (1 - 3 * _MACHINE_EPS))
# wide-leaf encoding in child_idx: >= 0 interior node id;
# < 0 leaf: -(1 + prim_offset * (MAX_LEAF_PRIMS+1) + n_prims)
_LEAF_STRIDE = MAX_LEAF_PRIMS + 1
_EMPTY = np.int32(2**30)  # empty slot: bounds are +inf/-inf, never hit


def slab_test_lane_major(b_lo, b_hi, o_c, inv_c):
    """Per-AXIS half of the watertight slab test for lane-major layouts:
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
