"""Two-level acceleration structure: treelets + 8-wide top tree (host build).

Port of tpu_pbrt/accel/treelet.py. The binary SAH tree (accel/build.py)
is cut into TREELETS — subtrees of <= leaf_tris triangles, contiguous in
leaf order — and each treelet gets its (F, 4L) Moller-Trumbore feature
block (accel/mxu.py), so a leaf visit is one dense feature product. A
small top BVH over the treelet boxes is collapsed 8-wide
(accel/wide.py). The build is the reference's numpy code line for line,
so the cut, the top tree and the prim order are the reference's; only
the upload produces torch tensors.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from tpu_pbrt_torch.accel.build import BVHArrays, build_bvh
from tpu_pbrt_torch.accel.mxu import tri_feature_weights_motion, tri_feature_weights_raw
from tpu_pbrt_torch.accel.wide import _LEAF_STRIDE, WideBVH, build_wide_numpy

#: default triangles per treelet of build_treelet_pack (the stream path
#: passes its own STREAM_LEAF_TRIS)
LEAF_TRIS = 64


class TreeletPack(NamedTuple):
    """Device tables of the two-level traversal.

    featT is stored with the features on axis 1: a leaf block contracts
    featT[c] (F, 4L) with the block's (F, 128) ray features, F = 16
    (64 with the cubic-in-time motion features). Column groups are
    [det (L) | u*det (L) | v*det (L) | t*det (L)]."""

    top: WideBVH  # 8-wide top tree; leaf codes encode treelet ids
    featT: torch.Tensor  # (C, F, 4L) f32
    center: torch.Tensor  # (C, 3) f32 re-centering point per treelet
    offset: torch.Tensor  # (C,) i32 first leaf-order triangle id
    count: torch.Tensor  # (C,) i32 triangles in treelet

    @property
    def leaf_tris(self) -> int:
        return self.featT.shape[2] // 4

    @property
    def n_features(self) -> int:
        """16 static, 64 with motion-blur time features."""
        return self.featT.shape[1]

    @property
    def n_treelets(self) -> int:
        return self.featT.shape[0]


def _subtree_ranges(bvh: BVHArrays):
    """Per-node (first leaf-order prim, prim count) via a reverse DFS pass."""
    n = bvh.n_nodes
    second = bvh.second_child
    n_prims = bvh.n_prims
    count = np.zeros(n, np.int64)
    first = np.zeros(n, np.int64)
    for i in range(n - 1, -1, -1):
        if n_prims[i] > 0:
            count[i] = n_prims[i]
            first[i] = bvh.prim_offset[i]
        elif second[i] > i:
            count[i] = count[i + 1] + count[second[i]]
            first[i] = first[i + 1]
    return first, count


def cut_treelets(bvh: BVHArrays, leaf_tris: int = LEAF_TRIS):
    """Top-down cut of the binary tree into subtrees of <= leaf_tris prims.
    Returns (offsets, counts, bmin, bmax), one row per treelet."""
    first, count = _subtree_ranges(bvh)
    offsets, counts, bmins, bmaxs = [], [], [], []
    stack = [0]
    while stack:
        i = stack.pop()
        if count[i] == 0:
            continue  # Morton padding
        if count[i] <= leaf_tris:
            offsets.append(first[i])
            counts.append(count[i])
            bmins.append(bvh.bounds_min[i])
            bmaxs.append(bvh.bounds_max[i])
        else:
            stack.append(int(bvh.second_child[i]))
            stack.append(i + 1)
    return (
        np.asarray(offsets, np.int64),
        np.asarray(counts, np.int64),
        np.asarray(bmins, np.float32),
        np.asarray(bmaxs, np.float32),
    )


def decode_top_leaf(code):
    """Top-tree wide leaf code -> treelet id (inverse of the leaf encoding
    with one 'primitive' — a treelet — per leaf). Works on ints and
    integer tensors (floor division, as the reference)."""
    return (-(code + 1)) // _LEAF_STRIDE


def build_treelet_pack_numpy(
    tri_verts_leaf_order: np.ndarray, bvh: BVHArrays, leaf_tris: int = LEAF_TRIS,
    tri_verts1: np.ndarray = None,
) -> dict:
    """The reference's build_treelet_pack as numpy arrays: keys top_bmin,
    top_bmax, top_idx, featT, center, offset, count. tri_verts1 (same
    leaf order): the shutter-end keyframe; each treelet is then centered
    on the union of both keyframes' boxes and its features are the
    64-row cubic-in-time tables of mxu.tri_feature_weights_motion (the
    caller's bvh must be built over the union bounds)."""
    off, cnt, bmin, bmax = cut_treelets(bvh, leaf_tris)
    c = len(off)

    # top tree over treelet AABBs, one treelet per leaf; its prim_order
    # permutes treelets, so reorder the treelet arrays to match
    top_bin = build_bvh(bmin, bmax, method="sah" if c <= 262144 else "hlbvh",
                        max_leaf_prims=1)
    order = top_bin.prim_order
    off, cnt = off[order], cnt[order]
    cmin, cmax, cidx = build_wide_numpy(top_bin)

    verts = np.asarray(tri_verts_leaf_order, np.float32)
    t_total = len(verts)
    gidx = off[:, None] + np.arange(leaf_tris)[None, :]  # (C, L)
    valid = np.arange(leaf_tris)[None, :] < cnt[:, None]
    tv = verts[np.clip(gidx, 0, t_total - 1)]  # (C, L, 3, 3)
    tv[~valid] = 0.0  # zero pad: det == 0, never hits
    if tri_verts1 is not None:
        tv1 = np.asarray(tri_verts1, np.float32)[np.clip(gidx, 0, t_total - 1)]
        tv1[~valid] = 0.0
        both = np.concatenate([tv, tv1], axis=1)
        valid2 = np.tile(valid, (1, 2))[..., None]
        vmin = np.where(valid2, both.min(axis=2), np.inf).min(axis=1)
        vmax = np.where(valid2, both.max(axis=2), -np.inf).max(axis=1)
    else:
        vmin = np.where(valid[..., None], tv.min(axis=2), np.inf).min(axis=1)
        vmax = np.where(valid[..., None], tv.max(axis=2), -np.inf).max(axis=1)
    center = (0.5 * (vmin + vmax)).astype(np.float32)  # (C, 3)
    if tri_verts1 is not None:
        featT = _motion_featT(tv, tv1, center)
    else:
        W = tri_feature_weights_raw(
            tv.reshape(c * leaf_tris, 3, 3), np.repeat(center, leaf_tris, axis=0)[:, None, :],
        ).reshape(c, leaf_tris, 16, 4)
        # (C, L, 16, 4) -> (C, 4, L, 16) -> (C, 4L, 16): rows grouped
        # [det(L) | u*det(L) | v*det(L) | t*det(L)]
        feat = np.ascontiguousarray(W.transpose(0, 3, 1, 2).reshape(c, 4 * leaf_tris, 16))
        featT = np.ascontiguousarray(feat.transpose(0, 2, 1))
    return {
        "top_bmin": cmin,
        "top_bmax": cmax,
        "top_idx": cidx,
        "featT": featT,
        "center": center,
        "offset": np.asarray(off, np.int32),
        "count": np.asarray(cnt, np.int32),
    }


def _motion_featT(tv: np.ndarray, tv1: np.ndarray, center: np.ndarray,
                  group: int = 32) -> np.ndarray:
    """The (C, 64, 4L) motion features of the treelets' (C, L, 3, 3)
    keyframes: mxu.tri_feature_weights_motion per group of treelets on a
    thread per core (numpy drops the GIL in its kernels), each element
    computed as the whole-table call computes it, so the table is the
    reference's bit for bit; the groups bound the f64 temporaries."""
    c, L = tv.shape[:2]
    featT = np.empty((c, 64, 4 * L), np.float32)

    def work(lo):
        hi = min(lo + group, c)
        n = (hi - lo) * L
        W = tri_feature_weights_motion(
            tv[lo:hi].reshape(n, 3, 3), tv1[lo:hi].reshape(n, 3, 3),
            np.repeat(center[lo:hi], L, axis=0)[:, None, :], raw=True,
        ).reshape(hi - lo, L, 64, 4)
        # [c, f, o * L + l] = W[c, l, f, o]: rows grouped [det | u*det | v*det | t*det]
        featT[lo:hi] = W.transpose(0, 2, 3, 1).reshape(hi - lo, 64, 4 * L)

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as ex:
        list(ex.map(work, range(0, c, group)))
    return featT


def pack_from_numpy(tables: dict, device="cpu") -> TreeletPack:
    """Upload build_treelet_pack_numpy's tables (or the same tables taken
    from the reference's TreeletPack) as a TreeletPack on `device`."""

    def t(k):
        return torch.from_numpy(np.array(tables[k], order="C")).to(device)

    return TreeletPack(
        top=WideBVH(t("top_bmin"), t("top_bmax"), t("top_idx")),
        featT=t("featT"),
        center=t("center"),
        offset=t("offset"),
        count=t("count"),
    )
