"""A seeded flush chunk with exact ties, for holding a flush kernel against
its plain version (numpy only: the CPU tests and chip_smoke.py share it).

`flush_inputs(F, L)` builds C=4 treelets of L triangles, CH=6 leaf blocks
(one dead, -1 slots) and R=300 rays, with two kinds of exact t tie:
- triangle L-3 of treelet 0 repeats triangle 2, so the two copies sit at
  both ends of the treelet and on both sides of any split of its
  triangles across warps or thread blocks; the lowest local index (2)
  must win;
- treelet 3 is a copy of treelet 1 (same features and center, another
  prim offset) and blocks 1 and 3 hold the same rays; the earlier block
  (prim offsets [L, 2L)) must win.

The tie rays start 1e-4 off their target triangle: at L = 512 the
treelet's triangles crowd the same box, and from 1e-3 off a neighbour
lies in front of triangle 2 for all 8 of its rays at F = 16. Treelet 3's
prim offset is 11 L so that the treelets' prim ranges stay disjoint at
every L.
"""

from __future__ import annotations

import numpy as np

from tpu_pbrt_torch.accel.mxu import tri_feature_weights_motion, tri_feature_weights_raw


def flush_inputs(F: int, L: int = 64, seed: int = 3):
    """(featT, meta, rid_rows, rayF, t_row, prim) as numpy arrays, on the
    flush kernel's interface (see kernels/flush.py)."""
    if L < 8:
        raise ValueError(f"flush_inputs: L must be at least 8, got {L}")
    rng = np.random.default_rng(seed)
    C, R, CH = 4, 300, 6
    dup = L - 3  # the copy of triangle 2 of treelet 0
    centers = rng.uniform(-1.0, 1.0, (C, 3)).astype(np.float32)
    v0 = (centers[:, None, None, :] + rng.uniform(-0.6, 0.6, (C, L, 3, 3))).astype(np.float32)
    v0[0, dup] = v0[0, 2]
    v0[3] = v0[1]
    centers[3] = centers[1]
    if F == 16:
        W = tri_feature_weights_raw(v0.reshape(C * L, 3, 3),
                                    np.repeat(centers, L, axis=0)[:, None, :])
        W = W.reshape(C, L, 16, 4)
    elif F == 64:
        v1 = (v0 + rng.uniform(-0.05, 0.05, v0.shape)).astype(np.float32)
        v1[0, dup] = v1[0, 2]
        v1[3] = v1[1]
        W = tri_feature_weights_motion(
            v0.reshape(C * L, 3, 3), v1.reshape(C * L, 3, 3),
            np.repeat(centers, L, axis=0)[:, None, :], raw=True,
        ).reshape(C, L, 64, 4)
    else:
        raise ValueError(f"flush_inputs: F must be 16 or 64, got {F}")
    featT = np.ascontiguousarray(W.transpose(0, 3, 1, 2).reshape(C, 4 * L, F).transpose(0, 2, 1))
    offset = np.array([0, L, 2 * L, 11 * L], np.int32)

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
    o[:48] = tgt[:48] + 1e-4 * n_t
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
