"""Ray-triangle intersection and the binary BVH walker (port of
tpu_pbrt/accel/traverse.py).

- `intersect_triangle`: pbrt's watertight shear test (translate to the
  ray origin, permute the largest |d| axis to z, shear, signed edge
  functions, scaled depth test), broadcasting over leading axes;
- `brute_force_intersect`: the closest hit over every triangle, chunked
  (the tests' oracle);
- `bvh_intersect` / `bvh_intersect_p`: BVHAccel::Intersect / IntersectP,
  the per-ray walk of the flattened binary BVH with a 64-entry stack and
  dir-sign near/far child order (`TORCH_PBRT_BVH=binary`).

The reference vmaps a scalar `lax.while_loop` over the batch; here the
loop is one masked step over every ray of the batch, repeated until no
ray is left. The exit test reads one flag back to the host, once every
`CHECK_EVERY` steps (a step of a finished ray changes nothing), and
`WALKS` counts those reads per wave. Products fused into the sum that
consumes them are rounded once (`xla_math.fmac`), as the reference's
compiled program rounds them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from tpu_pbrt_torch.accel.build import MAX_LEAF_PRIMS
from tpu_pbrt_torch.core.xla_math import fmac

MAX_STACK = 64
# float32 machine epsilon / 2 (pbrt MachineEpsilon) and pbrt's gamma(3)
_MACHINE_EPS = 5.960464477539063e-08
_BOX_EPS = 1.0 + 2.0 * ((3 * _MACHINE_EPS) / (1 - 3 * _MACHINE_EPS))

#: rays per walker dispatch (the reference's cap on its vmapped walks)
MAX_RAYS_PER_DISPATCH = 1 << 18
#: masked walker steps between two host reads of the loop's exit flag
CHECK_EVERY = 8


class Hit(NamedTuple):
    t: torch.Tensor  # (R,) f32, inf on a miss (t_max under the binary and wide walkers)
    prim: torch.Tensor  # (R,) i32 leaf-order triangle id, -1 on miss
    b0: torch.Tensor  # (R,) barycentric weight of v0
    b1: torch.Tensor  # (R,) barycentric weight of v1
    tv: Optional[torch.Tensor] = None  # (R, 3, 3) hit triangle's vertices


class WalkTally:
    """Per-wave counts of the walkers' loops: waves, masked steps and the
    host reads of their exit tests (the counterpart of the stream
    tracer's `WAVES` tally)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.waves = 0
        self.steps = 0
        self.host_reads = 0

    def add(self, steps: int, host_reads: int) -> None:
        self.waves += 1
        self.steps += int(steps)
        self.host_reads += int(host_reads)

    def stats(self) -> dict:
        w = max(self.waves, 1)
        return {"waves": self.waves, "steps": self.steps, "host_reads": self.host_reads,
                "host_reads_per_wave": self.host_reads / w}


WALKS = WalkTally()


def walk_loop(step, alive, state, max_steps: int):
    """Run `state = step(state)` until `alive(state)` (a bool tensor) has
    no True entry or `max_steps` steps ran, reading the exit flag back to
    the host once every CHECK_EVERY steps. Returns (state, steps, reads)."""
    steps = reads = 0
    while steps < max_steps:
        reads += 1
        if not bool(alive(state).any()):  # torchlint: disable=JL-SYNC (the walk's loop test)
            break
        for _ in range(min(CHECK_EVERY, max_steps - steps)):
            state = step(state)
            steps += 1
    return state, steps, reads


def _take_along(a, idx):
    """a[..., idx] along the last axis with idx broadcast to a's shape."""
    shp = torch.broadcast_shapes(a.shape, idx.shape)
    return torch.gather(a.expand(shp), -1, idx.expand(shp))


def intersect_triangle(o, d, p0, p1, p2, t_max):
    """Watertight ray-triangle test; broadcasts over leading axes.
    Returns (hit_mask, t, b0, b1)."""
    p0t = p0 - o
    p1t = p1 - o
    p2t = p2 - o
    # permute so |d| is largest along z (the first maximum wins, as argmax)
    kz = torch.argmax(torch.abs(d), dim=-1)
    kx = (kz + 1) % 3
    ky = (kx + 1) % 3
    perm = torch.stack([kx, ky, kz], dim=-1)
    dp = _take_along(d, perm)
    p0t = _take_along(p0t, perm)
    p1t = _take_along(p1t, perm)
    p2t = _take_along(p2t, perm)
    inv_dz = 1.0 / dp[..., 2]
    sx = -dp[..., 0] * inv_dz
    sy = -dp[..., 1] * inv_dz
    x0 = fmac(sx, p0t[..., 2], p0t[..., 0])
    y0 = fmac(sy, p0t[..., 2], p0t[..., 1])
    x1 = fmac(sx, p1t[..., 2], p1t[..., 0])
    y1 = fmac(sy, p1t[..., 2], p1t[..., 1])
    x2 = fmac(sx, p2t[..., 2], p2t[..., 0])
    y2 = fmac(sy, p2t[..., 2], p2t[..., 1])
    e0 = fmac(x1, y2, -(y1 * x2))
    e1 = fmac(x2, y0, -(y2 * x0))
    e2 = fmac(x0, y1, -(y0 * x1))
    det = e0 + e1 + e2
    same_sign = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | ((e0 <= 0) & (e1 <= 0) & (e2 <= 0))
    z0 = inv_dz * p0t[..., 2]
    z1 = inv_dz * p1t[..., 2]
    z2 = inv_dz * p2t[..., 2]
    t_scaled = fmac(e2, z2, fmac(e0, z0, e1 * z1))
    tmd = t_max * det
    in_range = torch.where(det < 0, (t_scaled < 0) & (t_scaled >= tmd),
                           (t_scaled > 0) & (t_scaled <= tmd))
    hit = same_sign & (det != 0) & in_range
    inv_det = 1.0 / torch.where(det == 0, torch.ones_like(det), det)
    return hit, t_scaled * inv_det, e0 * inv_det, e1 * inv_det


def _t_max_rows(o, t_max):
    return torch.broadcast_to(torch.as_tensor(t_max, dtype=torch.float32, device=o.device),
                              o.shape[:-1]).contiguous()


def brute_force_intersect(tri_verts, o, d, t_max, chunk: int = 4096) -> Hit:
    """Oracle: the closest hit over all triangles, chunked over T.
    o, d: (R, 3); tri_verts: (T, 3, 3). A miss keeps t = t_max."""
    n_tris = tri_verts.shape[0]
    r = o.shape[0]
    t_best = _t_max_rows(o, t_max).clone()
    prim_best = torch.full((r,), -1, dtype=torch.int32, device=o.device)
    b0_best = torch.zeros(r, dtype=torch.float32, device=o.device)
    b1_best = torch.zeros_like(b0_best)
    rr = torch.arange(r, dtype=torch.int64, device=o.device)
    for start in range(0, n_tris, chunk):
        tv = tri_verts[start:start + chunk]
        hit, t, b0, b1 = intersect_triangle(o[:, None, :], d[:, None, :], tv[None, :, 0],
                                            tv[None, :, 1], tv[None, :, 2], t_best[:, None])
        t = torch.where(hit, t, torch.full_like(t, float("inf")))
        k = torch.argmin(t, dim=1)
        tk = t[rr, k]
        better = tk < t_best
        t_best = torch.where(better, tk, t_best)
        prim_best = torch.where(better, (start + k).to(torch.int32), prim_best)
        b0_best = torch.where(better, b0[rr, k], b0_best)
        b1_best = torch.where(better, b1[rr, k], b1_best)
    return Hit(t_best, prim_best, b0_best, b1_best)


def slab_test(nmin, nmax, o, inv_d, t_far):
    """Conservative watertight ray/AABB slab test shared by every walker:
    nmin/nmax (..., 3) box bounds, o/inv_d (..., 3) broadcastable rays,
    t_far (...) the far clip. Returns (t_near, t_far, hit) with t_near >= 0,
    the far distance widened by gamma(3), and the 0 * inf NaN taken as
    inside the slab (pbrt's comparison order)."""
    neg = inv_d < 0
    lo = torch.where(neg, nmax, nmin)
    hi = torch.where(neg, nmin, nmax)
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d * _BOX_EPS
    t0 = torch.where(torch.isnan(t0), torch.full_like(t0, -float("inf")), t0)
    t1 = torch.where(torch.isnan(t1), torch.full_like(t1, float("inf")), t1)
    tn = torch.clamp(t0.amax(dim=-1), min=0.0)
    tf = torch.minimum(t1.amin(dim=-1), t_far)
    return tn, tf, tn <= tf


class _TravState(NamedTuple):
    node: torch.Tensor
    sp: torch.Tensor
    stack: torch.Tensor  # (R, MAX_STACK + 1): the last column takes no-op writes
    t: torch.Tensor
    prim: torch.Tensor
    b0: torch.Tensor
    b1: torch.Tensor
    done: torch.Tensor


def _ray_traverse(bvh: dict, tri_verts, o, d, t_max, any_hit: bool) -> Hit:
    """The binary walk of every ray of the batch at once: one masked step
    per loop iteration, a finished ray's state held."""
    R = o.shape[0]
    dev = o.device
    inv_d = 1.0 / d
    dir_neg = inv_d < 0
    n_tris = tri_verts.shape[0]
    rows = torch.arange(R, dtype=torch.int64, device=dev)
    bmin, bmax = bvh["bounds_min"], bvh["bounds_max"]
    n_prims_t, off_t = bvh["n_prims"], bvh["prim_offset"]
    second_t, axis_t = bvh["second_child"], bvh["axis"]

    def step(s: _TravState) -> _TravState:
        node = s.node.long()
        hit_box = slab_test(bmin[node], bmax[node], o, inv_d, s.t)[2]
        n_prims = n_prims_t[node]
        is_leaf = n_prims > 0
        test_leaf = hit_box & is_leaf & ~s.done
        t_new, prim_new, b0_new, b1_new = s.t, s.prim, s.b0, s.b1
        off = off_t[node]
        for k in range(MAX_LEAF_PRIMS):
            pidx = torch.clamp(off + k, max=n_tris - 1)
            tri = tri_verts[pidx.long()]
            h, th, b0h, b1h = intersect_triangle(o, d, tri[:, 0], tri[:, 1], tri[:, 2], t_new)
            take = test_leaf & (k < n_prims) & h
            t_new = torch.where(take, th, t_new)
            prim_new = torch.where(take, pidx, prim_new)
            b0_new = torch.where(take, b0h, b0_new)
            b1_new = torch.where(take, b1h, b1_new)
        live = ~s.done
        go_down = hit_box & ~is_leaf & live
        ax = axis_t[node].long()
        neg = dir_neg[rows, ax]
        second = second_t[node]
        first_c = torch.where(neg, second, s.node + 1)
        second_c = torch.where(neg, s.node + 1, second)
        col = torch.where(go_down, s.sp, torch.full_like(s.sp, MAX_STACK)).long()
        stack = s.stack.clone()
        stack[rows, col] = second_c
        sp_push = torch.where(go_down, s.sp + 1, s.sp)
        exhausted = sp_push == 0
        sp_pop = torch.clamp(sp_push - 1, min=0)
        popped = stack[rows, sp_pop.long()]
        next_node = torch.where(go_down, first_c, popped)
        next_sp = torch.where(go_down, sp_push, sp_pop)
        done = torch.where(go_down, torch.zeros_like(exhausted), exhausted)
        if any_hit:
            done = done | (prim_new >= 0)
        return _TravState(torch.where(live, next_node, s.node), torch.where(live, next_sp, s.sp),
                          stack, t_new, prim_new, b0_new, b1_new, s.done | (live & done))

    init = _TravState(
        node=torch.zeros(R, dtype=torch.int32, device=dev),
        sp=torch.zeros(R, dtype=torch.int32, device=dev),
        stack=torch.zeros((R, MAX_STACK + 1), dtype=torch.int32, device=dev),
        t=t_max.clone(),
        prim=torch.full((R,), -1, dtype=torch.int32, device=dev),
        b0=torch.zeros(R, dtype=torch.float32, device=dev),
        b1=torch.zeros(R, dtype=torch.float32, device=dev),
        done=torch.zeros(R, dtype=torch.bool, device=dev),
    )
    out, steps, reads = walk_loop(step, lambda s: ~s.done, init, 1 << 20)
    WALKS.add(steps, reads)
    return Hit(out.t, out.prim, out.b0, out.b1)


def _dispatch(fn, o, d, t_max):
    """fn over slices of at most MAX_RAYS_PER_DISPATCH rays."""
    t_max = _t_max_rows(o, t_max)
    R = o.shape[0]
    if R <= MAX_RAYS_PER_DISPATCH:
        return fn(o, d, t_max)
    parts = [fn(o[i:i + MAX_RAYS_PER_DISPATCH], d[i:i + MAX_RAYS_PER_DISPATCH],
                t_max[i:i + MAX_RAYS_PER_DISPATCH]) for i in range(0, R, MAX_RAYS_PER_DISPATCH)]
    return Hit(*(torch.cat(x) for x in zip(*(p[:4] for p in parts))))


def bvh_intersect(bvh: dict, tri_verts, o, d, t_max) -> Hit:
    """Closest hit for a ray batch. bvh: bvh_as_device_dict's tensors;
    o, d: (R, 3); t_max: scalar or (R,). A miss keeps t = t_max."""
    return _dispatch(lambda oo, dd, tt: _ray_traverse(bvh, tri_verts, oo, dd, tt, False),
                     o, d, t_max)


def bvh_intersect_p(bvh: dict, tri_verts, o, d, t_max) -> torch.Tensor:
    """Any-hit (shadow ray) predicate for a ray batch -> bool (R,)."""
    hit = _dispatch(lambda oo, dd, tt: _ray_traverse(bvh, tri_verts, oo, dd, tt, True),
                    o, d, t_max)
    return hit.prim >= 0


def bvh_as_device_dict(bvh_arrays) -> dict:
    """BVHArrays -> the binary walker's numpy tables. Fails loudly if the
    tree is deeper than the walker's fixed stack."""
    n_prims = np.asarray(bvh_arrays.n_prims)
    second = np.asarray(bvh_arrays.second_child)
    n = n_prims.shape[0]
    depth = np.ones(n, np.int64)
    # DFS layout: children have larger ids. Interior nodes are n_prims == 0
    # with a forward second-child pointer; the Morton build also emits empty
    # padded leaves (n_prims == 0, second == 0, inf/-inf bounds) which the
    # traversal never descends — skip them here the same way.
    for i in range(n - 1, -1, -1):
        if n_prims[i] == 0 and second[i] > i and i + 1 < n:
            depth[i] = 1 + max(depth[i + 1], depth[second[i]])
    if int(depth[0]) > MAX_STACK:
        raise ValueError(
            f"binary BVH depth {int(depth[0])} exceeds MAX_STACK={MAX_STACK}; "
            "raise MAX_STACK in accel/traverse.py"
        )
    return {
        "bounds_min": np.asarray(bvh_arrays.bounds_min, np.float32),
        "bounds_max": np.asarray(bvh_arrays.bounds_max, np.float32),
        "prim_offset": np.asarray(bvh_arrays.prim_offset, np.int32),
        "n_prims": np.asarray(bvh_arrays.n_prims, np.int32),
        "second_child": np.asarray(bvh_arrays.second_child, np.int32),
        "axis": np.asarray(bvh_arrays.axis, np.int32),
    }
