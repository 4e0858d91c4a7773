#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_pbrt_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. build  — compile every CUDA kernel from tpu_pbrt_torch/csrc/ (nvcc,
     sm_90a, all sources in parallel) and print the build seconds and
     the ptxas register / shared-memory report;
  2. check  — run each kernel against its plain PyTorch version on the
     card, on inputs captured from a real traversal of the killeroo
     scene's first 2^20-ray camera wave (flush at CH=512, F=16; expand
     at S=2^17 in closest-hit and any-hit mode), a synthetic F=64
     (motion feature) flush, and the seeded exact-tie flush chunk of
     kernels/fixtures.py at L=512 (prim must match exactly); print each
     kernel's device time per call (torch.profiler, summed over its
     kernels), the wrapper's host time per call, the plain version's and
     the library call's device time, and the bound;
  3. render — the port's main path: make_killeroo_like() at its full
     mesh, 128x128, 256 spp, maxdepth 5, through compile_scene and
     PathIntegrator.render on the card; the kernel launch counters are
     zeroed just before and read just after; the image must be finite
     and within per-pixel MSE 1e-4 of refimg/killeroo_cpu_128x128_256spp.npz;
  4. summary — one {"kernels": [...]} line, the card's name and power
     limit (nvidia-smi), and as the last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

It imports nothing of JAX or of the JAX package, and it fails without a
CUDA device or outside a checkout of the repo.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
REF_IMAGE = os.path.join(HERE, "refimg", "killeroo_cpu_128x128_256spp.npz")
MSE_BAR = 1e-4

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12  # FP32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12


class SmokeFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout else \
            "nvidia-smi: not available"
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi: not available"


def device_time_ms(fn, reps: int, warmup: int = 2):
    """Device time per call of `fn`: the CUDA kernels (and copies) that
    `reps` calls launch, summed by name from a torch.profiler trace, over
    `reps`. Returns (ms per call, {kernel name: ms per call}). The host's
    work around the launches is not in it (see host_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3 / reps
    total = sum(by_name.values())
    if total <= 0:
        raise SmokeFailure("the profiler recorded no device time")
    return total, by_name


def host_ms(fn, reps: int, warmup: int = 2) -> float:
    """Wall time per call on the host: what the caller waits for before it
    can enqueue the next operation (the launches themselves run on)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def _by_kernel(parts) -> str:
    """'name ms' per kernel, the longest first; a C++ name is cut to the
    function and its template arguments."""
    import re

    def short(name):
        m = re.search(r"(\w+(?:<[^>]*>)?)\(", name.replace("(anonymous namespace)::", ""))
        return m.group(1) if m else name[:48]

    return ", ".join(f"{short(k)} {v:.4f}" for k, v in sorted(parts.items(), key=lambda kv: -kv[1]))


# -- phase 1 -------------------------------------------------------------------

def phase_build() -> None:
    from tpu_pbrt_torch.kernels import build

    t0 = time.perf_counter()
    secs = build.build_all()
    log(f"[build] nvcc per source (parallel): "
        f"{ {k: round(v, 2) for k, v in secs.items()} }  total {time.perf_counter() - t0:.2f} s")
    for name in build.SOURCES:
        rep = os.path.join(build.BUILD_DIR, f"{name}.ptxas.txt")
        if os.path.exists(rep):
            for line in open(rep).read().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")
    for name in build.SOURCES:
        build.load(name)


# -- phase 2 -------------------------------------------------------------------

def _capture_wave_inputs(scene, integ):
    """Trace the first camera wave of the render (closest hit), recording
    the inputs of its first flush chunk and of its first expand step
    after that flush (a popped slab of mixed nodes). The any-hit expand
    input is that same slab with any_hit set and the wave's final hits
    on every other ray as the prim row, so the kernel's done-ray cull
    sees real data."""
    import torch

    from tpu_pbrt_torch.accel import stream

    dev = scene.dev
    plan = integ.prepare_chunks(scene)
    chunk = plan["chunk"]
    x0, x1, y0, _ = plan["bounds"]
    k = torch.arange(chunk, dtype=torch.int32, device=scene.device)
    _, _, _, _, _, o, d, _ = integ.work_to_rays(
        scene.camera, plan["spp"], x0, y0, x1 - x0, plan["npix"], 0, 0, k
    )
    cap = {}
    real_expand, real_flush = stream.expand, stream.flush_chunk
    n_flush = [0]

    def clone(args):
        return tuple(a.clone() if torch.is_tensor(a) else a for a in args)

    def expand_hook(*args):
        if "expand" not in cap and n_flush[0] > 0:
            cap["expand"] = clone(args)
        return real_expand(*args)

    def flush_hook(*args):
        n_flush[0] += 1
        if "flush" not in cap:  # the wave's first chunk: CH = min(512, block capacity)
            cap["flush"] = clone(args)
        return real_flush(*args)

    stream.expand, stream.flush_chunk = expand_hook, flush_hook
    try:
        hit = stream.stream_intersect(dev["tstream"], dev["tri_verts"], o, d, float("inf"),
                                      tv9T=dev["tri_verts9T"])
    finally:
        stream.expand, stream.flush_chunk = real_expand, real_flush
    missing = {"flush", "expand"} - set(cap)
    if missing:
        raise SmokeFailure(f"could not capture kernel inputs for {sorted(missing)}")
    ea = cap["expand"]
    # every other ray keeps its final hit (culled as done), the rest are open
    rid = torch.arange(hit.prim.shape[0], device=hit.prim.device)
    prim = torch.where(rid % 2 == 0, hit.prim, torch.full_like(hit.prim, -1)).contiguous()
    cap["expand_anyhit"] = ea[:3] + (prim,) + ea[4:7] + (True,)
    return cap, o, d


def _motion_table(scene, flush_args):
    """A 64-feature (cubic-in-time) table over the scene's own treelets:
    every triangle moves by a small seeded offset over the shutter."""
    import numpy as np
    import torch

    from tpu_pbrt_torch.accel.mxu import tri_feature_weights_motion

    tp = scene.dev["tstream"]
    L = tp.leaf_tris
    off = tp.offset.cpu().numpy().astype(np.int64)
    cnt = tp.count.cpu().numpy()
    verts = scene.dev["tri_verts"].cpu().numpy()[: scene.n_tris]
    gidx = off[:, None] + np.arange(L)[None, :]
    valid = np.arange(L)[None, :] < cnt[:, None]
    tv0 = verts[np.clip(gidx, 0, len(verts) - 1)]
    tv0[~valid] = 0.0
    rng = np.random.default_rng(64)
    tv1 = (tv0 + rng.uniform(-0.01, 0.01, tv0.shape) * valid[..., None, None]).astype(np.float32)
    C = len(off)
    W = tri_feature_weights_motion(
        tv0.reshape(-1, 3, 3), tv1.reshape(-1, 3, 3),
        np.repeat(tp.center.cpu().numpy(), L, axis=0)[:, None, :], raw=True,
    ).reshape(C, L, 64, 4)
    featT = np.ascontiguousarray(W.transpose(0, 3, 1, 2).reshape(C, 4 * L, 64).transpose(0, 2, 1))
    feat, meta, rows, rayF, t_row, prim = flush_args
    rayF = rayF.clone()
    rayF[7] = torch.from_numpy(rng.uniform(0, 1, rayF.shape[1]).astype(np.float32)).to(rayF.device)
    return (torch.from_numpy(featT).to(rayF.device), meta, rows, rayF, t_row, prim)


def _compare_flush(a, b, label):
    """t to 2 ulp; prim exact except at near-ties (t within 1e-6
    relative), which must stay under 0.1% of the rays."""
    import numpy as np

    tk, pk = a[0].cpu().numpy(), a[1].cpu().numpy()
    tp_, pp = b[0].cpu().numpy(), b[1].cpu().numpy()
    if not np.array_equal(np.isfinite(tk), np.isfinite(tp_)):
        raise SmokeFailure(f"{label}: hit sets differ")
    fin = np.isfinite(tk)
    ulp = np.abs(tk.view(np.int32).astype(np.int64) - tp_.view(np.int32).astype(np.int64))
    ulp = np.where(tk == tp_, 0, ulp)
    flips = pk != pp
    with np.errstate(invalid="ignore"):
        near = np.abs(tk.astype(np.float64) - tp_) <= 1e-6 * np.abs(tk.astype(np.float64))
    err = float(np.max(np.abs(tk[fin] - tp_[fin]))) if fin.any() else 0.0
    log(f"[check] {label}: rays {len(tk)}, updated {int((pk >= 0).sum())}, max ulp {int(ulp.max())}, "
        f"max |dt| {err:.3e}, prim flips {int(flips.sum())} (all near-ties: {bool((near | ~flips).all())})")
    if ulp.max() > 2 or not (near | ~flips).all() or flips.sum() > 0.001 * len(pk):
        raise SmokeFailure(f"{label}: kernel disagrees with its plain version")
    return err


def _flush_bound(args, count):
    """Least time for one flush chunk: the FP32 FMAs that its data needs
    (each filled slot of a live block against its treelet's count[tid]
    real triangles, not the zero padding up to L) vs the bytes it must
    move (those triangles' features once per distinct treelet, the block
    tables, the filled slots' ray columns, the (R,) winners in and out)."""
    feat, meta, rows, rayF, t_row, _ = args
    _, F, _ = feat.shape
    live = meta[:, 5] > 0
    tids = meta[:, 0].long()
    count = count.to(tids.device).long()
    n_filled = ((rows >= 0) & live[:, None]).sum(dim=1)
    flops = 2.0 * F * 4 * float((count[tids] * n_filled).sum())
    tris = float(count[tids[live].unique()].sum())  # distinct treelets, real triangles
    R = rayF.shape[1]
    nbytes = (tris * F * 4 * 4 + meta.numel() * 4 + rows.numel() * 4
              + float(n_filled.sum()) * (6 if F == 16 else 7) * 4 + 16 * R)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _flush_bound_padded(args):
    """The padded figure, kept to compare with earlier records: FP32 FMAs of
    every slot of the live blocks against all L triangle slots, zero
    padding included, vs the bytes (the distinct treelets' whole feature
    blocks once, the block tables, the slots' ray columns, the (R,)
    winners in and out)."""
    feat, meta, rows, rayF, t_row, _ = args
    _, F, four_l = feat.shape
    live = meta[:, 5] > 0
    n_live = int(live.sum())
    flops = 2.0 * F * four_l * 128 * n_live
    n_tl = int(meta[live, 0].unique().numel())
    n_slots = int(((rows >= 0) & live[:, None]).sum())
    R = rayF.shape[1]
    nbytes = (n_tl * F * four_l * 4 + meta.numel() * 4 + rows.numel() * 4
              + n_slots * (6 if F == 16 else 7) * 4 + 16 * R)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _expand_bound(args):
    """Least time for one expand step: the popped pairs, their ray rows,
    the node table once, and the (8, S) x 2 + (S,) outputs."""
    key_in, node, rayE, prim, box48, cid, tb, any_hit = args
    S, N = key_in.shape[0], box48.shape[1]
    nbytes = S * 8 + S * 7 * 4 + (S * 4 if any_hit else 0) + 56 * N * 4 + S * 17 * 4
    flops = S * 8 * 24.0  # slab tests: 3 axes x (2 sub, 3 mul, 2 select/min) per child
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _check_tie_fixture(flush_chunk, flush_chunk_plain):
    """The seeded exact-tie chunk (kernels/fixtures.py) at the main path's
    treelet size L = 512: t as _compare_flush holds it, and prim EXACTLY
    equal — these are exact ties, decided by block order and then the
    lowest local index, so no near-tie leniency applies."""
    import torch

    from tpu_pbrt_torch.kernels.fixtures import flush_inputs

    for F in (16, 64):
        args = tuple(torch.from_numpy(x).cuda() for x in flush_inputs(F, L=512))
        a, b = flush_chunk(*args), flush_chunk_plain(*args)
        _compare_flush(a, b, f"tie fixture F={F} L=512")
        same = torch.equal(a[1], b[1])
        log(f"[check] tie fixture F={F} L=512: prim exact: {same} "
            f"(duplicate triangle -> 2: {int((a[1][:8] == 2).sum())}/8)")
        if not same:
            raise SmokeFailure(f"tie fixture F={F}: prim differs from the plain version")


def phase_check(scene, integ):
    import torch

    from tpu_pbrt_torch.kernels.expand import expand, expand_plain
    from tpu_pbrt_torch.kernels.flush import flush_chunk, flush_chunk_plain

    t0 = time.perf_counter()
    cap, _, _ = _capture_wave_inputs(scene, integ)
    log(f"[check] captured kernel inputs from a {cap['flush'][3].shape[1]}-ray camera wave "
        f"in {time.perf_counter() - t0:.2f} s")
    out = {}
    _check_tie_fixture(flush_chunk, flush_chunk_plain)

    # flush, F = 16 (the main path)
    fa = cap["flush"]
    CH = fa[1].shape[0]
    err16 = _compare_flush(flush_chunk(*fa), flush_chunk_plain(*fa), f"flush F=16 CH={CH}")
    ms, parts = device_time_ms(lambda: flush_chunk(*fa), reps=20)
    h_ms = host_ms(lambda: flush_chunk(*fa), reps=20)
    plain_ms, _ = device_time_ms(lambda: flush_chunk_plain(*fa), reps=3, warmup=1)
    tids = fa[1][:, 0].long()
    n_live = int((fa[1][:, 5] > 0).sum())
    phiT = torch.randn(fa[1].shape[0], 128, 16, device=fa[0].device)
    featg = fa[0][tids].contiguous()
    lib_ms, lib_parts = device_time_ms(lambda: torch.bmm(phiT, featg), reps=10)
    del phiT, featg
    count = scene.dev["tstream"].count
    bound, by = _flush_bound(fa, count)
    padded, _ = _flush_bound_padded(fa)
    log(f"[check] flush F=16: kernel {ms:.4f} ms device ({_by_kernel(parts)}), host {h_ms:.4f} ms "
        f"per call, plain {plain_ms:.4f} ms, torch.bmm contraction {lib_ms:.4f} ms "
        f"({_by_kernel(lib_parts)}), bound {bound:.4f} ms ({by}; {padded:.4f} with the zero "
        f"padding); live blocks {n_live}")
    out["flush_chunk"] = dict(max_abs_err=err16, ms=ms, host_ms=h_ms, plain_ms=plain_ms,
                              bound_ms=bound, bound_by=by, bound_padded_ms=padded,
                              library_ms=lib_ms)

    # flush, F = 64 (motion features; off the render path)
    t1 = time.perf_counter()
    fm = _motion_table(scene, fa)
    err64 = _compare_flush(flush_chunk(*fm), flush_chunk_plain(*fm), f"flush F=64 CH={CH}")
    ms64, parts64 = device_time_ms(lambda: flush_chunk(*fm), reps=10)
    bound64, by64 = _flush_bound(fm, count)
    padded64, _ = _flush_bound_padded(fm)
    log(f"[check] flush F=64: kernel {ms64:.4f} ms device ({_by_kernel(parts64)}), bound "
        f"{bound64:.4f} ms ({by64}; {padded64:.4f} with the zero padding) "
        f"(table built in {time.perf_counter() - t1:.1f} s)")
    out["flush_chunk"]["max_abs_err"] = max(err16, err64)
    del fm

    # expand, closest-hit and any-hit (S = slab = 2^17 at R = 2^20)
    for key in ("expand", "expand_anyhit"):
        ea = cap[key]
        a, b = expand(*ea), expand_plain(*ea)
        same = all(torch.equal(x, y) for x, y in zip(a, b))
        S = ea[0].shape[0]
        log(f"[check] {key}: S {S}, any_hit {ea[7]}, live pairs {int(a[2].sum())}, exact: {same}")
        if not same:
            raise SmokeFailure(f"{key}: kernel disagrees with its plain version")
    ea = cap["expand"]
    ms, _ = device_time_ms(lambda: expand(*ea), reps=50)
    h_ms = host_ms(lambda: expand(*ea), reps=50)
    plain_ms, _ = device_time_ms(lambda: expand_plain(*ea), reps=10)
    bound, by = _expand_bound(ea)
    log(f"[check] expand: kernel {ms:.4f} ms device, host {h_ms:.4f} ms per call, plain "
        f"{plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    out["expand"] = dict(max_abs_err=0.0, ms=ms, host_ms=h_ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by=by, library_ms=None)
    del cap
    torch.cuda.empty_cache()
    return out


# -- phase 3 -------------------------------------------------------------------

def phase_render(scene, integ):
    import numpy as np

    from tpu_pbrt_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    res = integ.render(scene)
    launches = dict(LAUNCHES)
    img = res.image
    ref = np.load(REF_IMAGE)["image"]
    if img.shape != ref.shape or not np.isfinite(img).all():
        raise SmokeFailure(f"render: image shape {img.shape} / finite {np.isfinite(img).all()}")
    mse = float(np.mean((img.astype(np.float64) - ref) ** 2))
    log(f"[render] 128x128 256 spp maxdepth 5: {res.seconds:.3f} s, {res.rays_traced} rays, "
        f"{res.mray_per_sec:.4f} Mray/s, image mean {img.mean():.6f} (ref {ref.mean():.6f}), "
        f"MSE vs ref {mse:.3e} (bar {MSE_BAR:g})")
    log(f"[render] stats {json.dumps(res.stats)}")
    log(f"[render] kernel launches {json.dumps(launches)}")
    if mse > MSE_BAR:
        raise SmokeFailure(f"render: MSE {mse:.3e} > {MSE_BAR:g}")
    for name, n in launches.items():
        if n <= 0:
            raise SmokeFailure(f"render: kernel {name} was never launched on the main path")
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "tpu_pbrt_torch")) or not os.path.exists(REF_IMAGE):
        print("chip_smoke: run from a checkout of the repo (tpu_pbrt_torch/ and refimg/ "
              "must sit beside this script)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    try:
        card = card_line()
        log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]}; {card}")
        t0 = time.perf_counter()
        phase_build()

        from tpu_pbrt_torch.scenes import compile_api, make_killeroo_like

        t1 = time.perf_counter()
        api = make_killeroo_like(res=128, spp=256, maxdepth=5, device="cuda")
        scene, integ = compile_api(api)
        log(f"[scene] killeroo: {scene.n_tris} triangles, {scene.dev['tstream'].n_treelets} "
            f"treelets of {scene.dev['tstream'].leaf_tris}, compiled in {time.perf_counter() - t1:.2f} s")

        kt = phase_check(scene, integ)
        launches = phase_render(scene, integ)
        kernels = [
            dict(name="flush_chunk", route="cuda", source="tpu_pbrt_torch/csrc/flush.cu",
                 replaces="tpu_pbrt/accel/fusedwave.py:211", launches=launches["flush_chunk"],
                 **kt["flush_chunk"]),
            dict(name="expand", route="cuda", source="tpu_pbrt_torch/csrc/expand.cu",
                 replaces="tpu_pbrt/accel/fusedwave.py:348", launches=launches["expand"],
                 **kt["expand"]),
        ]
        log(f"[done] total {time.perf_counter() - t0:.1f} s")
        print(json.dumps({"kernels": kernels}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    except Exception as e:  # noqa: BLE001 - every phase failure is fatal
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
