#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_pbrt_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. build  — compile every CUDA kernel from tpu_pbrt_torch/csrc/ (nvcc,
     sm_90a, all sources in parallel) and print the build seconds and
     the ptxas register / shared-memory report;
  2. check  — run each kernel against its plain PyTorch version on the
     card, on inputs captured from two real traversals of the killeroo
     scene: the persistent pool's 2^19-ray fused camera+shadow wave (the
     main path's shape: wave 1 of the middle chunk, the first wave whose
     shadow half carries rays with a finite t_max; flush F=16; expand at
     S=2^17 with 10 entry-distance key bits, closest-hit), and the fixed
     batch's first 2^20-ray camera wave
     (flush F=16; expand in closest-hit and any-hit mode); a synthetic
     F=64 (motion feature) flush on that wave's chunk with random ray
     times (its plain version's and torch.bmm's times beside it, under
     "synthetic_f64"), and the seeded exact-tie flush chunk of
     kernels/fixtures.py at L=512 (prim must match exactly); print each
     kernel's device time per call (torch.profiler, summed over its
     kernels), the wrapper's host time per call, the plain version's and
     the library call's device time, and the bound;
  3. render — the port's main path: make_killeroo_like() at its full
     mesh, 128x128, 256 spp, maxdepth 5, through compile_scene and
     PathIntegrator.render on the card, through the persistent pool
     (chunks of 2^20 work items, 2^18 slots); the kernel launch counters
     are zeroed just before and read just after; the image must be finite
     and within per-pixel MSE 1e-4 of refimg/killeroo_cpu_128x128_256spp.npz.
     Then the same render through the fixed batch (TORCH_PBRT_REGEN=0's
     path), its launches counted the same way, which must trace the same
     rays; and both paths at 64x64, 16 spp, whose images must agree
     within rtol 1e-4 / atol 1e-5 with equal rays;
  4. crown  — the crown-class path: make_crown_like() at its full
     geometry (1,153,682 triangles in 3,279 treelets under a 1,079-node
     top tree; glass, two metal-GGX pieces, a matte ground, the HDR sky
     as an infinite light) at 512x512:
     [scene] its sizes and compile seconds, and the 64x128 sky (not the
     constant fallback map);
     [check] both kernels against their plain versions on the pool's
     wave 1 of the middle chunk (2^19 rays: the packed flush key) and on
     the fixed batch's first 2^20-ray camera wave of the middle chunk
     (the unpacked 2-array sort), EXACT: t 0 ulp, no prim flip; the
     expand bit-exact in closest-hit and any-hit mode; times and bounds
     as in phase 2;
     [branch] that camera wave's rays traced as one 2^20-ray wave
     (unpacked key) and as two 2^19-ray waves (packed key): the same
     (t, prim) bits, no pair dropped;
     [render] the pool at 64x64, 64 spp, maxdepth 5 against the JAX
     package's CPU render tests/torch_golden/crown_cpu_64x64_64spp.npz
     (MSE bar 1e-4, finite, no pair dropped), the fixed batch at the same
     size (the same rays; images within rtol 1e-4 / atol 1e-5), and the
     512x512 crown at CROWN_SPP (16) through the pool, its kernel launches
     counted as in phase 3;
  5. direct — the direct-lighting family (fixed batch, shadow rays as
     any-hit waves):
     [direct] both kernels against their plain versions, exact, on the
     first any-hit shadow wave of the full killeroo's `directlighting`
     chunk at 128x128x64 (the expand step after the wave's first flush,
     where answered rays are culled, and the first flush chunk after it;
     the wave's first of each where no expand follows a flush), timed as
     in phase 2; that render's Mray/s, its launches and its any-hit
     waves' counters; `python -m tpu_pbrt_torch.main
     scenes/cornell-box.pbrt` in a subprocess on the card at the file's
     own 256x256x16 (brute feature intersector), its image against
     tests/torch_golden/cornell_direct_cpu_256x256_16spp.npz and its rays
     (from the checkpoint) against the reference's; the full killeroo
     under `directlighting` and `ao` (finite maxdistance) at 64x64x16
     against killeroo_{direct,ao}_cpu_64x64_16spp.npz (MSE bar 1e-4,
     rays printed beside the reference's, no pair dropped);
     [samplers] every sampler kind's draws on the card equal the CPU
     port's bit for bit on a 2^20-item grid (int and per-lane salts, and
     the Sobol' film jitter);
  6. cloud  — participating media and null interfaces: make_cloud_like()
     (the killeroo's 128,880-triangle displaced sphere as a `Material
     "none"` container of a homogeneous medium, the ground, the quad area
     and point lights and the HDR sky) under `volpath` (fixed batch,
     maxdepth 5 + 4 pass-through iterations, shadow rays walking up to 4
     closest-hit segments through the container):
     [scene] its sizes and compile seconds;
     [check] both kernels against their plain versions, EXACT, on the
     first shadow-walk segment wave of the 256x256x16 render's chunk
     (closest hit with a finite per-ray t_max: the expand step after the
     wave's first flush and the first flush chunk after it), timed as in
     phase 2;
     [render] 64x64x16 against the JAX CPU render
     tests/torch_golden/cloud_volpath_cpu_64x64_16spp.npz (MSE bar 1e-4,
     no pair dropped, rays printed beside the reference's); the card
     against the CPU port per pixel at 32x32x16, and at 16x16x16 with
     Russian roulette off (MSE bar 1e-4, rays printed); the 256x256x16
     render timed (Mray/s, waves, wave_modes),
     its kernel launches counted as in phase 3;
  7. caustic — the light-transport integrators on make_caustic_like()
     (the killeroo's 128,880-triangle displaced sphere in glass over its
     matte ground, lit by its quad area light and by a point light that
     the glass focuses onto the ground; maxdepth 5):
     [scene] its sizes and compile seconds;
     [check] both kernels against their plain versions, EXACT, on two
     captured waves, timed as in phase 2: BDPT's fused connection wave of
     the 256x256x16 chunk (every strategy's visibility ray, 20 x 2^20
     rays, any hit with a finite per-ray t_max: the expand step after its
     first flush and the first flush chunk after it) and SPPM's first
     photon wave (closest hit, 2^20 rays leaving the lights);
     [render] BDPT at 256x256x16, SPPM at 256x256 (2 iterations of 2^20
     photons) and MLT at 128x128 (65,536 chains) timed (Mray/s, waves,
     wave_modes), each with its kernel launches counted as in phase 3;
     BDPT and SPPM against the JAX CPU references of
     tests/torch_golden/make_caustic_reference.py (MSE bar 1e-4, no pair
     dropped, rays printed beside the reference's), MLT against its
     reference by the image mean (within 2%: one accept that flips
     reroutes a chain for good) with the MSE printed; BDPT and SPPM on
     the card against the CPU port at 16x16 (MSE bar 1e-4);
  8. breadth — scene breadth on make_breadth_like() at its full geometry
     (1,178,624 triangles: eight `ObjectInstance`s of a 128,880-triangle
     `plymesh` blob, a 257x257 `heightfield2` ground, a disk, cylinder,
     cone, paraboloid and hyperboloid, a level-4 `loopsubdiv` tetrahedron
     and 256 `curve` strands; a spot, a goniometric, a projection and an
     infinite light; `path` at maxdepth 5):
     [scene] its sizes and compile seconds;
     [check] both kernels against their plain versions, EXACT, on the
     512x512x16 (gaussian filter) render's pool wave 1 of its middle chunk
     (packed flush key) and its middle chunk's first fixed-batch 2^20-ray
     camera wave (unpacked key), timed as in phase 2;
     [render] that render through the pool and the fixed batch (the same
     rays; images within rtol 1e-4 / atol 1e-5), timed (Mray/s), its
     launches counted as in phase 3; the perspective camera under the
     gaussian and the realistic camera (the built-in doublet) under the
     mitchell filter at 64x64x16 against the JAX CPU references
     tests/torch_golden/breadth_{perspective,realistic}_cpu_64x64_16spp.npz
     (MSE bar 1e-4, no pair dropped, rays printed beside the
     reference's); the realistic camera's rays for every work item of
     that render on the card and on the CPU port (the vignetting masks
     equal); the orthographic camera under the triangle and the
     environment camera under the sinc filter on the card against the
     CPU port at 32x32x4 on the small tessellation (MSE below 1e-8, the
     same rays);
  9. textured — textures and the layered materials on make_textured_like()
     at its full geometry (1,166,214 triangles: eight `ObjectInstance`s
     of the 128,880-triangle blob in uber, translucent, mix, matte,
     plastic, substrate materials under every procedural texture kind, a
     257x257 `heightfield2` ground in substrate with a 2048^2 sRGB PNG
     albedo and a PFM-driven roughness, a uv-textured sphere and two PNG
     panels under wrap black and clamp; an atlas of 8,738,132 texels; the
     crown's sky and a quad area light; `path` at maxdepth 5):
     [scene] its sizes, textures, atlas and compile seconds;
     [check] both kernels against their plain versions, EXACT, on the
     512x512x16 render's pool wave 1 of its middle chunk (packed flush
     key) and its middle chunk's first fixed-batch 2^20-ray camera wave
     (unpacked key), timed as in phase 2;
     [render] that render through the pool and the fixed batch (the same
     rays; images within rtol 1e-4 / atol 1e-5), timed (Mray/s, waves),
     its launches counted as in phase 3; one 256x256x4 chunk of each
     under torch.profiler (profile_render.measure: the idle share, the
     device operations per wave with and without the texture
     evaluation, and its share of the device time); 64x64x16 through
     the pool and the fixed batch against the JAX CPU reference
     tests/torch_golden/textured_path_cpu_64x64_16spp.npz (MSE bar 1e-4,
     no pair dropped, rays printed beside the reference's); the card
     against the CPU port at 32x32x4 on the small variant
     (TEXTURED_SMALL; MSE bar 1e-4, rays printed); `bdpt` (mix lanes
     resolved per vertex) at 32x32x16 against
     tests/torch_golden/textured_bdpt_cpu_32x32_16spp.npz (MSE bar 1e-4);
 10. motion — motion blur, disney and hair on make_motion_like() at its
     full geometry (1,042,004 triangles: 20,480 cubic-Bezier hair
     segments in three `curve` shapes under `Material "hair"`, one per way
     it resolves sigma_a, translating over the shutter; three
     `ObjectInstance`s of the 128,880-triangle blob in disney, one of them
     translating and one rotating; a disney ground, the crown's sky and a
     quad area light; `path` at maxdepth 5, shutter [0, 1]):
     [scene] its sizes, treelets, the F = 64 featT's bytes and compile
     seconds;
     [check] both kernels against their plain versions, EXACT, on the
     512x512x16 render's pool wave 1 of its middle chunk (packed flush
     key, F = 64, each lane's own shutter time in rayF row 7) and its
     middle chunk's first fixed-batch 2^20-ray camera wave (unpacked key,
     the camera samples' times), timed as in phase 2 (the bound, the
     plain version and torch.bmm of the same 64-row contraction);
     [render] that render through the pool and the fixed batch (the same
     rays; images within rtol 1e-4 / atol 1e-5), timed (Mray/s, waves,
     the card's name and power limit), its launches counted as in phase 3
     (the F = 64 flush must launch); `path` 64x64x64 through the pool and
     the fixed batch against the JAX CPU reference
     tests/torch_golden/motion_path_cpu_64x64_64spp.npz and `bdpt` (the
     shutter-start frame, disney and hair shaded through BDPT) at
     32x32x16 against motion_bdpt_cpu_32x32_16spp.npz (MSE bar 1e-4, no
     pair dropped, rays printed beside the reference's); the card
     against the CPU port at 32x32x4 on the small variant (MSE bar 1e-4);
 11. cli    — `python -m tpu_pbrt_torch.main scenes/cornell-path.pbrt
     --quick` in subprocesses on the card with a checkpoint every chunk:
     one uninterrupted render (the image must be written and finite), one
     killed after its first checkpoint and then resumed, whose image and
     final film must equal the uninterrupted one bit for bit;
 12. summary — one {"kernels": [...]} line (times and bounds at the pool
     wave, the fixed wave's under "at_fixed_wave"; launches of the pool
     and of the fixed path; the crown's under "crown"; the any-hit wave's
     under "direct"; the cloud's shadow-walk wave under "cloud"; the
     caustic's connection and photon waves under "caustic"; the breadth
     scene's pool and fixed waves under "breadth", the textured scene's
     under "textured", the motion scene's under "motion"), the card's name and
     power limit (nvidia-smi), and as the last line
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
GOLDEN = os.path.join(HERE, "tests", "torch_golden")
REF_IMAGE = os.path.join(HERE, "refimg", "killeroo_cpu_128x128_256spp.npz")
CROWN_REF = os.path.join(GOLDEN, "crown_cpu_64x64_64spp.npz")
CORNELL_REF = os.path.join(GOLDEN, "cornell_direct_cpu_256x256_16spp.npz")
KILLEROO_DIRECT_REF = os.path.join(GOLDEN, "killeroo_{}_cpu_64x64_16spp.npz")
CLOUD_REF = os.path.join(GOLDEN, "cloud_volpath_cpu_64x64_16spp.npz")
#: the timed cloud render, whose first shadow-walk wave the kernels are
#: checked on (one chunk of 2^20 camera rays)
CLOUD_RES, CLOUD_SPP = 256, 16
#: the killeroo directlighting render that is timed and whose first any-hit
#: wave the kernels are checked on (one chunk of 2^20 camera rays)
DIRECT_RES, DIRECT_SPP = 128, 64
MSE_BAR = 1e-4
#: the timed caustic BDPT render, whose connection wave the kernels are
#: checked on (one chunk of 2^20 camera rays)
CAUSTIC_RES, CAUSTIC_SPP = 256, 16
#: the timed caustic SPPM render (resolution, integrator parameters), whose
#: first photon wave the kernels are checked on
SPPM_TIMED = (256, '"integer numiterations" [2] "integer photonsperiteration" [1048576] '
                   '"float radius" [0.05]')
#: the timed caustic MLT render, with a chain count that fills the card
MLT_TIMED = (128, '"integer chains" [65536] "integer bootstrapsamples" [65536] '
                  '"integer mutationsperpixel" [64]')
#: SPPM on the card against the CPU port
SPPM_SMALL = '"integer numiterations" [2] "integer photonsperiteration" [4096] "float radius" [0.1]'
#: MLT on the card against its JAX CPU reference: the image means' bar
MLT_MEAN_BAR = 0.02
#: spp of the 512x512 crown render (the bench's 256 would not fit the time box)
CROWN_SPP = 16
#: the JAX CPU references of the breadth scene at 64x64x16, by camera
BREADTH_REF = os.path.join(GOLDEN, "breadth_{}_cpu_64x64_16spp.npz")
#: the timed breadth render, whose pool and fixed waves the kernels are checked on
BREADTH_RES, BREADTH_SPP = 512, 16
#: the 64x64x16 renders held against the JAX CPU references: camera -> filter
BREADTH_REFS = {"perspective": "gaussian", "realistic": "mitchell"}
#: the cameras held against the CPU port at 32x32x4 on the small tessellation
BREADTH_PORT = {"orthographic": "triangle", "environment": "sinc"}
#: the card against the CPU port on the breadth scene: the MSE bar
BREADTH_PORT_BAR = 1e-8
#: the JAX CPU references of the textured scene (path 64x64x16, bdpt 32x32x16)
TEXTURED_REF = os.path.join(GOLDEN, "textured_path_cpu_64x64_16spp.npz")
TEXTURED_BDPT_REF = os.path.join(GOLDEN, "textured_bdpt_cpu_32x32_16spp.npz")
#: the timed textured render, whose pool and fixed waves the kernels are checked on
TEXTURED_RES, TEXTURED_SPP = 512, 16
#: the profiled textured render: 2^18 camera rays (a trace's parse time
#: follows its device ops, which follow its waves)
TEXTURED_PROFILE = (256, 4)
#: the JAX CPU references of the motion scene (path 64x64x64, bdpt 32x32x16;
#: path at 64 spp: a few hair paths take another way at the last bits of
#: the two libraries' transcendentals, a squared difference that falls as
#: 1/spp, and 16 spp read 1.14e-4)
MOTION_REF = os.path.join(GOLDEN, "motion_path_cpu_64x64_64spp.npz")
MOTION_BDPT_REF = os.path.join(GOLDEN, "motion_bdpt_cpu_32x32_16spp.npz")
#: the timed motion render, whose pool and fixed waves the kernels are checked on
MOTION_RES, MOTION_SPP = 512, 16

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


def _event_ms(fn, reps: int) -> float:
    """Device time per call from CUDA events around `reps` calls that the
    host enqueues while the card sleeps in a spin kernel, so the calls run
    back to back and no host launch gap enters (the device's own gaps
    between kernels do)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # ~50 ms of device cycles: the host enqueues meanwhile
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time_ms(fn, reps: int, warmup: int = 2):
    """Device time per call of `fn`: the CUDA kernels (and copies) that
    `reps` calls launch, summed by name from a torch.profiler trace, over
    `reps`. Returns (ms per call, {kernel name: ms per call}). The host's
    work around the launches is not in it (see host_ms). The trace is
    checked against CUDA events (_event_ms): where it holds less than
    half of their time, it has lost kernels (seen after a long profiled
    render earlier in the process) and the events' time is returned."""
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
    events = _event_ms(fn, reps)
    if total < 0.5 * events:
        log(f"[timing] the profiler holds {total:.4f} ms of {events:.4f} ms by CUDA events: "
            f"the events' time instead")
        if events <= 0:
            raise SmokeFailure("neither the profiler nor CUDA events recorded device time")
        total, by_name = events, {"(CUDA events)": events}
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

def _clone(args):
    """A kernel call's arguments, its tensors copied."""
    import torch

    return tuple(a.clone() if torch.is_tensor(a) else a for a in args)


def _hook_kernels(cap, want, past=None):
    """Wrap the stream tracer's two kernel seams: `want()` says whether
    the current call belongs to the traversal being captured; it records
    that traversal's first flush chunk and its first expand step after
    that flush (a popped slab of mixed nodes). With `past` given, the run
    is ended by raising _Captured once the expand is recorded or `past()`
    says the traversal is over. Returns the restore call."""
    from tpu_pbrt_torch.accel import stream

    real_expand, real_flush = stream.expand, stream.flush_chunk
    n_flush = [0]

    def expand_hook(*args):
        if past is not None and past():
            raise _Captured
        if want() and n_flush[0] > 0 and "expand" not in cap:
            cap["expand"] = _clone(args)
            if past is not None:
                raise _Captured
        return real_expand(*args)

    def flush_hook(*args):
        if past is not None and past():
            raise _Captured
        if want():
            n_flush[0] += 1
            if "flush" not in cap:  # the wave's first chunk: CH = min(512, block capacity)
                cap["flush"] = _clone(args)
        return real_flush(*args)

    stream.expand, stream.flush_chunk = expand_hook, flush_hook

    def restore():
        stream.expand, stream.flush_chunk = real_expand, real_flush

    return restore


class _Captured(Exception):
    """Raised from a kernel hook once its inputs are recorded, to stop
    the traversal it interrupts."""


def _capture_wave_inputs(scene, integ, chunk: int = 0):
    """Trace the fixed batch's first camera wave of chunk `chunk` of the
    render (closest hit), recording the inputs of its first flush chunk
    and of its first expand step after that flush. The any-hit expand
    input is that same slab with any_hit set and the wave's final hits on
    every other ray as the prim row, so the kernel's done-ray cull sees
    real data."""
    import torch

    from tpu_pbrt_torch.accel import stream

    from tpu_pbrt_torch.integrators.common import DIM_TIME

    dev = scene.dev
    plan = integ.prepare_chunks(scene)
    x0, x1, y0, _ = plan.bounds
    k = torch.arange(plan.chunk, dtype=torch.int32, device=scene.device)
    _, px, py, s, _, o, d, _ = integ.work_to_rays(
        scene.camera, plan.spp, x0, y0, x1 - x0, plan.npix, *plan.start(chunk), k
    )
    # a motion scene's camera samples trace at their shutter times, as the
    # fixed batch draws them
    ray_time = integ.u1d(px, py, s, DIM_TIME) if "tri_verts1" in dev else None
    cap = {"rays": (o, d)}
    restore = _hook_kernels(cap, lambda: True)
    try:
        hit = stream.stream_intersect(dev["tstream"], dev["tri_verts"], o, d, float("inf"),
                                      time=ray_time, tri_verts1=dev.get("tri_verts1"),
                                      tv9T=dev["tri_verts9T"], tv9T1=dev.get("tri_verts1_9T"))
    finally:
        restore()
    missing = {"flush", "expand"} - set(cap)
    if missing:
        raise SmokeFailure(f"could not capture kernel inputs for {sorted(missing)}")
    ea = cap["expand"]
    # every other ray keeps its final hit (culled as done), the rest are open
    rid = torch.arange(hit.prim.shape[0], device=hit.prim.device)
    prim = torch.where(rid % 2 == 0, hit.prim, torch.full_like(hit.prim, -1)).contiguous()
    cap["expand_anyhit"] = ea[:3] + (prim,) + ea[4:7] + (True,)
    return cap


def _capture_pool_wave(scene, integ, wave: int = 1):
    """Drain the render's middle chunk through the persistent pool up to
    its wave `wave` (0-based; wave 0's shadow half is empty, wave 1 is the
    first fused wave whose shadow rays carry a finite t_max) and record
    that wave's first flush chunk and first expand step after it. The
    chunks are pixel-major, so chunk 0 holds the top rows of the frame,
    mostly background: its early waves carry almost no shadow rays."""
    from tpu_pbrt_torch.accel import stream

    plan = integ.prepare_chunks(scene)
    if not plan.use_regen:
        raise SmokeFailure("the render plan does not take the persistent pool")
    cap = {"chunk": plan.n_chunks // 2}
    stream.WAVES.reset()
    restore = _hook_kernels(cap, lambda: stream.WAVES.waves == wave,
                            past=lambda: stream.WAVES.waves > wave)
    try:
        integ.pool_chunk(scene.dev, scene.film.init_state(scene.device),
                         *plan.start(cap["chunk"]), plan.chunk, plan.pool)
    except _Captured:
        pass
    finally:
        restore()
    missing = {"flush", "expand"} - set(cap)
    if missing:
        raise SmokeFailure(f"could not capture pool-wave kernel inputs for {sorted(missing)}")
    return cap, plan


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


def _compare_flush(a, b, label, exact=False):
    """t to 2 ulp; prim exact except at near-ties (t within 1e-6
    relative), which must stay under 0.1% of the rays. With `exact`, t
    to 0 ulp and no prim flip at all."""
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
    if exact and (ulp.max() > 0 or flips.any()):
        raise SmokeFailure(f"{label}: kernel not exact against its plain version")
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


def _flush_numbers(fa, count, label, exact=False):
    """Hold one captured flush chunk against the plain version, then time
    the kernel (device and host), the plain version and torch.bmm of the
    contraction alone, beside the bounds."""
    import torch

    from tpu_pbrt_torch.kernels.flush import flush_chunk, flush_chunk_plain

    CH, F = fa[1].shape[0], fa[0].shape[1]
    err = _compare_flush(flush_chunk(*fa), flush_chunk_plain(*fa), f"{label}: flush F={F} CH={CH}",
                         exact=exact)
    ms, parts = device_time_ms(lambda: flush_chunk(*fa), reps=20)
    h_ms = host_ms(lambda: flush_chunk(*fa), reps=20)
    plain_ms, _ = device_time_ms(lambda: flush_chunk_plain(*fa), reps=3, warmup=1)
    tids = fa[1][:, 0].long()
    n_live = int((fa[1][:, 5] > 0).sum())
    phiT = torch.randn(fa[1].shape[0], 128, F, device=fa[0].device)
    featg = fa[0][tids].contiguous()
    lib_ms, lib_parts = device_time_ms(lambda: torch.bmm(phiT, featg), reps=10)
    del phiT, featg
    bound, by = _flush_bound(fa, count)
    padded, _ = _flush_bound_padded(fa)
    log(f"[check] {label}: flush F={F}: kernel {ms:.4f} ms device ({_by_kernel(parts)}), host "
        f"{h_ms:.4f} ms per call, plain {plain_ms:.4f} ms, torch.bmm contraction {lib_ms:.4f} ms "
        f"({_by_kernel(lib_parts)}), bound {bound:.4f} ms ({by}; {padded:.4f} with the zero "
        f"padding); live blocks {n_live}")
    return dict(max_abs_err=err, ms=ms, host_ms=h_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, bound_padded_ms=padded, library_ms=lib_ms)


def _expand_numbers(ea, label):
    """Hold one captured expand step against the plain version (bit
    exact), then time it."""
    import torch

    from tpu_pbrt_torch.accel.stream import _tn_bits
    from tpu_pbrt_torch.kernels.expand import expand, expand_plain

    a, b = expand(*ea), expand_plain(*ea)
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    S, R = ea[0].shape[0], ea[2].shape[1]
    log(f"[check] {label}: expand S {S}, R {R}, key bits tb {ea[6]} (_tn_bits {_tn_bits(R)}), "
        f"any_hit {ea[7]}, live pairs {int(a[2].sum())}, exact: {same}")
    if not same:
        raise SmokeFailure(f"{label}: expand disagrees with its plain version")
    ms, _ = device_time_ms(lambda: expand(*ea), reps=50)
    h_ms = host_ms(lambda: expand(*ea), reps=50)
    plain_ms, _ = device_time_ms(lambda: expand_plain(*ea), reps=10)
    bound, by = _expand_bound(ea)
    log(f"[check] {label}: expand: kernel {ms:.4f} ms device, host {h_ms:.4f} ms per call, "
        f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return dict(max_abs_err=0.0, ms=ms, host_ms=h_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=by, library_ms=None)


def _check_waves(scene, integ, label="", fixed_chunk=0, exact=False, fixed_packed=True,
                 extra=None, features=16):
    """Both kernels at a scene's pool wave (the top-level numbers; its flush
    key must pack) and at its fixed batch's first camera wave of chunk
    `fixed_chunk` (under "at_fixed_wave"; its key packed iff
    `fixed_packed`), and the any-hit expand on that wave's slab.
    `extra(flush_args)` runs on the fixed wave's flush capture and returns
    numbers kept under "synthetic_f64", their max_abs_err folded into the
    flush's.
    Both waves' flush tables must have `features` rows (16, or 64 with the
    cubic-in-time motion features, whose rays carry their shutter times in
    rayF row 7). Returns (numbers, the camera wave's rays)."""
    import torch

    from tpu_pbrt_torch.accel.stream import _ray_bits, flush_geometry
    from tpu_pbrt_torch.kernels.expand import expand, expand_plain

    tp = scene.dev["tstream"]

    def packed(R):
        return tp.n_treelets < (1 << (31 - _ray_bits(R)))

    t0 = time.perf_counter()
    pcap, plan = _capture_pool_wave(scene, integ)
    R = pcap["flush"][3].shape[1]
    # the flush's rayF row 6 is the t_max row: > 0 for a live ray
    n_shadow = int((pcap["flush"][3][6, plan.pool:] > 0).sum())
    log(f"[check] {label}pool wave: captured wave 1 of chunk {pcap['chunk']} of "
        f"{plan.n_chunks} (pool {plan.pool} slots, {R} rays: camera + shadow; {n_shadow} "
        f"shadow rays live; flush key packed: {packed(R)}) in {time.perf_counter() - t0:.2f} s; "
        f"flush geometry {flush_geometry(R, tp.n_treelets)}")
    if R != 2 * plan.pool or n_shadow == 0 or not packed(R):
        raise SmokeFailure(f"{label}pool wave: expected a packed 2x{plan.pool}-ray wave with "
                           f"live shadow rays, got {R} rays, {n_shadow} shadow rays live")
    _check_features(pcap["flush"], features, f"{label}pool wave")
    out = {"flush_chunk": _flush_numbers(pcap["flush"], tp.count, f"{label}pool wave", exact),
           "expand": _expand_numbers(pcap["expand"], f"{label}pool wave")}
    del pcap

    t0 = time.perf_counter()
    cap = _capture_wave_inputs(scene, integ, fixed_chunk)
    R = cap["flush"][3].shape[1]
    log(f"[check] {label}fixed wave: captured kernel inputs from chunk {fixed_chunk}'s {R}-ray "
        f"camera wave in {time.perf_counter() - t0:.2f} s; flush key packed: {packed(R)}; "
        f"flush geometry {flush_geometry(R, tp.n_treelets)}")
    if packed(R) != fixed_packed:
        raise SmokeFailure(f"{label}fixed wave: expected a {'packed' if fixed_packed else 'unpacked'}"
                           " flush key")
    _check_features(cap["flush"], features, f"{label}fixed wave")
    fixed = {"flush_chunk": _flush_numbers(cap["flush"], tp.count, f"{label}fixed wave", exact)}
    if extra is not None:
        out["flush_chunk"]["synthetic_f64"] = extra(cap["flush"])
        out["flush_chunk"]["max_abs_err"] = max(out["flush_chunk"]["max_abs_err"],
                                                out["flush_chunk"]["synthetic_f64"]["max_abs_err"])
    # expand closest-hit (timed) and any-hit (exactness only: the render
    # path traces closest-hit waves only)
    fixed["expand"] = _expand_numbers(cap["expand"], f"{label}fixed wave")
    ea = cap["expand_anyhit"]
    if not all(torch.equal(x, y) for x, y in zip(expand(*ea), expand_plain(*ea))):
        raise SmokeFailure(f"{label}any-hit expand disagrees with its plain version")
    log(f"[check] {label}fixed wave: any-hit expand exact: True")
    for k in out:
        out[k]["at_fixed_wave"] = fixed[k]
        out[k]["max_abs_err"] = max(out[k]["max_abs_err"], fixed[k]["max_abs_err"])
    rays = cap["rays"]
    del cap
    torch.cuda.empty_cache()
    return out, rays


def _check_features(fa, features, label):
    """A captured flush chunk's table has `features` rows; at F = 64 its
    live slots' rays carry shutter times (rayF row 7), not all zero."""
    import torch

    feat, meta, rows, rayF = fa[:4]
    live = rows[(rows >= 0) & (meta[:, 5] > 0)[:, None]].long()
    times = rayF[7, live]
    log(f"[check] {label}: feature rows F = {feat.shape[1]}, {live.numel()} filled slots, ray "
        f"times in [{float(times.min()):.4f}, {float(times.max()):.4f}]")
    if feat.shape[1] != features or (features == 64) != bool(torch.any(times != 0)):
        raise SmokeFailure(f"{label}: expected F = {features} with "
                           f"{'real' if features == 64 else 'zero'} ray times")


def phase_check(scene, integ):
    """Both kernels at the main path's shapes (_check_waves), plus the tie
    fixture and the F=64 (motion feature) flush on the fixed wave's chunk."""
    from tpu_pbrt_torch.kernels.flush import flush_chunk, flush_chunk_plain

    _check_tie_fixture(flush_chunk, flush_chunk_plain)

    def flush_f64(fa):
        t1 = time.perf_counter()
        fm = _motion_table(scene, fa)
        log(f"[check] synthetic F=64 table built in {time.perf_counter() - t1:.1f} s")
        return _flush_numbers(fm, scene.dev["tstream"].count, "synthetic F=64 table")

    return _check_waves(scene, integ, extra=flush_f64)[0]


# -- phase 3 -------------------------------------------------------------------

def _render_counted(integ, scene, regen: bool):
    """One render through the pool (regen) or the fixed batch, with the
    kernel launch counters zeroed just before and read just after."""
    from tpu_pbrt_torch.config import cfg
    from tpu_pbrt_torch.kernels import LAUNCHES, reset_launches

    saved = cfg.regen
    cfg.regen = regen
    try:
        reset_launches()
        res = integ.render(scene)
        launches = dict(LAUNCHES)
    finally:
        cfg.regen = saved
    if bool(res.stats.get("regen")) != regen:
        raise SmokeFailure(f"render: asked for regen={regen}, stats say {res.stats.get('regen')}")
    for name, n in launches.items():
        if n <= 0:
            raise SmokeFailure(f"render (regen={regen}): kernel {name} was never launched")
    return res, launches


def _log_render(label, res, launches):
    st = res.stats
    log(f"[render] {label}: {res.seconds:.3f} s, {res.rays_traced} rays, "
        f"{res.mray_per_sec:.4f} Mray/s, chunks {st['chunks']}, traversal waves {st['waves']}, "
        f"host reads per wave {st['host_reads_per_wave_mean']:.2f} (traversal) + "
        f"{st['loop_host_reads_per_wave']:.2f} (loop), launches {json.dumps(launches)}")
    log(f"[render] {label}: stats {json.dumps(st)}")


def phase_render(scene, integ):
    """The main path (the pool at 128x128x256, MSE bar against the
    reference image), the fixed batch on the same scene (same rays), and
    both at 64x64x16 (images within the reference's pool tolerance)."""
    import numpy as np

    from tpu_pbrt_torch.scenes import compile_api, make_killeroo_like

    res, launches = _render_counted(integ, scene, regen=True)
    img = res.image
    ref = np.load(REF_IMAGE)["image"]
    if img.shape != ref.shape or not np.isfinite(img).all():
        raise SmokeFailure(f"render: image shape {img.shape} / finite {np.isfinite(img).all()}")
    mse = float(np.mean((img.astype(np.float64) - ref) ** 2))
    _log_render("pool 128x128 256 spp maxdepth 5", res, launches)
    log(f"[render] pool: image mean {img.mean():.6f} (ref {ref.mean():.6f}), MSE vs ref "
        f"{mse:.3e} (bar {MSE_BAR:g}), pool {res.stats['pool']}, waves {res.stats['n_waves']}, "
        f"occupancy {res.stats['mean_wave_occupancy']:.4f}")
    if mse > MSE_BAR:
        raise SmokeFailure(f"render: MSE {mse:.3e} > {MSE_BAR:g}")

    fres, flaunches = _render_counted(integ, scene, regen=False)
    fmse = float(np.mean((fres.image.astype(np.float64) - ref) ** 2))
    _log_render("fixed 128x128 256 spp maxdepth 5", fres, flaunches)
    log(f"[render] fixed: MSE vs ref {fmse:.3e}; pool/fixed Mray/s "
        f"{res.mray_per_sec / max(fres.mray_per_sec, 1e-9):.3f}")
    if fres.rays_traced != res.rays_traced or fmse > MSE_BAR:
        raise SmokeFailure(f"render: fixed batch traced {fres.rays_traced} rays (pool "
                           f"{res.rays_traced}), MSE {fmse:.3e}")

    t0 = time.perf_counter()
    small, sinteg = compile_api(make_killeroo_like(res=64, spp=16, maxdepth=5, device="cuda"))
    sp, _ = _render_counted(sinteg, small, regen=True)
    sf, _ = _render_counted(sinteg, small, regen=False)
    diff = float(np.max(np.abs(sp.image - sf.image)))
    log(f"[render] 64x64 16 spp: pool {sp.rays_traced} rays, fixed {sf.rays_traced} rays, "
        f"max |pool - fixed| {diff:.3e} ({time.perf_counter() - t0:.1f} s with the compile)")
    if sp.rays_traced != sf.rays_traced or not np.allclose(sp.image, sf.image, rtol=1e-4,
                                                           atol=1e-5):
        raise SmokeFailure("render: the pool and the fixed batch disagree at 64x64x16")
    return launches, flaunches


# -- phase 4 -------------------------------------------------------------------

def crown_scene():
    """The crown at 512x512 (CROWN_SPP) on the card, with its sizes."""
    import numpy as np
    import torch

    from tpu_pbrt_torch.scenes import compile_api, crown_sky, make_crown_like

    t0 = time.perf_counter()
    scene, integ = compile_api(make_crown_like(res=512, spp=CROWN_SPP, maxdepth=5, device="cuda"))
    secs = time.perf_counter() - t0
    tp = scene.dev["tstream"]
    log(f"[scene] crown: {scene.n_tris} triangles, {tp.n_treelets} treelets of {tp.leaf_tris}, "
        f"{tp.top.child_bmin.shape[0]} top-tree nodes, featT {tuple(tp.featT.shape)} "
        f"{tp.featT.numel() * 4 / 1e6:.1f} MB, {scene.n_lights} light(s), compiled in {secs:.2f} s")
    env = scene.dev.get("envmap")
    sky = torch.from_numpy(crown_sky()).to(env.device) if env is not None else None
    if env is None or tuple(env.shape) != (64, 128, 3) or not torch.equal(env, sky):
        raise SmokeFailure("crown: the environment map is not the 64x128 sky "
                           f"(got {None if env is None else tuple(env.shape)})")
    mats = np.unique(scene.dev["mat"]["type"].cpu().numpy()).tolist()
    log(f"[scene] crown: envmap 64x128 sky, max {float(env.max()):.2f} (the sun), "
        f"mean {float(env.mean()):.4f}; materials {mats}")
    return scene, integ


def phase_crown_check(scene, integ):
    """Both kernels, exact, at the crown's pool wave (2^19 rays, packed
    flush key) and its middle chunk's first fixed-batch camera wave (2^20
    rays, unpacked key: chunk 0 holds the frame's top rows, nearly all
    sky, whose one flush comes after the last expand step); returns
    (numbers, the camera wave's rays)."""
    n_chunks = integ.prepare_chunks(scene).n_chunks
    return _check_waves(scene, integ, "crown ", fixed_chunk=n_chunks // 2, exact=True,
                        fixed_packed=False)


def phase_branch(scene, rays):
    """The camera wave's rays as one 2^20-ray wave (the flush's unpacked
    stable sort) and as two 2^19-ray waves (the packed key): per-ray
    (t, prim) bit-identical, no pair dropped."""
    import torch

    from tpu_pbrt_torch.accel import stream

    tp = scene.dev["tstream"]
    o, d = rays
    R = o.shape[0]
    t_max = torch.full((R,), float("inf"), device=o.device)
    t0 = time.perf_counter()
    whole = stream._traverse(tp, o, d, t_max, False)
    t_w, p_w, drop_w = whole.rayF[6].clone(), whole.prim.clone(), int(whole.n_drop)
    del whole
    t1 = time.perf_counter()
    h = R // 2
    t_h, p_h, drop_h = [], [], 0
    for sl in (slice(0, h), slice(h, R)):
        part = stream._traverse(tp, o[sl].contiguous(), d[sl].contiguous(), t_max[sl], False)
        t_h.append(part.rayF[6].clone())
        p_h.append(part.prim.clone())
        drop_h += int(part.n_drop)
        del part
    t2 = time.perf_counter()
    t_h, p_h = torch.cat(t_h), torch.cat(p_h)
    same_t = torch.equal(t_w.view(torch.int32), t_h.view(torch.int32))
    same_p = torch.equal(p_w, p_h)
    log(f"[branch] {R} rays, {tp.n_treelets} treelets: one wave of {R} (unpacked key) "
        f"{t1 - t0:.2f} s vs two of {h} (packed) {t2 - t1:.2f} s; hits {int((p_w >= 0).sum())}; "
        f"t bit-identical {same_t}, prim identical {same_p} "
        f"({int((p_w != p_h).sum())} differ); dropped {drop_w} / {drop_h}")
    if not (same_t and same_p) or drop_w or drop_h:
        raise SmokeFailure("branch: the unpacked and packed flush keys disagree")


def phase_crown_render(scene, integ):
    """The crown against the JAX CPU reference at 64x64x64 (pool: MSE bar;
    fixed batch: the same rays, images within the pool tolerance), then
    the 512x512 crown through the pool. Returns the launches of the 512
    render and of the two 64x64 renders."""
    import numpy as np

    from tpu_pbrt_torch.scenes import compile_api, make_crown_like

    ref = np.load(CROWN_REF)
    t0 = time.perf_counter()
    small, sinteg = compile_api(make_crown_like(res=64, spp=int(ref["spp"]),
                                                maxdepth=int(ref["maxdepth"]), device="cuda"))
    log(f"[render] crown 64x64: compiled in {time.perf_counter() - t0:.2f} s")
    sp, sp_l = _render_counted(sinteg, small, regen=True)
    img, want = sp.image, ref["image"]
    if img.shape != want.shape or not np.isfinite(img).all():
        raise SmokeFailure(f"crown: image shape {img.shape} / finite {np.isfinite(img).all()}")
    mse = float(np.mean((img.astype(np.float64) - want) ** 2))
    _log_render(f"crown pool 64x64 {int(ref['spp'])} spp", sp, sp_l)
    ref_rays = int(ref["rays_traced"])
    log(f"[render] crown pool: image mean {img.mean():.6f} (JAX CPU {want.mean():.6f}), MSE "
        f"{mse:.3e} (bar {MSE_BAR:g}), max |diff| {np.abs(img - want).max():.3e}; rays "
        f"{sp.rays_traced} (JAX CPU {ref_rays}, {sp.rays_traced - ref_rays} more), waves "
        f"{sp.stats['n_waves']} (JAX CPU {int(ref['n_waves'])}), dropped {sp.stats['n_drop']}")
    if mse > MSE_BAR or sp.stats["n_drop"]:
        raise SmokeFailure(f"crown: MSE {mse:.3e} > {MSE_BAR:g} or {sp.stats['n_drop']} "
                           "pairs dropped")
    sf, sf_l = _render_counted(sinteg, small, regen=False)
    _log_render(f"crown fixed 64x64 {int(ref['spp'])} spp", sf, sf_l)
    diff = np.abs(sp.image - sf.image)
    close = np.isclose(sp.image, sf.image, rtol=1e-4, atol=1e-5)
    log(f"[render] crown pool vs fixed: rays {sp.rays_traced} / {sf.rays_traced}, max |diff| "
        f"{diff.max():.3e}, pixel channels outside rtol 1e-4 / atol 1e-5: {int((~close).sum())}, "
        f"dropped {sf.stats['n_drop']}")
    if sp.rays_traced != sf.rays_traced or not close.all() or sf.stats["n_drop"]:
        raise SmokeFailure("crown: the pool and the fixed batch disagree at 64x64")
    del small, sinteg

    res, launches = _render_counted(integ, scene, regen=True)
    _log_render(f"crown pool 512x512 {CROWN_SPP} spp", res, launches)
    img = res.image
    st = res.stats
    log(f"[render] crown 512x512: {res.mray_per_sec:.4f} Mray/s, waves {st['n_waves']}, "
        f"occupancy {st['mean_wave_occupancy']:.4f}, host reads per wave "
        f"{st['host_reads_per_wave_mean']:.2f} + {st['loop_host_reads_per_wave']:.2f}, "
        f"dropped {st['n_drop']}, image mean {img.mean():.6f}")
    if not np.isfinite(img).all() or not img.mean() > 1e-6 or res.stats["n_drop"]:
        raise SmokeFailure("crown 512x512: the image is not a finite lit render, or pairs dropped")
    return launches, sp_l, sf_l, res


# -- phase 5 -------------------------------------------------------------------

def _capture_first_wave(run, any_hit: bool, label: str, when=lambda: True):
    """Run `run()` up to the end of its first traversal wave of the given
    mode (any-hit or closest-hit) that starts while `when()` holds,
    recording that wave's first expand step after its first flush (in an
    any-hit wave, rays answered by that flush are culled) and the first
    flush chunk after that expand (its pairs passed the filters of the
    steps before). A wave whose only flush comes after its last expand
    step has neither: its first of each is taken then. Returns
    (captures, the wave's stats: rays, live, hits, finite t_max,
    expand steps, flush chunks)."""
    import torch

    from tpu_pbrt_torch.accel import stream

    cap = {}
    state = {"in_wave": False, "flushes": 0, "expands": 0}
    real_trav, real_expand, real_flush = stream._traverse, stream.expand, stream.flush_chunk

    def traverse(tp, o, d, t_max, mode, time=None):
        if mode != any_hit or state["in_wave"] or not when():
            return real_trav(tp, o, d, t_max, mode, time=time)
        live = t_max > 0
        state.update(in_wave=True, rays=o.shape[0], live=int(live.sum()),
                     finite=bool(torch.isfinite(t_max[live]).all()))
        s = real_trav(tp, o, d, t_max, mode, time=time)
        state["hits"] = int((s.prim >= 0).sum())
        raise _Captured

    def expand_hook(*args):
        if state["in_wave"]:
            state["expands"] += 1
            if bool(args[7]) != any_hit:
                raise SmokeFailure(f"{label}: the captured wave's expand has the wrong mode")
            if state["expands"] == 1:
                cap["first_expand"] = _clone(args)
            elif state["flushes"] and "expand" not in cap:
                cap["expand"] = _clone(args)
        return real_expand(*args)

    def flush_hook(*args):
        if state["in_wave"]:
            state["flushes"] += 1
            if state["flushes"] == 1:
                cap["first_flush"] = _clone(args)
            elif "expand" in cap and "flush" not in cap:
                cap["flush"] = _clone(args)
        return real_flush(*args)

    stream._traverse, stream.expand, stream.flush_chunk = traverse, expand_hook, flush_hook
    try:
        run()
    except _Captured:
        pass
    finally:
        stream._traverse, stream.expand, stream.flush_chunk = real_trav, real_expand, real_flush
    if {"first_flush", "first_expand"} - set(cap):
        raise SmokeFailure(f"{label}: could not capture the wave's kernel inputs ({state})")
    state["expand_after_flush"] = "expand" in cap
    state["flush_after_expand"] = "flush" in cap
    for k in ("expand", "flush"):
        first = cap.pop(f"first_{k}")
        cap.setdefault(k, first)
    return cap, state


def _capture_anyhit_wave(scene, integ):
    """The first any-hit (shadow) wave of the render's first chunk."""
    plan = integ.prepare_chunks(scene)
    return _capture_first_wave(lambda: plan.dispatch(scene.film.init_state(scene.device), 0),
                               True, "direct")


def _killeroo_direct(which, res, spp):
    """The full killeroo under `directlighting` or `ao` on the card, built
    by the scene function that wrote the JAX CPU references
    (tests/torch_golden/make_direct_reference.py)."""
    if GOLDEN not in sys.path:
        sys.path.insert(0, GOLDEN)
    from make_direct_reference import killeroo_api

    from tpu_pbrt_torch import scenes

    return scenes.compile_api(killeroo_api(scenes, which, res=res, spp=spp, device="cuda"))


def _cornell_cli():
    """scenes/cornell-box.pbrt through the CLI in a subprocess on the card:
    (image, rays, seconds)."""
    import shutil
    import tempfile

    from tpu_pbrt_torch.parallel.checkpoint import load_checkpoint
    from tpu_pbrt_torch.utils.imageio import read_pfm

    tmp = tempfile.mkdtemp(prefix="chip_smoke_direct_")
    try:
        cmd = [sys.executable, "-m", "tpu_pbrt_torch.main",
               os.path.join(HERE, "scenes", "cornell-box.pbrt"), "--quiet",
               "-o", os.path.join(tmp, "c.pfm"), "--checkpoint", os.path.join(tmp, "c.npz")]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        if r.returncode != 0:
            raise SmokeFailure(f"direct cli: exit {r.returncode}: {r.stderr[-2000:]}")
        rays = load_checkpoint(os.path.join(tmp, "c.npz"))[2]
        return read_pfm(os.path.join(tmp, "c.pfm")), rays, secs
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _against(label, img, rays, ref, n_drop=0, tag="direct"):
    """MSE of a render against a JAX CPU reference, with the rays beside
    the reference's; fails past the bar, on a non-finite image or on a
    dropped pair."""
    import numpy as np

    want = ref["image"]
    if img.shape != want.shape or not np.isfinite(img).all():
        raise SmokeFailure(f"{label}: image shape {img.shape} / finite {np.isfinite(img).all()}")
    mse = float(np.mean((img.astype(np.float64) - want) ** 2))
    ref_rays = int(ref["rays_traced"])
    log(f"[{tag}] {label}: image mean {img.mean():.6f} (JAX CPU {want.mean():.6f}), MSE {mse:.3e} "
        f"(bar {MSE_BAR:g}), max |diff| {np.abs(img - want).max():.3e}; rays {rays} (JAX CPU "
        f"{ref_rays}, {rays - ref_rays:+d}), dropped {n_drop}")
    if mse > MSE_BAR or n_drop or not want.mean() > 0:
        raise SmokeFailure(f"{label}: MSE {mse:.3e} > {MSE_BAR:g} or {n_drop} pairs dropped")
    return mse


def phase_direct():
    """The direct-lighting family on the card (see the module doc, phase 5):
    the kernels on the any-hit wave and the timed render first, then the
    renders against the JAX CPU references. Returns {kernel: numbers at
    the any-hit wave, with the timed render's launches and Mray/s}."""
    import numpy as np

    scene, integ = _killeroo_direct("direct", DIRECT_RES, DIRECT_SPP)
    t0 = time.perf_counter()
    cap, wave = _capture_anyhit_wave(scene, integ)
    log(f"[direct] any-hit wave: the first shadow wave of chunk 0 ({wave['rays']} rays, "
        f"{wave['live']} live, {wave['hits']} occluded; {wave['expands']} expand steps, "
        f"{wave['flushes']} flush chunks; expand captured after a flush: "
        f"{wave['expand_after_flush']}, flush chunk after that expand: "
        f"{wave['flush_after_expand']}) in {time.perf_counter() - t0:.2f} s")
    count = scene.dev["tstream"].count
    out = {"flush_chunk": _flush_numbers(cap["flush"], count, "any-hit wave", exact=True),
           "expand": _expand_numbers(cap["expand"], "any-hit wave")}
    del cap
    res, launches = _render_counted(integ, scene, regen=False)
    _log_render(f"killeroo directlighting {DIRECT_RES}x{DIRECT_RES}x{DIRECT_SPP}", res, launches)
    anyhit = res.stats["wave_modes"]["any_hit"]
    log(f"[direct] killeroo directlighting {DIRECT_RES}x{DIRECT_RES}x{DIRECT_SPP}: "
        f"{res.mray_per_sec:.4f} Mray/s, {res.rays_traced} rays in {res.seconds:.3f} s; any-hit "
        f"waves {anyhit['waves']}: {anyhit['iters_per_wave_mean']:.2f} iterations, "
        f"{anyhit['host_reads_per_wave_mean']:.2f} host reads, "
        f"{anyhit['expand_calls_per_wave_mean']:.2f} expand and "
        f"{anyhit['flush_calls_per_wave_mean']:.2f} flush launches per wave; closest-hit "
        f"{json.dumps(res.stats['wave_modes']['closest_hit'])}")
    if not np.isfinite(res.image).all() or res.stats["n_drop"]:
        raise SmokeFailure("killeroo directlighting: non-finite image or pairs dropped")
    for name in out:
        out[name].update(launches=launches[name], mray_per_sec=res.mray_per_sec,
                         launches_anyhit=anyhit["expand_calls" if name == "expand"
                                                else "flush_calls"],
                         res=DIRECT_RES, spp=DIRECT_SPP)
    del scene, integ

    img, rays, secs = _cornell_cli()
    log(f"[direct] cornell-box.pbrt through the CLI: {img.shape[1]}x{img.shape[0]} "
        f"(16 spp), {secs:.1f} s in the subprocess")
    _against("cornell-box.pbrt directlighting 256x256x16", img, rays, np.load(CORNELL_REF))

    for which in ("direct", "ao"):
        scene, integ = _killeroo_direct(which, 64, 16)
        res, launches = _render_counted(integ, scene, regen=False)
        _log_render(f"killeroo {which} 64x64x16", res, launches)
        _against(f"killeroo {which} 64x64x16", res.image, res.rays_traced,
                 np.load(KILLEROO_DIRECT_REF.format(which)), res.stats["n_drop"])
        if not res.stats["wave_modes"].get("any_hit", {}).get("waves"):
            raise SmokeFailure(f"killeroo {which}: no any-hit wave was traced")
        del scene, integ
    return out


def phase_samplers():
    """Every sampler kind's draws on the card against the CPU port's, bit for
    bit, on a 2^20-item grid: int and per-lane salts, and the Sobol' film
    jitter."""
    from types import SimpleNamespace

    import torch

    from tpu_pbrt_torch.core import sampling
    from tpu_pbrt_torch.integrators.common import WavefrontIntegrator

    n, spp = 1 << 20, 12
    g = torch.Generator().manual_seed(5)
    px, py = torch.randint(0, 4096, (2, n), dtype=torch.int32, generator=g)
    s = torch.randint(0, spp, (n,), dtype=torch.int32, generator=g)
    salt = torch.randint(0, 400, (n,), dtype=torch.int32, generator=g)
    cpu = (px, py, s)
    gpu = tuple(x.cuda() for x in cpu)
    t0 = time.perf_counter()
    checked = 0
    for kind in ("random", "02", "stratified", "halton", "sobol"):
        for sl_c, sl_g in ((23, 23), (salt, salt.cuda())):
            for fn in (sampling.sample_1d, sampling.sample_2d):
                a = fn(kind, spp, *cpu, sl_c)
                b = fn(kind, spp, *gpu, sl_g)
                for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
                    checked += 1
                    if not torch.equal(x.view(torch.int32), y.cpu().view(torch.int32)):
                        raise SmokeFailure(f"samplers: {kind} {fn.__name__} differs on the card")
    self_ = SimpleNamespace(skind="sobol", _sobol_m=12)
    for x, y in zip(WavefrontIntegrator.film_jitter(self_, *cpu),
                    WavefrontIntegrator.film_jitter(self_, *gpu)):
        checked += 1
        if not torch.equal(x.view(torch.int32), y.cpu().view(torch.int32)):
            raise SmokeFailure("samplers: the Sobol' film jitter differs on the card")
    log(f"[samplers] {checked} draws of 2^20 items (random, 02, stratified, halton, sobol at "
        f"spp {spp}; int and per-lane salts; the Sobol' film jitter): the card's equal the CPU "
        f"port's bit for bit ({time.perf_counter() - t0:.1f} s)")


# -- phase 6 -------------------------------------------------------------------

def _capture_walk_wave(scene, integ):
    """The first shadow-walk segment wave of the render's first chunk
    (volpath's unoccluded_tr: closest hit, t_max the light distance
    left)."""
    from tpu_pbrt_torch.integrators import volpath

    real_walk, in_walk = volpath.unoccluded_tr, [False]

    def walk(*args, **kw):
        in_walk[0] = True
        try:
            return real_walk(*args, **kw)
        finally:
            in_walk[0] = False

    plan = integ.prepare_chunks(scene)
    volpath.unoccluded_tr = walk
    try:
        cap, state = _capture_first_wave(
            lambda: plan.dispatch(scene.film.init_state(scene.device), 0), False, "cloud",
            when=lambda: in_walk[0])
    finally:
        volpath.unoccluded_tr = real_walk
    if not state["finite"]:
        raise SmokeFailure(f"cloud: the shadow-walk wave has no finite t_max ({state})")
    return cap, state


def _cloud(res, spp, device):
    from tpu_pbrt_torch.scenes import compile_api, make_cloud_like

    return compile_api(make_cloud_like(res=res, spp=spp, maxdepth=5, device=device))


def phase_cloud():
    """The cloud-class scene on the card (see the module doc, phase 6):
    the kernels on the first shadow-walk wave of the 256x256x16 chunk,
    then that render timed, the 64x64x16 render against the JAX CPU
    reference and the card against the CPU port at 32x32x16. Returns
    {kernel: numbers at the shadow-walk wave, with the timed render's
    launches and Mray/s}."""
    import numpy as np

    t0 = time.perf_counter()
    scene, integ = _cloud(CLOUD_RES, CLOUD_SPP, "cuda")
    tp = scene.dev["tstream"]
    log(f"[scene] cloud: {scene.n_tris} triangles, {tp.n_treelets} treelets of {tp.leaf_tris}, "
        f"{tp.top.child_bmin.shape[0]} top-tree nodes, {scene.n_lights} light rows, null "
        f"surfaces {scene.has_null_materials} (shadow walk of {integ.vis_segments} segments, "
        f"{integ.max_depth + 1 + integ.margin} iterations), compiled in "
        f"{time.perf_counter() - t0:.2f} s")
    if not (scene.has_null_materials and integ.vis_segments == 4 and integ.margin == 4):
        raise SmokeFailure("cloud: the container is not a null interface")
    t0 = time.perf_counter()
    cap, wave = _capture_walk_wave(scene, integ)
    log(f"[cloud] shadow-walk wave: segment 0 of chunk 0's first walk ({wave['rays']} rays, "
        f"{wave['live']} live, all with a finite t_max: {wave['finite']}; {wave['hits']} hit "
        f"before their light; {wave['expands']} expand steps, {wave['flushes']} flush chunks; "
        f"expand captured after a flush: {wave['expand_after_flush']}, flush chunk after that "
        f"expand: {wave['flush_after_expand']}) in {time.perf_counter() - t0:.2f} s")
    out = {"flush_chunk": _flush_numbers(cap["flush"], tp.count, "cloud shadow-walk wave",
                                         exact=True),
           "expand": _expand_numbers(cap["expand"], "cloud shadow-walk wave")}
    del cap
    res, launches = _render_counted(integ, scene, regen=False)
    _log_render(f"cloud volpath {CLOUD_RES}x{CLOUD_RES}x{CLOUD_SPP}", res, launches)
    closest = res.stats["wave_modes"]["closest_hit"]
    log(f"[cloud] {CLOUD_RES}x{CLOUD_RES}x{CLOUD_SPP}: {res.mray_per_sec:.4f} Mray/s, "
        f"{res.rays_traced} rays in {res.seconds:.3f} s; closest-hit waves {closest['waves']}: "
        f"{closest['iters_per_wave_mean']:.2f} iterations, "
        f"{closest['host_reads_per_wave_mean']:.2f} host reads, "
        f"{closest['expand_calls_per_wave_mean']:.2f} expand and "
        f"{closest['flush_calls_per_wave_mean']:.2f} flush launches per wave; loop host reads "
        f"{res.stats['loop_host_reads_per_wave'] * res.stats['waves']:.0f}")
    if not np.isfinite(res.image).all() or res.stats["n_drop"] or "any_hit" in res.stats[
            "wave_modes"]:
        raise SmokeFailure("cloud: non-finite image, pairs dropped or an any-hit wave traced")
    for name in out:
        out[name].update(launches=launches[name], mray_per_sec=res.mray_per_sec,
                         res=CLOUD_RES, spp=CLOUD_SPP)
    del scene, integ, res

    scene, integ = _cloud(64, 16, "cuda")
    res, launches = _render_counted(integ, scene, regen=False)
    _log_render("cloud volpath 64x64x16", res, launches)
    ref = np.load(CLOUD_REF)
    _against("cloud volpath 64x64x16", res.image, res.rays_traced, ref, res.stats["n_drop"],
             tag="cloud")
    del scene, integ

    # the card against the CPU port, as rendered and with Russian roulette
    # off (rrthreshold 0): the roulette's survivor scale leaves a one-ulp
    # edge that a second roll after a null crossing reads, so the two
    # devices' rounding of the transcendentals moves some paths there
    for res, spp, rr in ((32, 16, None), (16, 16, 0.0)):
        t0 = time.perf_counter()
        img = {}
        for device in ("cuda", "cpu"):
            scene, integ = _cloud(res, spp, device)
            if rr is not None:
                integ.rr_threshold = rr
            r = integ.render(scene)
            img[device] = (r.image, r.rays_traced)
        (a, ra), (b, rb) = img["cuda"], img["cpu"]
        diff = np.abs(a.astype(np.float64) - b).max(axis=-1)
        mse = float(np.mean((a.astype(np.float64) - b) ** 2))
        label = f"{res}x{res}x{spp}" + ("" if rr is None else ", Russian roulette off")
        log(f"[cloud] card vs CPU port at {label}: rays {ra} / {rb} ({ra - rb:+d}), MSE "
            f"{mse:.3e}, max |diff| {diff.max():.3e}, pixels off by > 1e-5: "
            f"{int((diff > 1e-5).sum())} of {diff.size} ({time.perf_counter() - t0:.1f} s with "
            f"the CPU render)")
        if mse > MSE_BAR or not np.isfinite(a).all():
            raise SmokeFailure(f"cloud: the card and the CPU port differ by MSE {mse:.3e}")
    return out


# -- phase 7 -------------------------------------------------------------------

def _caustic(res, spp, integrator, params, device):
    from tpu_pbrt_torch.scenes import compile_api, make_caustic_like

    return compile_api(make_caustic_like(res=res, spp=spp, maxdepth=5, integrator=integrator,
                                         params=params, device=device))


def _caustic_cases():
    """make_caustic_reference.py's cases: {integrator: (res, spp, params, file)}."""
    if GOLDEN not in sys.path:
        sys.path.insert(0, GOLDEN)
    import make_caustic_reference as mcr

    return {k: (*v[:3], mcr.out_path(k)) for k, v in mcr.CASES.items()}


def _wave_line(tag, label, wave):
    log(f"[{tag}] {label}: {wave['rays']} rays, {wave['live']} live, finite t_max on every live "
        f"ray: {wave['finite']}; {wave['hits']} hit; {wave['expands']} expand steps, "
        f"{wave['flushes']} flush chunks; expand captured after a flush: "
        f"{wave['expand_after_flush']}, flush chunk after that expand: "
        f"{wave['flush_after_expand']}")


def _modes_line(tag, label, res):
    st = res.stats
    parts = []
    for mode, m in st["wave_modes"].items():
        parts.append(f"{mode} {m['waves']} waves, {m['iters_per_wave_mean']:.2f} iterations, "
                     f"{m['expand_calls_per_wave_mean']:.2f} expand and "
                     f"{m['flush_calls_per_wave_mean']:.2f} flush launches per wave")
    log(f"[{tag}] {label}: {res.mray_per_sec:.4f} Mray/s, {res.rays_traced} rays in "
        f"{res.seconds:.3f} s; waves {st['waves']}: {'; '.join(parts)}")


def _log_loop_render(label, res, launches):
    """An sppm or mlt render (its own iteration loop): time, rays, Mray/s,
    waves and launches, and its stats."""
    log(f"[render] {label}: {res.seconds:.3f} s, {res.rays_traced} rays, "
        f"{res.mray_per_sec:.4f} Mray/s, traversal waves {res.stats['waves']}, launches "
        f"{json.dumps(launches)}")
    log(f"[render] {label}: stats {json.dumps(res.stats)}")


def phase_caustic():
    """The light-transport integrators on the caustic-glass-class scene (see
    the module doc, phase 7). Returns {kernel: {"connection": numbers at
    BDPT's connection wave, "photon": at SPPM's first photon wave}, with
    the timed renders' launches and Mray/s}."""
    import numpy as np
    import torch

    cases = _caustic_cases()
    t0 = time.perf_counter()
    scene, integ = _caustic(CAUSTIC_RES, CAUSTIC_SPP, "bdpt", "", "cuda")
    tp = scene.dev["tstream"]
    n_k = integ.max_depth * 4
    log(f"[scene] caustic: {scene.n_tris} triangles, {tp.n_treelets} treelets of "
        f"{tp.leaf_tris}, {tp.top.child_bmin.shape[0]} top-tree nodes, {scene.n_lights} light "
        f"rows, materials {np.unique(scene.dev['mat']['type'].cpu().numpy()).tolist()}, "
        f"compiled in {time.perf_counter() - t0:.2f} s; bdpt maxdepth {integ.max_depth}: "
        f"{n_k} connection strategies")
    count = tp.count

    # [check] BDPT's fused connection wave (any hit, finite t_max)
    plan = integ.prepare_chunks(scene)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cap, wave = _capture_first_wave(
        lambda: plan.dispatch(scene.film.init_state(scene.device), 0), True, "caustic bdpt")
    _wave_line("caustic", f"bdpt connection wave of chunk 0 ({plan.chunk} camera rays x {n_k} "
               f"strategies; captured in {time.perf_counter() - t0:.2f} s, peak device memory "
               f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)", wave)
    if wave["rays"] != n_k * plan.chunk or not wave["finite"]:
        raise SmokeFailure(f"caustic: the connection wave is not {n_k} x {plan.chunk} rays "
                           "with a finite t_max")
    out = {"flush_chunk": {"connection": _flush_numbers(cap["flush"], count,
                                                        "caustic connection wave", exact=True)},
           "expand": {"connection": _expand_numbers(cap["expand"], "caustic connection wave")}}
    del cap
    torch.cuda.empty_cache()

    # [render] BDPT timed at full size
    res, launches = _render_counted(integ, scene, regen=False)
    _log_render(f"caustic bdpt {CAUSTIC_RES}x{CAUSTIC_RES}x{CAUSTIC_SPP}", res, launches)
    _modes_line("caustic", f"bdpt {CAUSTIC_RES}x{CAUSTIC_RES}x{CAUSTIC_SPP}", res)
    if not np.isfinite(res.image).all() or res.stats["n_drop"] or not res.image.mean() > 0:
        raise SmokeFailure("caustic bdpt: non-finite or black image, or pairs dropped")
    for name in out:
        out[name]["connection"].update(launches=launches[name], mray_per_sec=res.mray_per_sec,
                                       res=CAUSTIC_RES, spp=CAUSTIC_SPP)
    del scene, integ, res, plan
    torch.cuda.empty_cache()

    # [check] SPPM's first photon wave (closest hit, rays leaving the lights)
    scene, integ = _caustic(SPPM_TIMED[0], 1, "sppm", SPPM_TIMED[1], "cuda")
    n_ph = integ.photons_per_iter
    count = scene.dev["tstream"].count
    t0 = time.perf_counter()
    cap, wave = _capture_first_wave(lambda: integ._photon_pass(scene.dev, n_ph, 0), False,
                                    "caustic sppm")
    _wave_line("caustic", f"sppm photon wave 0 ({n_ph} photons; captured in "
               f"{time.perf_counter() - t0:.2f} s)", wave)
    if wave["rays"] != n_ph:
        raise SmokeFailure("caustic: the photon wave does not hold one ray per photon")
    out["flush_chunk"]["photon"] = _flush_numbers(cap["flush"], count, "caustic photon wave",
                                                  exact=True)
    out["expand"]["photon"] = _expand_numbers(cap["expand"], "caustic photon wave")
    del cap
    res, launches = _render_counted(integ, scene, regen=False)
    _log_loop_render(f"caustic sppm {SPPM_TIMED[0]}x{SPPM_TIMED[0]} ({SPPM_TIMED[1]})", res,
                     launches)
    _modes_line("caustic", f"sppm {SPPM_TIMED[0]}x{SPPM_TIMED[0]}", res)
    if not np.isfinite(res.image).all() or res.stats["n_drop"] or res.stats["photons_dropped"]:
        raise SmokeFailure("caustic sppm: non-finite image or photons dropped")
    for name in out:
        out[name]["photon"].update(launches=launches[name], mray_per_sec=res.mray_per_sec,
                                   res=SPPM_TIMED[0])
    del scene, integ, res
    torch.cuda.empty_cache()

    # [render] MLT timed, with a chain count that fills the card
    scene, integ = _caustic(MLT_TIMED[0], 1, "mlt", MLT_TIMED[1], "cuda")
    res, launches = _render_counted(integ, scene, regen=False)
    _log_loop_render(f"caustic mlt {MLT_TIMED[0]}x{MLT_TIMED[0]} ({MLT_TIMED[1]})", res, launches)
    _modes_line("caustic", f"mlt {MLT_TIMED[0]}x{MLT_TIMED[0]} ({res.stats['chains']} chains, "
                f"{res.stats['steps']} steps, acceptance {res.stats['acceptance']:.4f})", res)
    if not np.isfinite(res.image).all() or res.stats["n_drop"] or not res.image.mean() > 0:
        raise SmokeFailure("caustic mlt: non-finite or black image, or pairs dropped")
    for name in out:
        out[name]["mlt_launches"] = launches[name]
        out[name]["mlt_mray_per_sec"] = res.mray_per_sec
    del scene, integ, res
    torch.cuda.empty_cache()

    # [render] against the JAX CPU references
    for integrator, (r_res, r_spp, r_params, path) in cases.items():
        ref = np.load(path)
        scene, integ = _caustic(r_res, r_spp, integrator, r_params, "cuda")
        res, launches = _render_counted(integ, scene, regen=False)
        label = f"caustic {integrator} {r_res}x{r_res} (JAX CPU reference)"
        (_log_render if integrator == "bdpt" else _log_loop_render)(label, res, launches)
        if integrator != "mlt":
            _against(label, res.image, res.rays_traced, ref, res.stats["n_drop"], tag="caustic")
        else:
            # one accept that flips reroutes a chain for good: the chains on
            # the card and in the reference part ways, and the image is held
            # by its mean
            img, want = res.image, ref["image"]
            mse = float(np.mean((img.astype(np.float64) - want) ** 2))
            rel = abs(float(img.mean()) - float(want.mean())) / float(want.mean())
            log(f"[caustic] {label}: image mean {img.mean():.6f} (JAX CPU {want.mean():.6f}, "
                f"{rel:.4%} apart, bar {MLT_MEAN_BAR:.0%}), per-pixel MSE {mse:.3e}, max |diff| "
                f"{np.abs(img - want).max():.3e}; rays {res.rays_traced} (JAX CPU "
                f"{int(ref['rays_traced'])}); acceptance {res.stats['acceptance']:.4f}, b "
                f"{res.stats['b']:.6f} (JAX CPU {json.loads(str(ref['stats']))})")
            if rel > MLT_MEAN_BAR or not np.isfinite(img).all() or res.stats["n_drop"]:
                raise SmokeFailure(f"caustic mlt: image mean {rel:.4%} from the reference")
        del scene, integ, res

    # [render] the card against the CPU port
    for integrator, res_, spp, params in (("bdpt", 16, 4, ""), ("sppm", 16, 1, SPPM_SMALL)):
        t0 = time.perf_counter()
        img = {}
        for device in ("cuda", "cpu"):
            scene, integ = _caustic(res_, spp, integrator, params, device)
            r = integ.render(scene)
            img[device] = (r.image, r.rays_traced)
        (a, ra), (b, rb) = img["cuda"], img["cpu"]
        diff = np.abs(a.astype(np.float64) - b).max(axis=-1)
        mse = float(np.mean((a.astype(np.float64) - b) ** 2))
        log(f"[caustic] card vs CPU port, {integrator} {res_}x{res_}: rays {ra} / {rb} "
            f"({ra - rb:+d}), MSE {mse:.3e}, max |diff| {diff.max():.3e}, pixels off by > 1e-5: "
            f"{int((diff > 1e-5).sum())} of {diff.size} ({time.perf_counter() - t0:.1f} s with "
            f"the CPU render)")
        if mse > MSE_BAR or not np.isfinite(a).all():
            raise SmokeFailure(f"caustic {integrator}: the card and the CPU port differ by MSE "
                               f"{mse:.3e}")
    return out


# -- phase 8 -------------------------------------------------------------------

def _breadth(res, spp, camera, filt, device, **kw):
    from tpu_pbrt_torch.scenes import compile_api, make_breadth_like

    return compile_api(make_breadth_like(res, spp, camera=camera, filter=filt, device=device,
                                         **kw))


def _vignetting(scene, integ, cpu_scene, cpu_integ):
    """The realistic camera's rays for every work item of the render on
    the card and on the CPU port: the vignetting masks (weight > 0) must
    be equal. Returns (lanes, vignetted on the card, on the CPU, masks
    differing, max |o| / |d| difference over the passing lanes)."""
    import torch

    out = []
    for sc, ig in ((scene, integ), (cpu_scene, cpu_integ)):
        x0, x1, y0, y1 = sc.film.sample_bounds()
        npix = (x1 - x0) * (y1 - y0)
        k = torch.arange(npix * sc.sampler.spp, dtype=torch.int32, device=sc.device)
        valid, *_, o, d, wt = ig.work_to_rays(sc.camera, sc.sampler.spp, x0, y0, x1 - x0, npix,
                                              0, 0, k)
        out.append((wt.cpu() > 0, o.cpu(), d.cpu()))
    (ma, oa, da), (mb, ob, db) = out
    both = ma & mb
    return (ma.numel(), int((~ma).sum()), int((~mb).sum()), int((ma != mb).sum()),
            float((oa - ob)[both].abs().max()), float((da - db)[both].abs().max()))


def phase_breadth():
    """Scene breadth on the card (see the module doc, phase 8): the kernels
    on the 512x512x16 render's pool and fixed waves, that render timed
    through both, the 64x64x16 perspective and realistic renders against
    the JAX CPU references, the realistic camera's vignetting against the
    CPU port, and the orthographic and environment cameras against the
    CPU port. Returns {kernel: numbers at the pool wave (the fixed wave's
    under "at_fixed_wave"), with the timed renders' launches and Mray/s}."""
    import numpy as np
    import torch

    from tpu_pbrt_torch.scenes import BREADTH_SMALL

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    scene, integ = _breadth(BREADTH_RES, BREADTH_SPP, "perspective", "gaussian", "cuda")
    tp = scene.dev["tstream"]
    types = scene.dev["light"]["type"].tolist()
    log(f"[scene] breadth: {scene.n_tris} triangles, {tp.n_treelets} treelets of "
        f"{tp.leaf_tris}, {tp.top.child_bmin.shape[0]} top-tree nodes, featT "
        f"{tuple(tp.featT.shape)}, light rows {types} (spot, goniometric, projection, "
        f"infinite), light atlas {tuple(scene.dev['light_atlas'].shape)}, materials "
        f"{np.unique(scene.dev['mat']['type'].cpu().numpy()).tolist()}, filter "
        f"{tuple(scene.film.filter)}, compiled in {time.perf_counter() - t0:.2f} s")
    if scene.n_tris != 1_178_624 or types != [1, 5, 6, 4]:
        raise SmokeFailure(f"breadth: expected 1,178,624 triangles and the four light types, "
                           f"got {scene.n_tris} and {types}")

    # [check] both kernels, exact, at the pool wave and the middle chunk's
    # first fixed-batch camera wave (2^20 rays: the unpacked flush key)
    n_chunks = integ.prepare_chunks(scene).n_chunks
    out, _ = _check_waves(scene, integ, "breadth ", fixed_chunk=n_chunks // 2, exact=True,
                          fixed_packed=False)

    # [render] the 512x512x16 render through the pool and the fixed batch
    pool, p_l = _render_counted(integ, scene, regen=True)
    _log_render(f"breadth pool {BREADTH_RES}x{BREADTH_RES}x{BREADTH_SPP}", pool, p_l)
    fixed, f_l = _render_counted(integ, scene, regen=False)
    _log_render(f"breadth fixed {BREADTH_RES}x{BREADTH_RES}x{BREADTH_SPP}", fixed, f_l)
    close = np.isclose(pool.image, fixed.image, rtol=1e-4, atol=1e-5)
    log(f"[breadth] {BREADTH_RES}x{BREADTH_RES}x{BREADTH_SPP}: pool {pool.mray_per_sec:.4f} "
        f"Mray/s, fixed {fixed.mray_per_sec:.4f} Mray/s (pool/fixed "
        f"{pool.mray_per_sec / max(fixed.mray_per_sec, 1e-9):.3f}); rays {pool.rays_traced} / "
        f"{fixed.rays_traced}; pool waves {pool.stats['n_waves']}, occupancy "
        f"{pool.stats['mean_wave_occupancy']:.4f}; image mean {pool.image.mean():.6f}, pixel "
        f"channels outside rtol 1e-4 / atol 1e-5 of the fixed batch: {int((~close).sum())}; "
        f"dropped {pool.stats['n_drop']} / {fixed.stats['n_drop']}")
    if (not np.isfinite(pool.image).all() or not pool.image.mean() > 1e-6
            or pool.rays_traced != fixed.rays_traced or not close.all()
            or pool.stats["n_drop"] or fixed.stats["n_drop"]):
        raise SmokeFailure("breadth 512x512: the pool and the fixed batch disagree, or the "
                           "image is not a finite lit render, or pairs dropped")
    for name in out:
        out[name].update(launches=p_l[name], launches_fixed=f_l[name],
                         mray_per_sec=pool.mray_per_sec, fixed_mray_per_sec=fixed.mray_per_sec,
                         res=BREADTH_RES, spp=BREADTH_SPP)
    del scene, integ, pool, fixed
    torch.cuda.empty_cache()

    # [render] 64x64x16 against the JAX CPU references
    for camera, filt in BREADTH_REFS.items():
        ref = np.load(BREADTH_REF.format(camera))
        t0 = time.perf_counter()
        scene, integ = _breadth(64, 16, camera, filt, "cuda")
        secs = time.perf_counter() - t0
        res, launches = _render_counted(integ, scene, regen=True)
        label = f"breadth {camera}/{filt} pool 64x64x16"
        _log_render(f"{label} (compiled in {secs:.2f} s)", res, launches)
        _against(label, res.image, res.rays_traced, ref, res.stats["n_drop"], tag="breadth")
        if camera == "realistic":
            t0 = time.perf_counter()
            cpu_scene, cpu_integ = _breadth(64, 16, camera, filt, "cpu", **BREADTH_SMALL)
            n, vc, vp, differ, do, dd = _vignetting(scene, integ, cpu_scene, cpu_integ)
            log(f"[breadth] realistic camera rays, card vs CPU port: {n} lanes, vignetted "
                f"{vc} / {vp}, masks differing {differ}; max |o| diff {do:.3e}, max |d| diff "
                f"{dd:.3e} ({time.perf_counter() - t0:.1f} s)")
            if differ or not 0 < vc < n:
                raise SmokeFailure("breadth: the realistic camera vignettes other lanes on the "
                                   "card than on the CPU port")
        del scene, integ, res

    # the card against the CPU port on the small tessellation
    for camera, filt in BREADTH_PORT.items():
        t0 = time.perf_counter()
        img = {}
        for device in ("cuda", "cpu"):
            scene, integ = _breadth(32, 4, camera, filt, device, **BREADTH_SMALL)
            r = integ.render(scene)
            img[device] = (r.image, r.rays_traced)
        (a, ra), (b, rb) = img["cuda"], img["cpu"]
        mse = float(np.mean((a.astype(np.float64) - b) ** 2))
        log(f"[breadth] card vs CPU port, {camera}/{filt} 32x32x4 (small tessellation): rays "
            f"{ra} / {rb}, MSE {mse:.3e} (bar {BREADTH_PORT_BAR:g}), max |diff| "
            f"{np.abs(a - b).max():.3e}, image mean {a.mean():.6f} "
            f"({time.perf_counter() - t0:.1f} s with the CPU render)")
        if ra != rb or not mse < BREADTH_PORT_BAR or not np.isfinite(a).all() or not a.mean() > 0:
            raise SmokeFailure(f"breadth {camera}: the card and the CPU port differ (rays {ra} / "
                               f"{rb}, MSE {mse:.3e})")
    log(f"[breadth] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 9 -------------------------------------------------------------------

def _textured(res, spp, device, **kw):
    from tpu_pbrt_torch.scenes import compile_api, make_textured_like

    return compile_api(make_textured_like(res, spp, device=device, **kw))


def _profile_line(label, scene, integ, regen: bool):
    """One render under torch.profiler (profile_render.measure): its idle
    share, device operations per wave with and without the texture
    evaluation, and the texture evaluation's share of the device time."""
    from tpu_pbrt_torch.config import cfg
    from tpu_pbrt_torch.profile_render import TEXTURES, measure

    saved = cfg.regen
    cfg.regen = regen
    try:
        m = measure(integ, scene)
    finally:
        cfg.regen = saved
    waves = max(m["res"].stats["waves"], 1)
    tex = m["ranges"][TEXTURES]
    share = tex["device_us"] / max(m["device_us"], 1e-9)
    log(f"[textured] profile {label}: wall {m['wall']:.3f} s (profiler on), traversal waves "
        f"{waves}, device busy {m['device_us'] / 1e6:.3f} s, idle share {m['idle_share']:.3f}; "
        f"device ops {m['ops']}, {m['ops_per_wave']:.0f} per wave, {(m['ops'] - tex['ops']) / waves:.0f} "
        f"per wave without the texture evaluation; texture evaluation {tex['calls']} calls, "
        f"{tex['ops']} ops ({tex['ops'] / waves:.0f} per wave), {tex['device_us'] / 1e3:.2f} ms "
        f"device = {share:.4f} of the device time, {tex['host_us'] / 1e3:.2f} ms host")
    log(f"[textured] profile {label}: device time by group "
        f"{json.dumps({k: round(v / 1e3, 2) for k, v in m['groups'].items()})} ms")
    if m["device_us"] <= 0 or not tex["calls"]:
        raise SmokeFailure(f"textured profile {label}: no device time or no texture range")
    return dict(idle_share=m["idle_share"], ops_per_wave=m["ops_per_wave"],
                ops_per_wave_without_textures=(m["ops"] - tex["ops"]) / waves,
                texture_device_share=share, waves=waves)


def phase_textured():
    """Textures and the layered materials on the card (see the module doc,
    phase 9): the kernels on the 512x512x16 render's pool and fixed waves,
    that render timed through both, one chunk of each profiled, 64x64x16
    against the JAX CPU reference, the card against the CPU port, and
    `bdpt` against its JAX CPU reference. Returns {kernel: numbers at the
    pool wave (the fixed wave's under "at_fixed_wave"), with the timed
    renders' launches and Mray/s}."""
    import numpy as np
    import torch

    from tpu_pbrt_torch.scenes import TEXTURED_SMALL

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    scene, integ = _textured(TEXTURED_RES, TEXTURED_SPP, "cuda")
    tp = scene.dev["tstream"]
    atlas = scene.dev["tex_atlas"]
    log(f"[scene] textured: {scene.n_tris} triangles, {tp.n_treelets} treelets of "
        f"{tp.leaf_tris}, {tp.top.child_bmin.shape[0]} top-tree nodes, {len(scene.tex_eval)} "
        f"textures, atlas {atlas.shape[0]} texels ({atlas.numel() * 4 / 1e6:.1f} MB f32), "
        f"tex_used {sorted(scene.tex_used)}, material types "
        f"{np.unique(scene.dev['mat']['type'].cpu().numpy()).tolist()}, mix rows "
        f"{int((scene.dev['mat']['mix_a'] >= 0).sum())}, compiled in "
        f"{time.perf_counter() - t0:.2f} s")
    if scene.n_tris != 1_166_214 or atlas.shape[0] != 8_738_132 or len(scene.tex_eval) < 14:
        raise SmokeFailure(f"textured: expected 1,166,214 triangles, 8,738,132 texels and 14 "
                           f"textures, got {scene.n_tris}, {atlas.shape[0]}, "
                           f"{len(scene.tex_eval)}")

    # [check] both kernels, exact, at the pool wave and the middle chunk's
    # first fixed-batch camera wave (2^20 rays: the unpacked flush key)
    n_chunks = integ.prepare_chunks(scene).n_chunks
    out, _ = _check_waves(scene, integ, "textured ", fixed_chunk=n_chunks // 2, exact=True,
                          fixed_packed=False)

    # [render] the 512x512x16 render through the pool and the fixed batch
    pool, p_l = _render_counted(integ, scene, regen=True)
    _log_render(f"textured pool {TEXTURED_RES}x{TEXTURED_RES}x{TEXTURED_SPP}", pool, p_l)
    fixed, f_l = _render_counted(integ, scene, regen=False)
    _log_render(f"textured fixed {TEXTURED_RES}x{TEXTURED_RES}x{TEXTURED_SPP}", fixed, f_l)
    close = np.isclose(pool.image, fixed.image, rtol=1e-4, atol=1e-5)
    log(f"[textured] {TEXTURED_RES}x{TEXTURED_RES}x{TEXTURED_SPP}: pool "
        f"{pool.mray_per_sec:.4f} Mray/s, fixed {fixed.mray_per_sec:.4f} Mray/s (pool/fixed "
        f"{pool.mray_per_sec / max(fixed.mray_per_sec, 1e-9):.3f}); rays {pool.rays_traced} / "
        f"{fixed.rays_traced}; pool waves {pool.stats['n_waves']}, occupancy "
        f"{pool.stats['mean_wave_occupancy']:.4f}; image mean {pool.image.mean():.6f}, pixel "
        f"channels outside rtol 1e-4 / atol 1e-5 of the fixed batch: {int((~close).sum())}; "
        f"dropped {pool.stats['n_drop']} / {fixed.stats['n_drop']}")
    if (not np.isfinite(pool.image).all() or not pool.image.mean() > 1e-6
            or pool.rays_traced != fixed.rays_traced or not close.all()
            or pool.stats["n_drop"] or fixed.stats["n_drop"]):
        raise SmokeFailure("textured 512x512: the pool and the fixed batch disagree, or the "
                           "image is not a finite lit render, or pairs dropped")
    for name in out:
        out[name].update(launches=p_l[name], launches_fixed=f_l[name],
                         mray_per_sec=pool.mray_per_sec, fixed_mray_per_sec=fixed.mray_per_sec,
                         res=TEXTURED_RES, spp=TEXTURED_SPP)
    del scene, integ, pool, fixed
    torch.cuda.empty_cache()

    # [profile] one chunk through the pool and the fixed batch (the kernels,
    # the allocator and the texture constants are warm from the renders above)
    res_p, spp_p = TEXTURED_PROFILE
    scene, integ = _textured(res_p, spp_p, "cuda")
    prof = {"pool": _profile_line(f"pool {res_p}x{res_p}x{spp_p}", scene, integ, True),
            "fixed": _profile_line(f"fixed {res_p}x{res_p}x{spp_p}", scene, integ, False)}
    for name in out:
        out[name]["profile"] = prof
    del scene, integ

    # [render] 64x64x16 against the JAX CPU reference, pool and fixed batch
    ref = np.load(TEXTURED_REF)
    t0 = time.perf_counter()
    scene, integ = _textured(64, 16, "cuda")
    secs = time.perf_counter() - t0
    for regen in (True, False):
        res, launches = _render_counted(integ, scene, regen=regen)
        label = f"textured {'pool' if regen else 'fixed'} 64x64x16"
        _log_render(f"{label} (compiled in {secs:.2f} s)", res, launches)
        _against(label, res.image, res.rays_traced, ref, res.stats["n_drop"], tag="textured")
    del scene, integ

    # the card against the CPU port on the small variant
    t0 = time.perf_counter()
    got = {}
    for device in ("cuda", "cpu"):
        scene, integ = _textured(32, 4, device, **TEXTURED_SMALL)
        r = integ.render(scene)
        got[device] = (r.image, r.rays_traced)
    (a, ra), (b, rb) = got["cuda"], got["cpu"]
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    log(f"[textured] card vs CPU port, 32x32x4 (small variant): rays {ra} / {rb}, MSE "
        f"{mse:.3e} (bar {MSE_BAR:g}), max |diff| {np.abs(a - b).max():.3e}, image mean "
        f"{a.mean():.6f} ({time.perf_counter() - t0:.1f} s with the CPU render)")
    if not mse < MSE_BAR or not np.isfinite(a).all() or not a.mean() > 0:
        raise SmokeFailure(f"textured: the card and the CPU port differ (MSE {mse:.3e})")

    # [render] bdpt with mix lanes against its JAX CPU reference
    ref = np.load(TEXTURED_BDPT_REF)
    t0 = time.perf_counter()
    from tpu_pbrt_torch.scenes import compile_api, make_textured_like

    scene, integ = compile_api(make_textured_like(32, 16, integrator="bdpt", device="cuda"))
    res = integ.render(scene)
    log(f"[textured] bdpt 32x32x16: {res.seconds:.3f} s, {res.mray_per_sec:.4f} Mray/s "
        f"({time.perf_counter() - t0:.1f} s with the compile)")
    _against("textured bdpt 32x32x16", res.image, res.rays_traced, ref, res.stats["n_drop"],
             tag="textured")
    del scene, integ, res
    log(f"[textured] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 10 ------------------------------------------------------------------

def _motion(res, spp, device, **kw):
    from tpu_pbrt_torch.scenes import compile_api, make_motion_like

    return compile_api(make_motion_like(res, spp, device=device, **kw))


def phase_motion():
    """Motion blur, disney and hair on the card (see the module doc, phase
    10): the kernels on the 512x512x16 render's pool and fixed waves (F =
    64, real ray times), that render timed through both, `path` 64x64x64
    and `bdpt` 32x32x16 against the JAX CPU references, and the card
    against the CPU port. Returns {kernel: numbers at the pool wave (the
    fixed wave's under "at_fixed_wave"), with the timed renders' launches
    and Mray/s}."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    scene, integ = _motion(MOTION_RES, MOTION_SPP, "cuda")
    secs = time.perf_counter() - t0
    tp = scene.dev["tstream"]
    types = np.unique(scene.dev["mat"]["type"].cpu().numpy()).tolist()
    log(f"[scene] motion: {scene.n_tris} triangles, {tp.n_treelets} treelets of {tp.leaf_tris}, "
        f"{tp.top.child_bmin.shape[0]} top-tree nodes, featT F = {tp.n_features} "
        f"({tp.featT.numel() * 4 / 1e9:.3f} GB f32), tri_verts1 "
        f"{'tri_verts1' in scene.dev}, tri_tanT {'tri_tanT' in scene.dev}, material types "
        f"{types}, compiled in {secs:.2f} s")
    if (scene.n_tris != 1_042_004 or tp.n_features != 64 or "tri_verts1" not in scene.dev
            or "tri_tanT" not in scene.dev or not {9, 10} <= set(types)):
        raise SmokeFailure("motion: expected 1,042,004 triangles with the F = 64 pack, the "
                           "shutter-end keyframe, the hair tangents and disney + hair rows")

    # [check] both kernels, exact, at the pool wave (real ray times per
    # regenerated lane) and the middle chunk's first fixed-batch camera
    # wave (2^20 rays: the unpacked flush key)
    n_chunks = integ.prepare_chunks(scene).n_chunks
    out, _ = _check_waves(scene, integ, "motion ", fixed_chunk=n_chunks // 2, exact=True,
                          fixed_packed=False, features=64)

    # [render] the 512x512x16 render through the pool and the fixed batch
    pool, p_l = _render_counted(integ, scene, regen=True)
    _log_render(f"motion pool {MOTION_RES}x{MOTION_RES}x{MOTION_SPP}", pool, p_l)
    fixed, f_l = _render_counted(integ, scene, regen=False)
    _log_render(f"motion fixed {MOTION_RES}x{MOTION_RES}x{MOTION_SPP}", fixed, f_l)
    close = np.isclose(pool.image, fixed.image, rtol=1e-4, atol=1e-5)
    log(f"[motion] {MOTION_RES}x{MOTION_RES}x{MOTION_SPP}: pool {pool.mray_per_sec:.4f} Mray/s, "
        f"fixed {fixed.mray_per_sec:.4f} Mray/s (pool/fixed "
        f"{pool.mray_per_sec / max(fixed.mray_per_sec, 1e-9):.3f}); rays {pool.rays_traced} / "
        f"{fixed.rays_traced}; pool waves {pool.stats['n_waves']}, occupancy "
        f"{pool.stats['mean_wave_occupancy']:.4f}; image mean {pool.image.mean():.6f}, pixel "
        f"channels outside rtol 1e-4 / atol 1e-5 of the fixed batch: {int((~close).sum())}; "
        f"dropped {pool.stats['n_drop']} / {fixed.stats['n_drop']}; {card_line()}")
    if (not np.isfinite(pool.image).all() or not pool.image.mean() > 1e-6
            or pool.rays_traced != fixed.rays_traced or not close.all()
            or pool.stats["n_drop"] or fixed.stats["n_drop"]
            or not p_l["flush_chunk"] > 0 or not f_l["flush_chunk"] > 0):
        raise SmokeFailure("motion 512x512: the pool and the fixed batch disagree, the image is "
                           "not a finite lit render, pairs dropped, or the F = 64 flush never ran")
    for name in out:
        out[name].update(launches=p_l[name], launches_fixed=f_l[name],
                         mray_per_sec=pool.mray_per_sec, fixed_mray_per_sec=fixed.mray_per_sec,
                         res=MOTION_RES, spp=MOTION_SPP)
    del scene, integ, pool, fixed
    torch.cuda.empty_cache()

    # [render] path 64x64x64 against the JAX CPU reference, pool and fixed batch
    ref = np.load(MOTION_REF)
    t0 = time.perf_counter()
    scene, integ = _motion(64, 64, "cuda")
    secs = time.perf_counter() - t0
    for regen in (True, False):
        res, launches = _render_counted(integ, scene, regen=regen)
        label = f"motion {'pool' if regen else 'fixed'} 64x64x64"
        _log_render(f"{label} (compiled in {secs:.2f} s)", res, launches)
        _against(label, res.image, res.rays_traced, ref, res.stats["n_drop"], tag="motion")
    del scene, integ

    # [render] bdpt (the shutter-start frame; disney and hair through BDPT)
    ref = np.load(MOTION_BDPT_REF)
    t0 = time.perf_counter()
    scene, integ = _motion(32, 16, "cuda", integrator="bdpt")
    res = integ.render(scene)
    log(f"[motion] bdpt 32x32x16: {res.seconds:.3f} s, {res.mray_per_sec:.4f} Mray/s "
        f"({time.perf_counter() - t0:.1f} s with the compile)")
    _against("motion bdpt 32x32x16", res.image, res.rays_traced, ref, res.stats["n_drop"],
             tag="motion")
    del scene, integ, res

    # the card against the CPU port on the small variant
    t0 = time.perf_counter()
    got = {}
    for device in ("cuda", "cpu"):
        scene, integ = _motion(32, 4, device, small=True)
        r = integ.render(scene)
        got[device] = (r.image, r.rays_traced)
    (a, ra), (b, rb) = got["cuda"], got["cpu"]
    mse = float(np.mean((a.astype(np.float64) - b) ** 2))
    log(f"[motion] card vs CPU port, 32x32x4 (small variant): rays {ra} / {rb}, MSE "
        f"{mse:.3e} (bar {MSE_BAR:g}), max |diff| {np.abs(a - b).max():.3e}, image mean "
        f"{a.mean():.6f} ({time.perf_counter() - t0:.1f} s with the CPU render)")
    if not mse < MSE_BAR or not np.isfinite(a).all() or not a.mean() > 0:
        raise SmokeFailure(f"motion: the card and the CPU port differ (MSE {mse:.3e})")
    log(f"[motion] phase wall time {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 11 ------------------------------------------------------------------

def phase_cli(device: str = "cuda") -> None:
    """The CLI on the Cornell box in subprocesses: an uninterrupted
    render, and one killed after its first checkpoint then resumed, which
    must end bit-identical to the first."""
    import shutil
    import tempfile

    import numpy as np

    from tpu_pbrt_torch.parallel.checkpoint import load_checkpoint
    from tpu_pbrt_torch.utils.imageio import read_exr

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    try:
        def cmd(name):
            return [sys.executable, "-m", "tpu_pbrt_torch.main",
                    os.path.join(HERE, "scenes", "cornell-path.pbrt"), "--quick", "--quiet",
                    "--device", device, "--spp-chunk", "2048", "--checkpoint-every", "1",
                    "-o", os.path.join(tmp, f"{name}.exr"),
                    "--checkpoint", os.path.join(tmp, f"{name}.npz")]

        t0 = time.perf_counter()
        r = subprocess.run(cmd("a"), cwd=HERE, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise SmokeFailure(f"cli: exit {r.returncode}: {r.stderr[-2000:]}")
        img = read_exr(os.path.join(tmp, "a.exr"))
        full, n_chunks, rays, _ = load_checkpoint(os.path.join(tmp, "a.npz"))
        log(f"[cli] uninterrupted: {time.perf_counter() - t0:.1f} s, image {img.shape} mean "
            f"{img.mean():.5f}, {n_chunks} chunks, {rays} rays")
        if img.shape != (64, 64, 3) or not np.isfinite(img).all() or not img.mean() > 0:
            raise SmokeFailure("cli: the written image is not a finite 64x64 render")

        t0 = time.perf_counter()
        ck = os.path.join(tmp, "b.npz")
        proc = subprocess.Popen(cmd("b"), cwd=HERE, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE)
        try:
            while not os.path.exists(ck) and proc.poll() is None:
                time.sleep(0.002)
            proc.kill()
        finally:
            proc.wait(timeout=60)
        cursor = load_checkpoint(ck)[1]
        log(f"[cli] killed after its first checkpoint: cursor {cursor} of {n_chunks} "
            f"({time.perf_counter() - t0:.1f} s)")
        if not 1 <= cursor < n_chunks or os.path.exists(os.path.join(tmp, "b.exr")):
            raise SmokeFailure(f"cli: the second render was not stopped mid-way (cursor {cursor})")
        r = subprocess.run(cmd("b"), cwd=HERE, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise SmokeFailure(f"cli resume: exit {r.returncode}: {r.stderr[-2000:]}")
        resumed, n2, rays2, _ = load_checkpoint(ck)
        same_film = all(np.array_equal(x.numpy(), y.numpy()) for x, y in zip(full, resumed))
        with open(os.path.join(tmp, "a.exr"), "rb") as fa, open(os.path.join(tmp, "b.exr"), "rb") as fb:
            same_img = fa.read() == fb.read()
        log(f"[cli] resumed: cursor {n2}, {rays2} rays; film bit-identical {same_film}, "
            f"image file identical {same_img}")
        if not (same_film and same_img and n2 == n_chunks and rays2 == rays):
            raise SmokeFailure("cli: the resumed render differs from the uninterrupted one")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not (os.path.isdir(os.path.join(HERE, "tpu_pbrt_torch")) and os.path.exists(REF_IMAGE)
            and os.path.exists(CROWN_REF) and os.path.exists(CORNELL_REF)
            and os.path.exists(CLOUD_REF) and os.path.exists(BREADTH_REF.format("realistic"))
            and os.path.exists(TEXTURED_REF) and os.path.exists(TEXTURED_BDPT_REF)
            and os.path.exists(MOTION_REF) and os.path.exists(MOTION_BDPT_REF)
            and os.path.exists(os.path.join(GOLDEN, "make_caustic_reference.py"))):
        print("chip_smoke: run from a checkout of the repo (tpu_pbrt_torch/, refimg/ and "
              "tests/torch_golden/ must sit beside this script)", file=sys.stderr)
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
        launches, flaunches = phase_render(scene, integ)
        del scene, integ
        torch.cuda.empty_cache()

        cscene, cinteg = crown_scene()
        ct, rays = phase_crown_check(cscene, cinteg)
        phase_branch(cscene, rays)
        del rays
        claunches, c64_pool, c64_fixed, cres = phase_crown_render(cscene, cinteg)
        del cscene, cinteg
        torch.cuda.empty_cache()
        dt = phase_direct()
        torch.cuda.empty_cache()
        phase_samplers()
        lt = phase_cloud()
        torch.cuda.empty_cache()
        kt_c = phase_caustic()
        torch.cuda.empty_cache()
        kt_b = phase_breadth()
        torch.cuda.empty_cache()
        kt_t = phase_textured()
        torch.cuda.empty_cache()
        kt_m = phase_motion()
        torch.cuda.empty_cache()
        phase_cli()

        def kernel(name, source, replaces):
            crown = dict(ct[name], launches=claunches[name], launches_64_pool=c64_pool[name],
                         launches_64_fixed=c64_fixed[name], spp=CROWN_SPP,
                         mray_per_sec=cres.mray_per_sec)
            k = dict(name=name, route="cuda", source=source, replaces=replaces,
                     launches=launches[name], launches_fixed=flaunches[name], **kt[name],
                     crown=crown, direct=dt[name], cloud=lt[name], caustic=kt_c[name],
                     breadth=kt_b[name], textured=kt_t[name], motion=kt_m[name])
            k["max_abs_err"] = max(k["max_abs_err"], crown["max_abs_err"], dt[name]["max_abs_err"],
                                   lt[name]["max_abs_err"],
                                   kt_c[name]["connection"]["max_abs_err"],
                                   kt_c[name]["photon"]["max_abs_err"],
                                   kt_b[name]["max_abs_err"], kt_t[name]["max_abs_err"],
                                   kt_m[name]["max_abs_err"])
            return k

        kernels = [
            kernel("flush_chunk", "tpu_pbrt_torch/csrc/flush.cu",
                   "tpu_pbrt/accel/fusedwave.py:211"),
            kernel("expand", "tpu_pbrt_torch/csrc/expand.cu", "tpu_pbrt/accel/fusedwave.py:348"),
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
