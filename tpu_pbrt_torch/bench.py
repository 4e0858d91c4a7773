"""Killeroo-class benchmark of the port on one GPU (counterpart of the
repository's bench.py, which renders the same workload with the JAX
package).

    python -m tpu_pbrt_torch.bench

Renders `scenes.make_killeroo_like` (the ~128k-triangle matte mesh, area
and point light, `path` at maxdepth 5) on CUDA through
`PathIntegrator.render`: a warm-up pass boxed to 5 s (kernel builds,
allocator), then the measured pass, boxed to MEASURE_S and stopped at a
chunk boundary. Mray/s is rays traced over the measured pass's wall
time, which ends in a device synchronize. Then, unless BENCH_SKIP_MSE=1,
it renders the 128x128 256-spp scene and takes the per-pixel MSE against
refimg/killeroo_cpu_128x128_256spp.npz (bar 1e-4).

Then, unless BENCH_SKIP_CROWN=1, the crown-class leg (the reference
bench's crown row): `scenes.make_crown_like` at its full geometry
(1,153,682 triangles: glass, two metal-GGX pieces, a matte ground, the
HDR sky as an infinite light) at CROWN_RES (default 512) and CROWN_SPP
(default 256), warmed up for 5 s, then rendered boxed to MEASURE_S; it
adds crown_mray_per_sec, crown_completed_fraction, crown_rays_traced and
crown_image_mean to the same line. A crown failure is not caught: the
bench exits non-zero without printing a line.

Prints one JSON line with the reference's keys (metric, value, unit,
mse, tracer_mode, crown_*, ...) and the render's stats. Env knobs as in
the reference: BENCH_SPP (default 256), BENCH_RES (default 512),
BENCH_SKIP_MSE, CROWN_RES, CROWN_SPP, BENCH_SKIP_CROWN. It needs a CUDA
device and does not fall back to the CPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: wall-time box of the measured pass, seconds (stops at a chunk boundary)
MEASURE_S = 120.0
MSE_RES, MSE_SPP = 128, 256
MSE_TARGET = 1e-4


def _card() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def compute_mse(device) -> float:
    """The 128x128 256-spp render's per-pixel MSE against the JAX
    package's CPU reference image."""
    from tpu_pbrt_torch.scenes import compile_api, make_killeroo_like

    path = os.path.join(HERE, "refimg", f"killeroo_cpu_{MSE_RES}x{MSE_RES}_{MSE_SPP}spp.npz")
    ref = np.load(path)["image"].astype(np.float64)
    scene, integ = compile_api(make_killeroo_like(res=MSE_RES, spp=MSE_SPP, device=device))
    img = integ.render(scene).image
    return float(np.mean((img.astype(np.float64) - ref) ** 2))


def crown_leg(device) -> dict:
    """The crown-class row: compile, a 5 s warm-up, the boxed render."""
    from tpu_pbrt_torch.scenes import compile_api, make_crown_like

    res = int(os.environ.get("CROWN_RES", "512"))
    spp = int(os.environ.get("CROWN_SPP", "256"))
    t0 = time.perf_counter()
    scene, integ = compile_api(make_crown_like(res=res, spp=spp, device=device))
    compile_s = time.perf_counter() - t0
    integ.render(scene, max_seconds=5.0)
    cres = integ.render(scene, max_seconds=MEASURE_S)
    mean = float(np.mean(cres.image))
    if not (np.isfinite(cres.image).all() and mean > 1e-6):
        raise RuntimeError(f"crown: the image is not a finite, lit render (mean {mean})")
    return {
        "crown_mray_per_sec": cres.mray_per_sec,
        "crown_completed_fraction": cres.completed_fraction,
        "crown_rays_traced": cres.rays_traced,
        "crown_image_mean": mean,
        "crown_res": res,
        "crown_spp": spp,
        "crown_seconds": cres.seconds,
        "crown_scene_compile_seconds": compile_s,
        "crown_n_drop": cres.stats["n_drop"],
        "crown_stats": cres.stats,
    }


def main() -> int:
    import torch

    from tpu_pbrt_torch.accel.stream import flush_geometry
    from tpu_pbrt_torch.config import resolve_device
    from tpu_pbrt_torch.scenes import compile_api, make_killeroo_like

    try:
        device = resolve_device(None)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    spp = int(os.environ.get("BENCH_SPP", "256"))
    res = int(os.environ.get("BENCH_RES", "512"))
    t0 = time.perf_counter()
    scene, integ = compile_api(make_killeroo_like(res=res, spp=spp, device=device))
    scene_compile_seconds = time.perf_counter() - t0
    integ.render(scene, max_seconds=5.0)
    result = integ.render(scene, max_seconds=MEASURE_S)
    stats = result.stats
    img_mean = float(np.mean(result.image))
    line = {
        "metric": "killeroo_like_path_mray_per_sec",
        "value": result.mray_per_sec,
        "unit": "Mray/s",
        "completed_fraction": result.completed_fraction,
        "rays_traced": result.rays_traced,
        "seconds": result.seconds,
        "image_mean": img_mean,
        "scene_compile_seconds": scene_compile_seconds,
        "res": res,
        "spp": spp,
        "tracer_mode": stats.get("tracer_mode"),
        "device": torch.cuda.get_device_name(device),
        "card": _card(),
    }
    if stats.get("pool"):
        line["mean_wave_occupancy"] = stats["mean_wave_occupancy"]
        line["trace_waves"] = stats["n_waves"]
        line["pool"] = stats["pool"]
        # the tracer sees the fused camera+shadow 2R wave
        line["fused_blocks_per_flush"] = flush_geometry(
            2 * stats["pool"], scene.dev["tstream"].n_treelets)["blocks_per_flush"]
    if not img_mean > 1e-6:
        line["error"] = "image is black: tracer broken"
    if not os.environ.get("BENCH_SKIP_CROWN"):
        line.update(crown_leg(device))
    if not os.environ.get("BENCH_SKIP_MSE"):
        line["mse"] = compute_mse(device)
        line["mse_target"] = MSE_TARGET
    line["stats"] = stats
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
