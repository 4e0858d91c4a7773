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

After the measured leg (and before the crown and MSE legs), unless
BENCH_SKIP_STATIC=1, the static half of the roofline: a subprocess
(`python -m tpu_pbrt_torch.analysis.cost --bench-wave`, killed after
STATIC_S seconds) compiles the same scene and records one wave of the
measured render's pool on the card (analysis/cost.py::
bench_wave_rollup), which gives static_flops_per_wave,
static_bytes_per_wave, static_intensity and static_ops_per_wave. They
are advisory, as in the reference: a failure or an overrun nulls them
and never touches `value`. The `telemetry` block (telemetry_block) then
carries the measured leg's counters, wave spread, tracer mode, fused
blocks per flush, phase seconds, host_overlap_fraction and
obs/rooflive.py's live_vs_static fields.

Prints one JSON line with the reference's keys (metric, value, unit,
mse, tracer_mode, crown_*, static_*, telemetry, ...) and the render's
stats. Env knobs as in
the reference: BENCH_SPP (default 256), BENCH_RES (default 512),
BENCH_SKIP_MSE, CROWN_RES, CROWN_SPP, BENCH_SKIP_CROWN. It needs a CUDA
device and does not fall back to the CPU.

Before the timed legs, the backend probe (the reference bench's
`probe_backend`): a subprocess initialises CUDA and launches one tiny op
under a 150 s timeout, retried with the
reference's capped, deterministically jittered backoff up to
BENCH_PROBE_ATTEMPTS times (default 3). A CUDA runtime that hangs in
its initialisation cannot be bounded in-process; a subprocess can. Each
attempt, backoff and give-up is a FLIGHT heartbeat (`probe`,
`probe_backoff`, `probe_giveup`) in TORCH_PBRT_FLIGHT_PATH (default
BENCH_flight.jsonl), written as the reference writes them. When no
attempt succeeds the bench prints an `infra_outage` line and exits 1;
it never renders on the CPU. `probe:hang@attempt=N` in
TORCH_PBRT_FAULTS makes attempt N a subprocess that sleeps past the
timeout (the chaos seam); BENCH_SKIP_PROBE=1 skips the probe.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np

T_START = time.time()
#: wall-clock budget the probe's retries must fit in, seconds
BUDGET = float(os.environ.get("BENCH_BUDGET_S", "520"))
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: wall-time box of the measured pass, seconds (stops at a chunk boundary)
MEASURE_S = 120.0
MSE_RES, MSE_SPP = 128, 256
MSE_TARGET = 1e-4
#: time box of the static wave record, seconds
STATIC_S = 150.0
#: the static fields of the line (null when the record failed)
STATIC_KEYS = ("static_flops_per_wave", "static_bytes_per_wave", "static_intensity",
               "static_ops_per_wave")


# -- flight heartbeats of the probe phases ---------------------------------
# The reference writes these few lines without importing its package
# (whose import would start the runtime the probe exists to bound); the
# port keeps the same format, and once the probe passes the render's own
# FlightRecorder appends to the same file.
_FLIGHT_PATH = os.environ.get("TORCH_PBRT_FLIGHT_PATH") or "BENCH_flight.jsonl"
_TELEMETRY_ON = os.environ.get("TORCH_PBRT_TELEMETRY", "1").strip().lower() \
    not in ("0", "false", "no", "off")
_last_phase = None


def _flight_heartbeat(phase: str, **fields):
    global _last_phase
    _last_phase = phase
    if not _TELEMETRY_ON:
        return
    line = {"t": round(time.time(), 3), "elapsed_s": round(time.time() - T_START, 3),
            "phase": phase}
    line.update(fields)
    try:
        with open(_FLIGHT_PATH, "a") as f:
            f.write(json.dumps(line) + "\n")
    except OSError:
        pass


def _probe_hang_attempts() -> set:
    """The probe's chaos seam: the attempts that `probe:hang@attempt=N`
    entries of TORCH_PBRT_FAULTS name (the chaos registry's grammar, read
    before anything else runs; a bare value is the attempt)."""
    out = set()
    for entry in os.environ.get("TORCH_PBRT_FAULTS", "").split(","):
        entry = entry.strip()
        if not entry.startswith("probe:hang"):
            continue
        attempt = 1
        _, _, tail = entry.partition("@")
        for part in tail.split("&"):
            part = part.strip()
            if not part:
                continue
            k, eq, v = part.partition("=")
            if not eq:
                k, v = "attempt", k  # bare value -> the site default key
            if k == "attempt":
                try:
                    attempt = int(v)
                except ValueError:
                    pass
        out.add(attempt)
    return out


#: cumulative backoff the probe slept (reported on the outage JSON line)
_PROBE_BACKOFF_S = 0.0

#: the probe's healthy attempt: initialise the device and run one op
_PROBE_CODE = (
    "import torch; dev = torch.device({device!r}); "
    "x = torch.ones(8, device=dev) + 1; "
    "name = torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'; "
    "torch.cuda.synchronize(dev) if dev.type == 'cuda' else None; "
    "print(name, '|', dev.type, float(x.sum()), flush=True)"
)


def probe_backend(timeout_s: float = 150.0, max_attempts: int = 0,
                  backoff_base_s: float = 5.0, backoff_cap_s: float = 60.0,
                  device: str = "cuda") -> tuple:
    """Bounded device health check in a SUBPROCESS: it initialises
    `device` (CUDA unless the caller names the CPU) and launches one tiny
    op. Returns (ok, detail, retries, wait_seconds): retries = attempts
    beyond the first, wait_seconds = the time spent in the probe,
    backoff included.

    Retry policy (the reference's): capped exponential backoff with
    deterministic jitter between attempts (min(base * 2^k, cap) scaled
    into [0.5, 1.0]); every attempt and backoff is a FLIGHT heartbeat
    with its detail and the cumulative backoff, and an attempt is not
    started when the remaining BENCH_BUDGET_S cannot absorb it."""
    global _PROBE_BACKOFF_S
    code_ok = _PROBE_CODE.format(device=str(device))
    # chaos probe:hang — a subprocess that outlives the timeout is
    # indistinguishable from a runtime hung in its initialisation
    code_hang = "import time; time.sleep(3600)"
    hang_attempts = _probe_hang_attempts()
    max_attempts = max_attempts or int(os.environ.get("BENCH_PROBE_ATTEMPTS", "3"))
    t_probe = time.time()
    retries = 0
    detail = "?"
    for attempt in range(1, max_attempts + 1):
        if attempt > 1:
            retries += 1
        simulated = attempt in hang_attempts
        _flight_heartbeat("probe", attempt=attempt, **({"chaos_hang": True} if simulated else {}))
        try:
            r = subprocess.run([sys.executable, "-c", code_hang if simulated else code_ok],
                               capture_output=True, text=True, timeout=timeout_s)
            if r.returncode == 0 and r.stdout.strip():
                detail = r.stdout.strip()
                _flight_heartbeat("probe", attempt=attempt, ok=True, backend=detail)
                return True, detail, retries, time.time() - t_probe
            detail = (r.stderr or "").strip().splitlines()[-1:] or ["?"]
            detail = f"rc={r.returncode}: {detail[0][:200]}"
        except subprocess.TimeoutExpired:
            detail = f"backend init hung >{timeout_s:.0f}s"
        _flight_heartbeat("probe", attempt=attempt, ok=False, detail=detail)
        if attempt == max_attempts:
            break
        b = min(backoff_base_s * (2.0 ** (attempt - 1)), backoff_cap_s)
        # deterministic jitter (zlib.crc32 of the attempt index): the
        # same run shape replays identically under chaos
        frac = (zlib.crc32(f"probe:{attempt}".encode()) & 0xFFFF) / 65535.0
        sleep_s = b * (0.5 + 0.5 * frac)
        if BUDGET - (time.time() - T_START) < timeout_s + sleep_s + 30:
            # no budget for another attempt and its backoff
            _flight_heartbeat("probe_giveup", attempt=attempt,
                              remaining_s=round(BUDGET - (time.time() - T_START), 1))
            break
        _PROBE_BACKOFF_S += sleep_s
        _flight_heartbeat("probe_backoff", attempt=attempt, backoff_s=round(sleep_s, 1),
                          backoff_total_s=round(_PROBE_BACKOFF_S, 1))
        print(f"backend probe failed ({detail}); retrying in {sleep_s:.1f}s", file=sys.stderr)
        time.sleep(sleep_s)
    return False, detail, retries, time.time() - t_probe


def _card() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def static_wave_cost(res: int, spp: int, timeout_s: float = STATIC_S,
                     device: str = "cuda") -> dict:
    """The static per-wave cost of the bench's pool: a SUBPROCESS
    (`python -m tpu_pbrt_torch.analysis.cost --bench-wave`) compiles the
    bench's scene at `res` and `spp` and records one wave of the pool its
    render plans on `device`, killed at `timeout_s`, as the reference's
    static step is. Advisory: {} on a failure or an overrun
    (the judged metrics never depend on it, and nothing of it outlives
    the call)."""
    if os.environ.get("BENCH_SKIP_STATIC"):
        return {}
    cmd = [sys.executable, "-m", "tpu_pbrt_torch.analysis.cost", "--bench-wave", "--res",
           str(res), "--spp", str(spp), "--device", str(device)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout_s, cwd=HERE)
    except subprocess.TimeoutExpired:
        print(f"static wave cost: over {timeout_s:.0f} s, left out", file=sys.stderr)
        return {}
    try:
        line = json.loads(r.stdout.strip().splitlines()[-1]) if r.returncode == 0 else None
    except (IndexError, ValueError):
        line = None
    if not isinstance(line, dict):
        tail = (r.stderr or r.stdout or "").strip().splitlines()[-1:] or ["?"]
        print(f"static wave cost failed: rc={r.returncode}: {tail[0][:200]}", file=sys.stderr)
        return {}
    return {k: line.get(k) for k in STATIC_KEYS}


def telemetry_block(result, scene, static: dict) -> dict:
    """The bench line's `telemetry` block (the reference bench's): the
    measured render's device counters and per-rank wave spread, the
    tracer mode, the fused blocks per flush of its 2R wave, the phase
    histogram summary, host_overlap_fraction over the measured leg, and
    the live-vs-static roofline (obs/rooflive.py) of its waves against
    `static`'s per-wave bytes and FLOPs. Every key is present; a value
    that cannot be had is null."""
    import torch

    from tpu_pbrt_torch.accel.stream import flush_geometry
    from tpu_pbrt_torch.obs.metrics import host_overlap_fraction, phase_summary
    from tpu_pbrt_torch.obs.rooflive import live_vs_static

    stats = result.stats
    tstats = stats.get("telemetry") or {}
    fused_blocks = None
    if stats.get("pool") and "tstream" in scene.dev:
        # the tracer sees the fused camera+shadow 2R wave
        fused_blocks = flush_geometry(2 * int(stats["pool"]),
                                      scene.dev["tstream"].n_treelets)["blocks_per_flush"]
    dev = torch.device(scene.device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return {
        "counters": tstats.get("counters"),
        "wave_spread": tstats.get("wave_spread"),
        "tracer_mode": stats.get("tracer_mode"),
        "fused_blocks_per_flush": fused_blocks,
        "phase_seconds": phase_summary(),
        "host_overlap_fraction": host_overlap_fraction(stats.get("phase_seconds"),
                                                       result.seconds),
        **live_vs_static(waves=stats.get("n_waves"), seconds=result.seconds,
                         static_bytes_per_wave=static.get("static_bytes_per_wave"),
                         static_flops_per_wave=static.get("static_flops_per_wave"),
                         device_kind=kind, n_devices=1),
    }


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

    if not os.environ.get("BENCH_SKIP_PROBE"):
        ok, detail, retries, wait_s = probe_backend()
        if not ok:
            # an outage is reported, never measured: no render, no CPU
            print(json.dumps({
                "metric": "killeroo_like_path_mray_per_sec", "value": 0.0, "unit": "Mray/s",
                "infra_outage": True,
                "error": f"CUDA device unreachable ({detail}); nothing was rendered",
                "probe_retries": retries, "probe_wait_seconds": round(wait_s, 1),
                "probe_backoff_seconds": round(_PROBE_BACKOFF_S, 1),
                "flight_phase": _last_phase, "flight_path": _FLIGHT_PATH,
            }))
            _flight_heartbeat("report", infra_outage=True, retries=retries)
            return 1
        print(f"backend: {detail}", file=sys.stderr)
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
    static = static_wave_cost(res, spp) if stats.get("pool") else {}
    line.update({k: static.get(k) for k in STATIC_KEYS})
    line["telemetry"] = telemetry_block(result, scene, static)
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
