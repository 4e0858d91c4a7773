"""Where a render's time goes on the GPU.

    python -m tpu_pbrt_torch.profile_render
        [--scene killeroo|crown|cloud|caustic|breadth|textured|motion|subsurface]
        [--res 128] [--spp 64]
        [--integrator path|directlighting|whitted|ao|volpath|bdpt|sppm|mlt]
        [--params '"integer numiterations" [4] ...'] [--no-regen] [--out DIR]

Compiles `scenes.make_killeroo_like` (or, with `--scene crown`,
`scenes.make_crown_like`, with `--scene cloud`, `scenes.make_cloud_like`,
with `--scene caustic`, `scenes.make_caustic_like`, with `--scene
breadth`, `scenes.make_breadth_like`: perspective camera, gaussian
filter, with `--scene textured`, `scenes.make_textured_like`, with
`--scene motion`, `scenes.make_motion_like`: hair and disney under a
moving shutter, the F = 64 flush, with `--scene subsurface`,
`scenes.make_subsurface_like`: subsurface and kdsubsurface blobs over a
fourier ground, the BSSRDF probe wave's chords) at its full geometry
under the integrator (default `path`; the cloud's own is `volpath`, the
caustic's `bdpt`), with `--params` as more integrator parameters of the
caustic (scene text, e.g. sppm's iterations and photons or mlt's
chains), renders it
once to warm up, then renders it again under `torch.profiler` (CPU +
CUDA activity), through the persistent pool (`path`'s default render
path) or, with `--no-regen` and for the other integrators, through the
fixed batch (sppm and mlt run their own iteration loops), and prints:

- the render's wall time, rays traced and Mray/s (with the profiler on);
- the device's busy share: the summed time of the CUDA kernels and
  copies over the wall time (one stream, so they do not overlap), and
  how many of them the render launched;
- the device time by group (the two hand-written kernels, sorts,
  gathers and scatters, elementwise work, copies) and the top kernels;
- the film deposit's share: the device time of the kernels launched
  inside the film's deposit calls (`Film.add_samples*`, each under a
  profiler range), which a wide filter footprint multiplies;
- the texture evaluation's share: the device time and the device
  operations launched inside `integrators/common.py::textured_mat`'s
  profiler range, and the device operations per wave without them;
- the BSSRDF probe wave's share on a scene with a subsurface material
  (`PathIntegrator._probe_wave` under a profiler range): its chords, its
  shadow rays and its shading;
- the host reads per wave from the render's stats: the traversal's and
  the render loop's (one per pool wave or fixed-batch bounce), and the
  waves by mode (closest-hit, any-hit).

With `--out DIR` it also writes the Chrome trace there. The script needs
a CUDA device; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time
from collections import defaultdict

import torch

#: the profiler range around the film's deposit calls
DEPOSIT = "film_deposit"
#: the profiler range integrators/common.py::textured_mat opens
TEXTURES = "textured_mat"
#: the profiler range of path's BSSRDF probe wave (integrators/path.py)
PROBE = "bssrdf_probe"
#: kernel-name patterns -> group, first match wins
GROUPS = (
    ("flush (hand-written)", r"flush_blocks_kernel|seed_kernel|finalize_kernel"),
    ("expand (hand-written)", r"expand_kernel"),
    ("sort", r"radix|Sort|sort"),
    ("gather/scatter/index", r"index|gather|scatter|Index|Scatter|Gather|take"),
    ("reduce/scan", r"reduce|Reduce|scan|Scan|cumsum"),
    ("copy", r"Memcpy|Memset|copy|Copy"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)


def _group(name: str) -> str:
    for g, pat in GROUPS:
        if re.search(pat, name):
            return g
    return "other"


def _card() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def _range(prof, name: str) -> dict:
    """Calls, host time, device time and device operations of every
    kernel launched inside the profiler ranges called `name`."""
    out = {"calls": 0, "host_us": 0.0, "device_us": 0.0, "ops": 0}

    def walk(ev):
        for k in ev.kernels:
            out["ops"] += 1
            out["device_us"] += k.duration
        for c in ev.cpu_children:
            walk(c)

    for ev in prof.events():
        if ev.name == name and ev.device_type == torch.autograd.DeviceType.CPU:
            out["calls"] += 1
            out["host_us"] += ev.cpu_time_total
            walk(ev)
    return out


def measure(integ, scene) -> dict:
    """One render of `scene` under torch.profiler (CPU + CUDA activity),
    its kernel launches counted: the result, its wall time, the device's
    busy time, idle share and operations (per traversal wave), the device
    time by group and by kernel, and the film deposit's and the texture
    evaluation's and the BSSRDF probe wave's ranges (_range). Film
    deposits and the probe wave are wrapped in their ranges here;
    textured_mat opens its own."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_pbrt_torch.core.film import Film
    from tpu_pbrt_torch.integrators.path import PathIntegrator
    from tpu_pbrt_torch.kernels import LAUNCHES, reset_launches

    def _ranged(fn, label):
        def ranged(*a, **k):
            with torch.profiler.record_function(label):
                return fn(*a, **k)
        return ranged

    wrapped = [(Film, n, DEPOSIT) for n in ("add_samples", "add_samples_pixel",
                                            "add_samples_aligned")]
    wrapped.append((PathIntegrator, "_probe_wave", PROBE))
    saved = [(cls, n, getattr(cls, n)) for cls, n, _ in wrapped]
    for (cls, n, label), (_, _, fn) in zip(wrapped, saved):
        setattr(cls, n, _ranged(fn, label))
    try:
        reset_launches()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = integ.render(scene)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
    finally:
        for cls, n, fn in saved:
            setattr(cls, n, fn)
    by_name = defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(ev, "is_user_annotation", False)):
            rec = by_name[ev.name]
            rec[0] += ev.time_range.elapsed_us()
            rec[1] += 1
    dev_us = sum(v[0] for v in by_name.values())
    groups = defaultdict(float)
    for name, (us, _) in by_name.items():
        groups[_group(name)] += us
    n_ops = sum(v[1] for v in by_name.values())
    waves = max(res.stats.get("waves", 0), 1)
    return dict(res=res, wall=wall, by_name=by_name, prof=prof, launches=launches,
                device_us=dev_us, idle_share=1 - dev_us / 1e6 / wall, ops=n_ops,
                ops_per_wave=n_ops / waves, groups=dict(groups),
                ranges={n: _range(prof, n) for n in (DEPOSIT, TEXTURES, PROBE)})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", choices=("killeroo", "crown", "cloud", "caustic", "breadth",
                                        "textured", "motion", "subsurface"),
                    default="killeroo")
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--integrator", choices=("path", "directlighting", "whitted", "ao", "volpath",
                                             "bdpt", "sppm", "mlt"),
                    default=None, help="default: path (volpath for the cloud, bdpt for the "
                                       "caustic)")
    ap.add_argument("--params", default="",
                    help="more integrator parameters of the caustic, as scene text")
    ap.add_argument("--no-regen", action="store_true",
                    help="profile the fixed batch instead of the persistent pool")
    ap.add_argument("--out", default="", help="directory for the Chrome trace")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_render: no CUDA device visible")

    from tpu_pbrt_torch.config import cfg
    from tpu_pbrt_torch import scenes

    cfg.regen = not args.no_regen
    args.integrator = args.integrator or {"cloud": "volpath", "caustic": "bdpt"}.get(
        args.scene, "path")
    if args.scene in ("breadth", "textured", "motion", "subsurface"):
        make = {"breadth": scenes.make_breadth_like, "textured": scenes.make_textured_like,
                "motion": scenes.make_motion_like, "subsurface": scenes.make_subsurface_like}
        api = make[args.scene](args.res, args.spp, device="cuda")
        if args.integrator != "path" or args.params:
            raise SystemExit(f"profile_render: the {args.scene} scene renders under path")
    elif args.scene == "caustic":
        api = scenes.make_caustic_like(res=args.res, spp=args.spp, integrator=args.integrator,
                                       params=args.params, device="cuda")
    else:
        make = {"killeroo": scenes.make_killeroo_like, "crown": scenes.make_crown_like,
                "cloud": scenes.make_cloud_like}[args.scene]
        api = make(res=args.res, spp=args.spp, device="cuda")
        api.render_options.integrator_name = args.integrator
        if args.params:
            raise SystemExit("profile_render: --params applies to --scene caustic")
    scene, integ = scenes.compile_api(api)
    integ.render(scene)  # warm-up: kernel build, allocator, first-use costs
    m = measure(integ, scene)
    res, wall, by_name, prof = m["res"], m["wall"], m["by_name"], m["prof"]
    st = res.stats
    print(f"card: {_card()}")
    loop = ("pool of " + str(st["pool"]) if st.get("regen") else
            "own iteration loop" if args.integrator in ("sppm", "mlt") else "fixed batch")
    print(f"render {args.scene} {args.integrator} {args.res}x{args.res} {args.spp} spp, {loop} "
          f"(profiler on): {wall:.3f} s, {res.rays_traced} rays, "
          f"{res.rays_traced / wall / 1e6:.4f} Mray/s")
    if "host_reads_per_wave_mean" in st:
        print(f"traversal waves {st['waves']}, host reads per wave "
              f"{st['host_reads_per_wave_mean']:.2f} (traversal) + "
              f"{st['loop_host_reads_per_wave']:.2f} (loop)")
    else:
        print(f"traversal waves {st['waves']}")
    for mode, mm in st["wave_modes"].items():
        print(f"{mode} waves {mm['waves']}: {mm['iters_per_wave_mean']:.2f} iterations, "
              f"{mm['host_reads_per_wave_mean']:.2f} host reads, "
              f"{mm['expand_calls_per_wave_mean']:.2f} expand and "
              f"{mm['flush_calls_per_wave_mean']:.2f} flush launches per wave")
    print(f"stats: {json.dumps(st)}")
    print(f"launches: {json.dumps(m['launches'])}")
    dev_us = m["device_us"]
    if dev_us == 0:
        print("device time: not measured (the profiler recorded no CUDA activity)")
        return 1
    n_ops = m["ops"]
    print(f"device busy: {dev_us / 1e6:.3f} s of {wall:.3f} s wall = {dev_us / 1e6 / wall:.3f}; "
          f"idle share {m['idle_share']:.3f}")
    print(f"device operations (kernels and copies): {n_ops}, {m['ops_per_wave']:.0f} "
          f"per traversal wave, {wall / max(n_ops, 1) * 1e6:.1f} us of wall time each")
    print("device time by group:")
    for g, us in sorted(m["groups"].items(), key=lambda kv: -kv[1]):
        print(f"  {g:24s} {us / 1e3:10.2f} ms  {us / dev_us:6.3f}")
    for label, name in (("film deposit", DEPOSIT), ("texture evaluation", TEXTURES),
                        ("BSSRDF probe wave", PROBE)):
        r = m["ranges"][name]
        if r["calls"] and r["device_us"]:
            print(f"{label}: {r['calls']} calls, {r['device_us'] / 1e3:.2f} ms device "
                  f"({r['device_us'] / dev_us:.3f} of the device time), {r['ops']} device "
                  f"operations ({r['ops'] / max(st['waves'], 1):.0f} per traversal wave; "
                  f"{(n_ops - r['ops']) / max(st['waves'], 1):.0f} per wave without them), "
                  f"{r['host_us'] / 1e3:.2f} ms host")
        else:
            print(f"{label}: {r['calls']} calls, device time not measured")
    print("top kernels by device time:")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / 1e3:10.2f} ms  {n:7d} x  {name[:110]}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        mode = "fixed" if args.no_regen else "pool"
        path = os.path.join(args.out,
                            f"render_{args.scene}_{args.integrator}_{args.res}_{args.spp}_{mode}"
                            ".trace.json")
        prof.export_chrome_trace(path)
        print(f"trace: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
