"""`python -m tpu_pbrt_torch.serve` — the render-service frontends.

Default mode: a stdin/JSONL daemon. One JSON object per line in, one
JSON object per line out (responses carry {"ok": ...}; asynchronous job
completions are emitted as {"event": "done"/"failed", ...} lines).

Ops:
  {"op": "submit", "scene": "path.pbrt" | "text": "<inline scene>",
   "job": "id?", "tenant": "t?", "priority": 0, "weight": 1.0,
   "chunk": 0, "checkpoint": "path?", "checkpoint_every": 0,
   "preview_every": 0, "preview": "out.png?", "outfile": "img.exr?",
   "crop": [x0, x1, y0, y1]?, "quick": false}
  {"op": "poll",    "job": "j1"}
  {"op": "preempt", "job": "j1"}      # emergency checkpoint + park
  {"op": "resume",  "job": "j1"}
  {"op": "cancel",  "job": "j1"}      # releases residency
  {"op": "preview", "job": "j1", "out": "live.png"}
  {"op": "result",  "job": "j1", "out": "final.exr?"}
  {"op": "stats"}
  {"op": "metrics", "out": "metrics.prom?"}   # Prometheus text exposition
  {"op": "health"}                    # watchdog verdict (obs/health.py)
  {"op": "drain"}                     # stop admitting; park active jobs;
                                      # reports when the spool is quiescent
  {"op": "shutdown", "drain": true}

A submit may carry {"trace": "t:<id>"} — a caller-supplied trace
context (the fleet router's hop): the job's spans carry that id, but
the root serve/job span is owned by the caller, so a failover
re-submit on another daemon continues one end-to-end timeline.

`drain` is the fleet router's graceful-failover primitive, which
`shutdown` cannot provide: the daemon STAYS UP — answering polls,
stats, results — while every new submit is deterministically shed and
the runnable jobs park through the emergency-checkpoint path. The
response carries {"quiescent": true/false, "parked": [...], "spool":
{job: {checkpoint, cursor, durable}}}; once quiescent, every parked
job's durable spool entry holds the exact resumable tuple another
replica can adopt.

A submit rejected by SLO admission control (TORCH_PBRT_SERVE_SLO_DEPTH /
_WAIT_S, or --slo-depth/--slo-wait-s) answers {"ok": false, "shed":
true, "reason": ...} — deterministic, counted in the shed metrics and
the flight log; nothing was compiled or queued.

Between commands the daemon steps the service (one chunk-slice per
step, policy-scheduled), so renders progress while the client is idle.
EOF on stdin drains the remaining jobs and exits.

`--selftest` runs the smoke (no stdin): submit two cropped-cornell
jobs on one device, preempt/resume one mid-render, and assert both
films are finite AND bit-identical to a solo run-to-completion render,
the warm resubmit paid 0 scene compiles and 0 kernel builds, and the
preview stream wrote frames. Exit 0 = pass.

The service runs on CUDA unless `--device cpu` asks for the CPU; with no
GPU and no such request the daemon exits 1.

`--mesh N` serves over N ranks (serve/service.py, "Serving over a
mesh"): rank 0 runs in this process, reads the JSONL stream and writes
every reply; ranks 1..N-1 are spawned processes that follow its
decisions, and every rank leaves on `shutdown` (or EOF). The ranks take
one card each over NCCL when N cards are visible, else share cuda:0
over gloo (said on stderr); under `--device cpu` they are N CPU
processes over gloo.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_pbrt_torch.serve",
        description="tpu-pbrt-torch multi-tenant render service",
    )
    p.add_argument(
        "--selftest", action="store_true",
        help="run the service smoke (2 cropped cornell jobs, one "
        "preempt/resume, bit-identity vs solo, residency warm-hit) and exit",
    )
    p.add_argument("--mesh", default="",
                   help="serve over N ranks, e.g. '2' or '2,4' (their product): rank 0 "
                   "reads stdin, the others follow its decisions")
    p.add_argument("--device", default=None,
                   help="torch device to serve on: cuda (the default) or cpu")
    p.add_argument(
        "--chunk", type=int, default=0,
        help="slice width in camera rays (preemption quantum; 0 = platform default)",
    )
    p.add_argument("--seed", type=int, default=0, help="scheduler seed")
    p.add_argument(
        "--max-resident-mb", type=float, default=0.0,
        help="resident-scene device-memory budget in MB (0 = unbounded)",
    )
    p.add_argument(
        "--max-active", type=int, default=0,
        help="max jobs holding live film state (0 = unbounded)",
    )
    p.add_argument("--spool", default="", help="checkpoint spool directory")
    p.add_argument(
        "--slo-depth", default="",
        help="per-priority-class queue-depth SLO spec ('8' or '0=4,5=32'; "
        "overrides TORCH_PBRT_SERVE_SLO_DEPTH) — over-target submits shed",
    )
    p.add_argument(
        "--slo-wait-s", default="",
        help="per-class p90 queue-wait SLO spec in seconds (overrides "
        "TORCH_PBRT_SERVE_SLO_WAIT_S); evaluated over recent waits while "
        "the class has queued work",
    )
    p.add_argument(
        "--metrics-path", default="",
        help="write the Prometheus metrics snapshot here on shutdown "
        "(also settable via TORCH_PBRT_METRICS_PATH)",
    )
    p.add_argument("--quiet", action="store_true")
    return p


def _make_service(args, mesh=None):
    from tpu_pbrt_torch.serve import RenderService, SloPolicy, parse_slo_spec

    slo = None
    if getattr(args, "slo_depth", "") or getattr(args, "slo_wait_s", ""):
        base = SloPolicy.from_cfg()
        slo = SloPolicy(
            depth=parse_slo_spec(args.slo_depth, int) or base.depth,
            wait_s=parse_slo_spec(args.slo_wait_s, float) or base.wait_s,
        )
    if getattr(args, "metrics_path", ""):
        from tpu_pbrt_torch.obs.metrics import METRICS

        METRICS.configure(args.metrics_path)
    return RenderService(
        mesh=mesh,
        device=None if mesh is not None else args.device,
        chunk=args.chunk or None,
        max_resident_bytes=(
            int(args.max_resident_mb * 1e6) if args.max_resident_mb else None
        ),
        max_active=args.max_active or None,
        seed=args.seed,
        spool_dir=args.spool or None,
        quiet=True,
        slo=slo,
    )


# --------------------------------------------------------------------------
# JSONL daemon
# --------------------------------------------------------------------------


def _emit(out, payload):
    out.write(json.dumps(payload) + "\n")
    out.flush()


def _handle(service, req, out):
    from tpu_pbrt_torch.serve import ShedError

    op = req.get("op")
    try:
        if op == "submit":
            from tpu_pbrt_torch.scene.api import Options

            opts = Options(
                quiet=True,
                quick_render=bool(req.get("quick", False)),
                crop_window=(
                    tuple(req["crop"]) if req.get("crop") else None
                ),
                image_file=req.get("outfile", ""),
            )
            try:
                job = service.submit(
                    req.get("scene"),
                    text=req.get("text"),
                    options=opts,
                    job_id=req.get("job"),
                    tenant=req.get("tenant", "default"),
                    priority=int(req.get("priority", 0)),
                    weight=req.get("weight"),
                    chunk=int(req["chunk"]) if req.get("chunk") else None,
                    checkpoint_path=req.get("checkpoint", ""),
                    checkpoint_every=int(req.get("checkpoint_every", 0)),
                    preview_every=int(req.get("preview_every", 0)),
                    preview_path=req.get("preview", ""),
                    outfile=req.get("outfile", ""),
                    trace_id=req.get("trace"),
                )
            except ShedError as e:
                # SLO load shedding: a first-class protocol answer, not
                # an error string — clients branch on "shed" to retry
                # elsewhere/later (nothing was compiled or queued)
                _emit(out, {
                    "ok": False, "op": op, "shed": True,
                    "tenant": e.tenant, "priority": e.priority,
                    "reason": e.reason,
                })
                return None
            _emit(out, {"ok": True, "op": op, "job": job})
        elif op == "poll":
            _emit(out, {"ok": True, "op": op, **service.poll(req["job"])})
        elif op == "preempt":
            service.preempt(req["job"])
            _emit(out, {"ok": True, "op": op, "job": req["job"]})
        elif op == "resume":
            service.resume(req["job"])
            _emit(out, {"ok": True, "op": op, "job": req["job"]})
        elif op == "cancel":
            service.cancel(req["job"])
            _emit(out, {"ok": True, "op": op, "job": req["job"]})
        elif op == "preview":
            img = service.preview(req["job"])
            path = req.get("out", "")
            if path:
                from tpu_pbrt_torch.utils import imageio

                imageio.write_image(path, img)
            _emit(out, {
                "ok": True, "op": op, "job": req["job"],
                "mean": float(img.mean()), "out": path or None,
            })
        elif op == "result":
            r = service.result(req["job"])
            path = req.get("out", "")
            if path:
                from tpu_pbrt_torch.utils import imageio

                imageio.write_image(path, r.image)
            _emit(out, {
                "ok": True, "op": op, "job": req["job"],
                "rays": r.rays_traced,
                "seconds": round(r.seconds, 3),
                "mean": float(r.image.mean()),
                "stats": _json_safe(r.stats), "out": path or None,
            })
        elif op == "stats":
            _emit(out, {"ok": True, "op": op, **_json_safe(service.stats())})
        elif op == "metrics":
            # Prometheus text exposition of the process registry — the
            # scrape endpoint, JSONL-framed. "out" additionally writes
            # the page to a file (the --metrics-path snapshot shape).
            text = service.metrics_exposition()
            path = req.get("out", "")
            written = None
            if path and text:
                from tpu_pbrt_torch.obs.metrics import METRICS

                written = METRICS.export(path)
            # "out" reports what was actually WRITTEN — an empty page
            # (kill switch / nothing recorded) skips the export, and the
            # client must not be told a snapshot file exists
            _emit(out, {
                "ok": True, "op": op, "exposition": text,
                "lines": len(text.splitlines()), "out": written,
            })
        elif op == "health":
            # the watchdog verdict (obs/health.py): deterministic over
            # the service's own state + the metrics registry — what a
            # monitor polls instead of waiting for client timeouts
            from tpu_pbrt_torch.obs.health import evaluate

            _emit(out, {"ok": True, "op": op, **evaluate(service).to_dict()})
        elif op == "drain":
            # graceful handoff: shed new submits, park runnable jobs,
            # report the spool manifest — the daemon keeps serving
            # polls/results so a router can adopt the spool elsewhere
            _emit(out, {"ok": True, "op": op, **service.begin_drain()})
        elif op == "shutdown":
            return "drain" if req.get("drain", True) else "now"
        else:
            _emit(out, {"ok": False, "error": f"unknown op {op!r}"})
    except Exception as e:  # noqa: BLE001 — a bad request must not kill the daemon
        _emit(out, {"ok": False, "op": op, "error": f"{type(e).__name__}: {e}"})
    return None


def _json_safe(obj):
    """Counters and stats may carry numpy scalars; JSON needs ints."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if hasattr(obj, "item"):
        return obj.item()
    return obj


def run_daemon(service, in_stream=None, out=None) -> int:
    import queue as _q
    import threading

    in_stream = in_stream if in_stream is not None else sys.stdin
    out = out if out is not None else sys.stdout
    cmds: "_q.Queue" = _q.Queue()
    eof = threading.Event()

    def reader():
        for line in in_stream:
            cmds.put(line)
        eof.set()

    threading.Thread(target=reader, daemon=True).start()

    done_emitted = set()
    shutdown = None

    def process_line(raw):
        raw = raw.strip()
        if not raw:
            return None
        try:
            req = json.loads(raw)
        except ValueError as e:
            _emit(out, {"ok": False, "error": f"bad JSON: {e}"})
            return None
        if not isinstance(req, dict):
            # a bare string/number IS valid JSON — it must still be
            # rejected cleanly, not crash the daemon on req.get
            _emit(out, {"ok": False, "error": "request must be a JSON object"})
            return None
        return _handle(service, req, out)

    while True:
        # drain every pending command first (submits/cancels reshape the
        # very next scheduling decision)
        while shutdown is None:
            try:
                line = cmds.get_nowait()
            except _q.Empty:
                break
            shutdown = process_line(line)
        if shutdown == "now":
            break
        try:
            worked = service.step()
        except Exception as e:  # noqa: BLE001 — one job's crash must not kill the daemon
            _emit(out, {
                "event": "error", "error": f"{type(e).__name__}: {e}",
            })
            worked = None
        for job in service.jobs.values():
            if job.status in ("done", "failed") and job.job_id not in done_emitted:
                done_emitted.add(job.job_id)
                ev = {"event": job.status, "job": job.job_id}
                if job.status == "done":
                    r = job.result
                    ev.update(rays=r.rays_traced,
                              seconds=round(r.seconds, 3))
                else:
                    ev["error"] = job.error
                _emit(out, ev)
        if worked is None:
            if shutdown == "drain" or eof.is_set():
                break
            # idle: block briefly for the next command and process it
            # IN ORDER (re-queueing would reorder a burst of commands)
            try:
                shutdown = process_line(cmds.get(timeout=0.05))
            except _q.Empty:
                service.keepalive()  # a mesh's followers wait on rank 0
    return 0


def launch_serving(rank_fn, n: int, argv, device) -> int:
    """Start the N serving ranks of `--mesh N`: rank 0 in this process
    (it keeps stdin and stdout), ranks 1..N-1 spawned, each running
    `rank_fn(mesh, argv)`. One card per rank (NCCL) when N cards are
    visible, else every rank on cuda:0 over gloo; N CPU processes under
    --device cpu. Returns the largest rank exit code, 1 when a rank
    failed."""
    import torch

    from tpu_pbrt_torch.parallel.mesh import launch

    share = device.type == "cuda" and torch.cuda.device_count() < n
    if share:
        print(f"tpu-pbrt-torch: {n} serving ranks share cuda:0 "
              f"({torch.cuda.device_count()} card(s) visible; gloo)", file=sys.stderr)
    try:
        codes = launch(rank_fn, n, args=(list(argv),), device=device.type,
                       share_device=share, lead_here=True)
    except RuntimeError as e:
        print(f"tpu-pbrt-torch: {e}", file=sys.stderr)
        return 1
    return max(int(c or 0) for c in codes)


def _serve_rank(mesh, argv) -> int:
    """One rank of `--mesh N`: the daemon on rank 0, a follower elsewhere."""
    args = build_arg_parser().parse_args(argv)
    if mesh.rank:
        args.metrics_path = ""
    service = _make_service(args, mesh)
    try:
        return service.lead_or_follow(run_daemon) or 0
    finally:
        if not mesh.rank:
            from tpu_pbrt_torch.obs.metrics import METRICS

            METRICS.maybe_export()


# --------------------------------------------------------------------------
# --selftest: the CI smoke
# --------------------------------------------------------------------------


def selftest(args) -> int:
    import os
    import tempfile

    import numpy as np

    from tpu_pbrt_torch.scene.api import Options, compile_string
    from tpu_pbrt_torch.scenes import cornell_box_text

    def say(msg):
        print(f"serve-selftest: {msg}", file=sys.stderr)

    text = cornell_box_text(res=64, spp=1, integrator="path", maxdepth=3)
    crop = (0.0, 0.5, 0.0, 0.5)

    # solo run-to-completion reference (its own compile + integrator —
    # the service must reproduce it bit-for-bit through sliced,
    # interleaved, preempted scheduling)
    say("rendering solo reference")
    args.chunk = args.chunk or 256
    service = _make_service(args)
    scene, integ = compile_string(text, Options(quiet=True, crop_window=crop),
                                  device=service.device)
    ref = np.asarray(integ.render(scene).image, np.float32)
    tmp = tempfile.mkdtemp(prefix="tpu_pbrt_torch_selftest_")
    preview_path = os.path.join(tmp, "preview.pfm")
    opts = Options(quiet=True, crop_window=crop)
    j1 = service.submit(text=text, options=opts, tenant="alice",
                        preview_every=2, preview_path=preview_path)
    j2 = service.submit(text=text, options=opts, tenant="bob")
    say(f"submitted {j1} + {j2} (chunk={args.chunk})")

    fails = []
    res_stats = service.residency.stats()
    if res_stats["scene_compiles"] != 1:
        fails.append(
            f"expected 1 scene compile for 2 same-scene submits, got "
            f"{res_stats['scene_compiles']}"
        )

    # interleave a few slices, then preempt j2 mid-render
    for _ in range(3):
        service.step()
    p2 = service.poll(j2)
    service.preempt(j2)
    say(f"preempted {j2} at chunk {service.poll(j2)['chunks_done']}")
    if not (0 < p2["chunks_done"]):
        fails.append(f"{j2} had no progress before preempt: {p2}")
    for _ in range(2):
        service.step()
    service.resume(j2)
    service.drain()

    for j in (j1, j2):
        r = service.result(j)
        img = np.asarray(r.image, np.float32)
        if not np.isfinite(img).all():
            fails.append(f"{j}: non-finite pixels")
        if img.shape != ref.shape or not np.array_equal(img, ref):
            diff = (
                float(np.max(np.abs(img - ref)))
                if img.shape == ref.shape else "shape"
            )
            fails.append(f"{j}: film differs from solo (max diff {diff})")
    if service.poll(j2)["preemptions"] < 1:
        fails.append(f"{j2} records no preemption")
    if service.poll(j1)["previews"] < 1 or not os.path.exists(preview_path):
        fails.append("preview stream wrote no frames")

    # warm resubmit: same scene again — zero scene compiles, zero kernel
    # builds (kernels/build.py counts them)
    from tpu_pbrt_torch.kernels.build import BUILDS

    builds_before = dict(BUILDS)
    j3 = service.submit(text=text, options=opts, tenant="alice")
    service.drain()
    res_stats = service.residency.stats()
    if res_stats["scene_compiles"] != 1:
        fails.append(
            f"warm resubmit recompiled the scene "
            f"({res_stats['scene_compiles']} compiles)"
        )
    if BUILDS != builds_before:
        fails.append(f"warm resubmit built kernels ({builds_before} -> {BUILDS})")
    img3 = np.asarray(service.result(j3).image, np.float32)
    if not np.array_equal(img3, ref):
        fails.append("warm resubmit film differs from solo")

    # cancel releases residency: a fresh job's pin, cancelled, unpins
    j4 = service.submit(text=text, options=opts)
    service.cancel(j4)
    if service.residency.get(service.jobs[j4].resident_key).pins != 0:
        fails.append("cancel left the residency pin held")

    # SLO load shedding: with a class queue-depth target of 1,
    # an over-SLO submit burst is answered with deterministic sheds —
    # counted, before any compile or queue mutation. After the admitted
    # job leaves the queue, admission opens again.
    from tpu_pbrt_torch.serve import ShedError, SloPolicy, parse_slo_spec

    say("slo shed burst (depth target 1)")
    service.slo = SloPolicy(depth=parse_slo_spec("1", int))
    burst_ok, burst_shed = [], 0
    for _ in range(4):
        try:
            burst_ok.append(
                service.submit(text=text, options=opts, tenant="burst")
            )
        except ShedError:
            burst_shed += 1
    if len(burst_ok) != 1 or burst_shed != 3 or service.sheds != 3:
        fails.append(
            f"shed burst not deterministic: {len(burst_ok)} admitted, "
            f"{burst_shed} shed (counted {service.sheds})"
        )
    service.cancel(burst_ok[0])
    try:
        service.cancel(service.submit(text=text, options=opts,
                                      tenant="burst"))
    except ShedError:
        fails.append("submit still shed after the queue drained")
    service.slo = SloPolicy()

    # drain verb: the fleet router's graceful-failover
    # primitive — the service stops admitting, parks its runnable jobs
    # through the emergency-checkpoint path, and reports the spool
    # manifest another replica could adopt; the daemon stays up
    import io

    say("drain handoff (park + shed + spool manifest)")
    j5 = service.submit(text=text, options=opts, tenant="alice",
                        checkpoint_every=1)
    service.step()
    buf = io.StringIO()
    _handle(service, {"op": "drain"}, buf)
    ans = json.loads(buf.getvalue())
    if not (ans.get("ok") and ans.get("draining")):
        fails.append(f"drain verb answered {ans}")
    if j5 not in ans.get("parked", []) or j5 not in ans.get("spool", {}):
        fails.append(f"drain did not park+spool {j5}: {ans}")
    elif not ans["spool"][j5]["durable"]:
        fails.append(f"drain left {j5} without a durable spool entry")
    if not ans.get("quiescent"):
        fails.append(f"drain reports non-quiescent after parking: {ans}")
    try:
        service.submit(text=text, options=opts, tenant="alice")
        fails.append("draining service admitted a submit")
    except ShedError as e:
        if "draining" not in e.reason:
            fails.append(f"draining shed carries wrong reason: {e.reason}")
    buf = io.StringIO()
    _handle(service, {"op": "submit", "text": text}, buf)
    shed_ans = json.loads(buf.getvalue())
    if not shed_ans.get("shed"):
        fails.append(
            f"daemon answered a draining submit without shed: {shed_ans}"
        )
    # the handoff is reversible: lift the drain, resume the parked job
    # from its durable checkpoint, and the film is still bit-identical
    service.draining = False
    service.resume(j5)
    service.drain()
    if not np.array_equal(
        np.asarray(service.result(j5).image, np.float32), ref
    ):
        fails.append("film resumed after a drain differs from solo")

    # metrics exposition: the scrape page must lint clean and
    # carry the per-tenant queue-wait/service-time histograms + the shed
    # counter the burst above just incremented
    from tpu_pbrt_torch.obs.metrics import METRICS, validate_exposition

    if METRICS.enabled:
        exp = service.metrics_exposition()
        errs = validate_exposition(exp)
        fails += [f"exposition: {e}" for e in errs]
        for needle in (
            "tpu_pbrt_serve_queue_wait_seconds_bucket",
            "tpu_pbrt_serve_slice_seconds_count",
            'tenant="alice"',
            "tpu_pbrt_serve_shed_total",
            "tpu_pbrt_residency_hits_total",
        ):
            if needle not in exp:
                fails.append(f"exposition missing {needle}")
        # exemplars: the slice histogram's retained tail must
        # carry trace ids — the join key back into the trace timeline
        from tpu_pbrt_torch.config import cfg as _cfg

        if _cfg.metrics_exemplars > 0:
            ser = (
                METRICS.snapshot()["metrics"]
                .get("tpu_pbrt_serve_slice_seconds", {})
                .get("series", [])
            )
            if not any(
                e.get("trace_id")
                for s in ser for e in s.get("exemplars", [])
            ):
                fails.append("slice histogram has no trace-id exemplars")

    # health: a clean selftest must not trip the watchdog
    from tpu_pbrt_torch.obs.health import evaluate

    rep = evaluate(service)
    if not rep.ok:
        fails.append(
            f"health watchdog fired on a clean selftest: {rep.firing()}"
        )

    # when tracing is armed (TORCH_PBRT_TRACE_PATH), export the
    # trace, from which the job timelines of this run can be rebuilt
    from tpu_pbrt_torch.obs.trace import TRACE

    traced = TRACE.maybe_export()
    if traced:
        say(f"trace exported to {traced}")

    line = {
        "selftest": "tpu_pbrt_torch.serve",
        "ok": not fails,
        "jobs": len(service.jobs),
        "schedule_len": len(service.schedule),
        "scene_compiles": res_stats["scene_compiles"],
        "residency_hits": res_stats["hits"],
        "preemptions": service.poll(j2)["preemptions"],
        "previews": service.poll(j1)["previews"],
        "sheds": service.sheds,
    }
    if fails:
        line["failures"] = fails
        for f in fails:
            say(f"FAIL: {f}")
    print(json.dumps(line))
    return 0 if not fails else 1


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_arg_parser().parse_args(argv)
    from tpu_pbrt_torch.config import resolve_device

    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"tpu-pbrt-torch: {e} (on the command line: --device cpu)", file=sys.stderr)
        return 1
    if args.selftest:
        return selftest(args)
    from tpu_pbrt_torch.parallel.mesh import mesh_ranks

    if mesh_ranks(args.mesh) > 1:
        # the ranks are spawned: name the rank function by its module's
        # import path (a package's __main__ is not re-imported by spawn)
        import importlib

        this = importlib.import_module("tpu_pbrt_torch.serve.__main__")
        return launch_serving(this._serve_rank, mesh_ranks(args.mesh), argv, device)
    try:
        return run_daemon(_make_service(args))
    finally:
        from tpu_pbrt_torch.obs.metrics import METRICS

        # --metrics-path / TORCH_PBRT_METRICS_PATH: the final scrape
        # snapshot survives the daemon exiting
        METRICS.maybe_export()


if __name__ == "__main__":
    sys.exit(main())
