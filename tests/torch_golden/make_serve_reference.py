"""Write the JAX package's side of the render service's and the fleet
router's decisions that tests/test_torch_serve.py and
tests/test_torch_fleet.py hold the port to.

Both run the Cornell box under `path` at 32x32, 1 spp, maxdepth 3, in
slices of 256 camera rays (4 slices a job), on a VirtualClock, so every
decision is a pure function of the script:

- `run_service`: one RenderService with a queue-depth target of 2
  (every class) and a second one with max_active=1, driven through
  submit / step / preempt / resume / a shed / cancel / drain / a warm
  resubmit and a priority preemption. Recorded: the `schedule`, every
  submit's answer (its job id, or the shed's tenant, priority and
  reason), every `step()`'s job, each job's `poll` dict, the residency
  counts (entries, compiles, hits, evictions, pins), the phases of each
  job's FLIGHT file with their chunk fields, and the metric families
  with their time-free values (counter and gauge values, histogram
  counts).
- `run_fleet`: a FleetRouter over two LocalReplicas: same-scene
  affinity, a double delivery, the edge shed of a clamped knee, a kill
  failover through the spool, a drain failover and a router restart
  (`adopt`). Recorded: the routes, owners, the moved jobs, each job's
  poll dict, the edge-shed count and the router stats.

`run_service` and `run_fleet` run either package: `"tpu_pbrt"` here,
`"tpu_pbrt_torch"` (with device="cpu") in the tests, which also hold
every served film to the port's own solo render.

Run from the repository root (a few minutes, most of it XLA compiling
each service's chunk program):

    JAX_PLATFORMS=cpu python tests/torch_golden/make_serve_reference.py

Writes tests/torch_golden/serve_reference.json.
"""

import importlib
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "serve_reference.json")
RES, SPP, MAXDEPTH, CHUNK = 32, 1, 3, 256
#: flight-line fields compared (t and elapsed_s are times)
FIELDS = ("job", "chunk", "key", "tenant", "priority", "rays", "chunks", "attempt", "poisoned")


def scene_text(pkg: str, res: int = RES) -> str:
    scenes = importlib.import_module(f"{pkg}.scenes")
    return scenes.cornell_box_text(res=res, spp=SPP, integrator="path", maxdepth=MAXDEPTH)


def _metrics(snapshot) -> dict:
    """Metric families with their time-free values: counter and gauge
    values, histogram counts (the port's CPU tracer mode is "plain"
    where the reference's is "jnp")."""
    out = {}
    for name, m in snapshot["metrics"].items():
        rows = []
        for s in m["series"]:
            labels = {k: ("plain" if v == "jnp" else v) for k, v in s["labels"].items()}
            if m["type"] == "histogram":
                rows.append([labels, s["count"]])
            elif "seconds" not in name:
                rows.append([labels, s["value"]])
            else:
                rows.append([labels, None])
        out[name] = [m["type"], sorted(rows, key=json.dumps)]
    return out


def _flight(workdir: str, job_ids) -> dict:
    out = {}
    for jid in job_ids:
        path = os.path.join(workdir, f"flight.{jid}.jsonl")
        lines = []
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    d = json.loads(line)
                    lines.append([d["phase"]] + [[k, d[k]] for k in FIELDS if k in d])
        out[jid] = lines
    return out


def _residency(svc) -> dict:
    st = svc.residency.stats()
    return {k: st[k] for k in ("entries", "scene_compiles", "hits", "evictions")} | {
        "pins": sorted(svc.residency.pin_counts().values())}


def _poll(svc_or_router, jid) -> dict:
    return svc_or_router.poll(jid)


def run_service(pkg: str, workdir: str, device=None):
    """The service script. Returns (the recorded dict, {job id: image})."""
    serve = importlib.import_module(f"{pkg}.serve")
    clock_m = importlib.import_module(f"{pkg}.utils.clock")
    flight = importlib.import_module(f"{pkg}.obs.flight")
    metrics = importlib.import_module(f"{pkg}.obs.metrics")
    text = scene_text(pkg)
    kw = {} if device is None else {"device": device}
    for sub in ("spool", "spool2"):
        os.makedirs(os.path.join(workdir, sub), exist_ok=True)
    metrics.METRICS.reset()
    flight.FLIGHT.configure(os.path.join(workdir, "flight.jsonl"))
    images = {}
    try:
        clock = clock_m.VirtualClock(start=0.0, tick=1e-6)
        svc = serve.RenderService(
            chunk=CHUNK, seed=0, clock=clock, spool_dir=os.path.join(workdir, "spool"),
            slo=serve.SloPolicy(depth=serve.parse_slo_spec("2", int)), **kw)
        events = []

        def submit(**k):
            try:
                events.append(["submit", k, svc.submit(text=text, **k)])
            except serve.ShedError as e:
                events.append(["shed", k, e.tenant, e.priority, e.reason])

        def step(n=1):
            for _ in range(n):
                events.append(["step", svc.step()])

        submit(tenant="alice")
        submit(tenant="bob", weight=2.0)
        submit(tenant="carol")  # the class is at its depth target: shed
        step(3)
        svc.preempt("j2")
        events.append(["preempt", "j2", svc.poll("j2")["chunks_done"]])
        step(2)
        svc.resume("j2")
        submit(tenant="dave", priority=5)  # a higher class runs first
        submit(tenant="erin", priority=5)
        step()
        svc.cancel("j4")
        svc.drain()
        submit(tenant="alice")  # warm: a residency hit
        svc.drain()
        jobs = sorted(svc.jobs)
        out = {
            "events": events,
            "schedule": [list(s) for s in svc.schedule],
            "polls": {j: _poll(svc, j) for j in jobs},
            "residency": _residency(svc),
            "sheds": svc.sheds,
            "flight": _flight(workdir, jobs),
            "metrics": _metrics(metrics.METRICS.snapshot()),
        }
        images.update({j: svc.result(j).image for j in jobs if svc.jobs[j].status == "done"})
        # film-slot preemption: max_active=1, a priority-5 submit parks the
        # running priority-0 job
        svc2 = serve.RenderService(chunk=CHUNK, seed=0, max_active=1,
                                   clock=clock_m.VirtualClock(start=0.0, tick=1e-6),
                                   spool_dir=os.path.join(workdir, "spool2"), **kw)
        lo = svc2.submit(text=text, tenant="batch", job_id="lo")
        steps = [svc2.step(), svc2.step()]
        hi = svc2.submit(text=text, tenant="live", priority=5, job_id="hi")
        steps.append(svc2.step())
        parked = svc2.jobs[lo].state is None
        svc2.drain()
        out["max_active"] = {"steps": steps, "parked": parked,
                             "schedule": [list(s) for s in svc2.schedule],
                             "polls": {j: _poll(svc2, j) for j in (lo, hi)}}
        images.update({f"max_active/{j}": svc2.result(j).image for j in (lo, hi)})
        return out, images
    finally:
        flight.FLIGHT.configure(None)


def run_fleet(pkg: str, workdir: str, device=None):
    """The fleet script. Returns (the recorded dict, {job id: image})."""
    router_m = importlib.import_module(f"{pkg}.fleet.router")
    clock_m = importlib.import_module(f"{pkg}.utils.clock")
    service = importlib.import_module(f"{pkg}.serve.service")
    text = scene_text(pkg)
    text2 = scene_text(pkg, RES // 2)
    kw = {} if device is None else {"device": device}
    clock = clock_m.VirtualClock(start=0.0, tick=1e-6)
    reps = [router_m.LocalReplica(f"r{k}", clock=clock, chunk=CHUNK,
                                  spool_dir=os.path.join(workdir, f"r{k}"), **kw)
            for k in range(2)]
    router = router_m.FleetRouter(reps, clock=clock, spool_dir=os.path.join(workdir, "fleet"))
    out = {}
    images = {}
    # affinity and double delivery
    j1 = router.submit(text=text, tenant="alice", job_id="a1", checkpoint_every=1)
    j2 = router.submit(text=text, tenant="bob", job_id="a2")
    again = router.submit(text=text, tenant="alice", job_id="a1")
    out["affinity"] = {"owners": [router.owner(j1), router.owner(j2)], "again": again,
                       "instances": sum(len(r.service.jobs) for r in reps)}
    router.drain_fleet()
    # the edge shed of a clamped knee
    tight = router_m.FleetRouter(reps, clock=clock,
                                 policy=router_m.FleetPolicy(knee_req_s=0.5, rate_window_s=2.0),
                                 spool_dir=os.path.join(workdir, "edge"))
    edge = []
    for i in range(4):
        try:
            edge.append(["ok", tight.submit(text=text, tenant="burst", job_id=f"e{i}")])
        except service.ShedError as e:
            edge.append(["shed", e.reason])
    tight.drain_fleet()
    out["edge"] = {"answers": edge, "edge_sheds": tight.edge_sheds}
    # kill failover: resume from the spool on the survivor
    jk = router.submit(text=text, tenant="alice", job_id="k1", checkpoint_every=1)
    victim = router.owner(jk)
    steps = []
    while router.poll(jk)["chunks_done"] < 2:
        steps.append(router.step())
    at_kill = router.poll(jk)["chunks_done"]
    moved = router.kill_replica(victim)
    out["kill"] = {"victim": victim, "steps": [list(s) for s in steps], "at_kill": at_kill,
                   "moved": moved, "owner": router.owner(jk)}
    router.drain_fleet()
    # drain failover of a job of another scene (16x16, in 4 slices of 64):
    # the old instance is cancelled
    router3 = router_m.FleetRouter(
        [router_m.LocalReplica(f"s{k}", clock=clock, chunk=CHUNK // 4,
                               spool_dir=os.path.join(workdir, f"s{k}"), **kw)
         for k in range(2)],
        clock=clock, spool_dir=os.path.join(workdir, "fleet3"))
    jd = router3.submit(text=text2, tenant="carol", job_id="d1", checkpoint_every=1)
    old = router3.owner(jd)
    router3.step()
    moved_d = router3.drain_replica(old)
    out["drain"] = {"old": old, "moved": moved_d, "owner": router3.owner(jd),
                    "old_status": router3.replicas[old].status(jd)}
    router3.drain_fleet()
    # router restart: adopt rebuilds the table from the replicas' stats
    ja = router3.submit(text=text2, tenant="dave", job_id="r1", checkpoint_every=1)
    router3.step()
    adopted = router_m.FleetRouter.adopt(list(router3.replicas.values()), clock=clock,
                                         spool_dir=os.path.join(workdir, "fleet3"))
    out["adopt"] = {"jobs": sorted(adopted.jobs), "owner": adopted.owner(ja)}
    adopted.drain_fleet()
    out["routes"] = [list(r) for r in router.routes] + [list(r) for r in router3.routes]
    out["polls"] = {j: _poll(router, j) for j in (j1, j2, jk)} | {
        j: _poll(adopted if j == ja else router3, j) for j in (jd, ja)}
    out["stats"] = [router.stats(), router3.stats(), adopted.stats()]
    images.update({j: router.result(j).image for j in (j1, j2, jk)})
    images.update({jd: router3.result(jd).image, ja: adopted.result(ja).image})
    return out, images


def main(argv):
    ref = {}
    with tempfile.TemporaryDirectory() as d:
        ref["service"], _ = run_service("tpu_pbrt", os.path.join(d, "service"))
        print("service", ref["service"]["schedule"], flush=True)
        ref["fleet"], _ = run_fleet("tpu_pbrt", os.path.join(d, "fleet"))
        print("fleet", ref["fleet"]["routes"], flush=True)
    import subprocess

    try:
        commit = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                                cwd=HERE).stdout.strip()
    except OSError:
        commit = ""
    with open(OUT, "w") as f:
        json.dump({"commit": commit, **ref}, f, indent=1, sort_keys=True)
        f.write("\n")
    print("wrote", OUT)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    main(sys.argv[1:])
