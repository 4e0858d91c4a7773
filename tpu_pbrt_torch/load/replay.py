"""Replay: drive the REAL RenderService with a generated schedule under
a VirtualClock.

The engine is an event loop over virtual time: due arrivals are
submitted (sheds caught and counted), otherwise the service takes one
scheduler step, and each dispatched chunk-slice advances the clock by
the spec's per-slice service time — the replica's device-time model.
When nothing is runnable and arrivals remain, the clock jumps to the
next arrival. The whole run is a pure function of (workload, seed):
the service samples only the injected clock (the seam protocheck
verifies), the stub dispatches are numpy-deterministic, and every
decision appends one path-free line to the log — the byte-identity
artifact the determinism gate diffs across runs.

Stub vs real dispatches: by default jobs are submitted as precompiled
(StubScene, StubIntegrator) pairs from protocheck's harness — host
tensors on the CPU, so the service is built with device="cpu" — instant,
bit-deterministic, and exercising every service code path (residency,
WFQ, shedding, preemption, backoff, checkpoints). `scene_text` swaps in
real compiled scenes for a physically-meaningful (but slower) run.

Capture-replay: with a flight path armed, the engine writes a
``load_run`` header (the full spec) plus one ``load_submit`` heartbeat
per arrival; `workload_from_flight` reconstructs the exact Workload
from those lines — or, for a log recorded by a REAL service (no
harness lines), approximates one from the per-job ``serve_submit`` /
``serve_done`` heartbeats.

Fleet mode (``replicas > 1``): the same schedule is driven through a
``FleetRouter`` over N in-process ``LocalReplica``s, all under the one
VirtualClock — submits route by scene affinity (and may shed at the
fleet edge or at the routed replica's SLO), dispatches rotate across
the replicas, and every decision-log line names the owning replica, so
the byte-identity artifact is a pure function of (workload, seed, N).
The single-replica path is byte-for-byte what it was before fleet mode
existed — ``LOADTEST_baseline.json`` pins it.
"""

from __future__ import annotations

import glob
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tpu_pbrt_torch.load.workload import Request, Workload, WorkloadSpec

__all__ = ["ReplayResult", "replay", "workload_from_flight"]

#: hard ceiling on loop events — a wedged scheduler must terminate the
#: replay with evidence (the wedge flag), not hang CI
_MAX_EVENTS = 500_000


@dataclass
class ReplayResult:
    """Everything the gate layer consumes. Deterministic fields only —
    no wall times, no paths — so two same-seed results compare equal."""

    workload: Workload
    log: List[str] = field(default_factory=list)
    #: METRICS.snapshot() taken at drain, before teardown
    snapshot: Dict[str, Any] = field(default_factory=dict)
    #: every health condition that fired at any evaluation point
    health_flags: List[str] = field(default_factory=list)
    submitted: int = 0
    sheds: int = 0
    completed: int = 0
    failed: int = 0
    dispatches: int = 0
    steps: int = 0
    #: virtual clock at drain
    virtual_seconds: float = 0.0
    #: residency.stats() minus the per-scene detail
    compiles: int = 0
    residency_hits: int = 0
    evictions: int = 0
    preemptions: int = 0
    #: residency pin_counts() entries still nonzero at drain (leaks)
    pin_leaks: Dict[str, int] = field(default_factory=dict)
    #: job ids not terminal at drain (a wedge's evidence)
    unfinished: List[str] = field(default_factory=list)

    def log_text(self) -> str:
        return "".join(line + "\n" for line in self.log)


def _stub_pair(chunks: int, depth: int):
    """A fresh (scene, integrator) stub pair — protocheck's harness
    classes, so the replay exercises the identical submit path the
    protocol explorer verified."""
    from tpu_pbrt_torch.analysis.protocheck import _harness

    h = _harness()
    return (h["StubScene"](), h["StubIntegrator"](chunks, depth))


def replay(
    workload: Workload,
    *,
    replicas: int = 1,
    flight_path: Optional[str] = None,
    trace_path: Optional[str] = None,
    health_every: int = 1,
) -> ReplayResult:
    """Execute the schedule against a fresh RenderService — or, with
    ``replicas > 1``, against a FleetRouter over N of them. Arms the
    global recorders (FLIGHT/TRACE/METRICS/CHAOS) for the run and
    restores them exactly — the protocheck ProtocolModel contract."""
    if replicas > 1:
        return _replay_fleet(
            workload, replicas, flight_path=flight_path,
            trace_path=trace_path, health_every=health_every,
        )
    from tpu_pbrt_torch.chaos import CHAOS
    from tpu_pbrt_torch.obs import health
    from tpu_pbrt_torch.obs.flight import FLIGHT
    from tpu_pbrt_torch.obs.metrics import METRICS
    from tpu_pbrt_torch.obs.trace import TRACE
    from tpu_pbrt_torch.serve.queue import SloPolicy, parse_slo_spec
    from tpu_pbrt_torch.serve.service import (
        DONE,
        FAILED,
        RenderService,
        ShedError,
        _TERMINAL,
    )
    from tpu_pbrt_torch.utils.clock import VirtualClock

    spec = workload.spec
    clock = VirtualClock(start=0.0, tick=1e-6)
    tmpdir = tempfile.mkdtemp(prefix="tpu_load_")
    res = ReplayResult(workload=workload)

    # arm: virtual clock on every recorder, fresh registry (forced on —
    # the gates NEED the snapshot even under TORCH_PBRT_METRICS=0), the
    # scenario's fault plan, optional flight/trace sinks
    METRICS.reset()
    prev_force = METRICS._force
    METRICS._force = True
    flight_prev = (FLIGHT._clock, FLIGHT._t0, FLIGHT._path)
    FLIGHT.set_clock(clock)
    if flight_path:
        FLIGHT.configure(flight_path)
    trace_prev = (TRACE._clock, TRACE._t0, TRACE._path)
    TRACE.set_clock(clock)
    if trace_path:
        TRACE.configure(trace_path)
        TRACE.reset()
        TRACE.set_clock(clock)

    svc = RenderService(
        device="cpu",
        seed=workload.seed, spool_dir=tmpdir, clock=clock,
        max_active=spec.max_active,
        slo=SloPolicy(
            depth=parse_slo_spec(spec.slo_depth, int),
            wait_s=parse_slo_spec(spec.slo_wait_s, float),
        ),
    )
    CHAOS.install(spec.fault, workload.seed)
    flags: set = set()
    try:
        if flight_path:
            FLIGHT.heartbeat(
                "load_run", scenario=spec.name, seed=workload.seed,
                requests=len(workload.requests), spec=spec.to_json(),
            )
        pending = sorted(workload.requests, key=lambda r: (r.t, r.rid))
        i = 0
        events = 0
        while events < _MAX_EVENTS:
            events += 1
            now = clock.peek()
            if i < len(pending) and pending[i].t <= now:
                r = pending[i]
                i += 1
                try:
                    svc.submit(
                        compiled=_stub_pair(r.chunks, r.depth),
                        resident_key=r.scene, job_id=r.rid,
                        tenant=r.tenant, priority=r.priority,
                        checkpoint_every=r.checkpoint_every,
                    )
                    res.submitted += 1
                    outcome = "ok"
                except ShedError as e:
                    res.sheds += 1
                    outcome = f"shed:{e.reason}"
                if flight_path:
                    FLIGHT.heartbeat(
                        "load_submit", rid=r.rid, at=r.t,
                        tenant=r.tenant, prio=r.priority, scene=r.scene,
                        chunks=r.chunks, depth=r.depth,
                        ckpt=r.checkpoint_every, kind=r.kind,
                        outcome=outcome,
                    )
                res.log.append(
                    f"@{now:012.6f} submit {r.rid} tenant={r.tenant} "
                    f"prio={r.priority} scene={r.scene} -> {outcome}"
                )
            else:
                rid = svc.step()
                res.steps += 1
                if rid is None:
                    if i < len(pending):
                        clock.advance_to(pending[i].t)
                        res.log.append(
                            f"@{clock.peek():012.6f} advance"
                        )
                    elif svc.idle():
                        break
                    else:
                        # runnable work, no dispatch, nothing to wait
                        # for: a WEDGE. Keep stepping just long enough
                        # for the watchdog's gap counter to cross its
                        # threshold — the harness's job is to FLAG the
                        # wedge, not hang on it.
                        th = health.Thresholds()
                        for _ in range(th.resolved_wedge_steps() + 2):
                            svc.step()
                            flags |= set(
                                health.evaluate(svc, METRICS).firing()
                            )
                        res.log.append(
                            f"@{clock.peek():012.6f} wedge"
                        )
                        break
                else:
                    res.dispatches += 1
                    cur = svc.jobs[rid].cursor
                    res.log.append(
                        f"@{clock.peek():012.6f} step -> {rid}:c{cur}"
                    )
                    # the slice's device time: the replica is busy for
                    # this long in virtual time
                    clock.advance(spec.service_time_s)
            if events % max(1, health_every) == 0:
                flags |= set(health.evaluate(svc, METRICS).firing())
        flags |= set(health.evaluate(svc, METRICS).firing())

        res.health_flags = sorted(flags)
        res.virtual_seconds = round(clock.peek(), 6)
        res.completed = sum(
            1 for j in svc.jobs.values() if j.status == DONE
        )
        res.failed = sum(
            1 for j in svc.jobs.values() if j.status == FAILED
        )
        res.unfinished = sorted(
            j.job_id for j in svc.jobs.values()
            if j.status not in _TERMINAL
        )
        res.pin_leaks = {
            k: n for k, n in svc.residency.pin_counts().items() if n
        }
        res.compiles = svc.residency.scene_compiles
        res.residency_hits = svc.residency.hits
        res.evictions = svc.residency.evictions
        res.snapshot = METRICS.snapshot()
        res.preemptions = int(sum(
            s["value"] for s in res.snapshot["metrics"].get(
                "tpu_pbrt_serve_preemptions_total", {},
            ).get("series", ())
        ))
        if trace_path:
            # export INSIDE the armed window: the clock is still
            # virtual, so otherData.clock stamps "virtual" and scope's
            # --check exercises the non-wall path
            TRACE.export(trace_path)
        return res
    finally:
        CHAOS.clear()
        FLIGHT._clock, FLIGHT._t0, FLIGHT._path = flight_prev
        TRACE._clock, TRACE._t0, TRACE._path = trace_prev
        if trace_path:
            TRACE.reset()
        METRICS._force = prev_force


def _replay_fleet(
    workload: Workload,
    n_replicas: int,
    *,
    flight_path: Optional[str] = None,
    trace_path: Optional[str] = None,
    health_every: int = 1,
) -> ReplayResult:
    """The fleet engine: one VirtualClock, N LocalReplicas (each a real
    RenderService with the scenario's SLO), one FleetRouter in front.
    Same loop shape as the single-replica engine — due arrivals submit
    (through the router: affinity routing + fleet-edge shedding +
    per-replica SLO), otherwise `router.step()` dispatches one slice
    somewhere in the fleet — and the same aggregate ReplayResult, with
    the per-replica facts summed fleet-wide (pin leaks keyed by
    replica, health flags unioned over every replica's watchdog)."""
    from tpu_pbrt_torch.chaos import CHAOS
    from tpu_pbrt_torch.fleet.router import FleetRouter, LocalReplica
    from tpu_pbrt_torch.obs import health
    from tpu_pbrt_torch.obs.flight import FLIGHT
    from tpu_pbrt_torch.obs.metrics import METRICS
    from tpu_pbrt_torch.obs.trace import TRACE
    from tpu_pbrt_torch.serve.queue import SloPolicy, parse_slo_spec
    from tpu_pbrt_torch.serve.service import DONE, FAILED, ShedError, _TERMINAL
    from tpu_pbrt_torch.utils.clock import VirtualClock

    spec = workload.spec
    clock = VirtualClock(start=0.0, tick=1e-6)
    tmpdir = tempfile.mkdtemp(prefix="tpu_load_fleet_")
    res = ReplayResult(workload=workload)

    METRICS.reset()
    prev_force = METRICS._force
    METRICS._force = True
    flight_prev = (FLIGHT._clock, FLIGHT._t0, FLIGHT._path)
    FLIGHT.set_clock(clock)
    if flight_path:
        FLIGHT.configure(flight_path)
    trace_prev = (TRACE._clock, TRACE._t0, TRACE._path)
    TRACE.set_clock(clock)
    if trace_path:
        TRACE.configure(trace_path)
        TRACE.reset()
        TRACE.set_clock(clock)

    fleet = [
        LocalReplica(
            f"r{k}", device="cpu",
            clock=clock, seed=workload.seed,
            spool_dir=os.path.join(tmpdir, f"r{k}"),
            max_active=spec.max_active,
            slo=SloPolicy(
                depth=parse_slo_spec(spec.slo_depth, int),
                wait_s=parse_slo_spec(spec.slo_wait_s, float),
            ),
        )
        for k in range(int(n_replicas))
    ]
    router = FleetRouter(
        fleet, clock=clock, spool_dir=os.path.join(tmpdir, "fleet"),
    )
    CHAOS.install(spec.fault, workload.seed)

    def _fleet_health() -> set:
        out: set = set()
        for rep in fleet:
            out |= set(health.evaluate(rep.service, METRICS).firing())
        return out

    flags: set = set()
    try:
        if flight_path:
            FLIGHT.heartbeat(
                "load_run", scenario=spec.name, seed=workload.seed,
                requests=len(workload.requests), spec=spec.to_json(),
                replicas=n_replicas,
            )
        pending = sorted(workload.requests, key=lambda r: (r.t, r.rid))
        i = 0
        events = 0
        while events < _MAX_EVENTS:
            events += 1
            now = clock.peek()
            if i < len(pending) and pending[i].t <= now:
                r = pending[i]
                i += 1
                try:
                    router.submit(
                        compiled=_stub_pair(r.chunks, r.depth),
                        resident_key=r.scene, job_id=r.rid,
                        tenant=r.tenant, priority=r.priority,
                        checkpoint_every=r.checkpoint_every,
                    )
                    res.submitted += 1
                    outcome = f"ok@{router.owner(r.rid)}"
                except ShedError as e:
                    res.sheds += 1
                    outcome = f"shed:{e.reason}"
                if flight_path:
                    FLIGHT.heartbeat(
                        "load_submit", rid=r.rid, at=r.t,
                        tenant=r.tenant, prio=r.priority, scene=r.scene,
                        chunks=r.chunks, depth=r.depth,
                        ckpt=r.checkpoint_every, kind=r.kind,
                        outcome=outcome,
                    )
                res.log.append(
                    f"@{now:012.6f} submit {r.rid} tenant={r.tenant} "
                    f"prio={r.priority} scene={r.scene} -> {outcome}"
                )
            else:
                got = router.step()
                res.steps += 1
                if got is None:
                    if i < len(pending):
                        clock.advance_to(pending[i].t)
                        res.log.append(
                            f"@{clock.peek():012.6f} advance"
                        )
                    elif all(rep.service.idle() for rep in fleet):
                        break
                    else:
                        # fleet wedge: step every replica's service
                        # directly (router.step() short-circuits when
                        # nothing is dispatchable, so the per-replica
                        # watchdog gap counters only advance on direct
                        # steps) until the wedge threshold crosses,
                        # then stop with the flag as evidence
                        th = health.Thresholds()
                        for _ in range(th.resolved_wedge_steps() + 2):
                            for rep in fleet:
                                rep.service.step()
                            flags |= _fleet_health()
                        res.log.append(
                            f"@{clock.peek():012.6f} wedge"
                        )
                        break
                else:
                    rid, job = got
                    res.dispatches += 1
                    cur = router.replicas[rid].service.jobs[job].cursor
                    res.log.append(
                        f"@{clock.peek():012.6f} step -> {rid}/{job}:c{cur}"
                    )
                    clock.advance(spec.service_time_s)
            if events % max(1, health_every) == 0:
                flags |= _fleet_health()
        flags |= _fleet_health()

        res.health_flags = sorted(flags)
        res.virtual_seconds = round(clock.peek(), 6)
        statuses: Dict[str, str] = {}
        for job_id, rec in router.jobs.items():
            st = rec.terminal
            if not st:
                rep = router.replicas.get(rec.rid)
                st = (
                    rep.status(job_id)
                    if rep is not None and rep.alive else None
                )
            statuses[job_id] = st or ""
        res.completed = sum(1 for s in statuses.values() if s == DONE)
        res.failed = sum(1 for s in statuses.values() if s == FAILED)
        res.unfinished = sorted(
            j for j, s in statuses.items() if s not in _TERMINAL
        )
        res.pin_leaks = {
            f"{rep.rid}:{k}": n
            for rep in fleet
            for k, n in rep.service.residency.pin_counts().items() if n
        }
        res.compiles = sum(
            rep.service.residency.scene_compiles for rep in fleet
        )
        res.residency_hits = sum(
            rep.service.residency.hits for rep in fleet
        )
        res.evictions = sum(
            rep.service.residency.evictions for rep in fleet
        )
        res.snapshot = METRICS.snapshot()
        res.preemptions = int(sum(
            s["value"] for s in res.snapshot["metrics"].get(
                "tpu_pbrt_serve_preemptions_total", {},
            ).get("series", ())
        ))
        if trace_path:
            TRACE.export(trace_path)
        return res
    finally:
        CHAOS.clear()
        FLIGHT._clock, FLIGHT._t0, FLIGHT._path = flight_prev
        TRACE._clock, TRACE._t0, TRACE._path = trace_prev
        if trace_path:
            TRACE.reset()
        METRICS._force = prev_force


# --------------------------------------------------------------------------
# Capture-replay
# --------------------------------------------------------------------------


def _read_jsonl(path: str) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue  # torn tail line: crash-safe format
    except OSError:
        pass
    return out


def workload_from_flight(path: str) -> Workload:
    """Reconstruct a Workload from a recorded flight log.

    Preferred source: the ``load_run`` header + ``load_submit`` lines a
    harness replay wrote — reconstruction is EXACT (same spec, same
    requests, so a re-replay produces a byte-identical decision log).

    Fallback (a log from a real serve daemon): scavenge the per-job
    ``serve_submit`` heartbeats (arrival stamp, tenant, priority, key)
    and ``serve_done`` (chunk count) from the per-job flight files next
    to `path`. Approximate — arrival stamps are the recorder's 3-dp
    rounding, un-completed jobs fall back to one chunk — but it turns
    any production incident log into a replayable schedule."""
    lines = _read_jsonl(path)
    spec: Optional[WorkloadSpec] = None
    seed = 0
    requests: List[Request] = []
    for ln in lines:
        phase = ln.get("phase")
        if phase == "load_run" and "spec" in ln:
            spec = WorkloadSpec.from_json(ln["spec"])
            seed = int(ln.get("seed", 0))
        elif phase == "load_submit":
            requests.append(Request(
                rid=str(ln["rid"]), t=float(ln["at"]),
                tenant=str(ln["tenant"]), priority=int(ln["prio"]),
                scene=str(ln["scene"]), chunks=int(ln["chunks"]),
                depth=int(ln.get("depth", 1)),
                checkpoint_every=int(ln.get("ckpt", 0)),
                kind=str(ln.get("kind", "fresh")),
            ))
    if spec is not None and requests:
        requests.sort(key=lambda r: (r.t, r.rid))
        return Workload(spec=spec, seed=seed, requests=requests)

    # -- fallback: per-job serve_* heartbeats ------------------------------
    root, ext = os.path.splitext(path)
    submits: Dict[str, Dict[str, Any]] = {}
    chunks: Dict[str, int] = {}
    for jf in sorted(glob.glob(f"{root}.*{ext}")):
        for ln in _read_jsonl(jf):
            phase = ln.get("phase")
            job = ln.get("job")
            if job is None:
                # per-job files name the job in the filename only when
                # the service's _flight attaches it as a field; skip
                # lines without one
                continue
            if phase == "serve_submit":
                submits[job] = ln
            elif phase == "serve_done":
                if "chunks" in ln:
                    chunks[job] = int(ln["chunks"])
    requests = []
    for job, ln in submits.items():
        requests.append(Request(
            rid=str(job), t=float(ln.get("t", 0.0)),
            tenant=str(ln.get("tenant", "default")),
            priority=int(ln.get("priority", 0)),
            scene=str(ln.get("key", f"captured:{job}")),
            chunks=chunks.get(job, 1), kind="fresh",
        ))
    if not requests:
        raise ValueError(
            f"no load_submit or serve_submit heartbeats found under "
            f"{path!r} — nothing to reconstruct"
        )
    requests.sort(key=lambda r: (r.t, r.rid))
    duration = max(r.t for r in requests) + 1e-6
    spec = WorkloadSpec(
        name="captured", duration_s=round(duration, 6),
        rate=round(len(requests) / duration, 6),
    )
    return Workload(spec=spec, seed=seed, requests=requests)
