"""The fleet front door: scene-affinity routing, edge shedding, and
checkpoint-spool failover across N serve replicas.

Protocol shape:

- **route** — a submit hashes its scene key onto a consistent-hash
  ring of healthy replicas. Affinity is the point: the same key routes
  to the same replica while that replica stays healthy, so a warm
  resubmit finds its compiled scene resident.
- **edge shed** — before anything compiles, the offered arrival rate
  over a sliding window is compared against the fleet's capacity
  (``knee_req_s x healthy replicas``). Over-capacity submits are answered with the same
  deterministic ``ShedError`` contract the per-replica SLO uses.
- **failover** — the router polls each replica's health verdict; a
  wedged or backoff-storming replica is drained (its runnable jobs
  park through the emergency-checkpoint path) and each of its live
  jobs is re-submitted on another replica with the SAME router-owned
  spool checkpoint path, so the new replica's activation resumes from
  the durable cursor. Chunks are idempotent pure functions and film
  accumulation from the cursor is sequential, so the resumed film is
  BIT-identical to an undisturbed render.
- **consume-the-spool dedup** — a failover terminates the old
  instance before the new one exists (cancel on drain; the replica is
  dead on kill), and the router's job table plus a bounded dedup
  window refuse a second delivery of a job id that was already
  admitted. A job never renders twice.

Trace contract: the router mints
``t:<job>`` and owns the root ``serve/job`` async span; replicas get
the id as a caller-supplied trace context and never open or close the
root, so one request — including a failover's re-route/resume — is a
single timeline that ``obs.trace.validate_trace`` accepts.
"""

from __future__ import annotations

import hashlib
import os
from bisect import bisect_right
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from tpu_pbrt_torch.serve.service import (
    _RUNNABLE,
    _TERMINAL,
    PAUSED,
    RenderService,
    ShedError,
)
from tpu_pbrt_torch.utils.clock import WALL

#: the edge-shedding threshold and the sizing formula's denominator, in
#: req/s per replica: the knee of the port's own load harness, `python
#: -m tpu_pbrt_torch.load --capacity steady` (seed 7, p99 queue-wait
#: target 0.5 s), a virtual-time figure of the serving policy that
#: equals the reference's (LOADTEST_baseline.json)
KNEE_REQ_S = 159.5


def fleet_size(offered_req_s: float, knee_req_s: float = KNEE_REQ_S) -> int:
    """The capacity-derived sizing formula:
    ``replicas = ceil(offered / knee)``."""
    import math

    return max(1, math.ceil(float(offered_req_s) / float(knee_req_s)))


@dataclass(frozen=True)
class FleetPolicy:
    """Router knobs — all deterministic inputs, no hidden state."""

    #: per-replica sustainable req/s (KNEE_REQ_S by default); the edge
    #: admits while offered <= knee x healthy replicas
    knee_req_s: float = KNEE_REQ_S
    #: sliding window (seconds) the offered arrival rate is measured
    #: over at the edge
    rate_window_s: float = 1.0
    #: virtual nodes per replica on the hash ring — enough to spread
    #: keys evenly at small N without making the ring expensive
    vnodes: int = 16
    #: admitted job ids remembered after they leave the job table —
    #: the double-delivery refusal horizon
    dedup_window: int = 256


@dataclass
class _JobRecord:
    """The router's view of one admitted job: where it lives, how to
    re-submit it on failover, and the trace/spool handles it owns."""

    job_id: str
    key: str  # scene-affinity routing key (== the residency key)
    rid: str  # owning replica id
    trace_id: str
    checkpoint_path: str  # router-owned durable spool entry
    #: submit kwargs replayed verbatim on failover (None after a
    #: router restart: the rebuilt table can route/poll/cancel but a
    #: job whose source is unknown cannot be re-submitted)
    resubmit: Optional[Dict[str, Any]] = None
    terminal: str = ""  # fleet-wide terminal outcome, "" while live
    failovers: int = 0
    root_open: bool = True  # the root serve/job span awaits its end


class LocalReplica:
    """One in-process replica: a real RenderService under the shared
    (usually virtual) clock. The deterministic-testing backend — the
    whole fleet is then a pure function of the decision sequence.
    `device`: the service's (CUDA unless the caller names the CPU)."""

    kind = "local"

    def __init__(
        self,
        rid: str,
        *,
        clock=None,
        spool_dir: Optional[str] = None,
        seed: int = 0,
        slo=None,
        max_active: Optional[int] = None,
        chunk: Optional[int] = None,
        mesh=None,
        device=None,
    ):
        self.rid = rid
        self.alive = True
        self.draining = False
        if spool_dir is not None:
            os.makedirs(spool_dir, exist_ok=True)
        self.service = RenderService(
            mesh=mesh, device=device, chunk=chunk, max_active=max_active, seed=seed,
            spool_dir=spool_dir, quiet=True, slo=slo, clock=clock,
        )

    # -- submit/lifecycle forwarding ---------------------------------------
    def submit(self, **kw) -> str:
        return self.service.submit(**kw)

    def poll(self, job_id: str) -> Dict[str, Any]:
        return self.service.poll(job_id)

    def status(self, job_id: str) -> Optional[str]:
        j = self.service.jobs.get(job_id)
        return None if j is None else j.status

    def result(self, job_id: str):
        return self.service.result(job_id)

    def cancel(self, job_id: str) -> None:
        self.service.cancel(job_id)

    def stats(self) -> Dict[str, Any]:
        return self.service.stats()

    def health(self) -> Dict[str, Any]:
        from tpu_pbrt_torch.obs.health import evaluate

        rep = evaluate(self.service)
        return {"ok": rep.ok, "firing": rep.firing()}

    # -- scheduling (local-only: daemons step themselves) ------------------
    def step(self) -> Optional[str]:
        return self.service.step()

    def has_ready(self, now: float) -> bool:
        """Dispatchable work as of `now` — a pure observation (the
        shared `now` threads through, so checking N replicas never
        perturbs the decision clock)."""
        return bool(self.service._runnable(now))

    def backoff_deadlines(self, now: float) -> List[float]:
        return [
            j.not_before for j in self.service.jobs.values()
            if j.status in _RUNNABLE and j.not_before > now
        ]

    # -- handoff -----------------------------------------------------------
    def drain(self) -> Dict[str, Any]:
        self.draining = True
        return self.service.begin_drain()

    def kill(self) -> None:
        """Abrupt death. A real process would just vanish — its device
        memory and its trace file with it. In-process the recorders are
        shared, so the equivalent is: drop every device reference and
        close the open wait/slice spans (aborted), writing NOTHING
        durable — the spool keeps exactly what was already
        checkpointed, which is all a restarted peer could ever see."""
        self.alive = False
        svc = self.service
        for j in svc.jobs.values():
            if j.status not in _TERMINAL:
                svc._release_device(j)
                j.plan = None
                svc._trace_wait_end(j)


class FleetRouter:
    """The front door. Deterministic given (replica set, policy, clock,
    decision sequence): routing is a pure hash, edge shedding a pure
    function of the arrival window, and failover an explicit decision
    — which is what lets a test replay the whole
    route/re-route/resume-elsewhere/double-delivery grid exactly.
    """

    def __init__(
        self,
        replicas,
        *,
        clock=None,
        policy: Optional[FleetPolicy] = None,
        spool_dir: Optional[str] = None,
    ):
        self.clock = clock if clock is not None else WALL
        self.policy = policy if policy is not None else FleetPolicy()
        if spool_dir is None:
            import tempfile

            spool_dir = tempfile.mkdtemp(prefix="tpu_pbrt_fleet_")
        os.makedirs(spool_dir, exist_ok=True)
        self.spool_dir = spool_dir
        self.replicas: "OrderedDict[str, Any]" = OrderedDict(
            (r.rid, r) for r in replicas
        )
        if not self.replicas:
            raise ValueError("a fleet needs at least one replica")
        # the consistent-hash ring: policy.vnodes points per replica,
        # content-hashed (sha256 — stable across processes and
        # PYTHONHASHSEED) so the key->replica map is a pure function
        # of the replica-id set
        self._ring: List[Tuple[int, str]] = sorted(
            (self._hash(f"{rid}#{v}"), rid)
            for rid in self.replicas
            for v in range(self.policy.vnodes)
        )
        self.jobs: Dict[str, _JobRecord] = {}
        #: admitted ids remembered past the job table (bounded) — the
        #: double-delivery refusal window
        self._dedup: "OrderedDict[str, str]" = OrderedDict()
        self._arrivals: deque = deque()
        self._seq = 0
        self._rr = 0  # step() rotation cursor
        self.edge_sheds = 0
        #: routing decisions [(job_id, key, rid)] — the affinity
        #: evidence the tests assert on
        self.routes: List[Tuple[str, str, str]] = []

    # -- ring --------------------------------------------------------------
    @staticmethod
    def _hash(s: str) -> int:
        return int.from_bytes(
            hashlib.sha256(s.encode()).digest()[:8], "big"
        )

    def healthy(self) -> List[str]:
        return [
            rid for rid, r in self.replicas.items()
            if r.alive and not r.draining
        ]

    def route_key(self, key: str) -> str:
        """The ring walk: first healthy replica at/after the key's
        point, clockwise. Removing one replica re-routes ONLY the keys
        that pointed at it — every other key keeps its affinity."""
        healthy = set(self.healthy())
        if not healthy:
            raise RuntimeError(
                "no healthy replica to route to (all drained or dead)"
            )
        h = self._hash(key)
        n = len(self._ring)
        i = bisect_right(self._ring, (h, ""))
        for off in range(n):
            _, rid = self._ring[(i + off) % n]
            if rid in healthy:
                return rid
        raise RuntimeError("unreachable: healthy set non-empty")

    # -- edge admission ----------------------------------------------------
    def _edge_admit(self, now: float, tenant: str, priority: int) -> None:
        """Fleet-level SLO shedding BEFORE any replica compiles: the
        offered rate over the sliding arrival window (this arrival
        included) against knee x healthy. Deterministic — same arrival
        times, same healthy set, same sheds."""
        w = self.policy.rate_window_s
        arr = self._arrivals
        while arr and arr[0] <= now - w:
            arr.popleft()
        offered = (len(arr) + 1) / w
        cap = self.policy.knee_req_s * max(len(self.healthy()), 1)
        if offered > cap:
            self.edge_sheds += 1
            reason = (
                f"fleet-edge: offered {offered:g} req/s > capacity "
                f"{cap:g} (knee {self.policy.knee_req_s:g} x "
                f"{len(self.healthy())} replica(s))"
            )
            from tpu_pbrt_torch.obs.flight import FLIGHT
            from tpu_pbrt_torch.obs.metrics import METRICS
            from tpu_pbrt_torch.obs.trace import TRACE

            METRICS.counter(
                "fleet_edge_shed_total",
                "submits refused at the fleet edge (offered > knee x "
                "healthy)",
            ).inc(tenant=tenant, priority=priority)
            FLIGHT.heartbeat(
                "fleet_shed", tenant=tenant, priority=priority,
                reason=reason,
            )
            # same zero-length pseudo-trace the per-replica shed path
            # emits: the refusal is part of the fleet timeline
            tid = TRACE.trace_id(f"fshed{self.edge_sheds}")
            TRACE.async_begin(
                "serve/job", id=tid, cat="job", outcome="shed",
                tenant=tenant, priority=priority, reason=reason,
                trace_id=tid,
            )
            TRACE.async_end(
                "serve/job", id=tid, cat="job", outcome="shed"
            )
            raise ShedError(
                f"submit shed: {reason}", tenant=tenant,
                priority=priority, reason=reason,
            )
        arr.append(now)

    # -- submit ------------------------------------------------------------
    def _spool_path(self, job_id: str) -> str:
        return os.path.join(self.spool_dir, f"{job_id}.ckpt.npz")

    def submit(
        self,
        path: Optional[str] = None,
        *,
        text: Optional[str] = None,
        compiled=None,
        resident_key: Optional[str] = None,
        options=None,
        job_id: Optional[str] = None,
        tenant: str = "default",
        priority: int = 0,
        weight: Optional[float] = None,
        chunk: Optional[int] = None,
        checkpoint_every: int = 0,
        preview_every: int = 0,
        preview_path: str = "",
        outfile: str = "",
    ) -> str:
        """Route one submit. Returns the job id; a duplicate id (still
        tracked, or inside the dedup window) returns the EXISTING
        assignment without touching any replica — the double-delivery
        guard. Raises ShedError at the fleet edge (over capacity) or
        from the routed replica's own SLO admission."""
        if job_id is not None and (
            job_id in self.jobs or job_id in self._dedup
        ):
            return job_id  # already delivered once; never render twice
        now = self.clock.peek()
        self._edge_admit(now, tenant, int(priority))
        key = self._routing_key(
            path=path, text=text, compiled=compiled,
            resident_key=resident_key, options=options,
        )
        rid = self.route_key(key)
        self._seq += 1
        if job_id is None:
            job_id = f"f{self._seq}"
        from tpu_pbrt_torch.obs.trace import TRACE

        trace_id = TRACE.trace_id(job_id)
        resubmit = dict(
            path=path, text=text, compiled=compiled, resident_key=key,
            options=options, tenant=tenant, priority=int(priority),
            weight=weight, chunk=chunk,
            checkpoint_every=int(checkpoint_every),
            preview_every=int(preview_every), preview_path=preview_path,
            outfile=outfile,
        )
        # the root span opens at the ROUTER — the replicas see a
        # caller-supplied trace context and never re-open it, so a
        # failover's second submit continues this same timeline
        TRACE.async_begin(
            "serve/job", id=trace_id, cat="job", job=job_id,
            tenant=tenant, priority=int(priority), trace_id=trace_id,
            replica=rid,
        )
        try:
            self.replicas[rid].submit(
                job_id=job_id, trace_id=trace_id,
                checkpoint_path=self._spool_path(job_id), **resubmit,
            )
        except ShedError:
            TRACE.async_end(
                "serve/job", id=trace_id, cat="job", outcome="shed",
            )
            raise
        except Exception:
            TRACE.async_end(
                "serve/job", id=trace_id, cat="job", outcome="failed",
            )
            raise
        self.jobs[job_id] = _JobRecord(
            job_id=job_id, key=key, rid=rid, trace_id=trace_id,
            checkpoint_path=self._spool_path(job_id), resubmit=resubmit,
        )
        self._remember(job_id, rid)
        self.routes.append((job_id, key, rid))
        return job_id

    def _routing_key(
        self, *, path, text, compiled, resident_key, options,
    ) -> str:
        """The affinity key — the same residency key the replica will
        compute, so routing affinity IS residency affinity."""
        if resident_key:
            return resident_key
        from tpu_pbrt_torch.serve.residency import scene_source_key

        opt_extra = (
            getattr(options, "crop_window", None),
            getattr(options, "quick_render", False),
            getattr(options, "image_file", ""),
        )
        if path is not None:
            return scene_source_key(path=path, extra=opt_extra)
        if text is not None:
            return scene_source_key(text=text, extra=opt_extra)
        if compiled is not None:
            raise ValueError(
                "routing a precompiled pair needs an explicit "
                "resident_key (affinity must be content-derived)"
            )
        raise ValueError("submit needs a path, text, or compiled pair")

    def _remember(self, job_id: str, rid: str) -> None:
        self._dedup[job_id] = rid
        self._dedup.move_to_end(job_id)
        while len(self._dedup) > self.policy.dedup_window:
            self._dedup.popitem(last=False)

    # -- scheduling (local replicas) ---------------------------------------
    def step(self) -> Optional[Tuple[str, str]]:
        """Dispatch one chunk-slice somewhere in the fleet: rotate over
        the alive replicas that have dispatchable work at one shared
        observation of the clock; when nothing is dispatchable but
        backoff windows are open, wait out the earliest fleet-wide
        deadline and retry once. Returns (replica id, job id), or None
        when the whole fleet is idle. Local replicas only — daemon
        replicas run their own loops."""
        now = self.clock.peek()
        picked = self._pick(now)
        if picked is None:
            deadlines = [
                d for r in self.replicas.values() if r.alive
                for d in r.backoff_deadlines(now)
            ]
            if not deadlines:
                return None
            self.clock.sleep(max(min(deadlines) - now, 0.0))
            picked = self._pick(self.clock.peek())
            if picked is None:
                return None
        rid = picked
        job = self.replicas[rid].step()
        self._note_progress(rid)
        if job is None:
            return None
        return (rid, job)

    def _pick(self, now: float) -> Optional[str]:
        rids = [
            rid for rid, r in self.replicas.items()
            if r.alive and r.kind == "local" and r.has_ready(now)
        ]
        if not rids:
            return None
        order = list(self.replicas)
        # rotation: continue after the last-stepped replica, so equal
        # backlogs share the dispatch budget deterministically
        rids.sort(key=lambda rid: (
            (order.index(rid) - self._rr - 1) % len(order)
        ))
        self._rr = list(self.replicas).index(rids[0])
        return rids[0]

    def step_replica(self, rid: str) -> Optional[str]:
        """Step one NAMED replica (the explorer's interleaving
        decision) and run the terminal bookkeeping."""
        r = self.replicas[rid]
        if not r.alive:
            raise ValueError(f"replica {rid} is dead")
        job = r.step()
        self._note_progress(rid)
        return job

    def drain_fleet(self, max_steps: int = 1_000_000) -> None:
        """step() until the whole fleet is idle."""
        for _ in range(max_steps):
            if self.step() is None:
                return
        raise RuntimeError("fleet drain exceeded max_steps")

    def _note_progress(self, rid: str) -> None:
        """Scan the stepped replica for newly-terminal jobs: close
        their root spans with the fleet-wide outcome and consume their
        spool entries (a prefetch failure can terminate a job other
        than the stepped one, so the scan covers every record there)."""
        r = self.replicas[rid]
        for rec in self.jobs.values():
            if rec.terminal or rec.rid != rid:
                continue
            st = r.status(rec.job_id)
            if st in _TERMINAL:
                self._note_terminal(rec, st)

    def _note_terminal(self, rec: _JobRecord, status: str) -> None:
        from tpu_pbrt_torch.obs.trace import TRACE
        from tpu_pbrt_torch.parallel.checkpoint import delete_checkpoint

        rec.terminal = status
        if rec.root_open:
            rec.root_open = False
            r = self.replicas.get(rec.rid)
            chunks = 0
            if r is not None and r.alive:
                try:
                    chunks = int(r.poll(rec.job_id).get("chunks_done", 0))
                except Exception:  # noqa: BLE001 — daemon race at exit
                    chunks = 0
            TRACE.async_end(
                "serve/job", id=rec.trace_id, cat="job", outcome=status,
                chunks=chunks,
            )
        if status != "failed":
            # consume the spool: the durable entry exists for resume;
            # a done/cancelled job must not leave a stale cursor a
            # later failover could resurrect. Failed jobs keep theirs
            # for post-mortem.
            delete_checkpoint(rec.checkpoint_path)

    # -- verbs forwarded by ownership --------------------------------------
    def _rec(self, job_id: str) -> _JobRecord:
        rec = self.jobs.get(job_id)
        if rec is None:
            raise KeyError(f"unknown fleet job {job_id!r}")
        return rec

    def owner(self, job_id: str) -> str:
        return self._rec(job_id).rid

    def poll(self, job_id: str) -> Dict[str, Any]:
        rec = self._rec(job_id)
        out = self.replicas[rec.rid].poll(job_id)
        out["replica"] = rec.rid
        out["failovers"] = rec.failovers
        return out

    def result(self, job_id: str):
        rec = self._rec(job_id)
        return self.replicas[rec.rid].result(job_id)

    def cancel(self, job_id: str) -> None:
        rec = self._rec(job_id)
        r = self.replicas.get(rec.rid)
        if r is not None and r.alive:
            r.cancel(job_id)
        if not rec.terminal:
            self._note_terminal(rec, "cancelled")

    def stats(self) -> Dict[str, Any]:
        live = [r for r in self.jobs.values() if not r.terminal]
        return {
            "replicas": {
                rid: {
                    "alive": r.alive,
                    "draining": r.draining,
                    "jobs": sum(1 for j in live if j.rid == rid),
                }
                for rid, r in self.replicas.items()
            },
            "jobs": len(self.jobs),
            "live": len(live),
            "edge_sheds": self.edge_sheds,
            "routes": len(self.routes),
        }

    # -- health-driven drain & failover ------------------------------------
    def check_health(self) -> Dict[str, List[str]]:
        """Poll every routable replica's health verdict; drain any
        whose wedge or backoff_storm condition fires (the two verdicts
        that mean the replica is no longer making progress — slo_burn
        and nonfinite_spike are load/content signals the router answers
        with shedding, not eviction). Returns {rid: firing}."""
        firing: Dict[str, List[str]] = {}
        for rid in self.healthy():
            verdict = self.replicas[rid].health()
            flags = list(verdict.get("firing", []))
            if flags:
                firing[rid] = flags
            if {"wedge", "backoff_storm"} & set(flags):
                self.drain_replica(rid)
        return firing

    def drain_replica(self, rid: str) -> List[str]:
        """Graceful eviction: the replica sheds new submits and parks
        its runnable jobs (durable spool writes), then every live job
        it owned fails over to a surviving replica. Returns the moved
        job ids."""
        from tpu_pbrt_torch.obs.trace import TRACE

        r = self.replicas[rid]
        if not r.alive or r.draining:
            return []
        r.draining = True
        TRACE.instant("fleet/drain", replica=rid)
        r.drain()
        return self._failover_all(rid, cancel_old=True)

    def kill_replica(self, rid: str) -> List[str]:
        """Abrupt replica death (the chaos row): no goodbye, no final
        checkpoint — survivors adopt its jobs from whatever the spool
        already holds (possibly nothing: then the job restarts from
        chunk 0, which is still bit-identical)."""
        from tpu_pbrt_torch.obs.trace import TRACE

        r = self.replicas[rid]
        if not r.alive:
            return []
        TRACE.instant("fleet/replica_kill", replica=rid)
        r.kill()
        return self._failover_all(rid, cancel_old=False)

    def _failover_all(self, rid: str, *, cancel_old: bool) -> List[str]:
        moved = []
        for rec in list(self.jobs.values()):
            if rec.rid == rid and not rec.terminal:
                self._failover_job(rec.job_id, rid, cancel_old=cancel_old)
                moved.append(rec.job_id)
        return moved

    def _failover_job(
        self, job_id: str, from_rid: str, *, cancel_old: bool = True,
    ) -> str:
        """Move one live job: CONSUME the old instance (cancel it on a
        drained-but-alive replica — a dead one consumed itself), then
        re-submit on a surviving replica with the same spool checkpoint
        path, so activation resumes from the durable cursor. The order
        is the dedup guarantee: at no point do two replicas both
        consider the job theirs — skipping the consume would be
        exactly a double render."""
        from tpu_pbrt_torch.obs.trace import TRACE

        rec = self._rec(job_id)
        if rec.resubmit is None:
            raise RuntimeError(
                f"job {job_id} cannot fail over: its submit source was "
                "lost across a router restart"
            )
        old = self.replicas.get(from_rid)
        if cancel_old and old is not None and old.alive:
            old.cancel(job_id)  # explicit checkpoint_path: spool survives
        to_rid = self.route_key(rec.key)
        TRACE.instant(
            "fleet/failover", job=job_id, src=from_rid, dst=to_rid,
            trace_id=rec.trace_id,
        )
        self.replicas[to_rid].submit(
            job_id=job_id, trace_id=rec.trace_id,
            checkpoint_path=rec.checkpoint_path, **rec.resubmit,
        )
        rec.rid = to_rid
        rec.failovers += 1
        self._remember(job_id, to_rid)
        self.routes.append((job_id, rec.key, to_rid))
        return to_rid

    # -- restart recovery --------------------------------------------------
    @classmethod
    def adopt(
        cls,
        replicas,
        *,
        clock=None,
        policy: Optional[FleetPolicy] = None,
        spool_dir: str,
    ) -> "FleetRouter":
        """Router restart: build a fresh router over the SAME replicas
        and rebuild the routing table from each replica's `stats` verb
        — ownership, scene keys, and open root spans are recovered, so
        no job is lost and every in-flight trace still gets exactly one
        terminal close. (Jobs recovered this way can be polled,
        stepped, cancelled — but not failed over: the submit source
        died with the old router.)"""
        router = cls(
            replicas, clock=clock, policy=policy, spool_dir=spool_dir,
        )
        for rid, r in router.replicas.items():
            if not r.alive:
                continue
            st = r.stats()
            for job_id, p in sorted(st.get("jobs", {}).items()):
                if job_id in router.jobs:
                    continue  # first-seen owner wins (dup = defect)
                from tpu_pbrt_torch.obs.trace import TRACE

                rec = _JobRecord(
                    job_id=job_id, key=p.get("scene", job_id), rid=rid,
                    trace_id=TRACE.trace_id(job_id),
                    checkpoint_path=router._spool_path(job_id),
                    resubmit=None,
                )
                status = p.get("status", "")
                if status in _TERMINAL:
                    rec.terminal = status
                    rec.root_open = False  # closed by the old router
                router.jobs[job_id] = rec
                router._remember(job_id, rid)
        return router

    # -- idleness ----------------------------------------------------------
    def idle(self) -> bool:
        return all(
            rec.terminal or self._paused(rec) for rec in self.jobs.values()
        )

    def _paused(self, rec: _JobRecord) -> bool:
        r = self.replicas.get(rec.rid)
        return (
            r is not None and r.alive
            and r.status(rec.job_id) == PAUSED
        )
