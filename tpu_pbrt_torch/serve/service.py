"""The render service: resumable render jobs multiplexed on one device
or one mesh of ranks (the reference's serve/service.py, over the port's
ChunkPlan).

- A **RenderJob** owns exactly the checkpoint-v4 tuple (film state,
  chunk cursor, ray count, wave-counter snapshot) plus a `ChunkPlan`
  (integrators/common.py): the chunk decomposition and its dispatch.
  Every chunk is a pure function of (scene, work range) and the film
  accumulates chunks in cursor order, so a job can be stopped between
  any two chunk-slices and resumed (in this process or another) with a
  film bit-identical to an uninterrupted render.
- The **scheduler loop** (`step`) dispatches ONE chunk-slice of one job
  at a time: the preemption quantum. A slice either completed (its
  deposits are in the job's own film) or never ran.
- **Preemption** parks a job through the render loop's durable
  checkpoint path (CRC, fsync before rename, `.prev` rotation): the
  tuple is written, the film is dropped (device memory freed for
  higher-priority work), and a later activation reloads it.
- **Residency** (serve/residency.py): compiled scenes stay cached
  across jobs, so a warm resubmit pays zero scene compiles (and zero
  kernel builds: kernels/build.py counts them).
- **Policy** (serve/queue.py): strict priority classes, weighted fair
  sharing across tenants, deterministic given a seed; the recorded
  `schedule` is replayable.
- **Previews**: at a client-requested cadence the live film is
  developed (radiance planes self-normalize by the weight sum, so a
  partial render is a noisier image, not a darker one) and written.

- **Serving over a mesh** (parallel/mesh.py: one process per rank):
  every rank builds a RenderService over the same Mesh, and rank 0 owns
  every decision. The scheduler reads the clock (SLO classes,
  deadlines, backoff, health), so ranks deciding apart would enter
  different collectives: submits, admission and sheds, the WFQ pick,
  preempt/resume/cancel, parks and evictions, the recovery ladder and
  every checkpoint write are rank 0's. Rank 0 broadcasts a small
  decision record (`Mesh.broadcast_object`) before each act the ranks
  share: activate a job (compile its scene if this rank lacks it, build
  its plan over the mesh, load its film from rank 0's checkpoint or
  start a fresh one), dispatch chunk c at attempt a, park, release,
  stop. The other ranks run `follow()`, which applies those records;
  a dispatch is the same `ChunkPlan.dispatch` on every rank, whose
  slices agree on their outcome (`Mesh.agree`) before the film
  all-reduce, so a failure on one rank alone rolls every rank back
  together. Health and metrics are rank 0's.

Device syncs happen where the reference's happen: at the drain
boundaries (park, finalize, the strict firewall's per-chunk count)
through `.tolist()` / `.item()`, and at the in-flight window's retires
through the CUDA event recorded after each slice.

Frontends: the library API here, `python -m tpu_pbrt_torch.serve`
(stdin/JSONL daemon + --selftest, `--mesh N`), and `python -m
tpu_pbrt_torch.main --serve [--mesh N | --multihost]`.
"""

from __future__ import annotations

import itertools
import os
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from tpu_pbrt_torch.config import cfg
from tpu_pbrt_torch.core.film import FilmState
from tpu_pbrt_torch.integrators.common import (
    DEVICE_ERRORS,
    ChunkDispatchError,
    ChunkPlan,
    DispatchWindow,
    NonFiniteRadianceError,
    NonFiniteWaveError,
    RenderResult,
    redispatch_backoff,
)
from tpu_pbrt_torch.parallel.checkpoint import (
    checkpoint_exists,
    delete_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from tpu_pbrt_torch.obs.metrics import METRICS, phase_histogram
from tpu_pbrt_torch.serve.queue import FairScheduler, SloPolicy, preemption_victim
from tpu_pbrt_torch.serve.residency import (
    ResidencyCache,
    scene_source_key,
)
from tpu_pbrt_torch.utils.clock import WALL

# job lifecycle. queued: never dispatched. active: film state in memory.
# parked: progress on disk (policy preemption), schedulable. paused:
# explicitly preempted, needs resume(). done/cancelled/failed: terminal.
QUEUED = "queued"
ACTIVE = "active"
PARKED = "parked"
PAUSED = "paused"
DONE = "done"
CANCELLED = "cancelled"
FAILED = "failed"
_TERMINAL = (DONE, CANCELLED, FAILED)
_RUNNABLE = (QUEUED, ACTIVE, PARKED)

#: each process numbers the mesh services it builds: rank 0's decision
#: records name their service by it, so every rank must build its mesh
#: services in the same order
_MESH_SERVICE_IDS = itertools.count()
#: seconds an idle rank 0 lets pass between decision records (well
#: inside parallel/mesh.py's COLLECTIVE_TIMEOUT_S)
_KEEPALIVE_S = 60.0
#: this process's following services by number (weakly held)
_FOLLOWERS: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


class ShedError(RuntimeError):
    """A submit was load-shed by the SLO admission policy: the priority
    class's queue-depth or queue-wait target
    was already breached, so queuing more work would only deepen the
    breach. The request was NOT queued — the caller should retry later
    or against another service. Deterministic: the same submit burst
    against the same service state sheds the same requests."""

    def __init__(self, msg: str, *, tenant: str, priority: int, reason: str):
        super().__init__(msg)
        self.tenant = tenant
        self.priority = priority
        self.reason = reason


# NOTE on labels: tenant/priority only — never job ids. A long-lived
# daemon processes unbounded jobs, and histogram series are permanent;
# per-job detail belongs to the per-job flight files, not the registry.
def _queue_wait_hist():
    return METRICS.histogram(
        "serve_queue_wait_seconds",
        "seconds a runnable job waited for its next chunk-slice dispatch "
        "(labels: tenant, priority)",
    )


def _slice_hist():
    return METRICS.histogram(
        "serve_slice_seconds",
        "chunk-slice service time: dispatch through bookkeeping "
        "(labels: tenant)",
    )


def _host_sum(values) -> int:
    """Sum of per-slice device counts (tensors or ints) read to the host
    in one transfer: the drain-boundary read."""
    vals = list(values)
    tens = [v.reshape(()).to(torch.int64) for v in vals if isinstance(v, torch.Tensor)]
    total = sum(int(v) for v in vals if not isinstance(v, torch.Tensor))
    if tens:
        total += int(torch.stack(tens).sum().item())
    return total


#: recent queue waits kept per priority class for the wait-SLO signal
_WAIT_WINDOW = 32


def _window_p90(window) -> Optional[float]:
    """Nearest-rank p90 over the bounded recent-wait window — exact and
    deterministic given the recorded waits (no buckets needed at n<=32).
    Nearest-rank: the ceil(0.9*n)-th smallest (1-based), so at n=20 the
    18th sample decides — not the 19th, which would let 2 outliers in a
    window of 20 shed a class whose p90 is actually under target."""
    if not window:
        return None
    import math

    w = sorted(window)
    return w[max(math.ceil(0.9 * len(w)) - 1, 0)]


@dataclass
class RenderJob:
    """One submitted render: identity, policy inputs, and the resumable
    state tuple (exactly what checkpoint v4 persists)."""

    job_id: str
    tenant: str
    priority: int
    seq: int  # submit sequence (FIFO within a tenant; the LRU tiebreak)
    resident_key: str
    chunk: Optional[int]  # slice width override (None = service default)
    checkpoint_path: str
    spool_ckpt: bool  # service-managed checkpoint (delete on terminal)
    checkpoint_every: int
    preview_every: int
    preview_path: str
    outfile: str
    status: str = QUEUED
    plan: Optional[ChunkPlan] = None
    state: Optional[FilmState] = None
    cursor: int = 0
    prev_rays: int = 0
    prev_ctr: Dict[str, Any] = field(default_factory=dict)
    ray_counts: List[Any] = field(default_factory=list)
    occ_counts: List[Any] = field(default_factory=list)
    ctr_counts: List[Any] = field(default_factory=list)
    nf_counts: List[Any] = field(default_factory=list)
    attempt: int = 0
    redispatches: int = 0
    #: redispatches already folded into prev_ctr (by a park/checkpoint
    #: write): snapshot_counters adds only the unbaked delta, or every
    #: park would re-merge the cumulative count (render()'s prior_rec
    #: double-count guard, ported)
    baked_redispatches: int = 0
    #: wall-clock deadline before which this job must not re-dispatch
    #: (the capped-backoff window; other tenants schedule meanwhile)
    not_before: float = 0.0
    #: in-flight dispatch window: per-slice sync handles +
    #: deferred checkpoint writes, created lazily at the first dispatch
    #: and torn down at every park/recover/cancel/finalize boundary
    window: Optional[DispatchWindow] = None
    rollbacks: int = 0
    restarts: int = 0
    preemptions: int = 0
    previews: int = 0
    #: wall clock at which the job last became dispatchable (submit,
    #: slice completion, resume, recovery) — queue wait is measured from
    #: here to the next dispatch, per slice
    ready_t: float = 0.0
    active_seconds: float = 0.0
    error: str = ""
    result: Optional[RenderResult] = None
    #: plan.n_chunks stashed at activation — survives the terminal-path
    #: plan release (a DONE/FAILED job drops its plan, which holds the
    #: scene past eviction, but poll()/progress() still need totals)
    chunks_total: int = 0
    # -- trace context (minted at submit) ----------------------------------
    #: deterministic request trace id ("t:<job_id>") every span, flight
    #: line, and histogram exemplar this job produces carries
    trace_id: str = ""
    #: this service minted the trace id and owns the root span's
    #: begin/end pair. False when a caller (the fleet router) supplied
    #: the trace context: the job's slices/waits still carry the id,
    #: but the root span opens and closes exactly once AT THE CALLER —
    #: a failover re-submit on another replica must not re-open it
    trace_owned: bool = True
    #: queue-wait episodes opened so far (the per-episode async-span id
    #: suffix: "<trace_id>/q<epoch>")
    wait_epoch: int = 0
    #: a queue-wait async span is currently open
    wait_open: bool = False
    #: the job's root async span has been closed (terminal outcome)
    trace_done: bool = False
    #: nonfinite deposits already reported to the registry counter (the
    #: drain-boundary delta guard, like baked_redispatches)
    nf_reported: int = 0

    # -- derived -----------------------------------------------------------
    def progress(self) -> float:
        total = (
            self.plan.n_chunks if self.plan is not None else self.chunks_total
        )
        if total <= 0:
            return 0.0
        return self.cursor / total

    def rays_so_far(self) -> int:
        return self.prev_rays + _host_sum(self.ray_counts)

    def snapshot_counters(self, n_ctr=None, n_nf=None) -> Dict[str, Any]:
        """Cumulative telemetry counter dict — the checkpoint payload.
        The host read inside to_host is this job's drain-boundary
        fetch (park/finalize ARE drain boundaries). n_ctr/n_nf restrict
        the fetch to a list prefix: a deferred (pipelined) cadence
        checkpoint must persist counters for exactly the slices its
        cursor covers, not the ones dispatched ahead of it."""
        from tpu_pbrt_torch.obs import counters as obs_counters

        snap = obs_counters.merge_host(
            self.prev_ctr, obs_counters.to_host(self.ctr_counts[:n_ctr])
        )
        nf = self.nf_counts[:n_nf]
        if nf:
            snap = obs_counters.merge_host(
                snap,
                {
                    "nonfinite_deposits": _host_sum(nf)
                },
            )
        unbaked = self.redispatches - self.baked_redispatches
        if unbaked > 0:
            snap = obs_counters.merge_host(
                snap, {"chunks_redispatched": unbaked}
            )
        return snap


class RenderService:
    """Multi-tenant render service over one device or one mesh of ranks.

    Cooperative scheduler: `step()` dispatches exactly one chunk-slice
    of the policy-selected job; `drain()` steps until every schedulable
    job reaches a terminal state. All submits share the device —
    concurrency is wave-granular interleaving, not parallel processes
    (continuous batching on one resident model).

    `device`: CUDA unless the caller names the CPU (config.
    resolve_device); a scene the service compiles goes there. `mesh`: a
    parallel.mesh.Mesh of two or more ranks serves over them (the
    module doc): every rank builds its service over the same Mesh, rank
    0 drives it (submit, step, ...) and ends with `close()`, the others
    call `follow()`; `lead_or_follow(fn)` does both. The device is the
    mesh's.

    `max_active` bounds how many jobs may hold a live film at once; a
    higher-priority submit preempts the lowest outranked active job
    through the emergency-checkpoint path when the bound is hit.
    """

    def __init__(
        self,
        mesh=None,
        *,
        device=None,
        chunk: Optional[int] = None,
        max_resident_bytes: Optional[int] = None,
        max_active: Optional[int] = None,
        seed: int = 0,
        spool_dir: Optional[str] = None,
        quiet: bool = True,
        slo: Optional[SloPolicy] = None,
        clock=None,
    ):
        from tpu_pbrt_torch.config import resolve_device

        self.mesh = mesh
        self._sid = None
        if mesh is not None:
            from tpu_pbrt_torch.parallel.mesh import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError(
                    f"mesh must be a parallel.mesh.Mesh, not {type(mesh).__name__}"
                )
            if device is not None and resolve_device(device) != torch.device(mesh.device):
                raise ValueError(
                    f"rank {mesh.rank} of the mesh renders on {mesh.device}, "
                    f"not on {device}"
                )
            device = mesh.device
            if mesh.size > 1:
                self._sid = next(_MESH_SERVICE_IDS)
                if mesh.rank:
                    _FOLLOWERS[self._sid] = self
                    #: the scenes this rank compiled from rank 0's
                    #: sources (dropped when rank 0 evicts them), and the
                    #: pairs the caller handed follow()
                    self._f_scenes: Dict[str, Any] = {}
                    self._f_given: Dict[str, Any] = {}
                    #: job -> (plan, film) on this rank, or the error
                    #: that kept it from building them
                    self._f_jobs: Dict[str, Any] = {}
        self.device = resolve_device(device)
        #: rank 0 of a mesh: broadcasts its decision records
        self._leads = self._sid is not None and mesh.rank == 0
        self._last_lead = time.monotonic()
        #: how each resident key's scene is built: a follower compiles
        #: the same source (None: a precompiled pair, which the
        #: followers are handed by follow(compiled=...))
        self._sources: Dict[str, Any] = {}
        #: the collectives' wall seconds by kind (Mesh.take_log), summed
        #: over this service's steps on rank 0
        self._mesh_log: Dict[str, List[float]] = {}
        # the protocol's only time source (utils/clock.py): every
        # scheduling decision, backoff deadline and wait measurement
        # samples THIS object, so a VirtualClock makes a whole service
        # run a pure function of the decision sequence. Default WALL.
        self.clock = clock if clock is not None else WALL
        if chunk is None:
            chunk = cfg.serve_chunk
        self.chunk = chunk
        if max_resident_bytes is None and cfg.serve_resident_mb is not None:
            max_resident_bytes = int(cfg.serve_resident_mb * 1e6)
        self.residency = ResidencyCache(
            max_bytes=max_resident_bytes, clock=self.clock
        )
        self.scheduler = FairScheduler(seed=seed)
        self.max_active = max_active
        self.quiet = quiet
        if spool_dir is None:
            import tempfile

            spool_dir = tempfile.mkdtemp(prefix="tpu_pbrt_serve_")
        self.spool_dir = spool_dir
        self.jobs: Dict[str, RenderJob] = {}
        self._seq = 0
        # strict non-finite firewall modes read the scrub COUNT, which
        # rides the telemetry counters: refuse the combination here like
        # render() does, instead of silently degrading every job to
        # scrub mode (the exact contamination raise/retry exist to stop)
        from tpu_pbrt_torch.obs import counters as obs_counters

        if cfg.nonfinite != "scrub" and not obs_counters.enabled():
            raise ValueError(
                f"TORCH_PBRT_NONFINITE={cfg.nonfinite} needs the telemetry "
                "counters (the firewall's scrub count), but "
                "TORCH_PBRT_TELEMETRY=0 disabled them; re-enable telemetry "
                "or use the default scrub mode"
            )
        # SLO admission control: per-class depth/wait targets
        # from TORCH_PBRT_SERVE_SLO_* (or injected). The wait signal is a
        # BOUNDED in-service window of recent per-class queue waits —
        # not the registry's lifetime-cumulative histogram, whose p90
        # can never recover once elevated (shed submits produce no new
        # samples: a permanent lockout); the registry histogram remains
        # the exported observability surface. Works with
        # TORCH_PBRT_METRICS=0 too (the window is service state).
        self.slo = slo if slo is not None else SloPolicy.from_cfg()
        self._recent_waits: Dict[int, Any] = {}
        #: submits answered with a shed (the deterministic count the
        #: selftest pins; the labeled breakdown lives in the registry)
        self.sheds = 0
        #: drain handoff (fleet router): a draining service sheds every
        #: new submit and parks its runnable jobs so the durable spool
        #: can be re-routed to another replica (begin_drain())
        self.draining = False
        #: the dispatch record [(job_id, chunk_index), ...] — the
        #: deterministic-interleaving evidence tests assert on
        self.schedule: List[tuple] = []
        # health-watchdog inputs (obs/health.py): step() calls made, and
        # the step at which a chunk cursor last advanced — their gap is
        # the wedge signal (runnable work, no progress)
        self.health_steps = 0
        self.last_progress_step = 0

    def _now(self) -> float:
        """One DECISION sample of the injected clock. Contract:
        a function that reasons about runnability or backoff deadlines
        calls this at most once and threads the value through."""
        return self.clock.now()

    # -- submit ------------------------------------------------------------
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
        checkpoint_path: str = "",
        checkpoint_every: int = 0,
        preview_every: int = 0,
        preview_path: str = "",
        outfile: str = "",
        trace_id: Optional[str] = None,
    ) -> str:
        """Submit a render: a .pbrt file `path`, inline scene `text`, or
        a precompiled (scene, integrator) pair. Returns the job id.
        Scene compilation happens HERE (once per resident key — a warm
        key is a cache hit); no rendering happens until `step`.

        `trace_id` is the caller-supplied trace context (the fleet
        router's hop): when set, the job's spans carry that id but the
        ROOT async span is owned by the caller — this service neither
        opens nor closes it, so a failover re-submit on another replica
        continues the same request timeline without a duplicate root.

        Raises ShedError WITHOUT compiling or queuing anything when the
        SLO admission policy says the request's priority class is
        already over its queue-depth or queue-wait target — shedding
        after the compile would spend the exact resources shedding
        exists to protect. A draining service (begin_drain()) sheds
        every submit the same way: nothing is compiled or queued."""
        from tpu_pbrt_torch.obs.trace import TRACE

        if self.draining:
            self._shed(tenant, int(priority),
                       "draining: service is handing off its spool")
        if self.slo.enabled():
            self._admit_or_shed(tenant, int(priority))
        if options is None:
            from tpu_pbrt_torch.scene.api import Options

            options = Options(quiet=self.quiet)
        opt_extra = (
            getattr(options, "crop_window", None),
            getattr(options, "quick_render", False),
            getattr(options, "image_file", ""),
        )
        self._not_a_follower("submit")
        source = None
        if compiled is not None:
            scene_obj = compiled[0]
            key = resident_key or f"obj:{id(scene_obj):x}"
            builder = lambda: compiled  # noqa: E731
        elif path is not None:
            key = resident_key or scene_source_key(path=path, extra=opt_extra)
            source = ("path", path, options)

            def builder():
                from tpu_pbrt_torch.scene.api import compile_file

                return compile_file(path, options, device=self.device)

        elif text is not None:
            key = resident_key or scene_source_key(text=text, extra=opt_extra)
            source = ("text", text, options)

            def builder():
                from tpu_pbrt_torch.scene.api import compile_string

                return compile_string(text, options, device=self.device)

        else:
            raise ValueError("submit needs a path, text, or compiled pair")

        with TRACE.span("serve/submit", key=key):
            ent = self.residency.get_or_compile(key, builder)
        if self._leads and key not in self._sources:
            self._sources[key] = source
        from tpu_pbrt_torch.integrators.common import WavefrontIntegrator

        if type(ent.integrator).render is not WavefrontIntegrator.render:
            # SPPM/MLT own their render loops (camera/photon passes,
            # bootstrap chains) — they have no chunk-plan seam, so a
            # sliced submit would call a li() that does not exist. Refuse
            # at submit time with a clear error instead of failing the
            # first dispatch.
            name = getattr(ent.integrator, "name", type(ent.integrator).__name__)
            raise ValueError(
                f"integrator {name!r} overrides the chunked render loop "
                "and cannot be served slice-wise; render it with the "
                "batch CLI"
            )
        self.residency.pin(key)

        self._seq += 1
        if job_id is None:
            job_id = f"j{self._seq}"
        if job_id in self.jobs:
            self.residency.unpin(key)
            raise ValueError(f"job id {job_id!r} already exists")
        spool_ckpt = not checkpoint_path
        if spool_ckpt:
            checkpoint_path = os.path.join(
                self.spool_dir, f"{job_id}.ckpt.npz"
            )
        job = RenderJob(
            job_id=job_id, tenant=tenant, priority=int(priority),
            seq=self._seq, resident_key=key,
            chunk=chunk if chunk is not None else self.chunk,
            checkpoint_path=checkpoint_path, spool_ckpt=spool_ckpt,
            checkpoint_every=int(checkpoint_every),
            preview_every=int(preview_every), preview_path=preview_path,
            outfile=outfile,
        )
        if weight is not None:
            self.scheduler.set_weight(tenant, weight)
        # start-time fairness: a tenant returning from idle re-enters at
        # the busy tenants' vtime floor instead of spending banked credit
        self.scheduler.reenter(
            tenant,
            busy_tenants={
                j.tenant for j in self.jobs.values()
                if j.status in _RUNNABLE
            },
        )
        job.ready_t = self._now()
        self.jobs[job_id] = job
        # the job's trace context. With no caller-supplied
        # id the root async span opens here and closes at the terminal
        # outcome; a router-minted id means the root pair lives at the
        # router and every span here just carries the id in its args
        job.trace_owned = trace_id is None
        job.trace_id = trace_id if trace_id else TRACE.trace_id(job_id)
        if job.trace_owned:
            TRACE.async_begin(
                "serve/job", id=job.trace_id, cat="job", job=job_id,
                tenant=tenant, priority=job.priority,
                trace_id=job.trace_id,
            )
        self._trace_ready(job)
        METRICS.counter(
            "serve_submits_total", "jobs admitted by submit"
        ).inc(tenant=tenant)
        self._update_depth_gauge()
        self._flight(job, "serve_submit", key=key, tenant=tenant,
                     priority=job.priority)
        return job_id

    def _admit_or_shed(self, tenant: str, priority: int) -> None:
        """The SLO admission decision — a pure function of the current
        job table (class queue depth) and the registry's observed
        queue-wait p90 for the class. Breach -> counted + flight-logged
        ShedError; the request never touches the compiler or the
        queue."""
        depth = sum(
            1 for j in self.jobs.values()
            if j.status in _RUNNABLE and j.priority == priority
        )
        # the wait signal is consulted only while the class actually has
        # queued work: with an empty queue the recorded waits are stale
        # congestion, and admitting is what produces the fresh samples
        # that let the signal recover (no-lockout property, pinned by
        # tests/test_serve.py)
        wait_p90 = None
        if depth > 0 and self.slo.wait_target(priority) is not None:
            wait_p90 = _window_p90(self._recent_waits.get(priority))
        ok, reason = self.slo.admit(priority, depth, wait_p90)
        if ok:
            return
        self._shed(tenant, priority, reason)

    def _shed(self, tenant: str, priority: int, reason: str) -> None:
        """Count + flight-log + raise one shed answer (SLO admission
        breaches and the drain handoff share the same refusal path)."""
        self.sheds += 1
        METRICS.counter(
            "serve_shed_total",
            "submits answered with a shed by SLO admission control",
        ).inc(tenant=tenant, priority=priority)
        from tpu_pbrt_torch.obs.flight import FLIGHT
        from tpu_pbrt_torch.obs.trace import TRACE

        # a shed request never gets a job id, but its refusal is part of
        # the service timeline: a zero-length pseudo-trace records who
        # was turned away and why
        shed_tid = TRACE.trace_id(f"shed{self.sheds}")
        TRACE.async_begin(
            "serve/job", id=shed_tid, cat="job", outcome="shed",
            tenant=tenant, priority=priority, reason=reason,
            trace_id=shed_tid,
        )
        TRACE.async_end("serve/job", id=shed_tid, cat="job", outcome="shed")
        FLIGHT.heartbeat(
            "serve_shed", tenant=tenant, priority=priority, reason=reason,
            trace_id=shed_tid,
        )
        raise ShedError(
            f"submit shed: {reason}", tenant=tenant, priority=priority,
            reason=reason,
        )

    def _update_depth_gauge(self) -> None:
        """Per-priority-class runnable-job depth — the gauge a monitor
        alarms on before the shed counter starts climbing."""
        if not METRICS.enabled:
            return
        g = METRICS.gauge(
            "serve_queue_depth",
            "runnable jobs per priority class (labels: priority)",
        )
        depths: Dict[int, int] = {}
        for j in self.jobs.values():
            if j.status in _RUNNABLE:
                depths[j.priority] = depths.get(j.priority, 0) + 1
        seen = {ls.get("priority") for ls in g.labelsets()}
        for prio, n in depths.items():
            g.set(n, priority=prio)
        for prio in seen - {str(p) for p in depths}:
            if prio is not None:
                g.set(0, priority=prio)

    # -- the scheduler step -------------------------------------------------
    def _runnable(self, now: Optional[float] = None) -> List[RenderJob]:
        """Runnable jobs as of `now`. Callers that also reason about
        backoff windows (step's min-not_before wait) MUST pass the same
        `now` they use there: sampling the clock twice lets a job fall
        between the samples — excluded from the runnable set yet also
        past its not_before — and step() would return None with work
        still pending (nondeterministic under test clocks)."""
        active = [j for j in self.jobs.values() if j.state is not None]
        out = []
        if now is None:
            now = self._now()
        for j in self.jobs.values():
            if j.status not in _RUNNABLE:
                continue
            if j.not_before > now:
                continue  # inside its re-dispatch backoff window
            if j.state is None and self.max_active is not None and len(
                active
            ) >= self.max_active:
                # activating this job needs a film-state slot: runnable
                # only if it outranks someone it could preempt
                if preemption_victim(active, j) is None:
                    continue
            out.append(j)
        return out

    def step(self) -> Optional[str]:
        """Dispatch ONE chunk-slice of the policy-selected job. Returns
        that job's id, or None when nothing is schedulable (all jobs
        terminal, paused, or blocked on residency)."""
        # `now` is sampled ONCE per step: the runnable filter and the
        # backoff-wait computation below must see the SAME clock, or a
        # job whose not_before falls between two samples is excluded
        # from both — step() would answer None with work still pending
        self._not_a_follower("step")
        self.health_steps += 1
        now = self._now()
        job = self.scheduler.pick(self._runnable(now))
        if job is None:
            job = self._await_backoff(now)
            if job is None:
                return None
        out = self._step_job(job)
        if self._leads:
            for kind, secs in self.mesh.take_log().items():
                self._mesh_log.setdefault(kind, []).extend(secs)
        return out

    def _await_backoff(self, now: float) -> Optional[RenderJob]:
        """Nothing was dispatchable at `now` — but a job whose backoff
        window is still open is WORK, not idleness: wait out the
        earliest deadline so drain() doesn't return with jobs
        unfinished. `now` is step's single decision sample; the one
        fresh sample after the sleep is this function's own (one per
        deadline-reasoning scope)."""
        waiting = [
            j.not_before for j in self.jobs.values()
            if j.status in _RUNNABLE and j.not_before > now
        ]
        if not waiting:
            return None
        self.clock.sleep(max(min(waiting) - now, 0.0))
        return self.scheduler.pick(self._runnable(self._now()))

    def _release_device(self, job: RenderJob) -> None:
        """Drop EVERY device reference a job holds: the film, the
        in-flight window's slice handles, and the per-slice counter
        tensors. The one release point the terminal paths (cancel, fail,
        give-up, finalize) all call. Leaves `plan` to the caller: a
        parked job keeps its plan for resume; a terminal one must also
        drop it (the plan holds the scene past LRU eviction)."""
        if job.window is not None:
            job.window.flush(discard=True)  # closes in-flight spans
            job.window = None
        job.state = None
        self._lead("release", job=job.job_id)
        job.ray_counts.clear()
        job.occ_counts.clear()
        job.ctr_counts.clear()
        job.nf_counts.clear()

    def _step_job(self, job: RenderJob) -> str:
        """Run the selected job's slice: activation, dispatch with the
        recovery ladder, prefetch overlap, and the job-level failure
        firewall. Split from step() so the selection logic above stays
        a pure clock/deadline function while this body owns the side
        effects."""
        try:
            self._activate(job)
            self._dispatch_slice(job)
            if cfg.serve_prefetch:
                # dispatch lookahead: the slice just launched is in
                # flight — use its device time to pre-activate the
                # NEXT scheduled job (plan build + checkpoint film load
                # to the device + residency LRU touch) so the following
                # step's dispatch is not serialized behind activation
                self._prefetch_next(job)
        except Exception as e:  # noqa: BLE001
            # an unexpected error (trace failure, OOM, corrupt resume)
            # fails THE JOB, not the service — other tenants keep
            # rendering. The dispatch-level recovery ladder inside
            # _dispatch_slice already handled the expected failures.
            if job.status not in _TERMINAL:
                job.status = FAILED
                job.error = job.error or f"{type(e).__name__}: {e}"
            self._release_device(job)
            job.plan = None
            self.residency.unpin(job.resident_key)
            self._update_depth_gauge()
            self._trace_job_end(job, "failed")
            self._flight(job, "serve_failed", error=str(job.error)[:200])
        return job.job_id

    def _prefetch_next(self, current: RenderJob) -> None:
        """Pre-activate the job the policy would schedule next, under
        the device compute of `current`'s in-flight slice: build its
        ChunkPlan (the residency lookup inside _activate also touches
        the scene's LRU slot) and load its film state onto the device
        from its checkpoint. Pure overlap: it only runs when a film-state
        slot is free (a prefetch must never preempt), and it never
        perturbs the schedule — the peek is re-made, unchanged, by the
        next step. Self-contained error handling: a broken prefetch
        fails THAT job, never the one that just dispatched."""
        cand = [
            j for j in self._runnable()
            if j is not current and j.state is None
        ]
        nxt = self.scheduler.peek(cand)
        if nxt is None:
            return
        if self.max_active is not None:
            active = [j for j in self.jobs.values() if j.state is not None]
            if len(active) >= self.max_active:
                return
        from tpu_pbrt_torch.obs.trace import TRACE

        try:
            with TRACE.span(
                "serve/prefetch", job=nxt.job_id, trace_id=nxt.trace_id,
            ):
                self._activate(nxt)
            METRICS.counter(
                "serve_prefetches_total",
                "next-job activations overlapped under in-flight dispatch",
            ).inc(tenant=nxt.tenant)
            self._flight(nxt, "serve_prefetch", chunk=nxt.cursor)
        except Exception as e:  # noqa: BLE001 — a broken prefetch fails
            # the prefetched job exactly like its own step() would have
            if nxt.status not in _TERMINAL:
                nxt.status = FAILED
                nxt.error = f"{type(e).__name__}: {e}"
            self._release_device(nxt)
            nxt.plan = None
            self.residency.unpin(nxt.resident_key)
            self._update_depth_gauge()
            self._trace_job_end(nxt, "failed")
            self._flight(nxt, "serve_failed", error=str(nxt.error)[:200])

    def drain(self, max_steps: int = 1_000_000) -> None:
        """Step until no job is schedulable (paused jobs stay parked)."""
        for _ in range(max_steps):
            if self.step() is None:
                return
        raise RuntimeError("drain exceeded max_steps — scheduler wedged?")

    def idle(self) -> bool:
        return all(
            j.status in _TERMINAL or j.status == PAUSED
            for j in self.jobs.values()
        )

    # -- lifecycle verbs -----------------------------------------------------
    def preempt(self, job_id: str) -> None:
        """Explicit wave-granular preemption: emergency-checkpoint the
        job's tuple (the durable checkpoint write), free its film state,
        and PARK it until resume(). A job between slices loses nothing
        — the checkpoint is the exact (state, cursor, rays, counters)
        the next activation reloads."""
        from tpu_pbrt_torch.obs.trace import TRACE

        job = self._job(job_id)
        if job.status in _TERMINAL:
            raise ValueError(f"job {job_id} is {job.status}")
        if job.state is not None:
            self._park(job)
        job.status = PAUSED
        # a paused job is not waiting for the scheduler: close the open
        # queue-wait episode (resume opens a fresh one)
        self._trace_wait_end(job)
        TRACE.instant(
            "serve/preempt", job=job.job_id, chunk=job.cursor,
            trace_id=job.trace_id,
        )
        self._update_depth_gauge()  # PAUSED is not runnable
        self._flight(job, "serve_preempt", chunk=job.cursor)

    def resume(self, job_id: str) -> None:
        job = self._job(job_id)
        if job.status != PAUSED:
            raise ValueError(f"job {job_id} is {job.status}, not paused")
        job.status = PARKED if job.cursor else QUEUED
        job.ready_t = self._now()
        self._trace_ready(job)
        METRICS.counter(
            "serve_resumes_total", "paused jobs resumed"
        ).inc(tenant=job.tenant)
        self._update_depth_gauge()
        self._flight(job, "serve_resume", chunk=job.cursor)

    def begin_drain(self) -> Dict[str, Any]:
        """Quiesce for handoff (the daemon's `drain` verb and the fleet
        router's graceful-failover primitive): stop admitting — every
        later submit is answered with a deterministic shed — and park
        every runnable job through the emergency-checkpoint path, so
        each one's durable spool entry holds the exact resumable tuple
        another replica can adopt. Returns the spool manifest:
        quiescent means every job is terminal or parked with its
        checkpoint state reported (the "spool quiescent" signal the
        verb's caller polls for). Idempotent."""
        self.draining = True
        parked: List[str] = []
        for j in list(self.jobs.values()):
            if j.status in _RUNNABLE:
                self.preempt(j.job_id)
                parked.append(j.job_id)
        spool: Dict[str, Any] = {}
        for j in self.jobs.values():
            if j.status == PAUSED:
                spool[j.job_id] = {
                    "checkpoint": j.checkpoint_path,
                    "cursor": j.cursor,
                    "durable": checkpoint_exists(j.checkpoint_path),
                }
        return {
            "draining": True,
            "quiescent": self.idle(),
            "parked": parked,
            "spool": spool,
        }

    def cancel(self, job_id: str) -> None:
        """Terminal cancel: frees the film state, releases the residency
        pin (an unpinned scene is evictable), and removes the
        service-managed checkpoint spool."""
        job = self._job(job_id)
        if job.status in _TERMINAL:
            return
        job.status = CANCELLED
        self._release_device(job)
        job.plan = None
        self.residency.unpin(job.resident_key)
        self.residency.evict_over_budget()
        if job.spool_ckpt:
            delete_checkpoint(job.checkpoint_path)
        self._update_depth_gauge()
        self._trace_job_end(job, "cancelled")
        self._flight(job, "serve_cancel", chunk=job.cursor)

    def poll(self, job_id: str) -> Dict[str, Any]:
        job = self._job(job_id)
        out = {
            "job": job.job_id,
            "status": job.status,
            "tenant": job.tenant,
            "priority": job.priority,
            "progress": round(job.progress(), 6),
            "chunks_done": job.cursor,
            "chunks_total": (
                job.plan.n_chunks if job.plan
                else (job.chunks_total or None)
            ),
            "scene": job.resident_key,
            "preemptions": job.preemptions,
            "redispatches": job.redispatches,
            "previews": job.previews,
        }
        if job.error:
            out["error"] = job.error
        return out

    def result(self, job_id: str) -> RenderResult:
        job = self._job(job_id)
        if job.status != DONE or job.result is None:
            raise ValueError(
                f"job {job_id} has no result (status {job.status}"
                + (f": {job.error}" if job.error else "") + ")"
            )
        return job.result

    def preview(self, job_id: str) -> np.ndarray:
        """Develop the job's LIVE film state to an image right now (the
        streaming-preview primitive; the cadence path calls this too)."""
        job = self._job(job_id)
        if job.result is not None:
            return job.result.image
        plan, state = job.plan, job.state
        if plan is None or state is None:
            raise ValueError(f"job {job_id} has no live film state")
        frac = max(job.progress(), 1e-9)
        return plan.film.develop(state, splat_scale=1.0 / (plan.spp * frac))

    def stats(self) -> Dict[str, Any]:
        out = {
            "jobs": {j.job_id: self.poll(j.job_id) for j in self.jobs.values()},
            "residency": self.residency.stats(),
            "tenants": self.scheduler.stats(),
            "schedule_len": len(self.schedule),
            "sheds": self.sheds,
        }
        if self._leads:
            out["mesh"] = self.mesh_stats()
        return out

    def mesh_stats(self) -> Dict[str, Any]:
        """Rank 0's view of serving over the mesh: the layout, the
        decision records broadcast and their wall ms, and per dispatched
        slice the wait for the slowest rank (the agreement) and the film
        all-reduce, host staging included."""
        m = self.mesh
        log = self._mesh_log

        def ms(kind):
            v = log.get(kind, [])
            return {"n": len(v), "mean_ms": round(1e3 * sum(v) / len(v), 4) if v else None,
                    "total_ms": round(1e3 * sum(v), 4)}

        return {
            "ranks": m.size, "rank": m.rank, "backend": m.backend,
            "layout": m.layout, "slices": len(self.schedule),
            "decision": ms("decision"), "wait": ms("wait"),
            "all_reduce": ms("all_reduce"),
        }

    # -- serving over a mesh --------------------------------------------------
    def _lead(self, op: str, **fields) -> None:
        """Rank 0: broadcast one decision record to the following ranks
        (nothing on one device or on a follower)."""
        if not self._leads:
            return
        self.mesh.broadcast_object({"op": op, "sid": self._sid, **fields})
        self._last_lead = time.monotonic()

    def _not_a_follower(self, verb: str) -> None:
        if self._sid is not None and not self._leads:
            raise RuntimeError(
                f"rank {self.mesh.rank} of the mesh follows rank 0's decisions: "
                f"{verb} on rank 0, follow() here"
            )

    def keepalive(self) -> None:
        """Rank 0, idle: a no-op record once _KEEPALIVE_S has passed
        since the last one, so the followers' wait in the broadcast never
        reaches the group's collective timeout (the daemon calls this
        while it waits for input)."""
        if self._leads and time.monotonic() - self._last_lead > _KEEPALIVE_S:
            self._lead("noop")

    def close(self) -> None:
        """Rank 0: release the following ranks from follow()."""
        self._lead("stop")

    def lead_or_follow(self, lead: Callable[["RenderService"], Any], compiled=None):
        """The whole serving program of one rank: rank 0 (or a lone
        device) runs `lead(self)` and then releases the followers, even
        when `lead` raises; every other rank follows until then and
        returns None. `compiled` is follow()'s."""
        if self._sid is not None and not self._leads:
            self.follow(compiled)
            return None
        try:
            return lead(self)
        finally:
            self.close()

    def follow(self, compiled: Optional[Dict[str, Any]] = None) -> int:
        """A rank other than 0: apply rank 0's decision records until its
        `close()`. `compiled` maps resident keys to the (scene,
        integrator) pairs this rank compiled itself (rank 0 submitted
        its own pairs under the same keys); any other scene is compiled
        here from the source rank 0 built it from. Returns the records
        applied. The records of every mesh service this process built
        arrive here, each applied by the service it names."""
        if self._sid is None or self._leads:
            raise RuntimeError("follow() runs on the ranks other than 0 of a mesh")
        for svc in list(_FOLLOWERS.values()):
            svc._f_given.update(compiled or {})
        n = 0
        while True:
            rec = self.mesh.broadcast_object(None)
            if rec["op"] == "stop":
                return n
            n += 1
            svc = _FOLLOWERS.get(rec["sid"])
            if svc is None:
                raise RuntimeError(
                    f"rank {self.mesh.rank}: a decision record names mesh service "
                    f"{rec['sid']}, which this rank did not build"
                )
            svc._apply(rec)

    def _apply(self, rec: Dict[str, Any]) -> None:
        """One of rank 0's decision records, on a following rank. Only a
        dispatch enters a collective; a record this rank cannot carry
        out leaves the job without a film here, and its next dispatch
        then fails on every rank (a rank that fails is never skipped)."""
        op, job = rec["op"], rec.get("job")
        if op == "activate":
            self._f_jobs.pop(job, None)
            for key in list(self._f_scenes):
                if key not in rec["keys"] and key != rec["key"]:
                    del self._f_scenes[key]  # evicted on rank 0
            try:
                pair = self._f_given.get(rec["key"]) or self._f_scenes.get(rec["key"])
                if pair is None:
                    pair = self._f_scenes[rec["key"]] = self._follow_compile(rec)
                scene, integ = pair
                plan = integ.prepare_chunks(scene, self.mesh, chunk=rec["chunk"])
                if rec["ckpt"]:
                    state = load_checkpoint(rec["ckpt"], plan.fingerprint,
                                            device=scene.device)[0]
                else:
                    state = plan.film.init_state(scene.device)
                self._f_jobs[job] = (plan, state)
            except Exception as e:  # noqa: BLE001 - fails the job's next dispatch
                self._f_jobs[job] = e
        elif op == "dispatch":
            self._follow_dispatch(job, rec["chunk"], rec["attempt"])
        elif op in ("park", "release"):
            self._f_jobs.pop(job, None)

    def _follow_compile(self, rec):
        source = rec["source"]
        if source is None:
            raise RuntimeError(
                f"rank {self.mesh.rank} holds no compiled scene for {rec['key']!r} "
                "(pass it to follow(compiled=...))"
            )
        kind, what, options = source
        from tpu_pbrt_torch.scene.api import compile_file, compile_string

        build = compile_file if kind == "path" else compile_string
        return build(what, options, device=self.device)

    def _follow_dispatch(self, job: str, c: int, attempt: int) -> None:
        from tpu_pbrt_torch.chaos import CHAOS
        from tpu_pbrt_torch.parallel.mesh import join_failure

        held = self._f_jobs.get(job)
        try:
            CHAOS.dispatch(c, attempt, mesh=True)
            if not isinstance(held, tuple):
                raise RuntimeError(
                    f"rank {self.mesh.rank} holds no film for job {job}: {held}"
                )
        except Exception as e:  # noqa: BLE001 - agreed with the ranks in the step
            join_failure(self.mesh, e)
            return
        plan, state = held
        try:
            plan.dispatch(state, c)
        except Exception:  # noqa: BLE001 - agreed on every rank: rank 0 decides
            # the film was not merged (the merge follows the agreement);
            # rank 0 re-activates the job when the failure poisoned it
            pass

    def metrics_exposition(self) -> str:
        """The registry's Prometheus text page — what the daemon's
        `metrics` verb and `--metrics-path` snapshots serve. Empty when
        TORCH_PBRT_METRICS=0 (the kill switch leaves responses with
        nothing to report, not stale data)."""
        return METRICS.exposition() if METRICS.enabled else ""

    # -- internals -----------------------------------------------------------
    def _job(self, job_id: str) -> RenderJob:
        job = self.jobs.get(job_id)
        if job is None:
            raise KeyError(f"unknown job {job_id!r}")
        return job

    def _flight(self, job: RenderJob, phase: str, **fields) -> None:
        """Heartbeat into the job's PER-JOB flight file (the recorder's
        first-class `job_heartbeat` seam — concurrent jobs never
        interleave into one stream, and the per-job file sits behind the
        same TORCH_PBRT_FLIGHT_MAX_MB rotation cap as the main one). Every
        line carries the job's trace id: the join key from a flight
        post-mortem back into the trace timeline."""
        from tpu_pbrt_torch.obs.flight import FLIGHT

        FLIGHT.job_heartbeat(
            job.job_id, phase, job=job.job_id, trace_id=job.trace_id,
            **fields,
        )

    # -- span threading -----------------------------------------------------
    def _trace_ready(self, job: RenderJob) -> None:
        """Open a queue-wait async span: the job just became
        dispatchable (submit, slice completion, resume, recovery) and
        waits for the scheduler to pick it again. One span per episode,
        id "<trace_id>/q<epoch>" — closed by the next dispatch."""
        from tpu_pbrt_torch.obs.trace import TRACE

        if job.trace_done or job.wait_open or not job.trace_id:
            return
        job.wait_epoch += 1
        job.wait_open = True
        TRACE.async_begin(
            "serve/queue_wait", id=f"{job.trace_id}/q{job.wait_epoch}",
            cat="queue", job=job.job_id, chunk=job.cursor,
            trace_id=job.trace_id,
        )

    def _trace_wait_end(self, job: RenderJob, wait=None) -> None:
        from tpu_pbrt_torch.obs.trace import TRACE

        if not job.wait_open:
            return
        job.wait_open = False
        kw = {} if wait is None else {"wait_s": round(wait, 6)}
        TRACE.async_end(
            "serve/queue_wait", id=f"{job.trace_id}/q{job.wait_epoch}",
            cat="queue", **kw,
        )

    def _trace_job_end(self, job: RenderJob, outcome: str) -> None:
        """Close the job's root async span with its terminal outcome
        (done/failed/cancelled) — idempotent, and closes any queue-wait
        episode still open so the trace's pairing invariant holds on
        every terminal path."""
        from tpu_pbrt_torch.obs.trace import TRACE

        if job.trace_done or not job.trace_id:
            return
        job.trace_done = True
        self._trace_wait_end(job)
        if not job.trace_owned:
            # router-supplied context: the caller owns the root pair —
            # it closes the span once the JOB (not this instance of it)
            # reaches its fleet-wide terminal outcome
            return
        TRACE.async_end(
            "serve/job", id=job.trace_id, cat="job", outcome=outcome,
            chunks=job.cursor,
        )

    def _report_nonfinite(self, job: RenderJob, snap: Dict[str, Any]) -> None:
        """Fold the job's firewall scrub count into the registry at its
        drain boundaries (park/finalize — the places the device count is
        already fetched), as a DELTA so repeated parks never
        double-count. The watchdog's nonfinite-spike condition reads
        this counter."""
        total = int(snap.get("nonfinite_deposits", 0) or 0)
        delta = total - job.nf_reported
        if delta > 0:
            METRICS.counter(
                "render_nonfinite_total",
                "non-finite radiance deposits scrubbed by the firewall",
            ).inc(delta, tenant=job.tenant)
            job.nf_reported = total

    def _activate(self, job: RenderJob) -> None:
        """Make the job dispatchable: build (or re-use) its ChunkPlan,
        then load its film state — fresh, or from its checkpoint when a
        preemption parked it. Evicts/preempts per policy first."""
        if job.state is not None:
            job.status = ACTIVE
            return
        if self.max_active is not None:
            active = [j for j in self.jobs.values() if j.state is not None]
            while len(active) >= self.max_active:
                victim = preemption_victim(active, job)
                if victim is None:
                    break
                self._park(victim)
                victim.status = PARKED
                active = [
                    j for j in self.jobs.values() if j.state is not None
                ]
        ent = self.residency.get(job.resident_key)
        if ent is None:  # evicted while queued (unpinned by a bug) —
            raise RuntimeError(
                f"resident scene for job {job.job_id} was evicted while "
                "the job still held a pin"
            )
        resume = checkpoint_exists(job.checkpoint_path)
        # the ranks build the same plan and load the same film: rank 0's
        # checkpoint writes have all landed before this record leaves
        self._lead(
            "activate", job=job.job_id, key=job.resident_key,
            chunk=job.chunk, ckpt=job.checkpoint_path if resume else None,
            source=self._sources.get(job.resident_key),
            keys=sorted(self.residency.pin_counts()),
        )
        if job.plan is None:
            job.plan = ent.integrator.prepare_chunks(
                ent.scene, self.mesh, chunk=job.chunk
            )
            ent.fingerprints.add(job.plan.fingerprint)
            job.plan.capacity_audit()
        job.chunks_total = job.plan.n_chunks
        if resume:
            state, cursor, rays, ctr = load_checkpoint(
                job.checkpoint_path, job.plan.fingerprint,
                device=ent.scene.device,
            )
            job.state, job.cursor, job.prev_rays, job.prev_ctr = (
                state, cursor, rays, ctr
            )
            job.ray_counts.clear()
            job.occ_counts.clear()
            job.ctr_counts.clear()
            job.nf_counts.clear()
        else:
            job.state = job.plan.film.init_state(ent.scene.device)
        job.status = ACTIVE

    def _park(self, job: RenderJob) -> None:
        """Emergency-checkpoint the tuple and drop the film state (the
        preemption write — the durable path: CRC + fsync + .prev)."""
        from tpu_pbrt_torch.obs.trace import TRACE

        if job.window is not None:
            # drop still-deferred cadence writes: the park write below
            # supersedes them at the SAME path with a newer cursor, so
            # draining them here would pay redundant npz+CRC+fsync per
            # preemption. The in-flight slices need no explicit sync —
            # save_checkpoint's host copy of the film is ordered after
            # them on the stream (and surfaces any latent failure). Their
            # deposits ARE in the saved cursor's coverage, so their
            # spans close ok (the causal timeline has no gap here)
            job.window.close_spans(ok=True)
            job.window.flush(discard=True)
            job.window = None
        with TRACE.span(
            "serve/park", job=job.job_id, chunk=job.cursor,
            trace_id=job.trace_id,
        ):
            save_checkpoint(
                job.checkpoint_path, job.state, job.cursor,
                job.rays_so_far(), fingerprint=job.plan.fingerprint,
                counters=job.snapshot_counters(),
            )
        job.prev_rays = job.rays_so_far()
        job.prev_ctr = job.snapshot_counters()
        job.baked_redispatches = job.redispatches
        self._report_nonfinite(job, job.prev_ctr)
        job.ray_counts.clear()
        job.occ_counts.clear()
        job.ctr_counts.clear()
        job.nf_counts.clear()
        job.state = None
        self._lead("park", job=job.job_id)
        job.preemptions += 1
        METRICS.counter(
            "serve_preemptions_total",
            "jobs parked via the emergency-checkpoint path",
        ).inc(tenant=job.tenant)
        self._flight(job, "serve_park", chunk=job.cursor)

    def _queue_checkpoint(self, job: RenderJob) -> None:
        """Cadence checkpoint for a job. With slices in flight the
        durable write is deferred to the slice's retirement, so the npz
        compression + CRC + fsync run under in-flight compute. The film
        is written in place by the next slices, so the write reads a
        host copy enqueued now (parallel/checkpoint.begin_host_copy),
        ordered after this slice and before the next. With an empty
        window, write immediately."""
        from tpu_pbrt_torch.obs.trace import TRACE
        from tpu_pbrt_torch.parallel.checkpoint import begin_host_copy

        plan = job.plan
        cursor = job.cursor
        if job.window is None or not len(job.window):
            with TRACE.span(
                "serve/checkpoint_write", job=job.job_id, chunk=cursor,
                trace_id=job.trace_id, deferred=False,
            ):
                save_checkpoint(
                    job.checkpoint_path, job.state, cursor,
                    job.rays_so_far(), fingerprint=plan.fingerprint,
                    counters=job.snapshot_counters(),
                )
            return
        snap = begin_host_copy(job.state)
        n_ray = len(job.ray_counts)
        n_ctr = len(job.ctr_counts)
        n_nf = len(job.nf_counts)

        def write():
            # the deferred durable write runs at its cursor's retirement
            # — under newer slices' compute — but belongs to THIS job's
            # trace, which the span args record
            with TRACE.span(
                "serve/checkpoint_write", job=job.job_id, chunk=cursor,
                trace_id=job.trace_id, deferred=True,
            ):
                save_checkpoint(
                    job.checkpoint_path, snap.wait(), cursor,
                    job.prev_rays + _host_sum(job.ray_counts[:n_ray]),
                    fingerprint=plan.fingerprint,
                    counters=job.snapshot_counters(n_ctr, n_nf),
                )

        job.window.defer(cursor, write)

    def _dispatch_slice(self, job: RenderJob) -> None:
        """One chunk-slice with the recovery ladder (capped-backoff
        re-dispatch; poisoning failures roll back to the job's last
        checkpoint or restart the job). Pipelined: the
        dispatch is an async enqueue into the job's in-flight window —
        the bookkeeping below, the next step's scheduling decision and
        the next-job prefetch all run under its device compute; the
        window's oldest slice is retired (one bounded sync) only when
        the window is full."""
        from tpu_pbrt_torch.chaos import CHAOS
        from tpu_pbrt_torch.obs.trace import TRACE

        plan = job.plan
        c = job.cursor
        t0 = self._now()
        if job.window is None:
            tracer = plan.tracer

            def on_wait(dt, _tracer=tracer):
                if METRICS.enabled:
                    phase_histogram().observe(
                        dt, phase="device_wait", tracer=_tracer
                    )

            # the depth comes from the PLAN (resolve_pipeline_depth: the
            # strict firewall modes force depth 1)
            job.window = DispatchWindow(
                plan.pipeline_depth,
                on_wait=on_wait,
                span_name="serve/slice_retire",
                clock=self.clock,
            )
        sid = f"{job.trace_id}/c{c}"
        if job.ready_t:
            # queue wait: became-dispatchable -> this dispatch (includes
            # scheduler contention and any backoff window — the latency
            # the tenant actually observes, which is what the SLO wait
            # target bounds)
            wait = t0 - job.ready_t
            self._trace_wait_end(job, wait)
            _queue_wait_hist().observe(
                wait, tenant=job.tenant, priority=job.priority,
                exemplar={
                    "trace_id": job.trace_id,
                    "span_id": f"{job.trace_id}/q{job.wait_epoch}",
                    "job": job.job_id, "chunk": c,
                },
            )
            win = self._recent_waits.get(job.priority)
            if win is None:
                from collections import deque

                win = self._recent_waits[job.priority] = deque(
                    maxlen=_WAIT_WINDOW
                )
            win.append(wait)
        try:
            self._lead("dispatch", job=job.job_id, chunk=c, attempt=job.attempt)
            try:
                CHAOS.dispatch(c, job.attempt, mesh=self.mesh is not None)
            except ChunkDispatchError as e:
                if self._sid is None:
                    raise
                # the other ranks are in this chunk's step: agree on
                # its outcome with them (the render loop's rule)
                from tpu_pbrt_torch.parallel.mesh import join_failure

                raise join_failure(self.mesh, e) from e
            try:
                # a slice launched with older ones still in flight has
                # its host cost hidden under their compute — attributed
                # separately (dispatch_ahead), like the render loop
                with TRACE.span(
                    "serve/slice_ahead" if len(job.window) else "serve/slice",
                    job=job.job_id, chunk=c, trace_id=job.trace_id,
                    span_id=sid,
                ):
                    aux = plan.dispatch(job.state, c)  # in place
                    handle = None
                    if job.state.rgb.device.type == "cuda":
                        # the slice's sync handle: its last op
                        handle = torch.cuda.Event()
                        handle.record()
            except DEVICE_ERRORS as e:
                job.state = None  # written part-way: untrusted
                raise ChunkDispatchError(
                    f"device dispatch failed: {e}", poisons_state=True
                ) from e
            if cfg.nonfinite != "scrub":
                # (resolve_pipeline_depth forces the window to depth 1
                # in the strict modes — this is a per-chunk device sync)
                nrays, occ, ctr, _, nf = plan.aux_parts(aux)
                nf_dev = ctr.nonfinite if ctr is not None else nf
                nf_ct = 0 if nf_dev is None else int(nf_dev.item())
                if nf_ct:
                    if cfg.nonfinite == "raise":
                        # only the message here: _step_job's firewall
                        # sets FAILED and releases the device buffers
                        # (status and release in one scope)
                        job.error = (
                            f"chunk {c} deposited {nf_ct} non-finite "
                            "sample(s) (TORCH_PBRT_NONFINITE=raise)"
                        )
                        raise NonFiniteRadianceError(job.error)
                    raise NonFiniteWaveError(  # retry: poisons the film
                        f"non-finite firewall: chunk {c} scrubbed "
                        f"{nf_ct} deposit(s)"
                    )
        except ChunkDispatchError as e:
            try:
                job.window.flush(discard=e.poisons_state)
            except ChunkDispatchError as e2:
                e = e2  # the flush itself found a poisoned device
                job.window.flush(discard=True)
                job.state = None
            self._recover(job, e)
            return
        job.attempt = 0
        job.cursor = c + 1
        self.last_progress_step = self.health_steps
        self.schedule.append((job.job_id, c))
        self.scheduler.charge(job.tenant)
        nrays, occ, ctr, spread, nf = plan.aux_parts(aux)
        job.ray_counts.append(nrays)
        if occ is not None:
            job.occ_counts.append(occ)
        if ctr is not None:
            job.ctr_counts.append(ctr)
        if nf is not None:
            job.nf_counts.append(nf)
        if job.checkpoint_every and job.cursor % job.checkpoint_every == 0:
            self._queue_checkpoint(job)
        # retire the oldest in-flight slice(s) only once the window is
        # full — everything above (and the caller's prefetch + the next
        # step's scheduling) ran under their device compute. The slice's
        # in-flight lifetime (enqueue -> retire sync) is an async span
        # under the job's trace, causally bound by a flow event, so a
        # depth-N window renders as N overlapping attributed tracks
        TRACE.async_begin(
            "serve/slice_inflight", id=sid, cat="slice", job=job.job_id,
            chunk=c, trace_id=job.trace_id, span_id=sid,
        )
        TRACE.flow_start("slice_flow", id=sid)
        job.window.push(c, handle, span={
            "name": "serve/slice_inflight", "id": sid, "cat": "slice",
            "flow": sid, "trace_id": job.trace_id, "span_id": sid,
        })
        try:
            while job.window.full():
                job.window.retire_one()
        except ChunkDispatchError as e:
            job.state = None  # mid-flight device failure: untrusted
            job.window.flush(discard=True)
            self._recover(job, e)
            return
        # service time closes AFTER the retire: it must cover the
        # bounded device sync (at depth 1 that is the whole chunk
        # compute — the pre-pipeline meaning), not just the async
        # enqueue + bookkeeping
        now = self._now()
        job.active_seconds += now - t0
        _slice_hist().observe(
            now - t0, tenant=job.tenant,
            exemplar={
                "trace_id": job.trace_id, "span_id": sid,
                "job": job.job_id, "chunk": c,
            },
        )
        job.ready_t = now
        if job.cursor < plan.n_chunks:
            self._trace_ready(job)
        if (
            job.preview_every
            and job.preview_path
            and job.cursor % job.preview_every == 0
            and job.cursor < plan.n_chunks
        ):
            self._write_preview(job)
        if job.cursor >= plan.n_chunks:
            self._finalize(job)

    def _recover(self, job: RenderJob, e: ChunkDispatchError) -> None:
        job.window = None  # flushed by the caller; rebuilt lazily
        job.attempt += 1
        job.redispatches += 1
        if job.attempt > int(cfg.retry_max):
            if job.state is not None and not e.poisons_state:
                self._park(job)  # completed work survives the failure
            job.status = FAILED
            job.error = f"chunk {job.cursor} failed {job.attempt} times: {e}"
            self._release_device(job)
            job.plan = None
            self.residency.unpin(job.resident_key)
            self._update_depth_gauge()
            self._trace_job_end(job, "failed")
            self._flight(job, "serve_failed", error=job.error[:200])
            return
        if e.poisons_state:
            job.state = None
            if checkpoint_exists(job.checkpoint_path):
                job.rollbacks += 1
            else:
                # no durable progress: restart this job from chunk 0
                job.cursor = 0
                job.prev_rays = 0
                job.prev_ctr = {}
                job.baked_redispatches = 0
                job.restarts += 1
            job.ray_counts.clear()
            job.occ_counts.clear()
            job.ctr_counts.clear()
            job.nf_counts.clear()
            job.status = PARKED  # re-activation reloads/re-inits state
        backoff = redispatch_backoff(job.cursor, job.attempt)
        METRICS.counter(
            "serve_redispatches_total", "chunk-slice re-dispatches"
        ).inc(tenant=job.tenant)
        METRICS.counter(
            "serve_redispatch_backoff_seconds_total",
            "seconds of re-dispatch backoff accrued",
        ).inc(backoff, tenant=job.tenant)
        # one decision sample covers both the ready time and the backoff
        # deadline (recovery reasons about not_before, so it samples the
        # clock exactly once)
        now = self._now()
        job.ready_t = now
        self._trace_ready(job)
        self._flight(
            job, "serve_redispatch", chunk=job.cursor,
            attempt=job.attempt, poisoned=e.poisons_state,
            backoff_s=round(backoff, 3), error=str(e)[:200],
        )
        # the backoff is a per-job NOT-BEFORE deadline, never a sleep on
        # the scheduler thread: other tenants' healthy jobs keep
        # dispatching through one job's retry streak (step() only waits
        # when EVERY runnable job is inside its backoff window)
        if backoff > 0:
            from tpu_pbrt_torch.obs.trace import TRACE

            # the backoff window's extent is known the moment it opens:
            # an explicit-duration span shows WHY the job's timeline has
            # a hole between this recovery and its next dispatch
            TRACE.complete(
                "serve/backoff", backoff * 1e6, job=job.job_id,
                chunk=job.cursor, attempt=job.attempt,
                trace_id=job.trace_id,
            )
            job.not_before = now + backoff

    def _write_preview(self, job: RenderJob) -> None:
        from tpu_pbrt_torch.obs.trace import TRACE
        from tpu_pbrt_torch.utils import imageio

        t0 = self.clock.monotonic()
        with TRACE.span(
            "serve/preview", job=job.job_id, chunk=job.cursor,
            trace_id=job.trace_id,
        ):
            img = self.preview(job.job_id)
            try:
                imageio.write_image(job.preview_path, img)
                job.previews += 1
            except Exception as ex:  # noqa: BLE001
                from tpu_pbrt_torch.utils.error import Warning as _W

                _W(f"preview write failed for {job.job_id}: {ex}")
        METRICS.histogram(
            "serve_preview_seconds",
            "preview latency: live-film develop + image write",
        ).observe(self.clock.monotonic() - t0, tenant=job.tenant)
        self._flight(job, "serve_preview", chunk=job.cursor)

    def _finalize(self, job: RenderJob) -> None:
        from tpu_pbrt_torch.obs import counters as obs_counters
        from tpu_pbrt_torch.obs.trace import TRACE

        plan = job.plan
        # still-deferred cadence writes are superseded by the terminal
        # state below (spool checkpoints are deleted outright); the
        # block on job.state is the job's full drain either way
        window, job.window = job.window, None
        with TRACE.span(
            "serve/finalize", job=job.job_id, trace_id=job.trace_id,
        ):
            if job.state.rgb.device.type == "cuda":
                # the film's last write: an event after every enqueued op
                done = torch.cuda.Event()
                done.record()
                done.synchronize()
            if window is not None:
                # the block above IS the tail slices' sync: their spans
                # close complete, not aborted — the reconstructed
                # timeline covers every chunk through the final cursor
                window.close_spans(ok=True)
            rays = job.rays_so_far()
            ctr_total = job.snapshot_counters()
            stats: Dict[str, Any] = {
                "job_id": job.job_id,
                "tenant": job.tenant,
                "preemptions": job.preemptions,
            }
            if job.redispatches:
                stats["recovery"] = {
                    "redispatches": job.redispatches,
                    "rollbacks": job.rollbacks,
                    "restarts": job.restarts,
                }
            if plan.use_regen and job.occ_counts:
                lv = _host_sum([a for a, _, _ in job.occ_counts])
                wv = _host_sum([b for _, b, _ in job.occ_counts])
                tr = _host_sum([t for _, _, t in job.occ_counts])
                if tr:
                    from tpu_pbrt_torch.utils.error import Warning as _W

                    _W(
                        f"job {job.job_id}: pool drain truncated {tr} "
                        "chunk(s) at the max_waves bound — the image is "
                        "missing samples"
                    )
                    stats["truncated_chunks"] = tr
                stats |= {
                    "mean_wave_occupancy": lv / max(wv * plan.pool, 1),
                    "n_waves": wv,
                    "pool": plan.pool,
                    "regen": True,
                }
            if obs_counters.enabled() and ctr_total:
                stats["telemetry"] = {"counters": ctr_total}
            img = plan.film.develop(job.state, splat_scale=1.0 / plan.spp)
            if job.outfile:
                from tpu_pbrt_torch.utils import imageio

                try:
                    imageio.write_image(job.outfile, img)
                except Exception as ex:  # noqa: BLE001
                    from tpu_pbrt_torch.utils.error import Warning as _W

                    _W(f"could not write {job.outfile}: {ex}")
        job.result = RenderResult(
            image=img,
            film_state=job.state,
            seconds=job.active_seconds,
            rays_traced=rays,
            mray_per_sec=rays / max(job.active_seconds, 1e-9) / 1e6,
            spp=plan.spp,
            completed_fraction=1.0,
            stats=stats,
        )
        job.status = DONE
        # the film lives on in result.film_state; everything else —
        # counter tensors, the (already-None) window — drops here, and
        # the plan with it: it holds the scene past eviction
        self._release_device(job)
        job.plan = None
        self._report_nonfinite(job, ctr_total)
        self.residency.unpin(job.resident_key)
        self.residency.evict_over_budget()
        if job.spool_ckpt:
            delete_checkpoint(job.checkpoint_path)
        self._update_depth_gauge()
        self._trace_job_end(job, "done")
        self._flight(job, "serve_done", rays=rays, chunks=job.cursor,
                     seconds=round(job.active_seconds, 3))
