"""Queue policy for the render service: priority classes + weighted
fair sharing across tenants, deterministic given a seed.

Two-level decision, evaluated at every scheduler step over the runnable
job set:

1. **Strict priority classes.** A higher `priority` int always schedules
   before a lower one (and, through the service's `max_active` knob, can
   PREEMPT a lower class's film residency — see
   `preemption_victim`). Classes are for urgency tiers (interactive
   preview vs batch final-frame), not for shares.
2. **Weighted fair sharing across tenants** within a class: each tenant
   carries a virtual service time (`vtime`) advanced by
   `slice_cost / weight` per dispatched chunk-slice; the runnable job
   whose tenant has the SMALLEST vtime runs next. A tenant with weight 2
   therefore gets ~2x the slices of a weight-1 tenant under contention,
   and an idle tenant re-enters at the current minimum among busy
   tenants (no banked credit, the classic start-time fairness rule —
   new tenants via `tenant()`, returning ones via `reenter()`, which
   the service calls on every submit).
3. FIFO within a tenant (submit sequence number).

Determinism contract: `pick` consults nothing but (priority, vtime,
seeded tenant hash, submit seq) — no wall clock, no dict order, no
Python `hash` (PYTHONHASHSEED-dependent). Two services fed the same
submit/charge sequence with the same seed produce the same interleaving,
which is what lets tests assert interleaving-independence of the
rendered films and replay a production schedule from its log.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple


@dataclass
class TenantShare:
    """Per-tenant fair-share accounting."""

    weight: float = 1.0
    vtime: float = 0.0  # virtual service time (slice cost / weight)
    slices: int = 0  # total chunk-slices charged (stats only)


class FairScheduler:
    """Deterministic priority + weighted-fair-queueing policy."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._tenants: Dict[str, TenantShare] = {}

    # -- tenants -----------------------------------------------------------
    def _set_vtime(self, ts: TenantShare, vtime: float) -> None:
        """The ONLY sanctioned vtime writer. The fairness invariants
        (no banked credit, vtime monotone per tenant under charge) live
        in the three callers — tenant()'s floor init, reenter()'s busy
        clamp, charge()'s weighted advance; a vtime write anywhere else
        is a policy bypass."""
        ts.vtime = float(vtime)

    def tenant(self, name: str) -> TenantShare:
        ts = self._tenants.get(name)
        if ts is None:
            # a new (or returning-idle) tenant starts at the current
            # minimum vtime: it competes fairly from NOW instead of
            # replaying every slice it never asked for
            floor = min(
                (t.vtime for t in self._tenants.values()), default=0.0
            )
            ts = self._tenants[name] = TenantShare()
            self._set_vtime(ts, floor)
        return ts

    def set_weight(self, name: str, weight: float) -> None:
        self.tenant(name).weight = max(float(weight), 1e-9)

    def reenter(self, name: str, busy_tenants=()) -> None:
        """Start-time fairness for a RETURNING tenant: clamp its vtime
        up to the minimum among `busy_tenants` (the tenants that
        currently have schedulable work — the caller knows the job
        table, this policy object does not). Without the clamp an
        existing tenant that went idle keeps its stale low vtime and
        re-enters with banked credit, monopolizing the mesh until the
        backlog 'catches up' — the exact opposite of the no-banked-
        credit rule. Deterministic: a pure function of recorded
        vtimes."""
        ts = self.tenant(name)
        floor = [
            self._tenants[t].vtime
            for t in busy_tenants
            if t != name and t in self._tenants
        ]
        if floor:
            self._set_vtime(ts, max(ts.vtime, min(floor)))

    def _tiebreak(self, tenant: str) -> int:
        return zlib.crc32(f"{self.seed}:{tenant}".encode())

    # -- policy ------------------------------------------------------------
    def sort_key(self, job):
        """Total order over runnable jobs: smaller runs first. `job`
        needs .priority (int, higher = more urgent), .tenant (str) and
        .seq (int submit sequence)."""
        ts = self.tenant(job.tenant)
        return (-job.priority, ts.vtime, self._tiebreak(job.tenant), job.seq)

    def pick(self, jobs: Iterable, record: bool = True):
        """The runnable job to dispatch next, or None. `record` marks
        the decision on the trace timeline (an instant event carrying
        the chosen job's trace id) — peek passes False, keeping the
        lookahead contract that it leaves no mark anywhere."""
        best = None
        best_key = None
        for j in jobs:
            k = self.sort_key(j)
            if best is None or k < best_key:
                best, best_key = j, k
        if best is not None and record:
            from tpu_pbrt_torch.obs.trace import TRACE

            TRACE.instant(
                "sched/pick",
                job=getattr(best, "job_id", ""),
                tenant=best.tenant, priority=best.priority,
                trace_id=getattr(best, "trace_id", ""),
            )
        return best

    def peek(self, jobs: Iterable):
        """Read-only lookahead: which job WOULD dispatch next — the
        service's prefetch path uses this to pre-activate
        the next scheduled job under in-flight compute. Identical
        ordering to `pick` (neither charges vtime; accounting happens
        separately via `charge`) — the distinct name documents the
        prefetch contract that peeking must never perturb the recorded
        schedule (or the trace: record=False), and gives the policy
        room to diverge later (e.g. a pick that reserves) without
        breaking lookahead callers."""
        return self.pick(jobs, record=False)

    def charge(self, tenant: str, cost: float = 1.0) -> None:
        """Account one dispatched chunk-slice to `tenant`."""
        ts = self.tenant(tenant)
        self._set_vtime(ts, ts.vtime + cost / ts.weight)
        ts.slices += 1
        from tpu_pbrt_torch.obs.trace import TRACE

        # a counter track per tenant: Perfetto plots the fair-share
        # vtime race the schedule decisions above are explained by
        TRACE.counter("sched/vtime", **{tenant: round(ts.vtime, 6)})

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "weight": ts.weight,
                "vtime": round(ts.vtime, 6),
                "slices": ts.slices,
            }
            for name, ts in sorted(self._tenants.items())
        }


# --------------------------------------------------------------------------
# SLO admission control (load shedding)
# --------------------------------------------------------------------------


def parse_slo_spec(spec: str, cast) -> Dict[Optional[int], float]:
    """`TORCH_PBRT_SERVE_SLO_*` spec grammar -> {priority class: target}.
    A bare value ("8") or `default=8` sets the every-class default (the
    None key); `0=4,5=32` sets per-class targets. Raises on anything
    else — a silently ignored SLO knob is the worst failure mode an
    admission-control config can have."""
    out: Dict[Optional[int], float] = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        k, eq, v = part.partition("=")
        if not eq:
            out[None] = cast(k)
        elif k.strip().lower() in ("default", "*"):
            out[None] = cast(v)
        else:
            out[int(k)] = cast(v)
    return out


@dataclass
class SloPolicy:
    """Per-priority-class admission targets. The shed decision is a PURE
    function of (class, queued depth, observed wait p90) — no wall
    clock, no randomness — so an over-SLO submit burst sheds the same
    requests every run (the determinism contract the scheduler already
    keeps, extended to admission)."""

    #: class -> max runnable jobs before a submit sheds (None key = default)
    depth: Dict[Optional[int], float] = field(default_factory=dict)
    #: class -> max observed p90 queue wait (seconds) before a submit sheds
    wait_s: Dict[Optional[int], float] = field(default_factory=dict)

    @classmethod
    def from_cfg(cls) -> "SloPolicy":
        from tpu_pbrt_torch.config import cfg

        return cls(
            depth=parse_slo_spec(cfg.serve_slo_depth, int),
            wait_s=parse_slo_spec(cfg.serve_slo_wait_s, float),
        )

    def enabled(self) -> bool:
        return bool(self.depth or self.wait_s)

    def depth_target(self, priority: int) -> Optional[int]:
        t = self.depth.get(int(priority), self.depth.get(None))
        return None if t is None else int(t)

    def wait_target(self, priority: int) -> Optional[float]:
        t = self.wait_s.get(int(priority), self.wait_s.get(None))
        return None if t is None else float(t)

    def admit(
        self, priority: int, queued_depth: int,
        wait_p90: Optional[float] = None,
    ) -> Tuple[bool, str]:
        """(admit?, shed reason). queued_depth counts the class's
        runnable jobs BEFORE this submit; wait_p90 is the class's
        observed p90 queue wait (None = no observations yet — never a
        shed reason on its own: an idle service must accept work)."""
        d = self.depth_target(priority)
        if d is not None and queued_depth >= d:
            return False, (
                f"queue depth {queued_depth} at class-{priority} "
                f"target {d}"
            )
        w = self.wait_target(priority)
        if w is not None and wait_p90 is not None and wait_p90 > w:
            return False, (
                f"queue-wait p90 {wait_p90:.3f}s over class-{priority} "
                f"target {w:g}s"
            )
        return True, ""


def preemption_victim(active_jobs: Iterable, candidate) -> Optional[object]:
    """Which film-resident job to preempt (emergency-checkpoint to disk,
    the render loop's durable path) so `candidate` can activate: the LOWEST-priority active
    job strictly below the candidate's class — ties broken by largest
    submit seq (newest first, oldest work is closest to done). None when
    no active job is outranked (the candidate waits its fair turn
    instead)."""
    victim = None
    v_key = None
    for j in active_jobs:
        if j.priority >= candidate.priority:
            continue
        k = (j.priority, -j.seq)
        if victim is None or k < v_key:
            victim, v_key = j, k
    return victim
