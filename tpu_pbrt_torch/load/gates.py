"""Gates: fleet invariants asserted over a replay's results.

Each gate is a pure function of `ReplayResult` (and the scenario's
`GateTargets`) returning a `GateResult` — named, pass/fail, with the
observed value and the target it was held to. The p99 gate reads the
METRICS REGISTRY SNAPSHOT the replay captured at drain (not private
service state): the same surface a production monitor scrapes, so a
gate passing here means the alert built on the exported metric would
have stayed quiet too.

`evaluate_scenario` is the one-stop runner the CLI and tests share:
generate, replay TWICE (the determinism gate byte-compares schedule
and decision log), then apply the scenario's targets.

`capacity_sweep` re-runs one scenario across an arrival-rate ladder
and reports the KNEE — the highest offered req/s the replica sustains
with zero sheds, p99 within target, and a quiet watchdog. That number
(per replica, at the SLO) is the capacity-planning input the
fleet-router direction needs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from tpu_pbrt_torch.load.replay import ReplayResult, replay
from tpu_pbrt_torch.load.workload import (
    GateTargets,
    LoadScenario,
    generate,
    scaled,
)

__all__ = [
    "GateResult",
    "ScenarioReport",
    "snapshot_wait_p99",
    "evaluate_gates",
    "evaluate_scenario",
    "capacity_sweep",
]

_WAIT_METRIC = "tpu_pbrt_serve_queue_wait_seconds"


@dataclass
class GateResult:
    name: str
    ok: bool
    value: Any
    target: Any
    detail: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "ok": self.ok,
            "value": self.value, "target": self.target,
            "detail": self.detail,
        }


@dataclass
class ScenarioReport:
    """One scenario's full outcome: the gates plus the replay facts a
    future PR diffs against LOADTEST_baseline.json."""

    scenario: str
    seed: int
    gates: List[GateResult]
    result: ReplayResult
    #: fleet width the replay ran at (1 = the classic single-replica
    #: engine; >1 = routed through the FleetRouter)
    replicas: int = 1

    @property
    def ok(self) -> bool:
        return all(g.ok for g in self.gates)

    def to_dict(self) -> Dict[str, Any]:
        r = self.result
        extra: Dict[str, Any] = (
            {"replicas": self.replicas} if self.replicas != 1 else {}
        )
        return {
            **extra,
            "scenario": self.scenario,
            "seed": self.seed,
            "ok": self.ok,
            "gates": [g.to_dict() for g in self.gates],
            "requests": len(r.workload.requests),
            "submitted": r.submitted,
            "sheds": r.sheds,
            "completed": r.completed,
            "failed": r.failed,
            "dispatches": r.dispatches,
            "compiles": r.compiles,
            "residency_hits": r.residency_hits,
            "evictions": r.evictions,
            "preemptions": r.preemptions,
            "health_flags": r.health_flags,
            "virtual_seconds": r.virtual_seconds,
        }


# --------------------------------------------------------------------------
# Snapshot readers
# --------------------------------------------------------------------------


def snapshot_wait_p99(
    snapshot: Dict[str, Any], priority: int,
) -> Optional[float]:
    """Per-priority-class p99 queue wait from a registry snapshot:
    aggregate the histogram's bucket counts across every tenant series
    of the class, then interpolate — the exact arithmetic a recording
    rule on the exported metric would do."""
    from tpu_pbrt_torch.obs.metrics import percentile_from_buckets

    metric = snapshot.get("metrics", {}).get(_WAIT_METRIC)
    if not metric:
        return None
    agg: Optional[List[int]] = None
    edges: Tuple[float, ...] = ()
    for series in metric["series"]:
        if series["labels"].get("priority") != str(int(priority)):
            continue
        counts = series["counts"]
        if agg is None:
            agg = [0] * len(counts)
            edges = tuple(
                float(b) for b in series["buckets"] if b != "+Inf"
            )
        for i, c in enumerate(counts):
            agg[i] += c
    if agg is None:
        return None
    return percentile_from_buckets(edges, agg, 0.99)


def _shed_fraction(result: ReplayResult) -> float:
    total = result.sheds + result.submitted
    return result.sheds / total if total else 0.0


# --------------------------------------------------------------------------
# Gates
# --------------------------------------------------------------------------


def gate_determinism(
    a: ReplayResult, b: ReplayResult,
) -> GateResult:
    """Same seed, two independent replays: the schedules are identical
    by construction, so the byte-compare is over the DECISION LOGS —
    every submit/shed/dispatch the service made, in order."""
    same = a.log == b.log
    detail = ""
    if not same:
        for i, (la, lb) in enumerate(zip(a.log, b.log)):
            if la != lb:
                detail = f"first divergence at line {i}: {la!r} != {lb!r}"
                break
        else:
            detail = f"length mismatch: {len(a.log)} vs {len(b.log)}"
    return GateResult(
        "determinism", same, len(a.log), len(b.log), detail,
    )


def gate_shed_fraction(
    result: ReplayResult, bounds: Optional[Tuple[float, float]],
) -> GateResult:
    frac = round(_shed_fraction(result), 6)
    if bounds is None:
        return GateResult(
            "shed_fraction", result.sheds == 0, frac, 0.0,
            f"{result.sheds} shed(s) on a scenario that must shed none",
        )
    lo, hi = bounds
    return GateResult(
        "shed_fraction", lo <= frac <= hi, frac, list(bounds),
        f"{result.sheds} of {result.sheds + result.submitted} submits shed",
    )


def gate_p99_wait(
    result: ReplayResult, priority: int, target_s: float,
) -> GateResult:
    p99 = snapshot_wait_p99(result.snapshot, priority)
    name = f"p99_wait[{priority}]"
    if p99 is None:
        # a class with NO dispatches observed no waits — that is a
        # scenario-shape problem, not a latency pass
        return GateResult(
            name, False, None, target_s,
            f"no queue-wait samples for priority class {priority}",
        )
    return GateResult(
        name, p99 <= target_s, round(p99, 6), target_s,
        "virtual-seconds p99 from the registry snapshot",
    )


def gate_health(
    result: ReplayResult, targets: GateTargets,
) -> List[GateResult]:
    out: List[GateResult] = []
    if targets.health_clean:
        out.append(GateResult(
            "health_clean", not result.health_flags,
            result.health_flags, [],
            "watchdog conditions that fired during a clean scenario",
        ))
    missing = [
        f for f in targets.health_must_flag
        if f not in result.health_flags
    ]
    if targets.health_must_flag:
        out.append(GateResult(
            "health_must_flag", not missing,
            result.health_flags, list(targets.health_must_flag),
            f"missing: {missing}" if missing else "",
        ))
    return out


def gate_pin_balance(result: ReplayResult) -> GateResult:
    """PROTO-PIN at drain: every residency pin released once all jobs
    are terminal (a leak is a scene the LRU can never evict)."""
    return GateResult(
        "pin_balance", not result.pin_leaks, result.pin_leaks, {},
        "residency keys with live pins after drain",
    )


def gate_completion(result: ReplayResult) -> GateResult:
    bad = result.failed + len(result.unfinished)
    return GateResult(
        "completion", bad == 0,
        {"failed": result.failed, "unfinished": result.unfinished},
        {"failed": 0, "unfinished": []},
        "every admitted job must reach DONE at drain",
    )


def evaluate_gates(
    result: ReplayResult, targets: GateTargets,
) -> List[GateResult]:
    """Apply a scenario's targets to one replay result."""
    out = [gate_shed_fraction(result, targets.shed_frac)]
    for prio, tgt in targets.p99_wait_s:
        out.append(gate_p99_wait(result, prio, tgt))
    out.extend(gate_health(result, targets))
    out.append(gate_pin_balance(result))
    if targets.complete_all:
        out.append(gate_completion(result))
    return out


# --------------------------------------------------------------------------
# Runners
# --------------------------------------------------------------------------


def evaluate_scenario(
    scn: LoadScenario, seed: int,
    *,
    replicas: int = 1,
    flight_path: Optional[str] = None,
    trace_path: Optional[str] = None,
) -> ScenarioReport:
    """Generate + double-replay + gate one scenario (``replicas > 1``
    routes both replays through the fleet engine — the determinism
    gate then byte-compares routed decision logs, and the other gates
    read fleet-wide aggregates). The second replay exists only to feed
    the determinism gate; its recorders stay unarmed so the
    flight/trace sinks hold exactly one run."""
    wl = generate(scn.spec, seed)
    first = replay(
        wl, replicas=replicas,
        flight_path=flight_path, trace_path=trace_path,
    )
    second = replay(wl, replicas=replicas)
    gates = [gate_determinism(first, second)]
    gates.extend(evaluate_gates(first, scn.gates))
    return ScenarioReport(
        scenario=scn.spec.name, seed=seed, gates=gates, result=first,
        replicas=replicas,
    )


def capacity_sweep(
    scn: LoadScenario, seed: int,
    *,
    multipliers: Sequence[float] = (0.5, 1.0, 2.0, 4.0, 8.0),
    p99_target_s: float = 0.5,
) -> Dict[str, Any]:
    """Sweep offered arrival rate across `multipliers` x the scenario's
    base rate; a rung is SUSTAINABLE when the replica finished it with
    zero sheds, every class's p99 wait within `p99_target_s`, a quiet
    watchdog, and full completion. Returns the ladder and the knee:
    the highest sustainable OFFERED rate in requests per virtual
    second (per replica, at this SLO)."""
    ladder: List[Dict[str, Any]] = []
    knee: Optional[float] = None
    for m in multipliers:
        rung_scn = scaled(scn, scn.spec.rate * m)
        wl = generate(rung_scn.spec, seed)
        result = replay(wl)
        prios = sorted({r.priority for r in wl.requests}) or [0]
        p99s = {
            p: snapshot_wait_p99(result.snapshot, p) for p in prios
        }
        offered = (
            len(wl.requests) / rung_scn.spec.duration_s
            if rung_scn.spec.duration_s else 0.0
        )
        sustainable = (
            result.sheds == 0
            and not result.health_flags
            and result.failed == 0
            and not result.unfinished
            and all(
                v is not None and v <= p99_target_s
                for v in p99s.values()
            )
        )
        ladder.append({
            "rate_multiplier": m,
            "offered_req_s": round(offered, 6),
            "requests": len(wl.requests),
            "sheds": result.sheds,
            "p99_wait_s": {
                str(p): (None if v is None else round(v, 6))
                for p, v in p99s.items()
            },
            "health_flags": result.health_flags,
            "sustainable": sustainable,
        })
        if sustainable and (knee is None or offered > knee):
            knee = offered
    return {
        "scenario": scn.spec.name,
        "seed": seed,
        "p99_target_s": p99_target_s,
        "knee_req_s": None if knee is None else round(knee, 6),
        "ladder": ladder,
    }
