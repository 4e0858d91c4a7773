"""Seeded workload generation: traffic as a pure function of (seed, spec).

A `WorkloadSpec` names the statistical shape of the traffic — arrival
process, tenant mix, scene-size distribution, resubmit/edit behavior —
and `generate(spec, seed)` expands it into a concrete `Workload`: a
time-sorted list of `Request`s. Everything is drawn from ONE
`random.Random` instance seeded from (spec.name, seed), and every float
is quantized, so the same inputs produce a byte-identical schedule on
every run and platform (the determinism gate diffs the rendered lines).

The distributions model what a render fleet actually sees:

- **power-law tenants** — request share ~ 1/(rank+1)^alpha: a few hot
  studios, a long tail of occasional users (drives WFQ fairness);
- **bursty arrivals** — Poisson inter-arrivals whose rate is modulated
  by a square-wave burst window (drives SLO shedding);
- **heavy-tail scene shapes** — per-scene chunk counts from a clipped
  discrete Pareto: most scenes small, a few huge (drives preemption
  and the slice scheduler's fairness under size skew);
- **edit-storm** — a request re-submits a previously seen scene with a
  bumped revision: a NEW residency key, so it pays a recompile (drives
  residency churn and eviction);
- **resubmit** — a request re-submits an existing key verbatim: a warm
  residency hit (drives the zero-recompile contract).
"""

from __future__ import annotations

import json
import random
from dataclasses import asdict, dataclass, field, replace
from typing import Dict, List, Optional, Tuple

__all__ = [
    "WorkloadSpec",
    "Request",
    "Workload",
    "GateTargets",
    "LoadScenario",
    "SCENARIOS",
    "CI_SCENARIOS",
    "generate",
]


# --------------------------------------------------------------------------
# Spec / request / workload
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class WorkloadSpec:
    """The statistical shape of one traffic scenario. Frozen: a spec is
    a value — hash it, embed it in reports, reconstruct it from a
    capture header."""

    name: str
    #: virtual seconds during which requests arrive (service continues
    #: past this until drained)
    duration_s: float = 2.0
    #: mean off-burst arrival rate, requests per virtual second
    rate: float = 40.0
    #: arrival-rate multiplier inside a burst window (1.0 = flat Poisson)
    burst_factor: float = 1.0
    #: square-wave burst period; the FIRST half of each period bursts.
    #: 0 disables modulation.
    burst_period_s: float = 0.0
    #: tenant population; request share is power-law over rank
    tenants: int = 4
    tenant_alpha: float = 1.2
    #: priority classes and their draw weights (parallel tuples)
    priorities: Tuple[int, ...] = (0,)
    priority_weights: Tuple[float, ...] = (1.0,)
    #: per-scene chunk counts: clipped discrete Pareto on [min, max]
    chunks_min: int = 1
    chunks_max: int = 6
    chunks_tail: float = 1.5
    #: distinct base scenes in the pool (0 -> same as `tenants`)
    scene_pool: int = 0
    #: fraction of requests that re-submit an already-seen key verbatim
    resubmit_fraction: float = 0.0
    #: fraction that re-submit a seen scene with a bumped revision (a
    #: new key: the edit invalidates the compiled scene)
    edit_fraction: float = 0.0
    #: pipeline depth and checkpoint cadence passed through to submit
    depth: int = 1
    checkpoint_every: int = 0
    #: virtual seconds of device time one chunk-slice costs the replica
    #: (the service-time model replay advances the clock by per slice)
    service_time_s: float = 0.004
    #: SLO admission policy for the run (queue.parse_slo_spec grammar;
    #: "" disables that half)
    slo_depth: str = ""
    slo_wait_s: str = ""
    #: CHAOS fault plan installed for the run ("" = clean)
    fault: str = ""
    #: film-state slots (None = unbounded; small values drive preemption)
    max_active: Optional[int] = None

    def to_json(self) -> str:
        return json.dumps(asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "WorkloadSpec":
        d = json.loads(text)
        for k in ("priorities", "priority_weights"):
            if k in d:
                d[k] = tuple(d[k])
        return cls(**d)


@dataclass(frozen=True)
class Request:
    """One generated submit decision."""

    rid: str  #: deterministic request id (also the job id at replay)
    t: float  #: virtual arrival time, quantized to 1e-6 s
    tenant: str
    priority: int
    scene: str  #: residency key ("<base>@r<rev>")
    chunks: int
    depth: int = 1
    checkpoint_every: int = 0
    kind: str = "fresh"  #: fresh | resubmit | edit

    def line(self) -> str:
        """The schedule-artifact rendering — fixed-width, path-free;
        byte-compared by the determinism gate."""
        return (
            f"@{self.t:012.6f} {self.kind:<8s} {self.rid} "
            f"tenant={self.tenant} prio={self.priority} "
            f"scene={self.scene} chunks={self.chunks} depth={self.depth}"
        )


@dataclass
class Workload:
    """A concrete schedule: the spec that shaped it, the seed that drew
    it, and the time-sorted requests."""

    spec: WorkloadSpec
    seed: int
    requests: List[Request] = field(default_factory=list)

    def schedule_text(self) -> str:
        """The byte-identity artifact: same (spec, seed) => identical."""
        head = f"# tpu-load schedule {self.spec.name} seed={self.seed}\n"
        return head + "".join(r.line() + "\n" for r in self.requests)


# --------------------------------------------------------------------------
# Generation
# --------------------------------------------------------------------------


def _pareto_int(rng: random.Random, lo: int, hi: int, tail: float) -> int:
    """Clipped discrete Pareto: heavy-tail sizes in [lo, hi]. Smaller
    `tail` = heavier tail (more mass at hi)."""
    if hi <= lo:
        return lo
    u = max(rng.random(), 1e-12)
    v = lo * u ** (-1.0 / tail)
    return min(hi, max(lo, int(v)))


def _pick_weighted(rng: random.Random, cum: List[float]) -> int:
    """Index drawn by a pre-normalized cumulative weight table."""
    u = rng.random()
    for i, c in enumerate(cum):
        if u <= c:
            return i
    return len(cum) - 1


def _cumulative(weights: List[float]) -> List[float]:
    total = sum(weights)
    cum, acc = [], 0.0
    for w in weights:
        acc += w / total
        cum.append(acc)
    cum[-1] = 1.0
    return cum


def _in_burst(t: float, spec: WorkloadSpec) -> bool:
    if spec.burst_period_s <= 0 or spec.burst_factor == 1.0:
        return False
    return (t % spec.burst_period_s) < spec.burst_period_s / 2.0


def generate(spec: WorkloadSpec, seed: int) -> Workload:
    """Expand a spec into a concrete schedule — pure in (spec, seed)."""
    rng = random.Random(f"tpu-load:{spec.name}:{int(seed)}")

    # scene pool: each base scene draws its shape ONCE — a scene's
    # chunk count is a property of the scene, so every resubmit of the
    # same key replays the same shape (the residency cache returns the
    # first-compiled integrator anyway; divergence here would lie)
    n_scenes = spec.scene_pool or max(spec.tenants, 1)
    scene_chunks: Dict[str, int] = {
        f"s{i:02d}": _pareto_int(
            rng, spec.chunks_min, spec.chunks_max, spec.chunks_tail
        )
        for i in range(n_scenes)
    }
    bases = sorted(scene_chunks)

    tenant_cum = _cumulative(
        [(i + 1) ** -spec.tenant_alpha for i in range(spec.tenants)]
    )
    prio_cum = _cumulative(list(spec.priority_weights))

    requests: List[Request] = []
    seen_keys: List[str] = []  # insertion-ordered, deterministic
    revs: Dict[str, int] = dict.fromkeys(bases, 0)
    t = 0.0
    while True:
        rate = spec.rate * (
            spec.burst_factor if _in_burst(t, spec) else 1.0
        )
        t += rng.expovariate(rate)
        if t >= spec.duration_s:
            break
        tq = round(t, 6)
        tenant = f"t{_pick_weighted(rng, tenant_cum)}"
        prio = spec.priorities[_pick_weighted(rng, prio_cum)]
        u = rng.random()
        if seen_keys and u < spec.resubmit_fraction:
            kind = "resubmit"
            key = seen_keys[rng.randrange(len(seen_keys))]
            base = key.split("@", 1)[0]
        elif seen_keys and u < spec.resubmit_fraction + spec.edit_fraction:
            kind = "edit"
            prev = seen_keys[rng.randrange(len(seen_keys))]
            base = prev.split("@", 1)[0]
            revs[base] += 1
            key = f"{base}@r{revs[base]}"
        else:
            kind = "fresh"
            base = bases[rng.randrange(len(bases))]
            key = f"{base}@r{revs[base]}"
        if key not in seen_keys:
            seen_keys.append(key)
        requests.append(Request(
            rid=f"r{len(requests):04d}", t=tq, tenant=tenant,
            priority=int(prio), scene=key, chunks=scene_chunks[base],
            depth=spec.depth, checkpoint_every=spec.checkpoint_every,
            kind=kind,
        ))
    return Workload(spec=spec, seed=int(seed), requests=requests)


# --------------------------------------------------------------------------
# Scenario registry: spec + the gate targets that make it a TEST
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class GateTargets:
    """Pass/fail thresholds for one scenario (gates.py evaluates)."""

    #: inclusive (lo, hi) bounds on sheds/(sheds+submits); None = must
    #: shed nothing
    shed_frac: Optional[Tuple[float, float]] = None
    #: ((priority, max p99 queue wait in virtual seconds), ...)
    p99_wait_s: Tuple[Tuple[int, float], ...] = ()
    #: clean scenario: the health watchdog must NEVER fire during replay
    health_clean: bool = True
    #: storm scenario: these conditions MUST fire at least once
    health_must_flag: Tuple[str, ...] = ()
    #: every admitted job must reach DONE at drain
    complete_all: bool = True


@dataclass(frozen=True)
class LoadScenario:
    spec: WorkloadSpec
    gates: GateTargets
    #: include in the `--ci` smoke set
    ci: bool = True


def _scenarios() -> Dict[str, LoadScenario]:
    out: Dict[str, LoadScenario] = {}

    # steady: flat Poisson at ~40% utilization, power-law tenants.
    # The false-positive baseline: no sheds, no health flags, bounded
    # waits.
    out["steady"] = LoadScenario(
        spec=WorkloadSpec(
            name="steady", duration_s=2.0, rate=40.0, tenants=4,
        ),
        gates=GateTargets(
            shed_frac=None,
            p99_wait_s=((0, 0.5),),
        ),
    )

    # burst: 8x arrival spikes against a depth SLO — shedding must
    # engage, deterministically, and keep admitted-work p99 bounded,
    # WITHOUT burning past the slo_burn alarm (shedding that trips its
    # own pager is mistuned).
    out["burst"] = LoadScenario(
        spec=WorkloadSpec(
            name="burst", duration_s=2.0, rate=25.0, burst_factor=8.0,
            burst_period_s=1.0, tenants=4, slo_depth="8",
        ),
        gates=GateTargets(
            shed_frac=(0.01, 0.45),
            p99_wait_s=((0, 0.5),),
        ),
    )

    # heavy: heavy-tail scene sizes + two priority classes + two
    # film-state slots — preemption and size skew; the high class must
    # keep a tighter p99 than the default class.
    out["heavy"] = LoadScenario(
        spec=WorkloadSpec(
            name="heavy", duration_s=2.0, rate=20.0, tenants=3,
            priorities=(0, 5), priority_weights=(0.65, 0.35),
            chunks_max=16, chunks_tail=1.1, max_active=2,
            service_time_s=0.003,
        ),
        gates=GateTargets(
            shed_frac=None,
            p99_wait_s=((0, 1.5), (5, 1.5)),
        ),
    )

    # editstorm: half the traffic edits scenes (new keys = recompiles),
    # a third resubmits warm keys — residency churn under load.
    out["editstorm"] = LoadScenario(
        spec=WorkloadSpec(
            name="editstorm", duration_s=1.5, rate=30.0, tenants=2,
            scene_pool=3, edit_fraction=0.5, resubmit_fraction=0.3,
        ),
        gates=GateTargets(
            shed_frac=None,
            p99_wait_s=((0, 1.0),),
        ),
    )

    # shedstorm: a deliberately over-tight depth SLO under sustained
    # overload — the slo_burn health condition MUST fire (a storm the
    # watchdog sleeps through is the false-negative bug).
    out["shedstorm"] = LoadScenario(
        spec=WorkloadSpec(
            name="shedstorm", duration_s=1.0, rate=200.0, tenants=2,
            slo_depth="1", chunks_min=3, chunks_max=8,
            service_time_s=0.01,
        ),
        gates=GateTargets(
            shed_frac=(0.5, 1.0),
            health_clean=False,
            health_must_flag=("slo_burn",),
        ),
    )

    # retrystorm: CHAOS fails the first 6 chunk-0 dispatches — some
    # job's attempt counter must climb past the storm threshold and the
    # backoff_storm condition must fire; retry_max (8) still recovers
    # every job, so completion holds.
    out["retrystorm"] = LoadScenario(
        spec=WorkloadSpec(
            name="retrystorm", duration_s=2.0, rate=2.0, tenants=1,
            fault="dispatch:fail@chunk=0&times=6",
        ),
        gates=GateTargets(
            shed_frac=None,
            health_clean=False,
            health_must_flag=("backoff_storm",),
        ),
    )
    return out


SCENARIOS: Dict[str, LoadScenario] = _scenarios()
CI_SCENARIOS: Tuple[str, ...] = tuple(
    name for name, s in SCENARIOS.items() if s.ci
)


def scaled(scn: LoadScenario, rate: float) -> LoadScenario:
    """The capacity sweep's knob: the same scenario at a different
    offered rate (name suffixed so generation reseeds per rung)."""
    spec = replace(
        scn.spec, rate=float(rate), name=f"{scn.spec.name}+r{rate:g}"
    )
    return replace(scn, spec=spec)
