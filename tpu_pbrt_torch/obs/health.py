"""tpu-scope health watchdog: a deterministic evaluator over the
metrics registry and the render service's own state.

The serve daemon had no health surface: a wedged drain (runnable jobs,
no progress), a backoff storm (one job burning its retry budget), an
SLO burn (sheds outpacing admissions), or a nonfinite-deposit spike were
all invisible until a client timed out. This module turns those four
failure shapes into named, thresholded conditions:

- **wedge** — the service has made K consecutive `step()` calls while
  runnable jobs exist and no chunk cursor advanced. K is
  `TORCH_PBRT_HEALTH_WEDGE_STEPS` (default 12 — comfortably above the
  longest clean no-progress streak a backoff window produces in the
  chaos matrix, and far below any client timeout).
- **backoff_storm** — some job's CURRENT failure streak has reached
  `storm_attempts` consecutive re-dispatch attempts (job.attempt resets
  to 0 on success, so this flags live storms, not history).
- **slo_burn** — sheds / (sheds + admitted submits) exceeds
  `slo_burn_fraction` with at least `slo_burn_min_sheds` sheds: the
  admission policy is refusing a sustained fraction of the offered
  load, not just clipping one burst.
- **nonfinite_spike** — the `render_nonfinite_total` registry counter
  (folded in at the serve drain boundaries) exceeds `nonfinite_max`
  scrubbed deposits: the firewall is hiding real contamination.

Everything is a PURE function of (service state, registry counters,
thresholds) — no wall clock, no rates-over-time, no randomness — so the
chaos matrix can assert exactly which rows fire it and the 13 clean
rows provably do not. Exposed as the `health` verb on the JSONL daemon
and `--health` on `python -m tpu_pbrt_torch.obs` (which evaluates the
registry-derived half from a metrics snapshot file, no service needed).
"""

from __future__ import annotations


from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from tpu_pbrt_torch.obs.metrics import METRICS, PREFIX, MetricsRegistry


@dataclass
class Thresholds:
    """The watchdog's knobs — all deterministic counts/fractions."""

    #: consecutive no-progress step() calls (with runnable jobs) = wedge
    wedge_steps: Optional[int] = None  # None -> cfg.health_wedge_steps

    #: a job's current consecutive re-dispatch attempts = backoff storm
    storm_attempts: int = 3

    #: shed fraction of offered load (with a shed floor) = SLO burn
    slo_burn_fraction: float = 0.5
    slo_burn_min_sheds: int = 3

    #: scrubbed non-finite deposits tolerated before the spike fires
    nonfinite_max: int = 0

    def resolved_wedge_steps(self) -> int:
        if self.wedge_steps is not None:
            return int(self.wedge_steps)
        from tpu_pbrt_torch.config import cfg

        return int(cfg.health_wedge_steps)


@dataclass
class Condition:
    name: str
    firing: bool
    detail: str
    value: Optional[float] = None
    threshold: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "name": self.name, "firing": self.firing, "detail": self.detail,
        }
        if self.value is not None:
            out["value"] = self.value
        if self.threshold is not None:
            out["threshold"] = self.threshold
        return out


@dataclass
class HealthReport:
    conditions: List[Condition] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not any(c.firing for c in self.conditions)

    def firing(self) -> List[str]:
        return [c.name for c in self.conditions if c.firing]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "ok": self.ok,
            "firing": self.firing(),
            "conditions": [c.to_dict() for c in self.conditions],
        }


def _counter_total(registry: MetricsRegistry, name: str) -> float:
    """Sum of a counter across every label series, 0.0 if unregistered."""
    m = registry._metrics.get(PREFIX + name)
    if m is None or m.kind != "counter":
        return 0.0
    return float(sum(m._series.values()))


def _burn_condition(sheds: float, admits: float, th: Thresholds) -> Condition:
    offered = sheds + admits
    frac = sheds / offered if offered > 0 else 0.0
    firing = sheds >= th.slo_burn_min_sheds and frac > th.slo_burn_fraction
    return Condition(
        "slo_burn", firing,
        f"{int(sheds)} shed of {int(offered)} offered "
        f"({frac:.0%}; fires over {th.slo_burn_fraction:.0%} "
        f"with >= {th.slo_burn_min_sheds} sheds)",
        value=round(frac, 4), threshold=th.slo_burn_fraction,
    )


def _nonfinite_condition(total: float, th: Thresholds) -> Condition:
    return Condition(
        "nonfinite_spike", total > th.nonfinite_max,
        f"{int(total)} non-finite deposit(s) scrubbed "
        f"(tolerated: {th.nonfinite_max})",
        value=total, threshold=float(th.nonfinite_max),
    )


def evaluate(
    service=None,
    registry: MetricsRegistry = METRICS,
    thresholds: Optional[Thresholds] = None,
) -> HealthReport:
    """Evaluate every condition against a live service and/or the
    registry. `service=None` evaluates the registry-derived half only
    (wedge/storm report not-applicable rather than guessing)."""
    th = thresholds or Thresholds()
    rep = HealthReport()

    # -- wedge + backoff storm: service-state conditions -------------------
    if service is not None:
        from tpu_pbrt_torch.serve.service import _RUNNABLE

        runnable = [
            j for j in service.jobs.values() if j.status in _RUNNABLE
        ]
        k = th.resolved_wedge_steps()
        gap = service.health_steps - service.last_progress_step
        rep.conditions.append(Condition(
            "wedge", bool(runnable) and gap >= k,
            f"{gap} step(s) since the last cursor advance with "
            f"{len(runnable)} runnable job(s) (fires at {k})",
            value=float(gap), threshold=float(k),
        ))
        storming = [
            j for j in service.jobs.values()
            if j.attempt >= th.storm_attempts
        ]
        worst = max((j.attempt for j in storming), default=0)
        rep.conditions.append(Condition(
            "backoff_storm", bool(storming),
            (
                f"job(s) {sorted(j.job_id for j in storming)} at "
                f">= {th.storm_attempts} consecutive re-dispatch attempts"
                if storming
                else "no job in a live retry streak"
            ),
            value=float(worst), threshold=float(th.storm_attempts),
        ))
    else:
        rep.conditions.append(Condition(
            "wedge", False, "n/a (no service attached)"
        ))
        rep.conditions.append(Condition(
            "backoff_storm", False, "n/a (no service attached)"
        ))

    # -- SLO burn + nonfinite spike: registry-derived ----------------------
    if registry.enabled:
        sheds = _counter_total(registry, "serve_shed_total")
        admits = _counter_total(registry, "serve_submits_total")
        if service is not None and not sheds and not admits:
            # metrics armed after the fact (or reset): the service's own
            # deterministic counts carry the same signal
            sheds = float(service.sheds)
            admits = float(service._seq)
        rep.conditions.append(_burn_condition(sheds, admits, th))
        rep.conditions.append(_nonfinite_condition(
            _counter_total(registry, "render_nonfinite_total"), th
        ))
    elif service is not None:
        rep.conditions.append(_burn_condition(
            float(service.sheds), float(service._seq), th
        ))
        rep.conditions.append(Condition(
            "nonfinite_spike", False, "n/a (metrics registry disabled)"
        ))
    else:
        rep.conditions.append(Condition(
            "slo_burn", False, "n/a (no service or registry)"
        ))
        rep.conditions.append(Condition(
            "nonfinite_spike", False, "n/a (no service or registry)"
        ))
    return rep


def evaluate_snapshot(
    doc: Any, thresholds: Optional[Thresholds] = None
) -> HealthReport:
    """Evaluate the registry-derived conditions from a metrics
    `snapshot()` document (dict, or a path to its JSON) — the offline
    half `python -m tpu_pbrt_torch.obs --health` exposes: no live service, so
    wedge/storm are not applicable."""
    import json

    if isinstance(doc, str):
        with open(doc) as f:
            doc = json.load(f)
    th = thresholds or Thresholds()
    rep = HealthReport()
    rep.conditions.append(Condition(
        "wedge", False, "n/a (snapshot evaluation has no service state)"
    ))
    rep.conditions.append(Condition(
        "backoff_storm", False,
        "n/a (snapshot evaluation has no service state)",
    ))

    def total(name: str) -> float:
        m = (doc.get("metrics") or {}).get(PREFIX + name) or {}
        return float(sum(
            s.get("value", 0) or 0 for s in m.get("series", [])
        ))

    rep.conditions.append(_burn_condition(
        total("serve_shed_total"), total("serve_submits_total"), th
    ))
    rep.conditions.append(
        _nonfinite_condition(total("render_nonfinite_total"), th)
    )
    return rep
