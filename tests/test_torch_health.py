"""The port's health watchdog (tpu_pbrt_torch/obs/health.py) and its
`python -m tpu_pbrt_torch.obs` front end, held to the reference's.

- `evaluate` over a registry holding the same counter observations, and
  over the same service state (runnable jobs, retry streaks, the step
  gap, the shed and submit counts), gives the reference's report dict
  condition for condition: wedge, backoff_storm, slo_burn and
  nonfinite_spike, each with its detail, value and threshold;
- `evaluate_snapshot` over the same snapshot document does too;
- the front end's metrics selftest passes, its `--health` verdict exits
  non-zero exactly when a condition fires, and the trace and flight
  validators accept a span file and a flight file the port wrote.
"""

import json

import pytest
import torch

from tpu_pbrt.obs import health as jh
from tpu_pbrt.obs import metrics as jm
from tpu_pbrt_torch.obs import __main__ as obs_main
from tpu_pbrt_torch.obs import health as th
from tpu_pbrt_torch.obs import metrics as tm

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

#: name -> [(counter, increment, labels)]
REGISTRY_CASES = {
    "empty": [],
    "clean": [("serve_submits_total", 5, {"tenant": "a"})],
    "burn": [("serve_submits_total", 2, {"tenant": "a"}),
             ("serve_shed_total", 4, {"tenant": "b", "priority": 0})],
    "burn_below_floor": [("serve_submits_total", 1, {"tenant": "a"}),
                         ("serve_shed_total", 2, {"tenant": "b", "priority": 0})],
    "nonfinite": [("serve_submits_total", 3, {"tenant": "a"}),
                  ("render_nonfinite_total", 7, {"tenant": "a"})],
    "both": [("serve_submits_total", 1, {"tenant": "a"}),
             ("serve_shed_total", 9, {"tenant": "a", "priority": 5}),
             ("render_nonfinite_total", 1, {"tenant": "c"})],
}


def _registries(case):
    regs = (jm.MetricsRegistry(force_enabled=True), tm.MetricsRegistry(force_enabled=True))
    for reg in regs:
        for name, n, labels in REGISTRY_CASES[case]:
            reg.counter(name, "test counter").inc(n, **labels)
    return regs


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_conditions_match_the_reference(case):
    jreg, treg = _registries(case)
    ours = th.evaluate(None, registry=treg).to_dict()
    assert ours == jh.evaluate(None, registry=jreg).to_dict()
    assert ours["ok"] == (case in ("empty", "clean", "burn_below_floor"))


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_snapshot_conditions_match_the_reference(case):
    jreg, treg = _registries(case)
    doc = treg.snapshot()
    assert doc == jreg.snapshot()
    assert th.evaluate_snapshot(doc).to_dict() == jh.evaluate_snapshot(doc).to_dict()


class _Job:
    def __init__(self, job_id, status, attempt=0):
        self.job_id, self.status, self.attempt = job_id, status, attempt


class _Service:
    def __init__(self, jobs, steps, last, sheds=0, seq=0):
        self.jobs = {j.job_id: j for j in jobs}
        self.health_steps, self.last_progress_step = steps, last
        self.sheds, self._seq = sheds, seq


SERVICE_CASES = {
    "idle": _Service([], 40, 0),
    "progressing": _Service([_Job("j1", "active")], 20, 19, seq=1),
    "wedged": _Service([_Job("j1", "queued"), _Job("j2", "parked")], 30, 10, seq=2),
    "wedge_threshold": _Service([_Job("j1", "active")], 12, 0, seq=1),
    "storm": _Service([_Job("j1", "active", attempt=3), _Job("j2", "done", attempt=5)], 4, 3,
                      seq=2),
    "paused_only": _Service([_Job("j1", "paused")], 50, 0, seq=1),
    "sheds_without_registry": _Service([_Job("j1", "done")], 5, 5, sheds=4, seq=1),
}


@pytest.mark.parametrize("case", sorted(SERVICE_CASES))
def test_service_conditions_match_the_reference(case):
    svc = SERVICE_CASES[case]
    jreg, treg = (jm.MetricsRegistry(force_enabled=True), tm.MetricsRegistry(force_enabled=True))
    ours = th.evaluate(svc, registry=treg).to_dict()
    assert ours == jh.evaluate(svc, registry=jreg).to_dict()
    firing = {"wedged": ["wedge"], "wedge_threshold": ["wedge"], "storm": ["backoff_storm"],
              "sheds_without_registry": ["slo_burn"]}.get(case, [])
    assert ours["firing"] == firing


def test_thresholds_override_matches_the_reference():
    svc = SERVICE_CASES["progressing"]
    kw = dict(wedge_steps=1, storm_attempts=1, slo_burn_fraction=0.1, slo_burn_min_sheds=1,
              nonfinite_max=3)
    jreg, treg = _registries("both")
    ours = th.evaluate(svc, registry=treg, thresholds=th.Thresholds(**kw)).to_dict()
    assert ours == jh.evaluate(svc, registry=jreg, thresholds=jh.Thresholds(**kw)).to_dict()


def test_obs_front_end(tmp_path, capsys):
    from tpu_pbrt_torch.obs.flight import FLIGHT
    from tpu_pbrt_torch.obs.trace import TRACE

    assert obs_main.main(["--metrics-selftest"]) == 0
    for case, rc in (("clean", 0), ("burn", 1)):
        snap = tmp_path / f"{case}.json"
        snap.write_text(json.dumps(_registries(case)[1].snapshot()))
        assert obs_main.main(["--metrics-snapshot", str(snap), "--health"]) == rc
    trace, flight = tmp_path / "t.json", tmp_path / "f.jsonl"
    try:
        TRACE.configure(str(trace))
        FLIGHT.configure(str(flight))
        with TRACE.span("serve/slice", job="j1"):
            FLIGHT.heartbeat("render", chunk=0)
        FLIGHT.heartbeat("develop")
        TRACE.maybe_export()
    finally:
        TRACE.configure(None)
        TRACE.reset()
        FLIGHT.configure(None)
    assert obs_main.main([str(trace), "--flight", str(flight),
                          "--require-phases", "render,develop"]) == 0
    assert obs_main.main([str(trace), "--flight", str(flight),
                          "--require-phases", "serve_done"]) != 0
    capsys.readouterr()
