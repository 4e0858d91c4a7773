"""The port's load harness (tpu_pbrt_torch/load/) on the CPU, held to the
reference's tests/test_load.py behaviours and to the reference's own
output.

Oracles:

- SCHEDULES: the workload generator is a code copy of the reference's
  (tests/test_torch_isolation.py), and `schedule_text()` is byte-identical
  to the reference's for every registered scenario at two seeds (a live
  call on both packages: the generator is pure Python).
- DECISIONS: the replay drives the port's real RenderService (and, with
  two replicas, its FleetRouter) on a VirtualClock through the stub pairs
  of analysis/protocheck.py; every CI scenario's decision log and
  counts equal the reference's, stored by
  tests/torch_golden/make_load_reference.py (load_reference.json.gz).
- CAPACITY: `--capacity steady` reports LOADTEST_baseline.json's knee
  and ladder exactly (virtual-time decisions of the same policy).
- The cases of tests/test_load.py (determinism, burst shedding, the p99
  gate, capture-replay, health gating, residency counts) and the two
  replay cases of tests/test_fleet.py, on the port.
"""

import gzip
import json
import os

import pytest
import torch

from tpu_pbrt.load import workload as ref_workload
from tpu_pbrt_torch.load.gates import (
    capacity_sweep,
    evaluate_gates,
    gate_determinism,
    gate_p99_wait,
    snapshot_wait_p99,
)
from tpu_pbrt_torch.load.replay import replay, workload_from_flight
from tpu_pbrt_torch.load.workload import CI_SCENARIOS, SCENARIOS, generate

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
with gzip.open(os.path.join(HERE, "torch_golden", "load_reference.json.gz"), "rt") as f:
    GOLDEN = json.load(f)


# --------------------------------------------------------------------------
# the reference's own output
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [7, 123])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_schedule_text_is_the_reference_s(name, seed):
    ours = generate(SCENARIOS[name].spec, seed).schedule_text()
    theirs = ref_workload.generate(ref_workload.SCENARIOS[name].spec, seed).schedule_text()
    assert ours == theirs


@pytest.mark.parametrize("replicas", [1, 2])
@pytest.mark.parametrize("name", list(CI_SCENARIOS))
def test_decision_log_is_the_reference_s(name, replicas):
    import sys

    sys.path.insert(0, os.path.join(HERE, "torch_golden"))
    import make_load_reference as gen

    want = GOLDEN["runs"][f"{name}/r{replicas}"]
    got = json.loads(json.dumps(gen.record("tpu_pbrt_torch", name, GOLDEN["seed"], replicas)))
    assert len(got["log"]) == len(want["log"])
    for i, (a, b) in enumerate(zip(got["log"], want["log"])):
        assert a == b, f"line {i}: {a!r} != {b!r}"
    assert {k: v for k, v in got.items() if k != "log"} == \
        {k: v for k, v in want.items() if k != "log"}


def test_capacity_knee_and_ladder_are_the_baseline_s():
    from tpu_pbrt_torch.load.__main__ import (
        CI_CAPACITY_MULTIPLIERS,
        CI_CAPACITY_P99_S,
    )

    with open(os.path.join(ROOT, "LOADTEST_baseline.json")) as f:
        base = json.load(f)["capacity"]["steady"]
    cap = capacity_sweep(SCENARIOS["steady"], base["seed"],
                         multipliers=CI_CAPACITY_MULTIPLIERS, p99_target_s=CI_CAPACITY_P99_S)
    assert cap["knee_req_s"] == base["knee_req_s"] == 159.5
    assert json.loads(json.dumps(cap)) == base


def test_ci_smoke_passes_every_gate(tmp_path, capsys):
    from tpu_pbrt_torch.load.__main__ import run

    report = tmp_path / "report.json"
    assert run(["--ci", "--report", str(report)]) == 0
    rep = json.loads(report.read_text())
    assert set(rep["scenarios"]) == set(CI_SCENARIOS)
    assert all(s["ok"] for s in rep["scenarios"].values())
    assert rep["capacity"]["steady"]["knee_req_s"] == 159.5
    assert "knee=159.5 req/s" in capsys.readouterr().out


# --------------------------------------------------------------------------
# tests/test_load.py on the port
# --------------------------------------------------------------------------


def test_same_seed_schedule_byte_identity():
    spec = SCENARIOS["steady"].spec
    a = generate(spec, 123)
    b = generate(spec, 123)
    assert a.schedule_text() == b.schedule_text()
    assert a.requests == b.requests


def test_different_seed_diverges():
    spec = SCENARIOS["steady"].spec
    assert generate(spec, 1).schedule_text() != generate(spec, 2).schedule_text()


def test_same_seed_decision_log_byte_identity():
    wl = generate(SCENARIOS["steady"].spec, 5)
    a = replay(wl)
    b = replay(wl)
    g = gate_determinism(a, b)
    assert g.ok, g.detail
    assert a.log_text() == b.log_text()
    # the registry-derived gate inputs must agree too, not just the log
    assert snapshot_wait_p99(a.snapshot, 0) == snapshot_wait_p99(b.snapshot, 0)


def test_burst_scenario_sheds_deterministically():
    wl = generate(SCENARIOS["burst"].spec, 7)
    a = replay(wl)
    b = replay(wl)
    assert a.sheds > 0, "burst scenario must engage SLO shedding"
    assert a.sheds == b.sheds
    sheds_a = [ln for ln in a.log if "-> shed:" in ln]
    sheds_b = [ln for ln in b.log if "-> shed:" in ln]
    assert sheds_a == sheds_b and len(sheds_a) == a.sheds
    assert a.completed == a.submitted
    assert not a.pin_leaks


def test_p99_gate_positive_and_negative():
    res = replay(generate(SCENARIOS["steady"].spec, 7))
    p99 = snapshot_wait_p99(res.snapshot, 0)
    assert p99 is not None and p99 > 0
    assert gate_p99_wait(res, 0, target_s=10.0).ok
    assert not gate_p99_wait(res, 0, target_s=p99 / 2).ok
    missing = gate_p99_wait(res, 99, target_s=10.0)
    assert not missing.ok and missing.value is None


def test_capture_replay_round_trip(tmp_path):
    flight = str(tmp_path / "flight.jsonl")
    wl = generate(SCENARIOS["editstorm"].spec, 11)
    first = replay(wl, flight_path=flight)
    rebuilt = workload_from_flight(flight)
    assert rebuilt.spec == wl.spec
    assert rebuilt.requests == wl.requests
    assert rebuilt.schedule_text() == wl.schedule_text()
    assert replay(rebuilt).log == first.log


def test_capture_replay_serve_fallback(tmp_path):
    flight = str(tmp_path / "flight.jsonl")
    wl = generate(SCENARIOS["steady"].spec, 3)
    first = replay(wl, flight_path=flight)
    os.remove(flight)  # drop the harness header + load_submit lines
    rebuilt = workload_from_flight(flight)
    assert len(rebuilt.requests) == first.submitted
    assert {r.scene for r in rebuilt.requests} == {r.scene for r in wl.requests}
    orig = {r.scene: r.chunks for r in wl.requests}
    for r in rebuilt.requests:
        assert r.chunks == orig[r.scene]


def test_capture_replay_empty_log_raises(tmp_path):
    with pytest.raises(ValueError, match="nothing to reconstruct"):
        workload_from_flight(str(tmp_path / "nope.jsonl"))


@pytest.mark.parametrize("name", ["steady", "burst", "heavy", "editstorm"])
def test_clean_scenarios_zero_health_false_positives(name):
    res = replay(generate(SCENARIOS[name].spec, 7))
    assert res.health_flags == [], f"{name}: watchdog fired {res.health_flags} on clean traffic"


def test_storm_scenarios_must_flag():
    res = replay(generate(SCENARIOS["retrystorm"].spec, 7))
    assert "backoff_storm" in res.health_flags
    assert res.failed == 0 and not res.unfinished  # retry_max recovers
    res = replay(generate(SCENARIOS["shedstorm"].spec, 7))
    assert "slo_burn" in res.health_flags


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_all_registered_scenarios_pass_their_gates(name):
    scn = SCENARIOS[name]
    res = replay(generate(scn.spec, 7))
    bad = [g for g in evaluate_gates(res, scn.gates) if not g.ok]
    assert not bad, f"{name}: {[(g.name, g.detail) for g in bad]}"


def test_residency_behavior_editstorm():
    wl = generate(SCENARIOS["editstorm"].spec, 7)
    res = replay(wl)
    distinct_keys = len({r.scene for r in wl.requests})
    assert res.compiles == distinct_keys
    assert res.residency_hits == len(wl.requests) - distinct_keys
    assert res.residency_hits > 0


# --------------------------------------------------------------------------
# tests/test_fleet.py's replay cases on the port
# --------------------------------------------------------------------------


def test_fleet_replay_is_byte_deterministic_and_spreads():
    wl = generate(SCENARIOS["editstorm"].spec, 7)
    a = replay(wl, replicas=2)
    b = replay(wl, replicas=2)
    assert a.log_text() == b.log_text()
    owners = {ln.rsplit("@", 1)[1] for ln in a.log if "-> ok@" in ln}
    assert owners == {"r0", "r1"}  # the editstorm key set splits
    assert a.failed == 0 and not a.unfinished
    assert a.completed == a.submitted
    assert not a.pin_leaks


def test_fleet_replay_single_replica_path_untouched():
    wl = generate(SCENARIOS["steady"].spec, 7)
    assert replay(wl).log_text() == replay(wl, replicas=1).log_text()


def test_stub_harness_reference_state_matches_the_reference_s():
    """The stub film the replays deposit is the reference's, bit for
    bit (the harness is ported over the port's FilmState)."""
    import numpy as np

    from tpu_pbrt.analysis.protocheck import _harness as ref_harness
    from tpu_pbrt_torch.analysis.protocheck import RAYS_PER_CHUNK, _harness

    ours = _harness()["reference_state"](5)
    theirs = ref_harness()["reference_state"](5)
    for a, b in zip(ours, theirs):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert RAYS_PER_CHUNK == 64
