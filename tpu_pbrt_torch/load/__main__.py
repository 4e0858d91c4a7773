"""``python -m tpu_pbrt_torch.load`` — the load-harness CLI.

Modes:

- default / ``--scenario NAME`` — run named scenarios (or all) with
  their gates and print a pass/fail table;
- ``--ci`` — the CI smoke: every CI scenario at a fixed seed plus a
  small capacity sweep, under a wall-seconds budget, exiting nonzero
  on any gate failure or budget overrun;
- ``--capacity NAME`` — the arrival-rate sweep: report the knee (max
  sustainable req/s per replica at the SLO);
- ``--replicas N`` — replay through the fleet router over N replicas
  under one VirtualClock (decision logs stay byte-identical per
  (spec, seed, N); the gates read fleet-wide aggregates);
- ``--list`` — the scenario registry with specs.

``--report`` writes the deterministic JSON report (no wall times, no
paths) that LOADTEST_baseline.json pins; ``--trace-out`` exports the
first scenario replay's tpu-scope trace in virtual time (the smoke
feeds it to ``tools/scope.py --check``); ``--flight-out`` arms the
flight recorder (the capture-replay source).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict, List, Optional

from tpu_pbrt_torch.load.gates import capacity_sweep, evaluate_scenario
from tpu_pbrt_torch.load.workload import CI_SCENARIOS, SCENARIOS

#: wall-seconds the --ci smoke may spend before failing (the whole
#: point is hours of virtual traffic in seconds of wall time — a smoke
#: that crawls has lost the accelerated-replay property)
CI_BUDGET_S = 240.0

#: the --ci capacity sweep: scenario, ladder, SLO target
CI_CAPACITY_SCENARIO = "steady"
CI_CAPACITY_MULTIPLIERS = (0.5, 1.0, 2.0, 4.0, 8.0)
CI_CAPACITY_P99_S = 0.5


def _print_report(rep) -> None:
    mark = "ok " if rep.ok else "FAIL"
    print(f"[{mark}] {rep.scenario} (seed {rep.seed}): "
          f"{len(rep.result.workload.requests)} requests, "
          f"{rep.result.submitted} admitted, {rep.result.sheds} shed, "
          f"{rep.result.completed} done in "
          f"{rep.result.virtual_seconds:.3f} virtual s")
    for g in rep.gates:
        gm = "ok " if g.ok else "FAIL"
        print(f"    [{gm}] {g.name}: value={g.value} target={g.target}"
              + (f" ({g.detail})" if g.detail and not g.ok else ""))


def _print_capacity(cap: Dict[str, Any]) -> None:
    knee = cap["knee_req_s"]
    print(f"capacity[{cap['scenario']}] seed {cap['seed']} "
          f"p99_target={cap['p99_target_s']}s -> knee="
          + (f"{knee:g} req/s" if knee is not None else "NONE"))
    for rung in cap["ladder"]:
        mark = "sustainable" if rung["sustainable"] else "over"
        print(f"    x{rung['rate_multiplier']:g}: "
              f"{rung['offered_req_s']:g} req/s offered, "
              f"{rung['sheds']} shed, p99={rung['p99_wait_s']} "
              f"-> {mark}")


def run(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_pbrt_torch.load",
        description="deterministic traffic-replay load harness",
    )
    ap.add_argument("--scenario", action="append", default=None,
                    help="scenario name (repeatable; default: all)")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--replicas", type=int, default=1,
                    help="fleet width: replay through the router over "
                         "N serve replicas (default 1 = no router)")
    ap.add_argument("--ci", action="store_true",
                    help="CI smoke: gate every CI scenario + capacity "
                         "sweep under a wall budget")
    ap.add_argument("--capacity", metavar="NAME", default=None,
                    help="sweep arrival rate on NAME and report the "
                         "sustainable-req/s knee")
    ap.add_argument("--budget-s", type=float, default=None,
                    help=f"wall-seconds budget (default {CI_BUDGET_S:g} "
                         "with --ci, unlimited otherwise)")
    ap.add_argument("--report", metavar="PATH", default=None,
                    help="write the deterministic JSON report "
                         "('-' = stdout)")
    ap.add_argument("--trace-out", metavar="PATH", default=None,
                    help="export the first scenario's virtual-time "
                         "tpu-scope trace")
    ap.add_argument("--flight-out", metavar="PATH", default=None,
                    help="arm the flight recorder for the first "
                         "scenario (capture-replay source)")
    ap.add_argument("--list", action="store_true",
                    help="list the scenario registry")
    args = ap.parse_args(argv)

    if args.list:
        for name, scn in SCENARIOS.items():
            tags = []
            if scn.ci:
                tags.append("ci")
            if scn.gates.health_must_flag:
                tags.append(
                    "must-flag:" + ",".join(scn.gates.health_must_flag)
                )
            print(f"{name:<12s} rate={scn.spec.rate:g}/s "
                  f"dur={scn.spec.duration_s:g}s "
                  f"tenants={scn.spec.tenants}"
                  + (f" slo_depth={scn.spec.slo_depth}"
                     if scn.spec.slo_depth else "")
                  + (f" fault={scn.spec.fault}" if scn.spec.fault else "")
                  + (f"  [{' '.join(tags)}]" if tags else ""))
        return 0

    t_wall = time.perf_counter()
    budget = args.budget_s
    if budget is None and args.ci:
        budget = CI_BUDGET_S

    names: List[str]
    if args.ci:
        names = list(CI_SCENARIOS)
    elif args.scenario:
        names = list(args.scenario)
    elif args.capacity:
        names = []
    else:
        names = list(SCENARIOS)
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown or (args.capacity and args.capacity not in SCENARIOS):
        bad = unknown or [args.capacity]
        print(f"unknown scenario(s): {', '.join(bad)} "
              f"(--list shows the registry)", file=sys.stderr)
        return 2

    report: Dict[str, Any] = {
        "schema": "tpu-pbrt-loadtest-v1",
        "seed": args.seed,
        "scenarios": {},
        "capacity": {},
    }
    if args.replicas != 1:
        report["replicas"] = args.replicas
    failed = False
    for i, name in enumerate(names):
        rep = evaluate_scenario(
            SCENARIOS[name], args.seed,
            replicas=args.replicas,
            flight_path=args.flight_out if i == 0 else None,
            trace_path=args.trace_out if i == 0 else None,
        )
        _print_report(rep)
        report["scenarios"][name] = rep.to_dict()
        failed = failed or not rep.ok

    cap_name = args.capacity or (CI_CAPACITY_SCENARIO if args.ci else None)
    if cap_name:
        cap = capacity_sweep(
            SCENARIOS[cap_name], args.seed,
            multipliers=CI_CAPACITY_MULTIPLIERS,
            p99_target_s=CI_CAPACITY_P99_S,
        )
        _print_capacity(cap)
        report["capacity"][cap_name] = cap
        if cap["knee_req_s"] is None:
            # the sweep exists to EMIT a capacity number; a ladder with
            # no sustainable rung means the scenario/SLO pairing is
            # mistuned, and the capacity-planning consumer gets nothing
            print("capacity sweep found no sustainable rung",
                  file=sys.stderr)
            failed = True

    wall = time.perf_counter() - t_wall
    print(f"wall: {wall:.1f}s"
          + (f" (budget {budget:g}s)" if budget is not None else ""))
    if budget is not None and wall > budget:
        print(f"FAIL: wall budget exceeded ({wall:.1f}s > {budget:g}s)",
              file=sys.stderr)
        failed = True

    if args.report:
        text = json.dumps(report, indent=1, sort_keys=True)
        if args.report == "-":
            print(text)
        else:
            with open(args.report, "w") as f:
                f.write(text + "\n")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(run())
