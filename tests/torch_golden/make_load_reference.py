"""Write the JAX package's load-harness decision logs that
tests/test_torch_load.py holds the port's to.

For every CI scenario of tpu_pbrt/load/workload.py at seed 7, the
reference's `replay` runs the generated schedule on one replica and on
two (through its FleetRouter), each under a VirtualClock with the stub
pairs of its protocheck harness. Recorded per run: the decision log (one
line per submit, shed, step, advance, wedge), the replay's counts and
health flags. Both packages' logs are pure functions of (scenario,
seed, replicas), so the port's must equal these byte for byte.

Run from the repository root (a few seconds):

    JAX_PLATFORMS=cpu python tests/torch_golden/make_load_reference.py

Writes tests/torch_golden/load_reference.json.gz.
"""

import gzip
import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "load_reference.json.gz")
SEED = 7
REPLICAS = (1, 2)
FIELDS = ("submitted", "sheds", "completed", "failed", "dispatches", "steps",
          "virtual_seconds", "compiles", "residency_hits", "evictions", "preemptions",
          "health_flags", "unfinished", "pin_leaks")


def record(pkg: str, name: str, seed: int = SEED, replicas: int = 1) -> dict:
    """One replay of scenario `name` through package `pkg`: its log and
    its time-free facts."""
    workload = importlib.import_module(f"{pkg}.load.workload")
    replay = importlib.import_module(f"{pkg}.load.replay")
    res = replay.replay(workload.generate(workload.SCENARIOS[name].spec, seed),
                        replicas=replicas)
    return {"log": res.log, **{k: getattr(res, k) for k in FIELDS}}


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from tpu_pbrt.load.workload import CI_SCENARIOS

    out = {"seed": SEED, "runs": {}}
    for name in CI_SCENARIOS:
        for n in REPLICAS:
            out["runs"][f"{name}/r{n}"] = record("tpu_pbrt", name, replicas=n)
    with gzip.open(OUT, "wt") as f:
        json.dump(out, f, sort_keys=True)
    print(f"wrote {OUT}: {len(out['runs'])} runs")


if __name__ == "__main__":
    main()
