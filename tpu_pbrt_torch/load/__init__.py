"""The load harness: deterministic traffic replay over the port's
render service (port of tpu_pbrt/load/).

The serve stack's policies — WFQ, SLO shedding, preemption, backoff,
health verdicts — were each tuned against hand-written selftests. This
package proves them against TRAFFIC: a seeded workload generator
(`workload.py`) emits a timestamped request schedule that is a pure
function of (seed, spec); a replay engine (`replay.py`) drives the REAL
`RenderService` with that schedule under a `VirtualClock`, so hours of
simulated multi-tenant traffic run in seconds of wall time with a
byte-reproducible decision log; and a gate layer (`gates.py`) asserts
fleet invariants over the run's metrics-registry snapshot — shed
fraction under burst, per-class p99 queue wait, zero health-watchdog
false positives on clean scenarios, pin balance at drain.

Entry point: ``python -m tpu_pbrt_torch.load`` (see ``__main__.py``) — the
``--ci`` smoke the CI pipeline runs, and the ``--capacity`` sweep that
reports the max sustainable req/s knee the fleet-router direction
needs.

Determinism contract (the whole point): same (scenario, seed) =>
byte-identical schedule AND byte-identical service decision log. The
generator draws only from `random.Random(...)` seeded from (name,
seed); the replay clock is virtual; every log line is path-free.
"""

from tpu_pbrt_torch.load.workload import (  # noqa: F401
    Request,
    SCENARIOS,
    Workload,
    WorkloadSpec,
    generate,
)
