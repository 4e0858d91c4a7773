"""The fleet layer of the port: a front-door router spreading jobs
across N render-service replicas (the reference's fleet/), with

- scene-affinity consistent hashing: a resubmit of the same scene lands
  on the replica where the compiled scene is already resident (zero
  scene compiles on the warm path);
- fleet-level shedding at the edge: the offered arrival rate against
  `knee_req_s x healthy replicas`, before any replica compiles;
- drain/failover: a replica whose `health` verb fires wedge or
  backoff-storm is drained; its jobs resume on another replica through
  the durable checkpoint-v4 spool, with a double-delivery dedup window
  so a job never renders twice.

Replicas come in two kinds behind one handle interface: `LocalReplica`
(an in-process RenderService under an injected clock, the
deterministic-testing shape) and `fleet.daemon.DaemonReplica` (a child
`python -m tpu_pbrt_torch.serve` JSONL daemon).

Frontends: this library API and `python -m tpu_pbrt_torch.fleet --selftest`.
"""

from tpu_pbrt_torch.fleet.router import (
    KNEE_REQ_S,
    FleetPolicy,
    FleetRouter,
    LocalReplica,
    fleet_size,
)

__all__ = [
    "KNEE_REQ_S", "FleetPolicy", "FleetRouter", "LocalReplica",
    "fleet_size",
]
