"""The render service of the port: resident compiled scenes
(serve/residency.py), a priority + weighted-fair queue with
deterministic scheduling (serve/queue.py), and resumable render jobs
preempted at wave granularity through the checkpoint-v4 path
(serve/service.py). Frontends: this library API, the stdin/JSONL daemon
(`python -m tpu_pbrt_torch.serve`, `--selftest` for the smoke) and
`python -m tpu_pbrt_torch.main --serve`.
"""

from tpu_pbrt_torch.serve.queue import (
    FairScheduler,
    SloPolicy,
    parse_slo_spec,
    preemption_victim,
)
from tpu_pbrt_torch.serve.residency import (
    ResidencyCache,
    ResidentScene,
    scene_hbm_bytes,
    scene_source_key,
)
from tpu_pbrt_torch.serve.service import (
    ACTIVE,
    CANCELLED,
    DONE,
    FAILED,
    PARKED,
    PAUSED,
    QUEUED,
    RenderJob,
    RenderService,
    ShedError,
)

__all__ = [
    "ACTIVE", "CANCELLED", "DONE", "FAILED", "PARKED", "PAUSED", "QUEUED",
    "FairScheduler", "SloPolicy", "parse_slo_spec", "preemption_victim",
    "ResidencyCache", "ResidentScene", "scene_hbm_bytes",
    "scene_source_key",
    "RenderJob", "RenderService", "ShedError",
]
