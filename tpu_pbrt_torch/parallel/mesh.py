"""Device-layout decisions of the render loop (port of the single-device
part of tpu_pbrt/parallel/mesh.py).

Only `resolve_pipeline_depth` is here: the in-flight window depth the
render loop runs at. The mesh, the sharded renderers and the process
group (several GPUs) are not ported yet.
"""

from __future__ import annotations


def resolve_pipeline_depth(mesh=None) -> int:
    """How many chunk-slices the render loop keeps dispatched ahead of the
    host: TORCH_PBRT_PIPELINE (default 2), at least 1; depth 1 is the
    synchronous dispatch/block/host-work loop.

    The strict film-firewall modes (TORCH_PBRT_NONFINITE=raise|retry)
    force depth 1: they read each chunk's scrub count before the next
    dispatch may trust the film, a per-chunk sync the window cannot hide,
    and checking at once keeps the failure on the chunk that scrubbed.
    `mesh` is accepted for the reference's call signature."""
    from tpu_pbrt_torch.config import cfg

    if cfg.nonfinite != "scrub":
        return 1
    return max(1, int(cfg.pipeline))
