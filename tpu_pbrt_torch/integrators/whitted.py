"""WhittedIntegrator (port of tpu_pbrt/integrators/whitted.py): the
direct-lighting wavefront with the all-lights strategy, always."""

from __future__ import annotations

from tpu_pbrt_torch.integrators.direct import DirectLightingIntegrator


class WhittedIntegrator(DirectLightingIntegrator):
    name = "whitted"

    def __init__(self, params, scene, options):
        super().__init__(params, scene, options)
        self.set_strategy("all")
