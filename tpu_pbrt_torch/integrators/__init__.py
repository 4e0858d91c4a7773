"""Integrator factory (port of tpu_pbrt/integrators/__init__.py::make_integrator).

Only the path integrator is ported; any other name raises."""

from __future__ import annotations


def make_integrator(name: str, params, scene, options):
    from tpu_pbrt_torch.integrators.path import PathIntegrator
    from tpu_pbrt_torch.utils.error import PbrtError

    if name in ("path", "tpupath"):
        return PathIntegrator(params, scene, options)
    raise PbrtError(f'Integrator "{name}" is not ported to tpu_pbrt_torch yet (ported: "path")')
