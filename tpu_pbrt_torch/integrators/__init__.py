"""Integrator factory (port of tpu_pbrt/integrators/__init__.py::make_integrator).

`path` (alias `tpupath`), `directlighting`, `whitted`, `ao`, `volpath`,
`bdpt`, `sppm` and `mlt` are ported; any other name raises PbrtError."""

from __future__ import annotations

#: integrator names the port renders
PORTED = ("path", "tpupath", "directlighting", "whitted", "ao", "volpath", "bdpt", "sppm",
          "mlt")


def check_ported(name: str) -> None:
    """Raise PbrtError naming `name` unless the port renders it."""
    if name not in PORTED:
        from tpu_pbrt_torch.utils.error import PbrtError

        raise PbrtError(f'Integrator "{name}" is not ported to tpu_pbrt_torch yet '
                        f"(ported: {', '.join(PORTED)})")


def make_integrator(name: str, params, scene, options):
    check_ported(name)
    if name in ("path", "tpupath"):
        from tpu_pbrt_torch.integrators.path import PathIntegrator as cls
    elif name == "directlighting":
        from tpu_pbrt_torch.integrators.direct import DirectLightingIntegrator as cls
    elif name == "whitted":
        from tpu_pbrt_torch.integrators.whitted import WhittedIntegrator as cls
    elif name == "volpath":
        from tpu_pbrt_torch.integrators.volpath import VolPathIntegrator as cls
    elif name == "bdpt":
        from tpu_pbrt_torch.integrators.bdpt import BDPTIntegrator as cls
    elif name == "sppm":
        from tpu_pbrt_torch.integrators.sppm import SPPMIntegrator as cls
    elif name == "mlt":
        from tpu_pbrt_torch.integrators.mlt import MLTIntegrator as cls
    else:
        from tpu_pbrt_torch.integrators.ao import AOIntegrator as cls
    return cls(params, scene, options)
