"""Integrator plugin registry (port of tpu_pbrt/integrators/__init__.py).

pbrt-v3 api.cpp MakeIntegrator's string-dispatched factory: a scene file's
`Integrator "name"` selects the class. The built-in names are PORTED;
`register_integrator(name, cls)` adds a class under a name, and a
registered name overrides a built-in one, as in the reference. Any other
name raises PbrtError listing the available ones.
"""

from __future__ import annotations

import importlib

#: built-in name -> (module under tpu_pbrt_torch.integrators, class name)
_BUILTIN = {
    "path": ("path", "PathIntegrator"),
    "tpupath": ("path", "PathIntegrator"),
    "directlighting": ("direct", "DirectLightingIntegrator"),
    "whitted": ("whitted", "WhittedIntegrator"),
    "ao": ("ao", "AOIntegrator"),
    "volpath": ("volpath", "VolPathIntegrator"),
    "bdpt": ("bdpt", "BDPTIntegrator"),
    "sppm": ("sppm", "SPPMIntegrator"),
    "mlt": ("mlt", "MLTIntegrator"),
}

#: integrator names built into the port
PORTED = tuple(_BUILTIN)

#: registered name -> class (overrides a built-in of the same name)
_REGISTRY = {}


def register_integrator(name: str, cls) -> None:
    """Make `Integrator "name"` construct cls(params, scene, options)."""
    _REGISTRY[name] = cls


def available() -> list:
    """Every name make_integrator accepts, sorted."""
    return sorted(set(PORTED) | set(_REGISTRY))


def check_ported(name: str) -> None:
    """Raise PbrtError naming `name` and the available integrators unless
    `name` is built in or registered."""
    if name not in _REGISTRY and name not in PORTED:
        from tpu_pbrt_torch.utils.error import PbrtError

        raise PbrtError(f'Integrator "{name}" unknown or not implemented. '
                        f"Available: {available()}")


def make_integrator(name: str, params, scene, options):
    check_ported(name)
    cls = _REGISTRY.get(name)
    if cls is None:
        module, cls_name = _BUILTIN[name]
        cls = getattr(importlib.import_module(f"tpu_pbrt_torch.integrators.{module}"), cls_name)
    return cls(params, scene, options)
