"""Host-side observability of the port: the wave counters (counters),
the flight recorder (flight), the metrics registry (metrics), the span
tracer (trace) and the health watchdog (health); `python -m
tpu_pbrt_torch.obs` validates exported trace, flight and metrics files.

Submodules resolve lazily, as the reference's do, so that importing
one of them does not import the others.
"""

import importlib

_SUBMODULES = ("counters", "flight", "health", "metrics", "trace")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"tpu_pbrt_torch.obs.{name}")
    raise AttributeError(f"module 'tpu_pbrt_torch.obs' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
