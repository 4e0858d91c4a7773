"""Resident-scene cache: compiled scenes and their integrators, LRU by
device-memory footprint (the reference's serve/residency.py).

A scene compile (BVH build, material and texture baking, the upload to
the card) costs far more than rendering one chunk, so a repeat submit
of a warm scene must pay none. Residency keeps three things together:

- the `CompiledScene`, whose `dev` dict holds the device-resident
  geometry, stream-tracer, material, texture and light tables;
- the integrator bound to it (its plan pieces, such as the capacity
  audit's memo, live on it);
- the accounting that evicts cold entries once the footprint budget is
  exceeded (LRU by a monotonic touch counter, never the wall clock, so
  eviction order is deterministic and replayable).

Entries are keyed by the scene source (file path + mtime/size, or a
content hash for inline text), known before compiling, which is what
lets a hit skip the compile. The render fingerprint
(`parallel/checkpoint.render_fingerprint`) of every plan built against
an entry is indexed alongside.

Pinning: a scene referenced by a live (queued/active/parked) job cannot
be evicted; an over-budget cache of pinned scenes stays over budget
(visible in stats) rather than pulling tables from under a running job.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from tpu_pbrt_torch.obs.metrics import METRICS
from tpu_pbrt_torch.utils.clock import WALL

#: film-accumulator bytes per pixel: FilmState rgb + weight + splat, all f32
FILM_BYTES_PER_PIXEL = 4 * (3 + 1 + 3)


def _tensor_bytes(obj, seen) -> int:
    """Bytes of every torch tensor reachable from obj through dicts,
    lists, tuples and object attributes, each tensor counted once."""
    if id(obj) in seen:
        return 0
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_tensor_bytes(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(v, seen) for v in obj)
    if isinstance(obj, (str, bytes, int, float, bool, type(None))):
        return 0
    fields = getattr(obj, "__dict__", None)
    if fields is not None:
        return sum(_tensor_bytes(v, seen) for v in fields.values())
    slots = getattr(type(obj), "__slots__", ())
    return sum(_tensor_bytes(getattr(obj, s), seen) for s in slots if hasattr(obj, s))


def scene_hbm_bytes(scene) -> int:
    """Device-resident footprint of a compiled scene: the bytes of every
    tensor in its `dev` tables (geometry, stream-tracer tables,
    materials, texture atlas, light tables) plus one film-state
    allocation (the accumulator a job of this scene will hold)."""
    total = _tensor_bytes(scene.dev, set())
    rx, ry = scene.film.full_resolution
    total += rx * ry * FILM_BYTES_PER_PIXEL
    return total


def scene_source_key(
    path: Optional[str] = None, text: Optional[str] = None,
    extra: Tuple = (),
) -> str:
    """Residency key computable BEFORE compiling: file identity
    (abspath + mtime_ns + size — a rewritten file is a different scene)
    or a content hash for inline text, plus `extra` (render-affecting
    option overrides like crop/quick, which change the compiled film)."""
    h = hashlib.sha1()
    if path is not None:
        p = os.path.abspath(path)
        st = os.stat(p)
        h.update(f"file:{p}:{st.st_mtime_ns}:{st.st_size}".encode())
    elif text is not None:
        h.update(b"text:")
        h.update(text.encode())
    else:
        raise ValueError("scene_source_key needs a path or text")
    for item in extra:
        h.update(f":{item}".encode())
    return h.hexdigest()[:16]


@dataclass
class ResidentScene:
    """One cache entry: the compiled pair + accounting."""

    key: str
    scene: Any
    integrator: Any
    hbm_bytes: int
    compile_seconds: float
    pins: int = 0
    last_used: int = 0  # monotonic touch counter (deterministic LRU)
    hits: int = 0
    #: render_fingerprints of plans built against this entry (grows as
    #: jobs with different slice widths schedule on it)
    fingerprints: set = field(default_factory=set)


class ResidencyCache:
    """LRU-by-HBM-footprint cache of ResidentScene entries."""

    def __init__(self, max_bytes: Optional[int] = None, clock=None):
        self.max_bytes = max_bytes
        #: time source for compile-duration measurement only. The LRU
        #: order below runs on `_clock`, the integer touch counter —
        #: never this — so virtual-time harness runs and wall-clock
        #: serving evict in the same order.
        self.clock = clock if clock is not None else WALL
        self._entries: Dict[str, ResidentScene] = {}
        self._clock = 0
        self.scene_compiles = 0
        self.hits = 0
        self.evictions = 0

    # -- core --------------------------------------------------------------
    def _touch(self, ent: ResidentScene) -> None:
        self._clock += 1
        ent.last_used = self._clock

    def get(self, key: str) -> Optional[ResidentScene]:
        ent = self._entries.get(key)
        if ent is not None:
            self._touch(ent)
        return ent

    def get_or_compile(
        self, key: str, builder: Callable[[], Tuple[Any, Any]],
    ) -> ResidentScene:
        """The submit path: a hit costs a dict lookup; a miss runs
        `builder() -> (scene, integrator)` (parse + compile + upload),
        inserts, and evicts cold unpinned entries past the budget."""
        ent = self._entries.get(key)
        if ent is not None:
            ent.hits += 1
            self.hits += 1
            METRICS.counter(
                "residency_hits_total",
                "submits served from a resident compiled scene",
            ).inc()
            self._touch(ent)
            return ent
        t0 = self.clock.monotonic()
        scene, integ = builder()
        self.scene_compiles += 1
        METRICS.counter(
            "residency_misses_total",
            "submits that paid a scene compile",
        ).inc()
        ent = ResidentScene(
            key=key, scene=scene, integrator=integ,
            hbm_bytes=scene_hbm_bytes(scene),
            compile_seconds=self.clock.monotonic() - t0,
        )
        self._entries[key] = ent
        self._touch(ent)
        # the entry being handed back must survive this call's eviction
        # even when it alone exceeds the budget (the caller is about to
        # pin and use it; evicting it here would dangle the reference)
        ent.pins += 1
        try:
            self.evict_over_budget()
        finally:
            ent.pins -= 1
        return ent

    def find_by_fingerprint(self, fingerprint: str) -> Optional[ResidentScene]:
        """Entry whose compiled plans include this render fingerprint
        (`parallel/checkpoint.render_fingerprint`) — the lookup that
        lets a checkpoint written by another process resume onto an
        already-resident scene without recompiling."""
        for ent in self._entries.values():
            if fingerprint in ent.fingerprints:
                self._touch(ent)
                return ent
        return None

    # -- pinning / eviction ------------------------------------------------
    def pin(self, key: str) -> None:
        self._entries[key].pins += 1

    def unpin(self, key: str) -> None:
        ent = self._entries.get(key)
        if ent is not None and ent.pins > 0:
            ent.pins -= 1

    def total_bytes(self) -> int:
        return sum(e.hbm_bytes for e in self._entries.values())

    def evict_over_budget(self) -> int:
        """Evict least-recently-used UNPINNED entries until the total
        footprint fits max_bytes (no-op when unbudgeted). Returns the
        number of entries evicted. Dropping the entry releases the last
        strong references to scene.dev and the integrator; torch frees
        the device memory when the tensors are collected."""
        self._footprint_gauges()
        if self.max_bytes is None:
            return 0
        n = 0
        while self.total_bytes() > self.max_bytes:
            victims = [
                e for e in self._entries.values() if e.pins == 0
            ]
            if not victims:
                break  # everything pinned: stay over budget, loudly
            coldest = min(victims, key=lambda e: e.last_used)
            del self._entries[coldest.key]
            self.evictions += 1
            METRICS.counter(
                "residency_evicted_bytes_total",
                "HBM bytes reclaimed by LRU scene eviction",
            ).inc(coldest.hbm_bytes)
            n += 1
        if n:
            self._footprint_gauges()
        return n

    def _footprint_gauges(self) -> None:
        if not METRICS.enabled:
            return
        METRICS.gauge(
            "residency_resident_bytes",
            "HBM footprint of the resident compiled scenes",
        ).set(self.total_bytes())
        METRICS.gauge(
            "residency_entries", "resident compiled scenes"
        ).set(len(self._entries))

    def release(self, key: str) -> bool:
        """Drop an entry outright regardless of LRU order (explicit
        invalidation); refuses while pinned. Returns whether dropped."""
        ent = self._entries.get(key)
        if ent is None or ent.pins > 0:
            return False
        del self._entries[key]
        self.evictions += 1
        METRICS.counter(
            "residency_evicted_bytes_total",
            "HBM bytes reclaimed by LRU scene eviction",
        ).inc(ent.hbm_bytes)
        self._footprint_gauges()
        return True

    # -- introspection -----------------------------------------------------
    def pin_counts(self) -> Dict[str, int]:
        """key -> live pin count. Each key's pins equal the number of
        non-terminal jobs holding it, and every count is zero once all
        jobs are terminal (a leak here is a scene the LRU can never
        evict)."""
        return {k: e.pins for k, e in self._entries.items()}

    def stats(self) -> Dict[str, Any]:
        return {
            "entries": len(self._entries),
            "resident_bytes": self.total_bytes(),
            "max_bytes": self.max_bytes,
            "scene_compiles": self.scene_compiles,
            "hits": self.hits,
            "evictions": self.evictions,
            "scenes": {
                e.key: {
                    "hbm_bytes": e.hbm_bytes,
                    "pins": e.pins,
                    "hits": e.hits,
                    "compile_seconds": round(e.compile_seconds, 3),
                }
                for e in sorted(
                    self._entries.values(), key=lambda e: -e.last_used
                )
            },
        }
