"""Deterministic, declarative fault injection.

The reference fork's whole reason to exist is surviving failure: workers
die mid-tile and the master re-assigns their work without corrupting the
film merge (SURVEY.md §2e). This package turns that claim into a testable
contract: a fault PLAN — a comma-separated spec like

    dispatch:poison@chunk=3,ckpt:torn@write=2,nan:wave@5&chunk=1,probe:hang@attempt=1

— is parsed into seeded, reproducible injection points wired into the
render loop's existing failure seams:

========  =======================  ==========================================
site      kinds                    seam
========  =======================  ==========================================
dispatch  fail | poison            the chunk-dispatch try block in
                                   integrators/common.render (fail = clean
                                   loss, re-dispatch is exact; poison = the
                                   in-flight film accumulator is untrusted)
mesh      lost                     same seam, but only fires on a mesh
                                   render — simulates a single-device loss
                                   in the drain (state-poisoning)
ckpt      torn | crash | bitflip   parallel/checkpoint.save_checkpoint
                                   (torn final file, crash between tmp
                                   write and rename, seeded bit-flip)
nan       wave                     the pool wave's radiance output in
                                   PathIntegrator.pool_chunk (NaN lanes —
                                   exercises the non-finite film firewall)
probe     hang                     bench.py's backend probe (simulated
                                   runtime hang; parsed import-free there,
                                   see bench._probe_hang_attempts)
========  =======================  ==========================================

Grammar: ``site:kind[@param[&param...]]`` where each param is ``k=v`` or a
bare value that binds to the site's default key (``chunk`` for
dispatch/mesh, ``write`` for ckpt, ``wave`` for nan, ``attempt`` for
probe). The reserved param ``times=N`` caps how often a fault fires
(default 1 — every injection point fires exactly once unless asked
otherwise), which is what makes recovery testable: the re-dispatch of a
faulted chunk runs clean, so the recovered film must be BIT-identical to
an undisturbed render (idempotent chunks + counter-based RNG).

Activation: the process-global ``CHAOS`` registry, installed from
``TPU_PBRT_FAULTS`` at import (config snapshot contract — a later
``config.reload()`` does NOT re-install), ``--faults`` on main.py, or
``CHAOS.install(...)`` directly (tests, the matrix runner). An empty
registry costs one attribute read per seam.

``python -m tpu_pbrt_torch.chaos`` runs the recovery matrix: every scenario
against the cropped cornell scene on CPU, asserting bit-identity against
the undisturbed render (see __main__.py).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from tpu_pbrt_torch.config import cfg

#: legal kinds per site (parse-time validation: a typo'd plan must fail
#: loudly, not silently inject nothing)
SITE_KINDS: Dict[str, frozenset] = {
    "dispatch": frozenset({"fail", "poison"}),
    "mesh": frozenset({"lost"}),
    "ckpt": frozenset({"torn", "crash", "bitflip"}),
    "nan": frozenset({"wave"}),
    "probe": frozenset({"hang"}),
}

#: the key a bare ``@value`` binds to, per site
DEFAULT_KEY: Dict[str, str] = {
    "dispatch": "chunk",
    "mesh": "chunk",
    "ckpt": "write",
    "nan": "wave",
    "probe": "attempt",
}

#: legal param keys per site (plus the reserved ``times``): a typo'd key
#: would otherwise fall through the seams' .get(key, default) matching
#: and fire the fault somewhere other than where the plan claimed
SITE_PARAMS: Dict[str, frozenset] = {
    "dispatch": frozenset({"chunk", "attempt"}),
    "mesh": frozenset({"chunk", "attempt"}),
    "ckpt": frozenset({"write"}),
    "nan": frozenset({"wave", "chunk"}),
    "probe": frozenset({"attempt"}),
}


@dataclass
class Fault:
    """One parsed plan entry. ``fired`` counts actual injections; a fault
    stops matching once ``fired >= times`` — recovery re-runs see a clean
    world."""

    site: str
    kind: str
    params: Dict[str, int] = field(default_factory=dict)
    times: int = 1
    fired: int = 0

    def exhausted(self) -> bool:
        return self.fired >= self.times

    def spec(self) -> str:
        ps = "&".join(f"{k}={v}" for k, v in sorted(self.params.items()))
        if self.times != 1:
            ps = (ps + "&" if ps else "") + f"times={self.times}"
        return f"{self.site}:{self.kind}" + (f"@{ps}" if ps else "")


def parse_plan(spec: str) -> List[Fault]:
    """Parse a fault-plan string into Fault entries. Raises ValueError on
    unknown sites/kinds/params — a chaos plan that silently injects
    nothing would certify recovery that was never exercised."""
    faults: List[Fault] = []
    for entry in str(spec or "").split(","):
        entry = entry.strip()
        if not entry:
            continue
        head, _, tail = entry.partition("@")
        site, sep, kind = head.partition(":")
        site = site.strip()
        kind = kind.strip()
        if not sep or site not in SITE_KINDS:
            raise ValueError(
                f"chaos plan: unknown site in {entry!r} "
                f"(sites: {sorted(SITE_KINDS)})"
            )
        if kind not in SITE_KINDS[site]:
            raise ValueError(
                f"chaos plan: unknown kind {kind!r} for site {site!r} "
                f"(kinds: {sorted(SITE_KINDS[site])})"
            )
        params: Dict[str, int] = {}
        times = 1
        if tail:
            for part in tail.split("&"):
                part = part.strip()
                if not part:
                    continue
                k, eq, v = part.partition("=")
                if not eq:
                    # bare value -> the site's default key
                    k, v = DEFAULT_KEY[site], k
                try:
                    iv = int(v)
                except ValueError as e:
                    raise ValueError(
                        f"chaos plan: non-integer value in {entry!r}: {part!r}"
                    ) from e
                if k == "times":
                    times = iv
                elif k not in SITE_PARAMS[site]:
                    raise ValueError(
                        f"chaos plan: unknown param {k!r} for site "
                        f"{site!r} in {entry!r} "
                        f"(params: {sorted(SITE_PARAMS[site])} + times)"
                    )
                else:
                    params[k] = iv
        faults.append(Fault(site=site, kind=kind, params=params, times=times))
    return faults


def protocol_fault_space(n_chunks: int = 2) -> List[str]:
    """The fault plans the serve-protocol explorer (analysis layer 6,
    tools/explore.py) crosses its decision sequences with — drawn from
    THIS grammar so every explored fault schedule is also a plan a user
    can hand to --faults / TPU_PBRT_FAULTS and replay outside the
    explorer. Host-side sites only: dispatch fail/poison exercise the
    recovery ladder's clean-retry and rollback/restart arms, ckpt
    torn/crash exercise the .prev fallback under the deferred-write
    protocol. ("" = the undisturbed schedule every faulted end state is
    compared against.) Each entry is parse_plan-validated here, at
    definition time."""
    specs = [""]
    for c in range(max(int(n_chunks), 1)):
        specs.append(f"dispatch:fail@chunk={c}")
        specs.append(f"dispatch:poison@chunk={c}")
    specs.append("ckpt:torn@write=1")
    specs.append("ckpt:crash@write=1")
    for s in specs:
        parse_plan(s)
    return specs


class ChaosRegistry:
    """Process-global injection-point registry. All decisions are host-
    side and deterministic: plan + seed fully determine which dispatch
    raises, which checkpoint write tears, which byte flips, and which
    pool wave goes NaN. The only traced component is the nan-wave index,
    passed INTO the jitted chunk as an int32 argument (-1 = clean), so a
    re-dispatch after the fault fired compiles nothing new and runs the
    exact clean program."""

    def __init__(self):
        self._plan: List[Fault] = []
        self._hooks: List[Callable[[int, int], None]] = []
        self._ckpt_writes = 0
        self.seed = 0

    # -- lifecycle ---------------------------------------------------------
    def install(self, plan, seed: int = 0) -> "ChaosRegistry":
        """Install a plan (spec string or Fault list), replacing any
        previous one and resetting all fired/write counters."""
        self._plan = (
            parse_plan(plan) if isinstance(plan, str) else list(plan)
        )
        self._ckpt_writes = 0
        self.seed = int(seed)
        return self

    def clear(self) -> None:
        """Remove the plan and any registered hooks (test teardown)."""
        self._plan = []
        self._hooks = []
        self._ckpt_writes = 0

    def active(self) -> bool:
        return bool(self._plan) or bool(self._hooks)

    def plan(self) -> List[Fault]:
        return list(self._plan)

    def report(self) -> List[Dict[str, Any]]:
        """Fired accounting per fault (the matrix's fires-exactly-once
        evidence)."""
        return [
            {"fault": f.spec(), "fired": f.fired, "times": f.times}
            for f in self._plan
        ]

    def fired_total(self) -> int:
        return sum(f.fired for f in self._plan)

    # -- test-callable hooks (the promoted _fault_hook seam) ---------------
    def register_hook(self, fn: Callable[[int, int], None]) -> None:
        """Register a callable hook(chunk, attempt) run at every chunk
        dispatch — the first-class replacement for the old test-only
        ``integ._fault_hook`` monkeypatch. Hooks may raise
        ChunkDispatchError to inject arbitrary failures."""
        self._hooks.append(fn)

    # -- seams -------------------------------------------------------------
    def dispatch(self, chunk: int, attempt: int, mesh: bool = False) -> None:
        """The chunk-dispatch seam: raises ChunkDispatchError when the
        plan (or a registered hook) says this (chunk, attempt) fails.
        ``attempt`` param in the plan matches exactly when present, any
        attempt otherwise."""
        for hook in list(self._hooks):
            hook(chunk, attempt)
        for f in self._plan:
            if f.site not in ("dispatch", "mesh") or f.exhausted():
                continue
            if f.site == "mesh" and not mesh:
                continue
            if f.params.get("chunk", 0) != chunk:
                continue
            if "attempt" in f.params and f.params["attempt"] != attempt:
                continue
            f.fired += 1
            from tpu_pbrt_torch.integrators.common import ChunkDispatchError

            poisons = f.kind in ("poison", "lost")
            raise ChunkDispatchError(
                f"chaos: injected {f.site}:{f.kind} at chunk {chunk} "
                f"(attempt {attempt})",
                poisons_state=poisons,
            )

    def checkpoint_fault(self) -> Optional[str]:
        """The save_checkpoint seam: counts this write (1-based, process-
        wide since install) and returns the fault kind to apply — 'torn',
        'crash', 'bitflip' — or None for a clean write."""
        self._ckpt_writes += 1
        for f in self._plan:
            if f.site != "ckpt" or f.exhausted():
                continue
            if f.params.get("write", 1) == self._ckpt_writes:
                f.fired += 1
                return f.kind
        return None

    def bitflip_offset(self, size: int) -> int:
        """Seeded byte offset for ckpt:bitflip — same plan + seed flips
        the same byte (the determinism contract)."""
        return zlib.crc32(f"bitflip:{self.seed}".encode()) % max(size, 1)

    def has_nan(self) -> bool:
        """STATIC trace-time query: does the plan contain a nan site at
        all? When True the pool chunk closure takes the extra nan_wave
        argument (program shape changes — part of the jit-cache key via
        trace_key)."""
        return any(f.site == "nan" for f in self._plan)

    def nan_wave_for(self, chunk: int) -> int:
        """Host-side per-dispatch decision: the wave index to contaminate
        in this chunk's drain, or -1 for a clean dispatch. Marks the
        fault fired — the re-dispatch of the same chunk runs clean."""
        for f in self._plan:
            if f.site != "nan" or f.exhausted():
                continue
            if f.params.get("chunk", 0) != chunk:
                continue
            f.fired += 1
            return int(f.params.get("wave", 0))
        return -1

    def probe_hang(self, attempt: int) -> bool:
        """The bench probe seam (kept in API parity with bench.py's
        import-free parser, which is what production bench actually uses
        — this method serves tests of the shared grammar)."""
        for f in self._plan:
            if f.site != "probe" or f.kind != "hang" or f.exhausted():
                continue
            if f.params.get("attempt", 1) == attempt:
                f.fired += 1
                return True
        return False

    def trace_key(self) -> tuple:
        """The part of the registry that changes TRACED program shape —
        only the presence of a nan site (the injection argument exists or
        not). Host-only faults (dispatch/ckpt/probe) never force a
        recompile."""
        return (self.has_nan(),)


#: the process-global registry
CHAOS = ChaosRegistry()

# Env activation (TPU_PBRT_FAULTS), read once at import like every other
# config knob. Tests and the matrix runner use CHAOS.install() directly.
if cfg.faults:
    CHAOS.install(cfg.faults)
