"""Append-only JSONL flight recorder.

A benchmark capture once recorded `0.0` with nothing but "backend
unreachable" — no
record of which phase died, how long the probe waited, or what the last
completed work looked like. The flight recorder fixes that class of
capture: every phase writes heartbeat lines (`{"t", "elapsed_s",
"phase", ...fields}`) to an append-only JSONL file, each line flushed to
disk immediately, so whatever kills the process leaves the full
phase timeline plus the last counter snapshot behind.

Process-global `FLIGHT`, configured by `TPU_PBRT_FLIGHT_PATH` or
programmatically (bench.py defaults a path so outage captures always
carry a diagnosis). Unconfigured or with `TPU_PBRT_TELEMETRY=0` the
heartbeats still track `last_phase` in memory (bench's outage JSON
reports it either way) but write nothing.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional


class FlightRecorder:
    def __init__(self):
        self._path: Optional[str] = None
        from tpu_pbrt_torch.utils.clock import WALL

        self._clock = WALL
        self._t0 = self._clock.peek()
        self.last_phase: Optional[str] = None
        self.last_counters: Optional[Dict[str, Any]] = None

    def configure(self, path: Optional[str], t0: Optional[float] = None):
        """t0 rebases elapsed_s (epoch seconds): a caller that heartbeat
        with its own writer before this module could import (bench's
        import-free probe phase) hands its start time over so one JSONL
        file keeps a single monotonic elapsed_s baseline."""
        self._path = path or None
        if t0 is not None:
            self._t0 = t0

    def set_clock(self, clock=None):
        """Inject a time source (utils/clock.py; None restores the wall
        clock) and rebase the elapsed_s baseline onto it. Under a
        VirtualClock every heartbeat stamps virtual seconds — monotone
        nondecreasing along the decision sequence — instead of
        interleaving real time.time() into the lines of a simulated
        run. peek(): flight recording must never advance the timeline
        it is observing."""
        from tpu_pbrt_torch.utils.clock import WALL

        self._clock = clock if clock is not None else WALL
        self._t0 = self._clock.peek()

    @property
    def path(self) -> Optional[str]:
        from tpu_pbrt_torch.config import cfg

        return self._path or cfg.flight_path

    @property
    def enabled(self) -> bool:
        from tpu_pbrt_torch.config import cfg

        return bool(cfg.telemetry and self.path)

    def _maybe_rotate(self, path: str):
        """Growth cap (`TPU_PBRT_FLIGHT_MAX_MB`): single-file rotation at
        the flush boundary — when the file has grown past the cap it is
        renamed to `<path>.1` (the previous rotation, if any, is
        replaced) and appending restarts on a fresh file. A long-lived
        serve daemon keeps at most 2x the cap on disk instead of an
        unbounded JSONL; the tail of the timeline is always the readable
        pair (`<path>.1` then `<path>`)."""
        from tpu_pbrt_torch.config import cfg

        cap_mb = cfg.flight_max_mb
        if not cap_mb or cap_mb <= 0:
            return
        try:
            if os.path.getsize(path) >= cap_mb * 1e6:
                os.replace(path, path + ".1")
        except OSError:
            # missing file (nothing to rotate) or an unwritable dir —
            # the heartbeat's own open() will surface/swallow that
            pass

    def _write(self, path: str, phase: str, fields: Dict[str, Any]):
        """One JSONL line to `path`: wall clock, elapsed seconds, phase,
        fields. Opened/flushed/closed per line — crash-safe by
        construction — behind the same rotation cap whichever file it
        lands in."""
        now = self._clock.peek()
        line = {
            "t": round(now, 3),
            "elapsed_s": round(now - self._t0, 3),
            "phase": phase,
        }
        # reserved keys win: a caller kwarg must not clobber the
        # recorder's monotonic elapsed_s baseline (or t/phase)
        for k, v in fields.items():
            if k not in line:
                line[k] = v
        try:
            self._maybe_rotate(path)
            with open(path, "a") as f:
                f.write(json.dumps(line) + "\n")
        except OSError:
            # a full/readonly disk must never kill the render it's
            # supposed to be diagnosing
            pass

    def heartbeat(self, phase: str, **fields):
        """One JSONL line on the main flight file."""
        self.last_phase = phase
        if not self.enabled:
            return
        self._write(self.path, phase, fields)

    def job_heartbeat(self, job_id: str, phase: str, **fields):
        """One JSONL line on the per-job flight file
        (`flight.<job>.jsonl` next to the main path). First-class seam:
        the render service used to re-arm `_path` around every per-job
        heartbeat, which made the `TPU_PBRT_FLIGHT_MAX_MB` cap apply
        only as a side effect of the swap (and left any other per-job
        writer uncapped). Per-job files sit behind the same
        single-rotation cap as the main one, by construction."""
        self.last_phase = phase
        if not self.enabled:
            return
        path = job_flight_path(self.path, job_id)
        if path:
            self._write(path, phase, fields)

    def counters(self, snapshot: Dict[str, Any], phase: str = "counters"):
        """Record the latest device-counter snapshot (the drain-boundary
        fetch) so a post-mortem knows the last completed work."""
        self.last_counters = dict(snapshot)
        self.heartbeat(phase, counters=snapshot)


def job_flight_path(base: Optional[str], job_id: str) -> Optional[str]:
    """Per-job flight file next to `base` — `flight.jsonl` ->
    `flight.<job>.jsonl`. The render service re-arms the recorder with
    this per job slice it dispatches: a shared default path (bench's
    BENCH_flight.jsonl) would interleave heartbeat lines from every
    concurrent job into one undiagnosable stream."""
    if not base:
        return None
    # splitext (not a raw '.' split): it only splits the BASENAME, so a
    # dotted directory (/tmp/run.1/flight) can't be mangled into a
    # nonexistent path whose writes the recorder would silently drop
    root, ext = os.path.splitext(base)
    return f"{root}.{job_id}{ext}"


FLIGHT = FlightRecorder()


# -- validation (tests + `python -m tpu_pbrt_torch.obs` + CI smoke) --------------


def validate_flight(path: str, require_phases=None) -> List[str]:
    """Validate a flight-recorder JSONL file: every line parses, carries
    t/elapsed_s/phase, and (optionally) each phase in `require_phases`
    has >= 1 heartbeat. Returns a list of problems."""
    errs: List[str] = []
    phases_seen = set()
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError as e:
        return [f"unreadable flight file: {e}"]
    if not lines:
        errs.append("flight file is empty (no heartbeats recorded)")
    for i, raw in enumerate(lines):
        if not raw.strip():
            continue
        where = f"line {i + 1}"
        try:
            rec = json.loads(raw)
        except ValueError as e:
            errs.append(f"{where}: not JSON: {e}")
            continue
        if not isinstance(rec, dict):
            errs.append(f"{where}: not an object")
            continue
        if not isinstance(rec.get("phase"), str) or not rec.get("phase"):
            errs.append(f"{where}: missing phase")
        else:
            phases_seen.add(rec["phase"])
        for key in ("t", "elapsed_s"):
            if not isinstance(rec.get(key), (int, float)):
                errs.append(f"{where}: missing numeric {key}")
    for phase in require_phases or ():
        if phase not in phases_seen:
            errs.append(
                f"required phase {phase!r} has no heartbeat "
                f"(saw: {sorted(phases_seen)})"
            )
    return errs
