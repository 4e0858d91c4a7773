"""Injectable time source for the serve/dispatch protocol.

The render service's scheduling decisions (runnability filters, backoff
deadlines, queue-wait accounting) and the observability recorders
(trace spans, flight heartbeats) all consume time. Before this seam
they sampled the wall clock directly, which made a service run a
function of REAL time — unreproducible, and unexplorable: the protocol
checker (analysis layer 6, `tpu_pbrt/analysis/protocheck.py`) needs a
whole service run to be a pure deterministic function of an explicit
decision sequence.

Two implementations of one small interface:

- ``Clock`` (the module-level ``WALL`` default) — the production wall
  clock. Every method forwards to the stdlib, so a service built
  without an explicit clock behaves byte-identically to the pre-seam
  code.
- ``VirtualClock`` — deterministic simulated time. ``sleep`` advances
  time instead of blocking, and every **decision sample** (``now()``)
  advances time by a small configurable ``tick``, which is what makes
  *hidden* clock samples observable: code that samples the decision
  clock twice where it promised to sample once sees two different
  times, and a deadline falling between the samples reproduces —
  deterministically — the ``step()`` double-sample wedge the
  SV-CLOCK lint rule codifies.

The method split is part of the protocol model:

- ``now()`` — a DECISION sample (runnability, deadlines, ready times).
  Ticks virtual time forward.
- ``peek()`` — a pure OBSERVATION (flight-line stamps, invariant
  checks). Never perturbs virtual time, so arming telemetry cannot
  change a virtual run's scheduling decisions.
- ``monotonic()`` — span timing (trace timestamps, device-wait
  attribution). Also non-perturbing under virtual time.
- ``sleep(s)`` — wall: ``time.sleep``; virtual: advance by ``s``.
"""

from __future__ import annotations

import time


class Clock:
    """The production wall clock (and the injectable interface)."""

    def now(self) -> float:
        """Decision-relevant epoch-seconds sample."""
        return time.time()

    def peek(self) -> float:
        """Observation-only epoch-seconds read (never perturbs a
        virtual timeline — see VirtualClock)."""
        return time.time()

    def monotonic(self) -> float:
        """Span-timing read (perf_counter seconds)."""
        return time.perf_counter()

    def sleep(self, seconds: float) -> None:
        time.sleep(max(float(seconds), 0.0))


#: the process default — services/recorders built without an explicit
#: clock sample real time exactly as before the seam existed
WALL = Clock()


class VirtualClock(Clock):
    """Deterministic simulated time for protocol exploration.

    One timeline serves all three read kinds (``now``/``peek``/
    ``monotonic`` — virtual time has no epoch-vs-monotonic split);
    ``now()`` additionally advances it by ``tick`` per sample, modeling
    the real time that passes between two samples of a wall clock.
    ``sleep`` advances instead of blocking, so a backoff window costs
    nothing to wait out and a decision sequence replays in
    microseconds."""

    def __init__(self, start: float = 0.0, tick: float = 1e-6):
        self._t = float(start)
        self.tick = float(tick)
        self.samples = 0  # decision samples taken (now() calls)
        self.sleeps = 0

    def now(self) -> float:
        t = self._t
        self._t = t + self.tick
        self.samples += 1
        return t

    def peek(self) -> float:
        return self._t

    def monotonic(self) -> float:
        return self._t

    def sleep(self, seconds: float) -> None:
        self._t += max(float(seconds), 0.0)
        self.sleeps += 1

    def advance(self, seconds: float) -> None:
        """Explicitly move time forward (an explorer decision)."""
        self._t += max(float(seconds), 0.0)

    def advance_to(self, t: float) -> None:
        """Move time forward to ``t`` (never backward)."""
        self._t = max(self._t, float(t))
