"""Host-side span recorder with Chrome-trace/Perfetto JSON export.

Records named spans around the render phases the HOST can see — jit
build + first (compiling) dispatch, per-chunk wave-batch dispatches, the
drain sync that covers device execution and the mesh film psum/merge,
checkpoint writes, develop — into the Chrome trace-event format
(`chrome://tracing` / https://ui.perfetto.dev load it directly).

Since the dispatch window the host timeline is genuinely
concurrent — up to `TPU_PBRT_PIPELINE` chunk-slices in flight while the
host does other jobs' work — so flat complete ("X") spans alone cannot
express causality. tpu-scope adds the three Chrome-trace
event families that can:

- **trace/span ids**: `trace_id(seed)` mints a deterministic per-request
  id (the render service keys it by job id); `span_id()` mints a
  process-monotonic span id. Both ride in event `args`, and the service
  stamps them on flight-file lines and histogram exemplars too, so one
  id joins every artifact a job touched.
- **async spans** ("b"/"e" phases, paired by (cat, id)): a span that
  OUTLIVES the host stack frame that opened it — a chunk-slice from
  dispatch enqueue to retire sync, a job from submit to done, a queue
  wait across many scheduler steps. Overlapping slices at depth N render
  as overlapping tracks instead of a lie.
- **flow events** ("s"/"f" phases, bound by id): the causal arrow from a
  dispatch enqueue to the retire sync that completed it, drawn by
  Perfetto across the in-flight gap.

The recorder is a process-global (`TRACE`) configured by `--trace` on
main.py / bench.py or `TPU_PBRT_TRACE_PATH`; unconfigured (or with
`TPU_PBRT_TELEMETRY=0`) every call is a cheap no-op. Timestamps are
microseconds from recorder start, as the trace-event spec expects.
"""

from __future__ import annotations

import json
import os
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

#: event phases we emit/accept: complete span, instant, counter,
#: metadata, async begin/end, flow start/finish
_PHASES = ("X", "i", "C", "M", "b", "e", "s", "f")
#: phases that pair/bind by id (async by (cat, id); flow by (cat, id))
_ASYNC = ("b", "e")
_FLOW = ("s", "f")


class TraceRecorder:
    def __init__(self):
        self._events: List[Dict[str, Any]] = []
        self._path: Optional[str] = None
        from tpu_pbrt_torch.utils.clock import WALL

        self._clock = WALL
        self._t0 = self._clock.monotonic()
        self._next_span = 0

    # -- configuration -----------------------------------------------------
    def configure(self, path: Optional[str]):
        """Set (or clear) the export path; the --trace flag lands here."""
        self._path = path or None

    def set_clock(self, clock=None):
        """Inject a time source (utils/clock.py; None restores the wall
        clock) and REBASE the timestamp origin onto it. The rebase is
        the load-bearing part: a VirtualClock's timeline starts near 0,
        and subtracting a wall-clock `_t0` captured at import would
        produce negative `ts` — which validate_trace rightly rejects.
        Rebasing keeps every recorder the explorer arms emitting
        monotone nonnegative virtual-time stamps."""
        from tpu_pbrt_torch.utils.clock import WALL

        self._clock = clock if clock is not None else WALL
        self._t0 = self._clock.monotonic()

    @property
    def clock_kind(self) -> str:
        """"wall" or the injected clock's class name (lowercased) — the
        export stamps this so tools/scope.py can tell a virtual-time
        explorer trace from a production one."""
        from tpu_pbrt_torch.utils.clock import WALL

        if self._clock is WALL:
            return "wall"
        kind = type(self._clock).__name__.lower().removesuffix("clock")
        return kind or "wall"

    @property
    def path(self) -> Optional[str]:
        from tpu_pbrt_torch.config import cfg

        return self._path or cfg.trace_path

    @property
    def enabled(self) -> bool:
        from tpu_pbrt_torch.config import cfg

        return bool(cfg.telemetry and self.path)

    def reset(self):
        self._events = []
        self._t0 = self._clock.monotonic()
        self._next_span = 0

    # -- ids ---------------------------------------------------------------
    @staticmethod
    def trace_id(seed: str) -> str:
        """Deterministic request/trace id from a caller-owned seed (the
        service seeds with the job id): a pure string function, so the
        same submit sequence mints the same ids run after run — the
        determinism contract exemplars and test assertions need."""
        return f"t:{seed}"

    def span_id(self) -> str:
        """Process-monotonic span id ("s1", "s2", ...). Monotonic (not
        random): deterministic given the recorded event sequence, and
        reset() restarts the counter with the event buffer."""
        self._next_span += 1
        return f"s{self._next_span}"

    # -- recording ---------------------------------------------------------
    def _now_us(self) -> float:
        # monotonic(): a non-perturbing read — recording a span must
        # never advance a virtual timeline (arming the trace cannot
        # change the scheduling decisions it observes)
        return (self._clock.monotonic() - self._t0) * 1e6

    @contextmanager
    def span(self, name: str, **args):
        """Record a complete ("ph": "X") span around the with-body."""
        if not self.enabled:
            yield
            return
        ts = self._now_us()
        try:
            yield
        finally:
            self._events.append({
                "name": name, "ph": "X", "ts": ts,
                "dur": self._now_us() - ts,
                "pid": 0, "tid": 0, "args": args,
            })

    def complete(self, name: str, dur_us: float, ts_us: Optional[float] = None,
                 **args):
        """Emit a complete span with an EXPLICIT duration — for windows
        whose extent is known but not bracketed by a host stack frame
        (the re-dispatch backoff window: its length is computed the
        moment it opens)."""
        if not self.enabled:
            return
        self._events.append({
            "name": name, "ph": "X",
            "ts": self._now_us() if ts_us is None else ts_us,
            "dur": max(float(dur_us), 0.0),
            "pid": 0, "tid": 0, "args": args,
        })

    def instant(self, name: str, **args):
        if not self.enabled:
            return
        self._events.append({
            "name": name, "ph": "i", "ts": self._now_us(),
            "pid": 0, "tid": 0, "s": "p", "args": args,
        })

    def counter(self, name: str, **values):
        """A "C" counter event — Perfetto plots these as tracks."""
        if not self.enabled:
            return
        self._events.append({
            "name": name, "ph": "C", "ts": self._now_us(),
            "pid": 0, "tid": 0, "args": values,
        })

    # -- async spans + flow events (tpu-scope) -----------------------------
    def _id_event(self, ph: str, name: str, id: str, cat: str, extra=None,
                  **args):
        ev = {
            "name": name, "ph": ph, "ts": self._now_us(),
            "pid": 0, "tid": 0, "id": str(id), "cat": cat, "args": args,
        }
        if extra:
            ev |= extra
        self._events.append(ev)

    def async_begin(self, name: str, id: str, cat: str = "job", **args):
        """Open an async span: lives until the matching `async_end` with
        the same (cat, id) — across stack frames, scheduler steps, and
        other jobs' interleaved work."""
        if self.enabled:
            self._id_event("b", name, id, cat, **args)

    def async_end(self, name: str, id: str, cat: str = "job", **args):
        if self.enabled:
            self._id_event("e", name, id, cat, **args)

    @contextmanager
    def async_span(self, name: str, id: str, cat: str = "job", **args):
        """Async b/e pair around the with-body — for callers that DO
        have a bracketing frame but want the span on an id-keyed async
        track (overlap-safe) instead of the flat X timeline."""
        self.async_begin(name, id, cat, **args)
        try:
            yield
        finally:
            self.async_end(name, id, cat)

    def flow_start(self, name: str, id: str, cat: str = "flow", **args):
        """Open a causal arrow: the matching `flow_finish` with the same
        (cat, id) is the event this one CAUSED (dispatch enqueue ->
        retire sync)."""
        if self.enabled:
            self._id_event("s", name, id, cat, **args)

    def flow_finish(self, name: str, id: str, cat: str = "flow", **args):
        if self.enabled:
            # bp=e: bind to the enclosing slice, not the next one
            self._id_event("f", name, id, cat, extra={"bp": "e"}, **args)

    # -- export ------------------------------------------------------------
    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Write the Chrome trace JSON; returns the path written (None if
        no path is configured). Rewrites the whole file each call, so
        incremental exports (per render) are safe and the last one wins."""
        path = path or self.path
        if not path:
            return None
        doc = {
            "traceEvents": self._events,
            "displayTimeUnit": "ms",
            "otherData": {
                "tool": "tpu-pbrt obs.trace",
                "clock": self.clock_kind,
            },
        }
        # atomic tmp+rename (the checkpoint.py pattern): a crash mid-
        # export must leave the previous valid export intact, not a
        # truncated JSON — the failure path is where the trace matters
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path

    def maybe_export(self) -> Optional[str]:
        """export() iff enabled — the render loop's exit hook."""
        return self.export() if self.enabled else None


#: the process-wide recorder every phase reports into
TRACE = TraceRecorder()


# -- schema validation (tests + `python -m tpu_pbrt_torch.obs` + CI smoke) -------


def _intervals_overlap(iv: List[tuple]) -> bool:
    iv = sorted(iv)
    return any(b_start < a_end for (_, a_end), (b_start, _) in zip(iv, iv[1:]))


def validate_trace(doc) -> List[str]:
    """Validate a Chrome-trace document (dict, or a path to one).
    Returns a list of problems; empty means the file loads in Perfetto.

    Beyond per-event schema, this checks the tpu-scope causality
    invariants (the pre-scope validator accepted a
    depth-2 trace whose overlapping slices had no async structure and no
    dispatch_ahead attribution at all):

    - async "b"/"e" events pair up per (cat, id): every begin has a
      later end, no end without an open begin;
    - flow "f" events bind to an earlier "s" with the same (cat, id),
      and every started flow finishes;
    - overlapping in-flight slice spans (async cat "slice") imply
      pipelined dispatch — such a trace must also carry at least one
      `*_ahead` dispatch-attribution span, or the phase attribution the
      overlap fraction is computed from has a hole.
    """
    errs: List[str] = []
    if isinstance(doc, str):
        try:
            with open(doc) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            return [f"unreadable trace file: {e}"]
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["top level must be an object with a traceEvents array"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not an array"]
    async_open: Dict[tuple, List[float]] = {}  # (cat, id) -> begin ts stack
    flow_open: Dict[tuple, int] = {}  # (cat, id) -> started - finished
    slice_spans: Dict[tuple, List[float]] = {}  # open slice begins
    slice_iv: List[tuple] = []  # completed (begin_ts, end_ts) slice spans
    has_ahead = False
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errs.append(f"{where}: not an object")
            continue
        name = ev.get("name")
        if not isinstance(name, str) or not name:
            errs.append(f"{where}: missing/empty name")
            name = ""
        ph = ev.get("ph")
        if ph not in _PHASES:
            errs.append(f"{where}: unknown phase {ph!r}")
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"{where}: bad ts {ts!r}")
            ts = 0.0
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: complete span with bad dur {dur!r}")
            if name.endswith("_ahead"):
                has_ahead = True
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                errs.append(f"{where}: missing integer {key}")
        if ph in _ASYNC or ph in _FLOW:
            cat, aid = ev.get("cat"), ev.get("id")
            if not isinstance(cat, str) or not cat:
                errs.append(f"{where}: {ph!r} event without a cat")
                cat = ""
            if not isinstance(aid, str) or not aid:
                errs.append(f"{where}: {ph!r} event without an id")
                continue
            k = (cat, aid)
            if ph == "b":
                async_open.setdefault(k, []).append(ts)
                if cat == "slice":
                    slice_spans.setdefault(k, []).append(ts)
            elif ph == "e":
                if not async_open.get(k):
                    errs.append(
                        f"{where}: async end {name!r} ({cat}:{aid}) "
                        "without an open begin"
                    )
                else:
                    t_b = async_open[k].pop()
                    if cat == "slice" and slice_spans.get(k):
                        slice_spans[k].pop()
                        slice_iv.append((t_b, ts))
            elif ph == "s":
                flow_open[k] = flow_open.get(k, 0) + 1
            elif ph == "f":
                if flow_open.get(k, 0) <= 0:
                    errs.append(
                        f"{where}: flow finish {name!r} ({cat}:{aid}) "
                        "without a matching flow start"
                    )
                else:
                    flow_open[k] -= 1
    for (cat, aid), stack in async_open.items():
        for _ in stack:
            errs.append(f"async span ({cat}:{aid}) begun but never ended")
    for (cat, aid), n in flow_open.items():
        if n > 0:
            errs.append(f"flow ({cat}:{aid}) started but never finished")
    if _intervals_overlap(slice_iv) and not has_ahead:
        errs.append(
            "overlapping in-flight slice spans (pipeline depth > 1) but "
            "no *_ahead dispatch-attribution span anywhere in the trace"
        )
    return errs
