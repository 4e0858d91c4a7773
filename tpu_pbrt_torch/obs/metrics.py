"""tpu-metrics: process-wide HOST-side metrics registry.

The runtime telemetry gives each render its own primitives — device counters
fetched once per drain, raw Perfetto spans, an append-only flight file.
A long-lived multi-tenant service needs the layer above: aggregation
ACROSS jobs (percentile queue wait, chunk service time), an exposition a
monitor can scrape, and the pressure signal the service's load shedding
decides against. This module is that layer:

- **Counter / Gauge / Histogram** with free-form labels. Histograms use
  FIXED bucket edges chosen at registration: snapshots are a pure
  function of the observed values (no reservoir sampling, no decay), so
  two services fed the same event sequence expose identical bytes — the
  same determinism contract the fair scheduler keeps.
- **p50/p90/p99 derived from bucket counts** (linear interpolation
  inside the covering bucket): cheap, deterministic, and good enough to
  steer load shedding — exact order statistics would need per-sample
  storage a render service must not pay.
- **Prometheus text exposition** (`exposition()`) plus a deterministic
  JSON `snapshot()`; both validated by `python -m tpu_pbrt_torch.obs`
  (`validate_exposition` / `validate_snapshot`).
- **Span folding** (`fold_trace`): maps the render's Chrome-trace span names
  onto the phase histogram with `tracer` labels, so one `--trace`
  capture yields the fused-vs-jnp phase breakdown without re-running
  anything.

Division of labor with the device telemetry: device-side truth stays with the traced
`WaveCounters` — this registry ingests host-visible events only, at the
existing drain/serve host boundaries. Nothing here imports jax, nothing
is called from traced code, so the audit/shardcheck/transfer-guard gates
and the compiled programs are untouched by construction.

Kill switch: `TPU_PBRT_METRICS=0`. Every record call is a no-op and no
snapshot/exposition is produced; render stats and serve responses are
byte-identical to a build without the registry (pinned by
tests/test_metrics.py).
"""

from __future__ import annotations

import math
import os
import re
from typing import Any, Dict, List, Optional, Tuple

#: exposition namespace — every metric name is prefixed with this
PREFIX = "tpu_pbrt_"

#: fixed latency edges (seconds): sub-ms host hops through multi-minute
#: chunk drains. Fixed at import so every snapshot is comparable.
TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label(v: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return (
        str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    """Canonical (sorted) label tuple — the series key. Values are
    stringified here so snapshot/exposition need no further coercion."""
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt_value(v: float) -> str:
    """Sample-value formatting: integers print as integers (counter
    increments are usually whole), floats round-trip via repr."""
    if isinstance(v, bool):
        return "1" if v else "0"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_le(edge: float) -> str:
    return "+Inf" if math.isinf(edge) else _fmt_value(edge)


def percentile_from_buckets(
    edges: Tuple[float, ...], counts: List[int], q: float
) -> Optional[float]:
    """The q-quantile implied by fixed-bucket counts: find the covering
    bucket by cumulative rank and interpolate linearly inside it.
    Deterministic (pure function of the counts); None on no data. The
    +Inf bucket cannot be interpolated — it clamps to the last finite
    edge (an under-estimate, which for SLO shedding is the conservative
    direction only if edges cover the targets; pick edges accordingly)."""
    total = sum(counts)
    if total <= 0:
        return None
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        if c > 0 and cum + c >= target:
            lo = edges[i - 1] if i > 0 else 0.0
            hi = edges[i] if i < len(edges) else edges[-1]
            return lo + (hi - lo) * ((target - cum) / c)
        cum += c
    return edges[-1]


class _Metric:
    """Shared series storage: one dict keyed by the canonical label
    tuple. Subclasses define how values accumulate."""

    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str):
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name {name!r}")
        self._reg = registry
        self.name = name
        self.help = help
        self._series: Dict[Tuple[Tuple[str, str], ...], Any] = {}

    def _enabled(self) -> bool:
        return self._reg.enabled

    def labelsets(self) -> List[Dict[str, str]]:
        return [dict(k) for k in sorted(self._series)]


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if not self._enabled():
            return
        if value < 0:
            raise ValueError(f"counter {self.name} decremented by {value}")
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not self._enabled():
            return
        self._series[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, registry, name, help, buckets=TIME_BUCKETS):
        super().__init__(registry, name, help)
        edges = tuple(float(b) for b in buckets)
        if list(edges) != sorted(set(edges)) or not edges:
            raise ValueError(f"histogram {name}: edges must be sorted unique")
        if math.isinf(edges[-1]):
            edges = edges[:-1]  # the +Inf bucket is implicit
        self.edges = edges
        # per-series exemplars: label key -> [(value, seq, fields), ...]
        self._exemplars: Dict[Tuple[Tuple[str, str], ...], list] = {}

    def observe(
        self, value: float, exemplar: Optional[Dict[str, Any]] = None,
        **labels,
    ) -> None:
        if not self._enabled():
            return
        key = _label_key(labels)
        ser = self._series.get(key)
        if ser is None:
            # [bucket counts (len(edges)+1, last = +Inf), sum, count]
            ser = self._series[key] = [[0] * (len(self.edges) + 1), 0.0, 0]
        v = float(value)
        i = len(self.edges)
        for j, edge in enumerate(self.edges):
            if v <= edge:
                i = j
                break
        ser[0][i] += 1
        ser[1] += v
        if exemplar is not None:
            # seq = pre-increment observation count: a deterministic
            # tiebreak that needs no extra state
            self._note_exemplar(key, v, ser[2], exemplar)
        ser[2] += 1

    def _note_exemplar(self, key, v: float, seq: int, fields):
        """Bounded, deterministic exemplar retention (tpu-scope): keep
        the top-K observations by value — the tail a debugger wants to
        join back to a trace — with the join ids (trace_id/span_id) the
        caller attached. Replacement is strictly-greater-than-the-min
        with ties keeping the EARLIEST observation, so the retained set
        is a pure function of the observation sequence (no reservoir
        sampling, no clock), matching the registry's determinism
        contract."""
        from tpu_pbrt_torch.config import cfg

        k = cfg.metrics_exemplars
        if k <= 0:
            return
        ex = self._exemplars.setdefault(key, [])
        entry = (v, seq, dict(fields))
        if len(ex) < k:
            ex.append(entry)
            return
        mi = min(range(len(ex)), key=lambda i: (ex[i][0], -ex[i][1]))
        if v > ex[mi][0]:
            ex[mi] = entry

    def exemplars(self, **labels) -> List[Dict[str, Any]]:
        """Retained exemplars for one series, largest value first
        (deterministic order: value desc, then observation seq)."""
        ex = self._exemplars.get(_label_key(labels), [])
        return [
            {"value": v, **fields}
            for v, _, fields in sorted(ex, key=lambda e: (-e[0], e[1]))
        ]

    def _matching(self, match: Optional[Dict[str, Any]]):
        want = {str(k): str(v) for k, v in (match or {}).items()}
        for key, ser in sorted(self._series.items()):
            kd = dict(key)
            if all(kd.get(k) == v for k, v in want.items()):
                yield key, ser

    def percentile(
        self, q: float, match: Optional[Dict[str, Any]] = None
    ) -> Optional[float]:
        """q-quantile over every series whose labels match `match`
        (subset semantics; {} or None = all series aggregated)."""
        agg = [0] * (len(self.edges) + 1)
        for _, ser in self._matching(match):
            for i, c in enumerate(ser[0]):
                agg[i] += c
        return percentile_from_buckets(self.edges, agg, q)

    def aggregate(self, match: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Summed (sum, count, p50/p90/p99) over matching series —
        the bench/stats summary shape."""
        total_sum = 0.0
        total_n = 0
        agg = [0] * (len(self.edges) + 1)
        for _, ser in self._matching(match):
            for i, c in enumerate(ser[0]):
                agg[i] += c
            total_sum += ser[1]
            total_n += ser[2]
        if total_n == 0:
            return {}
        return {
            "seconds": round(total_sum, 6),
            "count": total_n,
            "p50": round(percentile_from_buckets(self.edges, agg, 0.50), 6),
            "p90": round(percentile_from_buckets(self.edges, agg, 0.90), 6),
            "p99": round(percentile_from_buckets(self.edges, agg, 0.99), 6),
        }


class MetricsRegistry:
    """Process-wide registry (the `METRICS` singleton). Registration is
    get-or-create keyed by name — instrumentation sites just call
    `METRICS.histogram(...)` inline and share series automatically; a
    kind conflict (counter re-registered as gauge) raises."""

    def __init__(self, force_enabled: bool = False):
        self._metrics: Dict[str, _Metric] = {}
        self._path: Optional[str] = None
        #: bypass the TPU_PBRT_METRICS kill switch — for OFFLINE use
        #: (trace replay, selftest) where the operator explicitly asked
        #: for an analysis: the switch guards live-render overhead and
        #: stats purity, neither of which an offline registry touches
        self._force = bool(force_enabled)

    @property
    def enabled(self) -> bool:
        if self._force:
            return True
        from tpu_pbrt_torch.config import cfg

        return bool(cfg.metrics)

    # -- registration ------------------------------------------------------
    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        if not name.startswith(PREFIX):
            name = PREFIX + name
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(self, name, help, **kw)
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name} already registered as {m.kind}, "
                f"not {cls.kind}"
            )
        elif "buckets" in kw:
            # a second registration site asking for DIFFERENT edges
            # would silently record into the first site's buckets (every
            # observation past the smaller scale lands in +Inf) — a
            # conflict must raise like the kind conflict above
            want = tuple(float(b) for b in kw["buckets"])
            if want and math.isinf(want[-1]):
                want = want[:-1]
            if want != m.edges:
                raise ValueError(
                    f"histogram {name} already registered with edges "
                    f"{m.edges}, not {want}"
                )
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets=TIME_BUCKETS
    ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def reset(self) -> None:
        """Drop every metric AND its registration (test seam)."""
        self._metrics.clear()

    # -- export ------------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Deterministic JSON-safe dict: metric names sorted, series
        sorted by label tuple, histogram percentiles precomputed."""
        out: Dict[str, Any] = {"schema": "tpu-pbrt-metrics-v1", "metrics": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            series = []
            for key in sorted(m._series):
                ser = m._series[key]
                entry: Dict[str, Any] = {"labels": dict(key)}
                if m.kind == "histogram":
                    entry |= {
                        "buckets": [_fmt_le(e) for e in m.edges] + ["+Inf"],
                        "counts": list(ser[0]),
                        "sum": ser[1],
                        "count": ser[2],
                    }
                    for q, label in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                        entry[label] = percentile_from_buckets(
                            m.edges, ser[0], q
                        )
                    ex = m.exemplars(**dict(key))
                    if ex:
                        entry["exemplars"] = ex
                else:
                    entry["value"] = ser
                series.append(entry)
            out["metrics"][name] = {
                "type": m.kind, "help": m.help, "series": series,
            }
        return out

    def exposition(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if not m._series:
                # a registration with nothing recorded (e.g. the kill
                # switch was on) exposes nothing — not even headers, so
                # TPU_PBRT_METRICS=0 yields an empty page by contract
                continue
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for key in sorted(m._series):
                ser = m._series[key]
                base_labels = list(key)
                if m.kind == "histogram":
                    cum = 0
                    for i, edge in enumerate(list(m.edges) + [math.inf]):
                        cum += ser[0][i]
                        lab = _render_labels(
                            base_labels + [("le", _fmt_le(edge))]
                        )
                        lines.append(f"{name}_bucket{lab} {cum}")
                    lab = _render_labels(base_labels)
                    lines.append(f"{name}_sum{lab} {_fmt_value(ser[1])}")
                    lines.append(f"{name}_count{lab} {ser[2]}")
                else:
                    lab = _render_labels(base_labels)
                    lines.append(f"{name}{lab} {_fmt_value(ser)}")
        return "\n".join(lines) + ("\n" if lines else "")

    # -- snapshot file (--metrics-path) ------------------------------------
    def configure(self, path: Optional[str]) -> None:
        self._path = path or None

    @property
    def path(self) -> Optional[str]:
        from tpu_pbrt_torch.config import cfg

        return self._path or cfg.metrics_path

    def export(self, path: Optional[str] = None) -> Optional[str]:
        """Write the exposition text atomically (tmp+rename, the
        checkpoint/trace pattern: a crash mid-write must leave the last
        valid snapshot, not a truncated one)."""
        path = path or self.path
        if not path:
            return None
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.exposition())
        os.replace(tmp, path)
        return path

    def maybe_export(self) -> Optional[str]:
        return self.export() if (self.enabled and self.path) else None


def _render_labels(pairs: List[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in sorted(pairs))
    return "{" + inner + "}"


#: the process-wide registry every instrumentation site records into
METRICS = MetricsRegistry()


# -- render-phase attribution ------------------------------------------------

#: render span names -> phase labels; fold_trace and the inline render-loop
#: attribution write the SAME histogram, so a live capture and an offline
#: trace replay land in one comparable place
PHASE_HISTOGRAM = "render_phase_seconds"
SPAN_PHASES = {
    "render/chunk_dispatch": "dispatch",
    "render/chunk_dispatch+compile": "dispatch_compile",
    # a dispatch issued while older slices are still in flight (the
    # pipelined window): its host cost is hidden under device
    # compute, so it is attributed separately from a bare dispatch
    "render/chunk_dispatch_ahead": "dispatch_ahead",
    "render/chunk_retire": "device_wait",
    "render/wave_drain+film_merge": "device_wait",
    "render/develop": "deposit_develop",
    "render/write_image": "deposit_develop",
    "render/checkpoint": "checkpoint",
    "serve/slice": "dispatch",
    "serve/slice_ahead": "dispatch_ahead",
    "serve/slice_retire": "device_wait",
}


def phase_histogram(registry: MetricsRegistry = METRICS) -> Histogram:
    return registry.histogram(
        PHASE_HISTOGRAM,
        "wall seconds per render-loop phase (labels: phase, tracer)",
    )


def fold_trace(doc, registry: MetricsRegistry = METRICS) -> int:
    """Fold a Chrome-trace document (dict, or a path to one) into the
    phase histogram: every complete ('X') span whose name maps to a
    phase is observed with its tracer label. Returns the number of
    spans folded. This is the offline half of phase attribution — a
    `--trace` capture from a LIVE run replays into the exact histograms
    the inline instrumentation fills, labeled fused vs jnp."""
    import json

    if isinstance(doc, str):
        with open(doc) as f:
            doc = json.load(f)
    hist = phase_histogram(registry)
    n = 0
    for ev in doc.get("traceEvents", []):
        if not isinstance(ev, dict) or ev.get("ph") != "X":
            continue
        phase = SPAN_PHASES.get(ev.get("name"))
        if phase is None:
            continue
        args = ev.get("args") or {}
        hist.observe(
            float(ev.get("dur", 0)) / 1e6,
            phase=phase,
            tracer=str(args.get("tracer", "unknown")),
        )
        n += 1
    return n


def phase_summary(
    registry: MetricsRegistry = METRICS,
) -> Optional[Dict[str, Any]]:
    """{phase: {seconds, count, p50, p90, p99}} over every tracer label —
    the bench-JSON `telemetry.phase_seconds` block and the render-stats
    summary. None when the registry is off or holds no phase data."""
    if not registry.enabled:
        return None
    m = registry._metrics.get(PREFIX + PHASE_HISTOGRAM)
    if m is None or not m._series:
        return None
    phases = sorted({dict(k).get("phase", "") for k in m._series})
    out = {}
    for ph in phases:
        agg = m.aggregate(match={"phase": ph})
        if agg:
            out[ph] = agg
    return out or None


def host_overlap_fraction(
    phases: Optional[Dict[str, float]] = None,
    wall_seconds: Optional[float] = None,
    registry: MetricsRegistry = METRICS,
) -> Optional[float]:
    """device_wait seconds / wall — the fraction of the drain's wall
    time the host spent blocked on device compute rather than doing its
    own work serially (the dispatch window's acceptance metric). 1.0
    means every host-side second — deposit bookkeeping, develop,
    checkpoint serialization, scheduling — was hidden under in-flight
    dispatches; the gap to 1.0 is the host tax the pipeline window
    exists to hide.

    `phases` is a {phase: seconds} dict (a render's
    stats["phase_seconds"]); None aggregates the process-wide phase
    histogram instead. `wall_seconds` is the measured wall clock; None
    falls back to the sum of the attributed phases (a lower bound on
    wall, so the fallback fraction is an upper bound). Returns None
    when nothing was attributed."""
    if phases is None:
        summ = phase_summary(registry)
        if not summ:
            return None
        phases = {ph: agg["seconds"] for ph, agg in summ.items()}
    if not phases:
        return None
    wall = wall_seconds if wall_seconds else sum(phases.values())
    if not wall or wall <= 0:
        return None
    return round(min(float(phases.get("device_wait", 0.0)) / wall, 1.0), 4)


# -- validation (tests + `python -m tpu_pbrt_torch.obs` + CI) --------------------


def validate_snapshot(doc: Any) -> List[str]:
    """Validate a registry snapshot() dict (or a path to its JSON)."""
    import json

    if isinstance(doc, str):
        try:
            with open(doc) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            return [f"unreadable snapshot: {e}"]
    errs: List[str] = []
    if not isinstance(doc, dict) or doc.get("schema") != "tpu-pbrt-metrics-v1":
        return ["snapshot must be an object with schema tpu-pbrt-metrics-v1"]
    metrics = doc.get("metrics")
    if not isinstance(metrics, dict):
        return ["snapshot.metrics must be an object"]
    for name, m in metrics.items():
        where = f"metrics[{name}]"
        if not _NAME_RE.match(str(name)):
            errs.append(f"{where}: bad metric name")
        if not isinstance(m, dict):
            errs.append(f"{where}: not an object")
            continue
        if m.get("type") not in ("counter", "gauge", "histogram"):
            errs.append(f"{where}: bad type {m.get('type')!r}")
            continue
        series = m.get("series", [])
        if not isinstance(series, list):
            errs.append(f"{where}: series is not an array")
            continue
        for i, ser in enumerate(series):
            sw = f"{where}.series[{i}]"
            if not isinstance(ser, dict):
                errs.append(f"{sw}: not an object")
                continue
            labels = ser.get("labels")
            if not isinstance(labels, dict):
                errs.append(f"{sw}: missing labels object")
                continue
            for k in labels:
                if not _LABEL_RE_OK(k):
                    errs.append(f"{sw}: bad label name {k!r}")
            if m["type"] == "histogram":
                counts = ser.get("counts")
                edges = ser.get("buckets")
                if not isinstance(counts, list) or not isinstance(edges, list):
                    errs.append(f"{sw}: histogram needs buckets+counts")
                    continue
                if len(counts) != len(edges):
                    errs.append(
                        f"{sw}: {len(counts)} counts for {len(edges)} buckets"
                    )
                if any((not isinstance(c, int)) or c < 0 for c in counts):
                    errs.append(f"{sw}: negative/non-int bucket count")
                if sum(c for c in counts if isinstance(c, int)) != ser.get(
                    "count"
                ):
                    errs.append(f"{sw}: count != sum of bucket counts")
                ex = ser.get("exemplars")
                if ex is not None:
                    if not isinstance(ex, list):
                        errs.append(f"{sw}: exemplars is not an array")
                    else:
                        for j, e in enumerate(ex):
                            if not isinstance(e, dict) or not isinstance(
                                e.get("value"), (int, float)
                            ):
                                errs.append(
                                    f"{sw}.exemplars[{j}]: missing "
                                    "numeric value"
                                )
            elif not isinstance(ser.get("value"), (int, float)):
                errs.append(f"{sw}: missing numeric value")
    return errs


def _LABEL_RE_OK(name: str) -> bool:
    return bool(_LABEL_NAME_RE.match(str(name)))


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"  # metric name
    r"(?:\{(.*)\})?"  # optional label body (parsed separately)
    r"\s+(\S+)\s*$"  # value
)
_LABEL_PAIR_RE = re.compile(
    r'\s*([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"\s*(,|$)'
)


def _unescape_label(raw: str) -> str:
    """Single left-to-right pass — sequential str.replace would decode
    the '\\\\n' in a value like 'C:\\\\new' as backslash-then-newline
    instead of the literal backslash + 'n' the escaper wrote."""
    out = []
    i = 0
    while i < len(raw):
        ch = raw[i]
        if ch == "\\" and i + 1 < len(raw):
            nxt = raw[i + 1]
            out.append("\n" if nxt == "n" else nxt)
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _parse_labels(body: str) -> Optional[Dict[str, str]]:
    """Parse a Prometheus label body, honoring escapes. None on syntax
    error (including an unescaped quote, which the naive split a lint
    must catch would mis-parse)."""
    out: Dict[str, str] = {}
    pos = 0
    while pos < len(body):
        m = _LABEL_PAIR_RE.match(body, pos)
        if m is None:
            return None
        out[m.group(1)] = _unescape_label(m.group(2))
        pos = m.end()
    return out


def validate_exposition(text: str) -> List[str]:
    """Lint a Prometheus text exposition: TYPE lines present and legal,
    sample/label syntax (incl. escaping), histogram bucket counts
    cumulative-monotone with a +Inf bucket equal to _count. Returns a
    list of problems; empty = a scraper will accept the page."""
    errs: List[str] = []
    types: Dict[str, str] = {}
    # histogram accounting: base name -> series key -> {le: value}
    hbuckets: Dict[str, Dict[Tuple, Dict[float, float]]] = {}
    hsums: Dict[str, Dict[Tuple, float]] = {}
    hcounts: Dict[str, Dict[Tuple, float]] = {}
    for ln, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line:
            continue
        where = f"line {ln}"
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                errs.append(f"{where}: malformed TYPE line")
                continue
            _, _, name, kind = parts
            if kind not in ("counter", "gauge", "histogram", "summary",
                           "untyped"):
                errs.append(f"{where}: unknown type {kind!r}")
            if name in types:
                errs.append(f"{where}: duplicate TYPE for {name}")
            types[name] = kind
            continue
        if line.startswith("#"):
            continue  # HELP / comments
        m = _SAMPLE_RE.match(line)
        if m is None:
            errs.append(f"{where}: unparseable sample")
            continue
        name, label_body, value_s = m.group(1), m.group(2), m.group(3)
        labels = _parse_labels(label_body) if label_body else {}
        if labels is None:
            errs.append(f"{where}: bad label syntax/escaping")
            continue
        try:
            value = float(value_s)
        except ValueError:
            errs.append(f"{where}: non-numeric value {value_s!r}")
            continue
        # resolve the declaring TYPE (histograms expose _bucket/_sum/_count)
        base = None
        if name in types:
            base = name
        else:
            for suffix in ("_bucket", "_sum", "_count"):
                if name.endswith(suffix) and name[: -len(suffix)] in types:
                    base = name[: -len(suffix)]
                    break
        if base is None:
            errs.append(f"{where}: sample {name} has no preceding TYPE line")
            continue
        if types[base] == "histogram" and base != name:
            key = tuple(sorted(
                (k, v) for k, v in labels.items() if k != "le"
            ))
            if name.endswith("_bucket"):
                le_s = labels.get("le")
                if le_s is None:
                    errs.append(f"{where}: histogram bucket without le")
                    continue
                try:
                    le = math.inf if le_s == "+Inf" else float(le_s)
                except ValueError:
                    errs.append(f"{where}: non-numeric le {le_s!r}")
                    continue
                hbuckets.setdefault(base, {}).setdefault(key, {})[le] = value
            elif name.endswith("_sum"):
                hsums.setdefault(base, {})[key] = value
            elif name.endswith("_count"):
                hcounts.setdefault(base, {})[key] = value
        if value < 0 and types[base] == "counter":
            errs.append(f"{where}: negative counter sample")
    for base, series in hbuckets.items():
        for key, by_le in series.items():
            lab = dict(key)
            ledges = sorted(by_le)
            if not ledges or not math.isinf(ledges[-1]):
                errs.append(f"{base}{lab}: histogram missing +Inf bucket")
                continue
            vals = [by_le[e] for e in ledges]
            if any(b < a for a, b in zip(vals, vals[1:])):
                errs.append(
                    f"{base}{lab}: bucket counts not monotone "
                    f"non-decreasing: {vals}"
                )
            cnt = hcounts.get(base, {}).get(key)
            if cnt is None:
                errs.append(f"{base}{lab}: histogram missing _count")
            elif cnt != vals[-1]:
                errs.append(
                    f"{base}{lab}: _count {cnt} != +Inf bucket {vals[-1]}"
                )
            if hsums.get(base, {}).get(key) is None:
                errs.append(f"{base}{lab}: histogram missing _sum")
    return errs
