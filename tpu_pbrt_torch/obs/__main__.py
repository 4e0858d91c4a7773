"""`python -m tpu_pbrt_torch.obs` — validate exported telemetry artifacts.

    python -m tpu_pbrt_torch.obs trace.json \
        --flight flight.jsonl --require-phases render,develop \
        --metrics metrics.prom --metrics-snapshot metrics.json

Exit 0 iff every named artifact validates: the trace JSON loads in
Perfetto (schema check, no browser needed), the flight JSONL carries
>= 1 heartbeat for every required phase, a `--metrics` exposition file
passes the Prometheus text-format lint (type lines, label escaping,
monotone cumulative bucket counts), and a `--metrics-snapshot` JSON
matches the registry snapshot schema. The same checks are importable
via
trace.validate_trace / flight.validate_flight /
metrics.validate_exposition / metrics.validate_snapshot.

Extras:
  --fold-metrics   fold the trace's phase spans into a metrics registry
                   and print the per-phase summary (the offline half of
                   the fused-vs-plain phase attribution)
  --metrics-selftest  exercise the registry end to end (record -> lint
                   exposition -> percentile math) with no render.
  --health         evaluate the tpu-scope health watchdog (obs/health.py)
                   over a --metrics-snapshot file (the registry-derived
                   conditions: slo_burn, nonfinite_spike; wedge/storm
                   need a live service — use the daemon's `health` verb)
                   and exit non-zero if any condition fires.
"""

from __future__ import annotations

import argparse
import json
import sys

from tpu_pbrt_torch.obs.flight import validate_flight
from tpu_pbrt_torch.obs.trace import validate_trace


def metrics_selftest() -> int:
    """Registry smoke with zero renders: known observations in, validated
    exposition + exact percentile expectations out. Runs import-free of
    torch (obs.metrics is pure host Python)."""
    from tpu_pbrt_torch.obs import metrics as m

    # force_enabled: the selftest validates the registry itself, so the
    # live-render kill switch must not turn it into a silent no-op
    reg = m.MetricsRegistry(force_enabled=True)
    fails = []
    h = reg.histogram("selftest_seconds", "selftest latencies")
    # 100 observations landing in known buckets: 1..100 ms
    for i in range(1, 101):
        h.observe(i / 1000.0, tenant="alice" if i % 2 else 'bo"b\\x')
    c = reg.counter("selftest_total", "selftest events")
    c.inc(3, kind="a")
    c.inc(2, kind="b")
    reg.gauge("selftest_depth", "selftest depth").set(4, klass="0")
    p50 = h.percentile(0.5)
    p99 = h.percentile(0.99)
    if not (0.025 <= p50 <= 0.1):
        fails.append(f"p50 {p50} outside the covering buckets")
    if not (0.05 <= p99 <= 0.25):
        fails.append(f"p99 {p99} outside the covering buckets")
    text = reg.exposition()
    errs = m.validate_exposition(text)
    fails += [f"exposition: {e}" for e in errs]
    errs = m.validate_snapshot(reg.snapshot())
    fails += [f"snapshot: {e}" for e in errs]
    # determinism: a second registry fed the same events exposes the
    # same bytes
    reg2 = m.MetricsRegistry(force_enabled=True)
    h2 = reg2.histogram("selftest_seconds", "selftest latencies")
    for i in range(1, 101):
        h2.observe(i / 1000.0, tenant="alice" if i % 2 else 'bo"b\\x')
    c2 = reg2.counter("selftest_total", "selftest events")
    c2.inc(3, kind="a")
    c2.inc(2, kind="b")
    reg2.gauge("selftest_depth", "selftest depth").set(4, klass="0")
    if reg2.exposition() != text:
        fails.append("same events produced a different exposition")
    for f in fails:
        print(f"FAIL metrics-selftest: {f}", file=sys.stderr)
    if not fails:
        print(f"metrics selftest OK ({len(text.splitlines())} lines)")
    return 1 if fails else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu_pbrt_torch.obs")
    ap.add_argument(
        "trace", nargs="?", help="Chrome-trace JSON file to validate"
    )
    ap.add_argument(
        "--flight", default="", help="flight-recorder JSONL file to validate"
    )
    ap.add_argument(
        "--require-phases", default="",
        help="comma-separated phases the flight file must each have "
             ">= 1 heartbeat for",
    )
    ap.add_argument(
        "--min-spans", type=int, default=1,
        help="minimum number of trace events required (default 1)",
    )
    ap.add_argument(
        "--metrics", default="",
        help="Prometheus text exposition file to lint",
    )
    ap.add_argument(
        "--metrics-snapshot", default="",
        help="metrics registry JSON snapshot file to validate",
    )
    ap.add_argument(
        "--fold-metrics", action="store_true",
        help="fold the trace's phase spans into a registry and print the "
             "per-phase time-attribution summary",
    )
    ap.add_argument(
        "--metrics-selftest", action="store_true",
        help="run the registry selftest (record/lint/percentiles) and exit",
    )
    ap.add_argument(
        "--health", action="store_true",
        help="evaluate the health watchdog over --metrics-snapshot "
             "(registry-derived conditions) and exit non-zero if firing",
    )
    args = ap.parse_args(argv)
    if args.metrics_selftest:
        return metrics_selftest()
    if args.fold_metrics and not args.trace:
        ap.error("--fold-metrics needs a trace file to fold")
    if args.health and not args.metrics_snapshot:
        ap.error("--health needs --metrics-snapshot to evaluate")
    if not any((args.trace, args.flight, args.metrics,
                args.metrics_snapshot)):
        ap.error(
            "nothing to validate: pass a trace file, --flight, --metrics "
            "and/or --metrics-snapshot"
        )

    problems = []
    if args.trace:
        errs = validate_trace(args.trace)
        problems += [f"trace: {e}" for e in errs]
        if not errs:
            with open(args.trace) as f:
                n = len(json.load(f)["traceEvents"])
            if n < args.min_spans:
                problems.append(
                    f"trace: only {n} events (need >= {args.min_spans})"
                )
            else:
                print(f"trace OK: {args.trace} ({n} events)")
        if not errs and args.fold_metrics:
            from tpu_pbrt_torch.obs import metrics as m

            # force_enabled: an explicitly requested OFFLINE replay must
            # work even when the capture ran under TORCH_PBRT_METRICS=0
            reg = m.MetricsRegistry(force_enabled=True)
            folded = m.fold_trace(args.trace, reg)
            print(f"folded {folded} phase spans from {args.trace}")
            print(json.dumps(m.phase_summary(reg), indent=2))
    if args.flight:
        phases = [p for p in args.require_phases.split(",") if p]
        errs = validate_flight(args.flight, require_phases=phases)
        problems += [f"flight: {e}" for e in errs]
        if not errs:
            print(f"flight OK: {args.flight} (phases: {phases or 'any'})")
    if args.metrics:
        from tpu_pbrt_torch.obs.metrics import validate_exposition

        try:
            with open(args.metrics) as f:
                errs = validate_exposition(f.read())
        except OSError as e:
            errs = [f"unreadable exposition file: {e}"]
        problems += [f"metrics: {e}" for e in errs]
        if not errs:
            print(f"metrics OK: {args.metrics}")
    if args.metrics_snapshot:
        from tpu_pbrt_torch.obs.metrics import validate_snapshot

        errs = validate_snapshot(args.metrics_snapshot)
        problems += [f"metrics-snapshot: {e}" for e in errs]
        if not errs:
            print(f"metrics snapshot OK: {args.metrics_snapshot}")
        if not errs and args.health:
            from tpu_pbrt_torch.obs.health import evaluate_snapshot

            rep = evaluate_snapshot(args.metrics_snapshot)
            print(json.dumps(rep.to_dict(), indent=2))
            if not rep.ok:
                problems += [
                    f"health: condition firing: {name}"
                    for name in rep.firing()
                ]

    for p in problems:
        print(f"FAIL {p}", file=sys.stderr)
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())
