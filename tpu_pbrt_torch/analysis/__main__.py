"""`python -m tpu_pbrt_torch.analysis` — run the port's analysis suite
(counterpart of tpu_pbrt/analysis/__main__.py).

Stages, in order:
- the AST lint (`lint.py`), always;
- the audit (`audit.py`): the entry points recorded on the device and
  their invariants (film in place, no rebuild, host reads equal the
  tally's, float64 confined, no callbacks); `--no-audit` skips it;
- the static cost and its budget gate (`cost.py`) against the committed
  `tpu_pbrt_torch/analysis/budgets.json` entries of the device;
  `--no-cost` skips it, `--update-budgets` rewrites the device's entries
  instead of gating against them (`--budgets PATH` reads and writes
  another file);
- hbmcheck (`hbmcheck.py`): the device-memory model of the serve
  lifecycle and its rules HC-CAP, HC-LEAK, HC-ACCT and HC-ALIAS against
  the committed `hbm_budgets.json`; `--no-hbmcheck` skips it,
  `--update-budgets` refreshes its entries too.

`--device` picks the device the audit and the cost record on: CUDA by
default (config.resolve_device), or `--device cpu`; without a card the
default exits 1. The audit's records are rolled up by the cost stage
too, so each entry point runs once.

Exit code 0 iff no error in any stage that ran and the pragma count is
within the lint's budget. A stage that crashes is reported as that
stage's failure and the rest still run.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu_pbrt_torch.analysis")
    ap.add_argument("paths", nargs="*", help="files to lint (default: all of tpu_pbrt_torch/)")
    ap.add_argument("--no-audit", action="store_true", help="skip the recorded-run audit")
    ap.add_argument("--no-cost", action="store_true", help="skip the static cost / budget gate")
    ap.add_argument("--no-hbmcheck", action="store_true",
                    help="skip the device-memory model of the serve lifecycle")
    ap.add_argument("--update-budgets", action="store_true",
                    help="rewrite the device's entries of budgets.json from this tree instead of "
                         "gating against them (commit the result)")
    ap.add_argument("--budgets", default=None, help="the budgets file (default: the committed "
                    "tpu_pbrt_torch/analysis/budgets.json)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)

    from tpu_pbrt_torch.analysis.lint import PRAGMA_BUDGET, lint_tree

    repo_root = Path(__file__).resolve().parents[2]
    paths = [Path(p).resolve() for p in args.paths] or None
    violations, pragmas = lint_tree(repo_root, paths)
    over_budget = paths is None and pragmas > PRAGMA_BUDGET

    device = None
    if not (args.no_audit and args.no_cost):
        from tpu_pbrt_torch.config import resolve_device

        try:
            device = resolve_device(args.device).type
        except (RuntimeError, ValueError) as e:
            print(f"analysis: {e}", file=sys.stderr)
            return 1
        import torch

        torch.manual_seed(0)

    def _stage(fn, sink):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - every stage reports
            sink.append(f"stage crashed: {type(e).__name__}: {e}")
            return None

    runs: dict = {}
    audit_failures: list = []
    if not args.no_audit:
        def _audit():
            from tpu_pbrt_torch.analysis import audit

            for name, fn in audit.entry_points(device).items():
                try:
                    runs[name] = fn()
                except Exception:  # noqa: BLE001 - run_audit records it again and reports
                    pass
            return audit.run_audit(device, runs=runs)

        audit_failures = _stage(_audit, audit_failures) or audit_failures

    cost_errors: list = []
    cost_warnings: list = []
    rollups: dict = {}
    cost_findings: list = []
    if not args.no_cost:
        def _cost():
            from tpu_pbrt_torch.analysis.cost import run_cost

            return run_cost(update=args.update_budgets, device=device, runs=runs,
                            budgets_path=Path(args.budgets) if args.budgets else None)

        out = _stage(_cost, cost_errors)
        if out is not None:
            cost_errors, cost_warnings, rollups, cost_findings = out

    hbm_errors: list = []
    hbm_warnings: list = []
    if not args.no_hbmcheck:
        def _hbm():
            from tpu_pbrt_torch.analysis.hbmcheck import run_hbmcheck

            return run_hbmcheck(update=args.update_budgets)

        out = _stage(_hbm, hbm_errors)
        if out is not None:
            hbm_errors, hbm_warnings = out

    errors = [v for v in violations if v.severity == "error"]
    ok = not (errors or audit_failures or over_budget or cost_errors or hbm_errors)
    if args.format == "json":
        print(json.dumps({
            "device": device,
            "lint": [v.__dict__ for v in violations],
            "audit": audit_failures,
            "cost": {
                "rollups": {k: dict(r.to_json(), intensity=round(r.intensity, 3))
                            for k, r in rollups.items()},
                "findings": [{"rule": f.rule, "entry": f.entry, "detail": f.detail,
                              "severity": f.severity, "waived": f.waived}
                             for f in cost_findings],
                "errors": cost_errors,
                "warnings": cost_warnings,
            },
            "hbmcheck": {"errors": hbm_errors, "warnings": hbm_warnings},
            "pragmas": pragmas,
            "pragma_budget": PRAGMA_BUDGET,
            "ok": ok,
        }))
    else:
        for v in violations:
            print(v)
        for f in audit_failures:
            print(f"AUDIT: {f}")
        for r in rollups.values():
            print(f"COST {r.entry} [{r.device}]: {r.flops} flops, {r.hbm_bytes} B, {r.ops} ops "
                  f"per wave over {r.waves} waves, intensity {r.intensity:.3f}, "
                  f"fp {r.fingerprint}")
        for w in cost_warnings:
            print(f"COST [warning]: {w}")
        for e in cost_errors:
            print(f"COST [error]: {e}")
        if args.update_budgets and not args.no_cost and not cost_errors:
            from tpu_pbrt_torch.analysis.cost import BUDGETS_PATH

            print(f"cost: {device} budgets refreshed -> {args.budgets or BUDGETS_PATH}")
        for w in hbm_warnings:
            print(f"HBM [warning]: {w}")
        for e in hbm_errors:
            print(f"HBM [error]: {e}")
        n_warn = len(violations) - len(errors)
        audit_part = ("audit skipped" if args.no_audit
                      else f"{len(audit_failures)} audit failure(s)")
        cost_part = "cost skipped" if args.no_cost else f"{len(cost_errors)} cost error(s)"
        hbm_part = ("hbmcheck skipped" if args.no_hbmcheck
                    else f"{len(hbm_errors)} hbmcheck error(s)")
        print(f"torchlint: {len(errors)} error(s), {n_warn} warning(s), {audit_part}, "
              f"{cost_part}, {hbm_part}, {pragmas} pragma suppression(s) "
              f"(budget {PRAGMA_BUDGET}); "
              f"device {device or '-'}")
        if over_budget:
            print(f"torchlint: pragma budget exceeded ({pragmas} > {PRAGMA_BUDGET}) — fix the "
                  "code instead of suppressing")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
