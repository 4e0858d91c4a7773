"""Static cost per wave of the port's entry points, with budgets
(counterpart of tpu_pbrt/analysis/cost.py).

The reference walks each entry point's jaxpr and charges every equation
FLOPs and HBM bytes. The port has no jaxpr: it charges the ops that one
recorded run of each entry point dispatched (analysis/record.py, the
runs of analysis/audit.py) and divides by the run's waves, so each
figure reads "per wave":

- **per-op model** (the reference's, on aten names): a transcendental
  (exp, log, sin, sqrt, pow, ...) weighs 8 FLOPs an element; data
  movement (copies, casts, concatenation, creation) costs bytes and no
  FLOPs; a view (view, expand, permute, slice, select, ...) moves
  nothing in torch and costs nothing but its op; a reduction costs its
  input elements; a gather its output elements, and it reads only the
  rows it fetches; a scatter its updates, and it reads and writes its
  whole operand; mm / bmm 2 M N K; a sort n log2 n per operand; any
  other op one FLOP per output element. Bytes are the unfused traffic:
  every input read and every output written (a Python number passed
  to an op on the card is a literal, not traffic);
- **kernels**: a kernel wrapper call is charged its own work, from one
  definition that chip_smoke.py's bounds read too:
  kernels/flush.py::flush_work (the padded figure, the kernel's own
  schedule, in the spirit of the reference's `_charge_pallas`) and
  kernels/expand.py::expand_work;
- **rollup**: FLOPs, bytes and ops per wave (the counterpart of the
  reference's `eqns`: on the card each op is a host-side launch, and a
  wave's host cost is its op count), arithmetic intensity, and a
  fingerprint of the first wave's op sequence.

On top of the rollup, the walk reports anti-pattern findings with the
reference's thresholds:

JC-CHURN     a dtype round trip A -> B -> A (`_to_copy` chains through
             views and one-tensor elementwise ops) of at least
             CHURN_MIN_ELEMS elements.
JC-RELAYOUT  a copy that relayouts a non-contiguous view (`clone`,
             `contiguous`) of at least RELAYOUT_MIN_BYTES, per wave.
JC-GATHER    a gather (index, index_select, gather, take) whose rows are
             narrower than GATHER_MIN_SLICE_BYTES over more than
             GATHER_INDEX_FACTOR x the wave width of indices, fetching
             at least GATHER_MIN_TOTAL_BYTES; exempt when the indices
             derive from a sort or an arange (a monotone stream).
JC-BCAST     a broadcast materialized (a copy of an expanded view,
             `repeat`) at BCAST_MIN_RATIO x a non-scalar input and at
             least BCAST_MIN_BYTES.

The reference's JC-PAD models the TPU's (8, 128) f32 vector-memory tile;
the card has no such tile (a tensor pays its own bytes), so it has no
counterpart here. Deliberate patterns are waived in `WAIVERS` with a
reason.

The budget gate compares fresh rollups with the committed
`tpu_pbrt_torch/analysis/budgets.json`, whose entries are keyed by
device type (`cpu`: gated by the tests; `cuda`: written from a run on
the card with `--update-budgets --device cuda`): a rollup past the 10%
tolerance in FLOPs, bytes or ops is an error, a missing entry is an
error, an improvement past it is a ratchet warning, a changed
fingerprint a warning; `--update-budgets` rewrites the device's entries.

    python -m tpu_pbrt_torch.analysis.cost [--device cpu] [--update-budgets]
    python -m tpu_pbrt_torch.analysis.cost --bench-wave [--res 512 --spp 256]
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from tpu_pbrt_torch.analysis.record import OpRecord

# --------------------------------------------------------------------------
# per-op cost model
# --------------------------------------------------------------------------

#: FLOPs-per-element weight of transcendental / iterative elementwise ops
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "sin", "cos", "tan", "asin",
    "acos", "atan", "atan2", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "pow",
    "rsqrt", "sqrt", "erf", "erfc", "erfinv", "sigmoid", "lgamma", "digamma",
}
_TRANSCENDENTAL_WEIGHT = 8

#: views: no data moves, no FLOPs (the op itself is still counted)
_VIEWS = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand", "permute", "transpose", "t",
    "squeeze", "unsqueeze", "slice", "select", "as_strided", "unbind", "split",
    "split_with_sizes", "chunk", "narrow", "view_as", "expand_as", "unfold", "diagonal",
    "view_as_real", "view_as_complex", "squeeze_", "unsqueeze_", "t_", "transpose_",
    "_local_scalar_dense",
}

#: data movement: bytes only
_MOVEMENT = {
    "clone", "contiguous", "copy", "copy_", "_to_copy", "to", "cat", "stack",
    "constant_pad_nd", "pad", "flip", "roll", "repeat", "expand_copy", "tile", "arange",
    "empty", "empty_like", "empty_strided", "zeros", "zeros_like", "ones", "ones_like", "full",
    "full_like", "fill", "fill_", "new_full", "new_zeros", "new_empty", "new_ones",
    "scalar_tensor", "lift_fresh_copy", "zero_", "linspace", "meshgrid", "resize_",
    "_copy_from", "set_",
}

#: reductions: FLOPs = input elements
_REDUCTIONS = {
    "sum", "mean", "prod", "amax", "amin", "any", "all", "argmax", "argmin", "cumsum", "cumprod",
    "cummax", "cummin", "logsumexp", "norm", "linalg_vector_norm", "count_nonzero", "std",
    "var", "aminmax",
}

_SCATTERS = {
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
    "index_add", "index_add_", "index_put", "index_put_", "_index_put_impl_", "index_copy",
    "index_copy_", "index_reduce", "index_reduce_", "masked_scatter", "masked_scatter_",
}

#: gathers: the index operand's position among the op's tensor inputs
_GATHERS = {"index": 1, "index_select": 1, "gather": 1, "take": 1, "take_along_dim": 1,
            "embedding": 1}

_SORTS = {"sort", "argsort", "msort", "topk"}
_MATMUL = {"mm", "bmm", "matmul", "addmm", "baddbmm", "mv", "dot", "vdot"}


def _tensor_bytes(metas) -> int:
    return sum(m.nbytes for m in metas if not m.scalar)


def op_bytes(r: OpRecord) -> int:
    """HBM traffic of one op: every input read, every output written. A
    gather reads only the rows it fetches (not the whole table); a
    scatter reads and writes its whole operand."""
    name = r.name
    if name in _VIEWS:
        return 0
    outs = _tensor_bytes(r.outs)
    if name in _GATHERS:
        idx = _tensor_bytes(r.ins[_GATHERS[name]:])
        return 2 * outs + idx
    if name in _SCATTERS:
        return 2 * _tensor_bytes(r.ins[:1]) + _tensor_bytes(r.ins[1:])
    if name.endswith("_") and r.ins and r.outs and r.outs[0].uid == r.ins[0].uid:
        # in place: the result is the first input, written once
        return _tensor_bytes(r.ins) + outs
    return _tensor_bytes(r.ins) + outs


def op_flops(r: OpRecord) -> int:
    name = r.name.rstrip("_") if r.name not in ("copy_", "fill_", "zero_") else r.name
    out_elems = sum(m.numel for m in r.outs)
    if r.name in _VIEWS or r.name in _MOVEMENT or name in _MOVEMENT:
        return 0
    if name in _MATMUL and len(r.ins) >= 2:
        a = r.ins[-2] if name in ("addmm", "baddbmm") else r.ins[0]
        k = a.shape[-1] if a.shape else 1
        return 2 * k * out_elems
    if name in ("max", "min") and len([m for m in r.ins if not m.scalar]) == 2:
        return out_elems  # elementwise maximum / minimum
    if name in _REDUCTIONS or name in ("max", "min"):
        return sum(m.numel for m in r.ins if not m.scalar)
    if name in _SORTS:
        n = max(r.ins[0].numel, 2) if r.ins else 2
        return int(n * math.log2(n)) * max(len(r.outs) - 1, 1)
    if name in _GATHERS:
        return out_elems
    if r.name in _SCATTERS or name in _SCATTERS:
        upd = sum(m.numel for m in r.ins[2:] if not m.scalar) if len(r.ins) > 2 else 0
        return upd or sum(m.numel for m in r.ins[1:2]) or out_elems
    if name in _TRANSCENDENTAL:
        return _TRANSCENDENTAL_WEIGHT * out_elems
    return out_elems


def kernel_work(r: OpRecord) -> Tuple[float, float]:
    """(FLOPs, bytes) of one kernel wrapper call, from the kernel module's
    own count."""
    if r.name == "flush_chunk":
        from tpu_pbrt_torch.kernels.flush import flush_work

        return flush_work(*r.args)
    if r.name == "expand":
        from tpu_pbrt_torch.kernels.expand import expand_work

        return expand_work(*r.args)
    raise ValueError(f"no work count for kernel {r.name!r}")


# --------------------------------------------------------------------------
# rollup + findings
# --------------------------------------------------------------------------


@dataclass
class Rollup:
    """Static cost per wave of one entry point on one device."""

    entry: str
    flops: int = 0
    hbm_bytes: int = 0
    #: dispatched ops (aten ops and kernel calls) per wave
    ops: float = 0.0
    waves: int = 1
    device: str = "cpu"
    fingerprint: str = ""

    @property
    def intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1)

    def to_json(self) -> Dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes, "ops": self.ops,
                "waves": self.waves, "fingerprint": self.fingerprint}


@dataclass(frozen=True)
class Finding:
    rule: str
    entry: str
    detail: str
    severity: str = "warning"
    waived: Optional[str] = None

    def __str__(self) -> str:
        w = f" (waived: {self.waived})" if self.waived else ""
        return f"{self.entry}: {self.rule} [{self.severity}] {self.detail}{w}"


# thresholds (the reference's; module constants so the tests can use them)
CHURN_MIN_ELEMS = 64
RELAYOUT_MIN_BYTES = 1 << 16
GATHER_MIN_SLICE_BYTES = 16
GATHER_MIN_TOTAL_BYTES = 1 << 16
GATHER_INDEX_FACTOR = 4
BCAST_MIN_BYTES = 1 << 20
BCAST_MIN_RATIO = 64

#: (rule, entry substring, detail substring, reason): deliberate patterns,
#: kept visible in --format json (waived, severity "info") but not failing
WAIVERS: List[Tuple[str, str, str, str]] = [
    (
        "JC-CHURN", "", "core/xla_math.py",
        "the CPU forms of core/xla_math.py (fma32's _fma_f64, the correctly rounded sqrt) "
        "round one f64 result to f32 by design, the reference's fused multiply-add bit for "
        "bit; on CUDA fma32 is one addcmul and sqrt torch's own, with no f64",
    ),
]

_CHURN_PROP = {"view", "_unsafe_view", "reshape", "expand", "permute", "transpose", "t",
               "squeeze", "unsqueeze", "slice", "select", "clone", "contiguous"}
_ONE_TENSOR_ARITH = {"add", "sub", "mul", "neg", "abs", "clamp", "clamp_min", "clamp_max",
                     "maximum", "minimum"}
_SORTED_PROP = _CHURN_PROP | {"_to_copy", "to", "clamp", "clamp_min", "clamp_max", "maximum",
                              "minimum", "where"}
_SORTED_ONE_TENSOR = {"add", "sub", "bitwise_and", "__and__", "__rshift__", "bitwise_right_shift",
                      "remainder", "floor_divide", "div"}


def _waiver_for(rule: str, entry: str, detail: str) -> Optional[str]:
    for r, e, d, reason in WAIVERS:
        if r == rule and e in entry and d in detail:
            return reason
    return None


class _Walk:
    def __init__(self, entry: str, wave_width: int):
        self.entry = entry
        self.wave = max(int(wave_width), 1)
        self.findings: List[Finding] = []
        #: tensor uid -> the dtype its convert chain left
        self._churn: Dict[int, torch.dtype] = {}
        #: tensor uids that derive from a sort's output
        self._sorted: set = set()

    def emit(self, rule: str, detail: str) -> None:
        waived = _waiver_for(rule, self.entry, detail)
        f = Finding(rule, self.entry, detail, severity="info" if waived else "warning",
                    waived=waived)
        if f not in self.findings:
            self.findings.append(f)

    def visit(self, r: OpRecord) -> None:
        if r.kind != "op":
            return
        self._check_churn(r)
        self._track_sorted(r)
        name = r.name
        if name in ("clone", "contiguous", "_to_copy", "copy_", "repeat", "expand_copy", "tile"):
            self._check_copy(r)
        elif name in _GATHERS and len(r.ins) > _GATHERS[name]:
            self._check_gather(r)

    def _one_tensor(self, r: OpRecord) -> bool:
        return sum(0 if m.scalar or m.numel <= 1 else 1 for m in r.ins) == 1

    def _check_churn(self, r: OpRecord) -> None:
        if r.name in ("_to_copy", "to") and r.ins and r.outs:
            src, out = r.ins[0], r.outs[0]
            if src.dtype == out.dtype:
                self._prop_churn(r)
                return
            tag = self._churn.get(src.uid)
            if tag is not None and tag == out.dtype and out.numel >= CHURN_MIN_ELEMS:
                self.emit("JC-CHURN", f"{out.dtype}->{src.dtype}->{out.dtype} round trip @ "
                          f"{out.numel} elems {r.frame} — two convert passes over the array; "
                          "keep one dtype through the chain")
            else:
                self._churn[out.uid] = src.dtype
            return
        if r.name in _CHURN_PROP or (r.name in _ONE_TENSOR_ARITH and self._one_tensor(r)):
            self._prop_churn(r)

    def _prop_churn(self, r: OpRecord) -> None:
        for m in r.ins:
            tag = self._churn.get(m.uid)
            if tag is not None:
                for o in r.outs:
                    self._churn[o.uid] = tag
                return

    def _track_sorted(self, r: OpRecord) -> None:
        # a sort's output, and an arange (a monotone index stream: the
        # reference's literal iota indices)
        if r.name in _SORTS or r.name == "arange":
            self._sorted.update(o.uid for o in r.outs)
            return
        if r.name in _SORTED_PROP or (r.name in _SORTED_ONE_TENSOR and self._one_tensor(r)):
            if any(m.uid in self._sorted for m in r.ins):
                self._sorted.update(o.uid for o in r.outs)

    def _check_copy(self, r: OpRecord) -> None:
        if not r.ins or not r.outs:
            return
        src, out = r.ins[-1] if r.name == "copy_" else r.ins[0], r.outs[0]
        if r.name in ("repeat", "expand_copy", "tile") or src.broadcast:
            in_elems = src.base if src.broadcast else src.numel
            in_b = max(in_elems * src.dtype.itemsize, 1)
            if in_elems > 1 and out.nbytes >= BCAST_MIN_BYTES and \
                    out.nbytes // in_b >= BCAST_MIN_RATIO:
                self.emit("JC-BCAST", f"broadcast blowup {in_b} B -> {out.nbytes} B "
                          f"({out.nbytes // in_b}x) @ {out.shape} — the expansion is "
                          "materialized; keep it a view")
            return
        if not src.contiguous and src.nbytes >= RELAYOUT_MIN_BYTES:
            self.emit("JC-RELAYOUT", f"relayout copy of {src.nbytes} B view {src.shape} "
                      f"@ {r.name} {r.frame} — a per-wave copy; hoist it to build time or keep "
                      "the consumer's layout")

    def _check_gather(self, r: OpRecord) -> None:
        pos = _GATHERS[r.name]
        idx = r.ins[pos]
        out_b = sum(m.nbytes for m in r.outs)
        n_idx = idx.numel
        slice_bytes = out_b // max(n_idx, 1)
        flat = len(idx.shape) <= 1
        if (0 < slice_bytes < GATHER_MIN_SLICE_BYTES and out_b >= GATHER_MIN_TOTAL_BYTES
                and n_idx > GATHER_INDEX_FACTOR * self.wave and flat
                and idx.uid not in self._sorted):
            self.emit("JC-GATHER", f"narrow gather: {slice_bytes} B/row over {n_idx} indices "
                      f"(wave width {self.wave}) @ {r.frame or r.name} — random access far "
                      "past wave width; batch rows or sort indices")


def rollup_records(records: List[OpRecord], entry: str, waves: int = 1, wave_width: int = 1,
                   device: str = "cpu") -> Tuple[Rollup, List[Finding]]:
    """Charge every recorded op, divide by `waves`, and walk the findings."""
    walk = _Walk(entry, wave_width)
    flops = nbytes = 0.0
    ops = 0
    fp = hashlib.sha256()
    first = None
    for r in records:
        if r.kind not in ("op", "kernel"):
            continue
        ops += 1
        if r.kind == "kernel":
            f, b = kernel_work(r)
            if first is None:
                first = r.wave
        else:
            f, b = op_flops(r), op_bytes(r)
            walk.visit(r)
        flops += f
        nbytes += b
    first = first if first is not None else 0
    for r in records:
        if r.kind in ("op", "kernel") and r.wave == first:
            fp.update(f"{r.name}{[m.shape for m in r.outs]}{[str(m.dtype) for m in r.outs]}"
                      .encode())
    w = max(int(waves), 1)
    roll = Rollup(entry=entry, flops=int(round(flops / w)), hbm_bytes=int(round(nbytes / w)),
                  ops=round(ops / w, 1), waves=w, device=device,
                  fingerprint=fp.hexdigest()[:16])
    return roll, walk.findings


def rollup_run(run) -> Tuple[Rollup, List[Finding]]:
    """Roll up one analysis/audit.py EntryRun."""
    return rollup_records(run.rec.records, run.entry, run.waves, run.wave_width, run.device)


def collect_rollups(device: Optional[str] = None, entries=None, runs=None):
    """Record and roll up every entry point (analysis/audit.py). Returns
    (rollups, findings, crashes): a crash is reported, never raised.
    `runs`: entry points already recorded (name -> EntryRun)."""
    from tpu_pbrt_torch.analysis import audit

    entries = entries if entries is not None else audit.entry_points(device)
    rollups: Dict[str, Rollup] = {}
    findings: List[Finding] = []
    crashes: List[str] = []
    for name, fn in entries.items():
        try:
            run = runs[name] if runs and name in runs else fn()
            roll, f = rollup_run(run)
            rollups[name] = roll
            findings.extend(f)
        except Exception as e:  # noqa: BLE001 - the report must be complete
            crashes.append(f"{name}: cost record crashed: {type(e).__name__}: {e}")
    return rollups, findings, crashes


# --------------------------------------------------------------------------
# the budget gate
# --------------------------------------------------------------------------

BUDGETS_PATH = Path(__file__).resolve().parent / "budgets.json"
DEFAULT_TOLERANCE = 0.10
#: the gated metrics of a rollup
METRICS = ("flops", "hbm_bytes", "ops")


def load_budgets(path: Optional[Path] = None) -> Dict:
    p = Path(path) if path is not None else BUDGETS_PATH
    if not p.exists():
        return {"tolerance": DEFAULT_TOLERANCE, "entries": {}}
    return json.loads(p.read_text())


def save_budgets(rollups: Dict[str, Rollup], device: str, path: Optional[Path] = None,
                 tolerance: Optional[float] = None) -> Path:
    """Rewrite `device`'s entries from `rollups`, keeping the other devices'
    entries and the committed tolerance."""
    p = Path(path) if path is not None else BUDGETS_PATH
    data = load_budgets(p)
    entries = dict(data.get("entries", {}))
    entries[device] = {k: r.to_json() for k, r in sorted(rollups.items())}
    versions = dict(data.get("torch_version", {}) if isinstance(data.get("torch_version"), dict)
                    else {})
    versions[device] = torch.__version__
    out = {
        "_comment": ("Static per-wave cost budgets of the port's entry points "
                     "(tpu_pbrt_torch/analysis/cost.py), by device type. Regenerate with "
                     "`python -m tpu_pbrt_torch.analysis --update-budgets --device <cpu|cuda>` "
                     "after an intended hot-path change; the gate fails when FLOPs, bytes or "
                     "ops per wave drift past the tolerance."),
        "tolerance": float(data.get("tolerance", DEFAULT_TOLERANCE) if tolerance is None
                           else tolerance),
        # the op counts depend on how this torch version dispatches
        "torch_version": versions,
        "entries": entries,
    }
    p.write_text(json.dumps(out, indent=2, sort_keys=True) + "\n")
    return p


def check_budgets(rollups: Dict[str, Rollup], budgets: Dict,
                  device: str = "cpu") -> Tuple[List[str], List[str]]:
    """Fresh rollups against the committed budgets of `device`. Returns
    (errors, warnings): a regression past tolerance and a missing entry
    are errors; an improvement past it (ratchet), a changed fingerprint,
    a committed entry with no live counterpart and a torch version other
    than the one the budgets were written under are warnings."""
    errors: List[str] = []
    warnings: List[str] = []
    tol = float(budgets.get("tolerance", DEFAULT_TOLERANCE))
    committed = budgets.get("entries", {}).get(device, {})
    ver = (budgets.get("torch_version") or {}).get(device)
    if ver and ver != torch.__version__:
        warnings.append(f"budgets.json's {device} entries were written under torch {ver}; this "
                        f"process runs torch {torch.__version__}: op counts may differ with the "
                        "version, not with the change")
    for name, roll in sorted(rollups.items()):
        b = committed.get(name)
        if b is None:
            errors.append(f"{name}: no committed {device} budget — run `python -m "
                          f"tpu_pbrt_torch.analysis --update-budgets --device {device}` and "
                          "commit budgets.json")
            continue
        for metric in METRICS:
            fresh = float(getattr(roll, metric))
            base = float(b.get(metric, 0))
            if base <= 0:
                continue
            ratio = fresh / base
            if ratio > 1.0 + tol:
                errors.append(f"{name}: static {metric} per wave regressed {ratio:.2f}x ({base:g} "
                              f"-> {fresh:g}, tolerance {tol:.0%}) — fix the hot path or, if "
                              "intended, refresh with --update-budgets")
            elif ratio < 1.0 - tol:
                warnings.append(f"{name}: static {metric} per wave improved {ratio:.2f}x "
                                f"({base:g} -> {fresh:g}) — ratchet the budget down with "
                                "--update-budgets")
        if b.get("fingerprint") and b["fingerprint"] != roll.fingerprint:
            warnings.append(f"{name}: op-sequence fingerprint changed ({b['fingerprint']} -> "
                            f"{roll.fingerprint}) — the entry point's first wave dispatches "
                            "other ops; refresh budgets.json if the metrics above look right")
    for name in committed:
        if name not in rollups and not name.startswith("_"):
            warnings.append(f"{name}: committed {device} budget has no live entry point — "
                            "remove it with --update-budgets")
    return errors, warnings


def run_cost(update: bool = False, budgets_path: Optional[Path] = None, entries=None,
             device: Optional[str] = None, runs=None):
    """Record, roll up, and gate (or refresh) the budgets of `device` (CUDA
    unless the caller names the CPU; with `entries` given, the device type
    whose budgets they are gated against). Returns (errors, warnings,
    rollups, findings)."""
    if device is None:
        from tpu_pbrt_torch.config import resolve_device

        device = resolve_device(None).type
    rollups, findings, crashes = collect_rollups(device, entries, runs)
    errors: List[str] = list(crashes)
    warnings: List[str] = [str(f) for f in findings if f.waived is None]
    if update:
        if not crashes:
            save_budgets(rollups, device, budgets_path)
    else:
        e, w = check_budgets(rollups, load_budgets(budgets_path), device)
        errors.extend(e)
        warnings.extend(w)
    return errors, warnings, rollups, findings


# --------------------------------------------------------------------------
# bench hook: the bench's wave
# --------------------------------------------------------------------------


def bench_wave_rollup(scene, integ) -> Rollup:
    """Static cost of one wave of a render's pool: PathIntegrator.pool_chunk
    over the compiled `scene` with the pool its render plans.
    One refill of the pool is recorded (pool items: every wave at the
    pool's width until the lanes drain), from the frame's middle chunk
    (the first chunk's top rows are sky, whose rays all miss in one
    wave), and divided by its waves. The port records a real run, so the
    geometry counts (the flushes are charged per live block and treelet):
    the bench records its own scene (`--bench-wave`)."""
    from tpu_pbrt_torch.accel import stream
    from tpu_pbrt_torch.analysis.record import OpRecorder

    device = torch.device(scene.device)
    plan = integ.prepare_chunks(scene)
    pool = min(plan.pool, plan.total)
    start_pix, start_s = plan.start(plan.n_chunks // 2)
    film = scene.film
    fs = film.init_state(device)
    stream.WAVES.reset()
    with OpRecorder() as rec:
        integ.pool_chunk(scene.dev, fs, start_pix, start_s, pool, pool, film=film,
                         cam=scene.camera)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    roll, _ = rollup_records(rec.records, "bench.pool_chunk", max(rec.waves(), 1), pool,
                             device.type)
    return roll


def bench_fields(roll: Rollup) -> Dict:
    """The bench line's static fields from a bench-wave rollup."""
    return {"static_flops_per_wave": roll.flops, "static_bytes_per_wave": roll.hbm_bytes,
            "static_intensity": round(roll.intensity, 3), "static_ops_per_wave": roll.ops}


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m tpu_pbrt_torch.analysis.cost")
    ap.add_argument("--bench-wave", action="store_true",
                    help="compile the bench's scene (tpu_pbrt_torch/bench.py) at --res and --spp, "
                         "record one wave of its pool and print its static cost as one JSON line")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--update-budgets", action="store_true")
    args = ap.parse_args(argv)
    from tpu_pbrt_torch.config import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"cost: {e}")
        return 1
    if args.bench_wave:
        from tpu_pbrt_torch.scenes import compile_api, make_killeroo_like

        # the scene bench.py main() measures
        scene, integ = compile_api(make_killeroo_like(res=args.res, spp=args.spp, device=device))
        roll = bench_wave_rollup(scene, integ)
        print(json.dumps(dict(bench_fields(roll), fingerprint=roll.fingerprint,
                              waves=roll.waves, device=device.type)))
        return 0
    errors, warnings, rollups, _ = run_cost(update=args.update_budgets, device=device.type)
    for r in rollups.values():
        print(f"{r.entry} [{r.device}]: {r.flops} flops, {r.hbm_bytes} B, {r.ops} ops per wave "
              f"over {r.waves} waves, intensity {r.intensity:.2f}, fp {r.fingerprint}")
    for w in warnings:
        print(f"WARN: {w}")
    for e in errors:
        print(f"ERROR: {e}")
    return 1 if errors else 0


if __name__ == "__main__":
    import sys

    sys.exit(_main())
