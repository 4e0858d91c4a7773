"""hbmcheck: a static model of the card's memory across the port's serve
lifecycle, and four rules over it (port of tpu_pbrt/analysis/hbmcheck.py).

The model counts what a serving process keeps on the card:

- the resident compiled scenes (`serve/residency.py::scene_hbm_bytes`,
  at most the LRU budget `TORCH_PBRT_SERVE_RESIDENT_MB`);
- each active job's film state (`core/film.py::FilmState`) and the
  per-slice counter scalars its dispatches append (`RenderJob`'s
  `ray_counts`, `occ_counts`, `ctr_counts`, `nf_counts`);
- the dispatch window's depth (`TORCH_PBRT_PIPELINE`): the film carries
  live at once (`integrators/common.py::live_film_carries`);
- the prefetched next activation (one fresh film state);
- the develop staging (one RGB f32 image).

What it does not count statically, the transient working set of a slice
(the stream tracer's worklists, the pool's lanes) and the caching
allocator's slack, is what HBM_HEADROOM leaves free. On a card both are
measured (chip_smoke.py's [render] and [serve]): the working set of a
solo render at a slice size is its allocator peak above what the model
counts for it (`working_set_bytes`); the model plus that term must
reach the peak of a served session at the same slice size
(`predict_session`, `session_check`), and the default slice's working
set plus the allocator's measured slack (its peak reserved bytes beyond
its peak allocated ones) must fit inside the share of the card
HBM_HEADROOM leaves beside the worst case (`headroom_check`).

Rules:

- **HC-CAP**: the worst case at the configured knobs must fit the
  capacity table with headroom. The table lives in `hbm_budgets.json`
  (`"capacity"`: the card's name -> its bytes), written from
  `torch.cuda.get_device_properties(0).total_memory` by
  `--derive-hbm-caps` on a card; `--derive-hbm-caps` also inverts the
  model per card (the largest safe resident budget, active-job count and
  window depth) and the configured knobs are held to it.
- **HC-LEAK**: an AST pass over `serve/service.py` (the single-device
  paths and the mesh lead and follow paths alike) and
  `serve/residency.py`: a function that drives a job to a terminal
  status must release its device buffers (`_release_device`, or `.state
  = None` and all four counter lists cleared) and unpin its scene; a
  function that drops a resident entry must consult its pin count.
- **HC-ACCT**: residency's estimate against the exact bytes (shape times
  item size of every tensor leaf) of a reference scene and film, within
  DEFAULT_TOLERANCE.
- **HC-ALIAS**: the port has no buffer donation. Its window writes the
  film in place: at depth 1 the dispatch's output IS the live film (an
  alias edge, counted once) and a checkpoint is written from the live
  film (a reference, counted once); at depth > 1 each in-flight slice
  holds its deferred checkpoint's snapshot, a copy of its own (counted
  each). The symbolic buffer graph deduplicated over its alias edges
  must reproduce the closed-form job footprint exactly.

The `# torchlint: disable=HC-*` pragma grammar of the lint applies.
`python -m tpu_pbrt_torch.analysis.hbmcheck [--derive-hbm-caps]
[--update-budgets] [--format json]`; `python -m tpu_pbrt_torch.analysis`
runs it unless `--no-hbmcheck`.
"""

from __future__ import annotations

import ast
import hashlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from tpu_pbrt_torch.analysis.lint import Violation
from tpu_pbrt_torch.analysis.protocheck import _pragma_lines, _shallow_walk, repo_root

BUDGETS_PATH = Path(__file__).resolve().parent / "hbm_budgets.json"
DEFAULT_TOLERANCE = 0.10

GiB = 1024 ** 3
#: the share of a card's memory the serve model may plan for: the rest
#: is the waves' transient working set, the caching allocator's slack
#: and the libraries' workspaces, which the static model cannot see
HBM_HEADROOM = 0.80

#: reference film for the worst-case model and the budget entries
REF_FILM = (512, 512)
#: reference concurrent-job load (the planning headroom the derived caps
#: are inverted against)
REF_MAX_ACTIVE = 4

HC_RULES = {
    "HC-CAP": "worst-case serve footprint exceeds the card's memory with headroom, or a "
              "configured knob exceeds its derived cap",
    "HC-LEAK": "a serve path drives a job terminal without releasing its device buffers, "
               "or eviction ignores pin counts",
    "HC-ACCT": "residency's estimated footprint drifts from the exact bytes beyond tolerance",
    "HC-ALIAS": "an aliased window carry is double counted in the window model",
    "HC-PARSE": "file does not parse",
}


# --------------------------------------------------------------------------
# the memory model
# --------------------------------------------------------------------------


def _bytes_of(tensors) -> int:
    return sum(int(t.numel()) * int(t.element_size()) for t in tensors)


def film_state_bytes(rx: int, ry: int) -> int:
    """Device bytes of ONE film state at rx x ry, from the live FilmState
    layout (a 2x2 probe, scaled), so a new film plane shows up here and
    HC-ACCT catches residency drifting from it."""
    import torch

    from tpu_pbrt_torch.core.film import FilmState

    probe = FilmState(rgb=torch.zeros((2, 2, 3), dtype=torch.float32),
                      weight=torch.zeros((2, 2), dtype=torch.float32),
                      splat=torch.zeros((2, 2, 3), dtype=torch.float32))
    return int(rx) * int(ry) * (_bytes_of(probe) // 4)


def slice_counter_bytes() -> int:
    """The device scalars one pool slice appends to its job (the larger
    of the two drains): rays, live lanes, waves and truncations (int64
    each) and the wave-counter block (obs/counters.py)."""
    import torch

    from tpu_pbrt_torch.obs import counters

    return 4 * torch.zeros((), dtype=torch.int64).element_size() + _bytes_of(
        counters.zeros("cpu"))


COUNTER_BYTES_PER_SLICE = slice_counter_bytes()


def develop_staging_bytes(rx: int, ry: int) -> int:
    """The develop staging: one RGB f32 image the film resolve makes
    before the copy to the host."""
    return int(rx) * int(ry) * 3 * 4


def job_hbm_bytes(film_bytes: int, depth: int) -> int:
    """Worst-case device bytes ONE mid-dispatch job holds: its live film
    carries (integrators/common.py::live_film_carries: the film alone at
    depth 1, depth + 1 beyond) and the counter scalars of a full window."""
    from tpu_pbrt_torch.integrators.common import live_film_carries

    d = max(1, int(depth))
    return live_film_carries(d) * int(film_bytes) + d * COUNTER_BYTES_PER_SLICE


def serve_model(rx: Optional[int] = None, ry: Optional[int] = None,
                depth: Optional[int] = None, max_active: Optional[int] = None,
                prefetch: Optional[bool] = None,
                resident_bytes: Optional[int] = None) -> Dict[str, Any]:
    """The worst-case simultaneous serve footprint, each knob defaulting
    from the live config: resident scenes at the full LRU budget +
    max_active mid-dispatch jobs + the prefetched next activation (one
    fresh film state) + the develop staging."""
    from tpu_pbrt_torch.config import cfg

    if rx is None or ry is None:
        rx, ry = REF_FILM
    if depth is None:
        depth = int(cfg.pipeline)
    if max_active is None:
        max_active = REF_MAX_ACTIVE
    if prefetch is None:
        prefetch = bool(cfg.serve_prefetch)
    if resident_bytes is None:
        resident_bytes = int(cfg.serve_resident_mb * 1e6) if cfg.serve_resident_mb else 0
    fb = film_state_bytes(rx, ry)
    jb = job_hbm_bytes(fb, depth)
    pf = fb if prefetch else 0
    st = develop_staging_bytes(rx, ry)
    total = int(resident_bytes) + max_active * jb + pf + st
    return {
        "film": [int(rx), int(ry)],
        "depth": int(depth),
        "max_active": int(max_active),
        "prefetch": bool(prefetch),
        "film_state_bytes": fb,
        "resident_bytes": int(resident_bytes),
        "job_bytes": jb,
        "jobs_bytes": max_active * jb,
        "prefetch_bytes": pf,
        "staging_bytes": st,
        "total_bytes": total,
    }


def capacity_table(budgets: Optional[Dict] = None) -> Dict[str, int]:
    """The capacity table HC-CAP gates against: card name -> bytes, as
    committed in hbm_budgets.json by --derive-hbm-caps on the card."""
    b = budgets if budgets is not None else load_budgets()
    table = {k: int(v) for k, v in b.get("capacity", {}).items()}
    if not table:
        raise ValueError(f"{BUDGETS_PATH.name} has no capacity table: run "
                         "`python -m tpu_pbrt_torch.analysis.hbmcheck --derive-hbm-caps` "
                         "on the card")
    return table


def check_capacity(model: Optional[Dict[str, Any]] = None, headroom: float = HBM_HEADROOM,
                   capacity: Optional[Dict[str, int]] = None) -> List[str]:
    """HC-CAP: the worst-case simultaneous footprint must fit the smallest
    card of the table with headroom."""
    m = model if model is not None else serve_model()
    card, cap = min((capacity or capacity_table()).items(), key=lambda kv: kv[1])
    budget = int(cap * headroom)
    if m["total_bytes"] <= budget:
        return []
    return [
        f"HC-CAP: worst-case serve footprint {m['total_bytes']} B (resident "
        f"{m['resident_bytes']} + {m['max_active']} jobs x {m['job_bytes']} + prefetch "
        f"{m['prefetch_bytes']} + staging {m['staging_bytes']}) exceeds {budget} B "
        f"({headroom:.0%} of {card} {cap} B) — lower TORCH_PBRT_SERVE_RESIDENT_MB, "
        "max_active or TORCH_PBRT_PIPELINE"
    ]


def session_check(model_bytes: int, peak_bytes: int) -> Tuple[float, List[str]]:
    """The model's bytes for a served session against the peak the card's
    allocator measured for it (torch.cuda.max_memory_allocated): returns
    (model / peak, errors); an error when the model is below."""
    ratio = model_bytes / max(int(peak_bytes), 1)
    if model_bytes >= peak_bytes:
        return ratio, []
    return ratio, [f"HC-CAP: the model's {model_bytes} B is below the measured peak "
                   f"{peak_bytes} B of the served session ({ratio:.3f}x)"]


def render_model_bytes(rx: int, ry: int, depth: Optional[int] = None) -> int:
    """What the model counts for a solo render above its compiled scene:
    one job's film carries and counters at the window's depth, and the
    develop staging."""
    from tpu_pbrt_torch.config import cfg

    d = int(cfg.pipeline) if depth is None else int(depth)
    return job_hbm_bytes(film_state_bytes(rx, ry), d) + develop_staging_bytes(rx, ry)


def working_set_bytes(peak_bytes: int, model_bytes: int) -> int:
    """The transient working set of a render's slices: its measured
    allocator peak above what the model counts for it (never below 0)."""
    return max(int(peak_bytes) - int(model_bytes), 0)


def predict_session(model: Dict[str, Any], working_set: int, compile_extra: int = 0) -> int:
    """The peak the model predicts for a served session (serve_model at
    the session's film, jobs and resident bytes): the resident scenes,
    plus the larger of a scene compile's transient bytes above its
    scene and the jobs, prefetch and staging with one slice's working
    set (both measured on a solo render at the session's slice size)."""
    rest = model["jobs_bytes"] + model["prefetch_bytes"] + model["staging_bytes"]
    return model["resident_bytes"] + max(int(compile_extra), rest + int(working_set))


def headroom_check(worst_bytes: int, working_set: int, slack_bytes: int,
                   capacity: Dict[str, int],
                   headroom: float = HBM_HEADROOM) -> Tuple[float, List[str]]:
    """HC-CAP against what the card measured: the worst case plus the
    default slice's working set plus the caching allocator's slack (its
    peak reserved bytes beyond its peak allocated ones) must fit the
    smallest card, and what the static model leaves out (that working set
    and the slack) must fit in the 1 - headroom share it leaves free.
    Returns (the share of the card the total takes, errors)."""
    card, cap = min(capacity.items(), key=lambda kv: kv[1])
    unseen = int(working_set) + max(int(slack_bytes), 0)
    held = int(worst_bytes) + unseen
    errors = []
    if held > cap:
        errors.append(f"HC-CAP: the worst case {worst_bytes} B plus the working set "
                      f"{working_set} B and the allocator's slack {slack_bytes} B is {held} B, "
                      f"over {card}'s {cap} B")
    if unseen > (1.0 - headroom) * cap:
        errors.append(f"HC-CAP: the working set and the allocator's slack ({unseen} B) exceed "
                      f"the {1.0 - headroom:.0%} of {card} the headroom leaves")
    return held / cap, errors


# --------------------------------------------------------------------------
# HC-ACCT: residency estimates against exact bytes
# --------------------------------------------------------------------------


class _RefFilm:
    full_resolution = REF_FILM


class _RefScene:
    """A deterministic stand-in for a compiled scene: a mixed-dtype nested
    dev of tensors shaped like the real upload (the lane-major vertex
    table, a treelet pack, a uint8 texture atlas, a light CDF, a material
    table), enough variety that an estimator taking dtype or nesting
    shortcuts drifts measurably from the exact walk."""

    def __init__(self):
        import torch

        from tpu_pbrt_torch.accel.treelet import TreeletPack
        from tpu_pbrt_torch.accel.wide import WideBVH

        z = torch.zeros
        self.film = _RefFilm()
        self.dev = {
            "tri_verts9T": z((9, 4096), dtype=torch.float32),
            "tstream": TreeletPack(
                top=WideBVH(z((64, 8, 3), dtype=torch.float32), z((64, 8, 3), dtype=torch.float32),
                            z((64, 8), dtype=torch.int32)),
                featT=z((32, 16, 2048), dtype=torch.float32), center=z((32, 3), dtype=torch.float32),
                offset=z((32,), dtype=torch.int32), count=z((32,), dtype=torch.int32)),
            "tex_atlas_u8": z((256, 256, 3), dtype=torch.uint8),
            "light_cdf": z((129,), dtype=torch.float32),
            "mat": {"table": z((64, 16), dtype=torch.float32), "type": z((64,), dtype=torch.int64)},
        }


def reference_scene():
    return _RefScene()


def _leaves(obj, seen=None):
    """Every array-like leaf (anything with a shape and a dtype) reachable
    through dicts, lists, tuples and object attributes, each once."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if hasattr(obj, "shape") and hasattr(obj, "dtype"):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _leaves(v, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _leaves(v, seen)
    elif not isinstance(obj, (str, bytes, int, float, bool, type(None))):
        for v in getattr(obj, "__dict__", {}).values():
            yield from _leaves(v, seen)


def _itemsize(dtype) -> int:
    import numpy as np
    import torch

    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def exact_scene_bytes(scene) -> int:
    """Exact device bytes: shape x item size per dev leaf (independent of
    any size attribute the estimator reads) plus the film state."""
    total = 0
    for leaf in _leaves(scene.dev):
        n = 1
        for d in tuple(leaf.shape):
            n *= int(d)
        total += n * _itemsize(leaf.dtype)
    rx, ry = scene.film.full_resolution
    return total + film_state_bytes(rx, ry)


def acct_check(scene=None, tolerance: float = DEFAULT_TOLERANCE) -> List[str]:
    """HC-ACCT: the LRU evicts on `scene_hbm_bytes` estimates; they must
    track the exact bytes within tolerance, and residency's per-pixel film
    constant must match the live FilmState layout."""
    from tpu_pbrt_torch.serve import residency

    errors: List[str] = []
    live_px = film_state_bytes(1, 1)
    if residency.FILM_BYTES_PER_PIXEL != live_px:
        errors.append(
            f"HC-ACCT: residency charges {residency.FILM_BYTES_PER_PIXEL} B/pixel of film but "
            f"the live FilmState layout is {live_px} B/pixel — the LRU would evict on wrong "
            "numbers; update residency.FILM_BYTES_PER_PIXEL")
    sc = scene if scene is not None else reference_scene()
    est = residency.scene_hbm_bytes(sc)
    exact = exact_scene_bytes(sc)
    if exact > 0:
        ratio = est / exact
        if not (1.0 - tolerance <= ratio <= 1.0 + tolerance):
            errors.append(
                f"HC-ACCT: residency estimates {est} B for the reference scene but its exact "
                f"footprint is {exact} B ({ratio:.2f}x, tolerance {tolerance:.0%}) — the LRU "
                "evicts on wrong numbers")
    return errors


# --------------------------------------------------------------------------
# HC-ALIAS: each window carry counted once
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Buf:
    """A symbolic device buffer of the window model. `alias_of` names the
    buffer this one shares storage with (the in-place dispatch output, a
    checkpoint written from the live film); `in_place` marks a dispatch
    output that MUST alias its input film."""

    name: str
    nbytes: int
    alias_of: Optional[str] = None
    in_place: bool = False


def job_buffers(film_bytes: int, depth: int, cadence: bool = True) -> List[Buf]:
    """The symbolic live buffers of one job mid-dispatch at `depth`. The
    dispatch writes the film in place, so its output aliases the live
    film at every depth. At depth 1 a checkpoint is written from the live
    film (a reference); at depth > 1 each in-flight slice holds its
    deferred checkpoint's snapshot, a copy of its own."""
    d = max(1, int(depth))
    bufs: List[Buf] = [Buf("film", int(film_bytes)),
                       Buf("film_out", int(film_bytes), alias_of="film", in_place=True)]
    if d == 1:
        if cadence:
            bufs.append(Buf("ckpt_ref", int(film_bytes), alias_of="film"))
    else:
        bufs.extend(Buf(f"ckpt_snap{i}", int(film_bytes)) for i in range(1, d + 1))
    bufs.extend(Buf(f"counters{i}", COUNTER_BYTES_PER_SLICE) for i in range(d))
    return bufs


def _alias_root(buf: Buf, by_name: Dict[str, Buf]) -> Optional[str]:
    seen = set()
    while buf.alias_of is not None:
        if buf.alias_of in seen or buf.alias_of not in by_name:
            return None
        seen.add(buf.name)
        buf = by_name[buf.alias_of]
    return buf.name


def dedup_bytes(bufs: List[Buf]) -> int:
    """Total bytes counting each alias class ONCE (by its root)."""
    by_name = {b.name: b for b in bufs}
    roots, total = set(), 0
    for b in bufs:
        r = _alias_root(b, by_name)
        if r is None or r in roots:
            continue
        roots.add(r)
        total += by_name[r].nbytes
    return total


def check_alias(bufs: List[Buf]) -> List[str]:
    """HC-ALIAS structural checks on a buffer graph: an in-place output
    must carry an alias edge (else the model double-counts the film) and
    every alias edge must resolve."""
    errors: List[str] = []
    by_name: Dict[str, Buf] = {}
    for b in bufs:
        if b.name in by_name:
            errors.append(f"HC-ALIAS: duplicate buffer name {b.name!r} in the window model")
        by_name[b.name] = b
    for b in bufs:
        if b.in_place and b.alias_of is None:
            errors.append(f"HC-ALIAS: {b.name!r} is written in place but carries no alias "
                          "edge — the model would double-count the film")
        if b.alias_of is not None and b.alias_of not in by_name:
            errors.append(f"HC-ALIAS: {b.name!r} aliases unknown buffer {b.alias_of!r}")
    return errors


def alias_audit(depths: Tuple[int, ...] = (1, 2, 3)) -> List[str]:
    """HC-ALIAS self-consistency: at every depth the buffer graph,
    deduplicated over its alias edges, must reproduce `job_hbm_bytes`."""
    errors: List[str] = []
    fb = film_state_bytes(*REF_FILM)
    for d in depths:
        bufs = job_buffers(fb, d)
        errors.extend(check_alias(bufs))
        got, want = dedup_bytes(bufs), job_hbm_bytes(fb, d)
        if got != want:
            errors.append(
                f"HC-ALIAS: window model at depth {d} counts {got} B after alias dedup but "
                f"the closed-form job footprint is {want} B — a carry is double counted")
    return errors


# --------------------------------------------------------------------------
# HC-LEAK: the serve code paths release what a finished job held
# --------------------------------------------------------------------------

_SERVICE_MOD = "tpu_pbrt_torch/serve/service.py"
_RESIDENCY_MOD = "tpu_pbrt_torch/serve/residency.py"
_TERMINAL_NAMES = frozenset({"FAILED", "CANCELLED", "DONE"})
_COUNTER_LISTS = frozenset({"ray_counts", "occ_counts", "ctr_counts", "nf_counts"})


def _leak_service(tree: ast.AST, rel: str) -> List[Violation]:
    """Every function of service.py that assigns a terminal status must
    release the job's device buffers on that path (`_release_device`, or
    `.state = None` and all four counter lists cleared inline) and must
    `unpin` its resident scene."""
    out: List[Violation] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        terminal_line = None
        has_release = has_unpin = has_state_none = False
        cleared: set = set()
        for n in _shallow_walk(node):
            if isinstance(n, ast.Assign):
                if (isinstance(n.value, ast.Name) and n.value.id in _TERMINAL_NAMES
                        and any(isinstance(t, ast.Attribute) and t.attr == "status"
                                for t in n.targets)):
                    terminal_line = terminal_line or n.lineno
                if (isinstance(n.value, ast.Constant) and n.value.value is None
                        and any(isinstance(t, ast.Attribute) and t.attr == "state"
                                for t in n.targets)):
                    has_state_none = True
            elif isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
                if n.func.attr == "_release_device":
                    has_release = True
                elif n.func.attr == "unpin":
                    has_unpin = True
                elif (n.func.attr == "clear" and isinstance(n.func.value, ast.Attribute)
                      and n.func.value.attr in _COUNTER_LISTS):
                    cleared.add(n.func.value.attr)
        if terminal_line is None:
            continue
        if not (has_release or (has_state_none and cleared == set(_COUNTER_LISTS))):
            out.append(Violation(
                "HC-LEAK", rel, terminal_line,
                f"{node.name}() drives a job to a terminal status but releases no device "
                "buffers on that path — call _release_device(job) (or null .state and clear "
                "all four counter lists) so the film, the in-flight window and the per-slice "
                "counters drop with the job", "error"))
        if not has_unpin:
            out.append(Violation(
                "HC-LEAK", rel, terminal_line,
                f"{node.name}() drives a job to a terminal status without releasing its "
                "residency pin — the scene can never be evicted and the LRU budget silently "
                "shrinks", "error"))
    return out


def _leak_residency(tree: ast.AST, rel: str) -> List[Violation]:
    """A function that drops a resident entry (`del ..._entries[...]`)
    must consult pin counts in the same function."""
    out: List[Violation] = []
    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        del_line = None
        sees_pins = False
        for n in _shallow_walk(node):
            if isinstance(n, ast.Delete):
                for t in n.targets:
                    if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Attribute)
                            and t.value.attr == "_entries"):
                        del_line = del_line or n.lineno
            if isinstance(n, ast.Attribute) and n.attr == "pins":
                sees_pins = True
        if del_line is not None and not sees_pins:
            out.append(Violation(
                "HC-LEAK", rel, del_line,
                f"{node.name}() drops a resident entry without consulting pin counts — a "
                "pinned scene under a live job could be evicted out from under it", "error"))
    return out


def hc_leak_source(src: str, rel: str) -> List[Violation]:
    """HC-LEAK over one source text, scoped by `rel` (the repo-relative
    path); `# torchlint: disable=HC-LEAK` suppresses a line, and on a def
    line the whole function."""
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return [Violation("HC-PARSE", rel, e.lineno or 0, f"does not parse: {e.msg}", "error")]
    found: List[Violation] = []
    if rel.endswith("service.py") and "serve" in rel:
        found.extend(_leak_service(tree, rel))
    if rel.endswith("residency.py") and "serve" in rel:
        found.extend(_leak_residency(tree, rel))
    per_line, file_wide = _pragma_lines(src)
    defs = [n for n in ast.walk(tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    kept = []
    for v in found:
        rules = per_line.get(v.line, set()) | file_wide
        for fn in defs:
            if fn.lineno <= v.line <= (fn.end_lineno or fn.lineno):
                rules |= per_line.get(fn.lineno, set())
        if v.rule in rules or "all" in rules:
            continue
        kept.append(v)
    return sorted(kept, key=lambda v: (v.line, v.rule))


def hc_leak_tree(root: Optional[str] = None) -> List[Violation]:
    base = Path(root if root else repo_root())
    out: List[Violation] = []
    for rel in (_SERVICE_MOD, _RESIDENCY_MOD):
        p = base / rel
        if p.exists():
            out.extend(hc_leak_source(p.read_text(), rel))
    return out


# --------------------------------------------------------------------------
# budgets: the committed hbm_budgets.json gate
# --------------------------------------------------------------------------


def _fingerprint(detail: Dict[str, Any]) -> str:
    return hashlib.sha1(json.dumps(detail, sort_keys=True).encode()).hexdigest()[:12]


def collect_entries(model: Optional[Dict[str, Any]] = None) -> Dict[str, Dict[str, Any]]:
    """The budget entries the gate tracks: every term of the worst-case
    model and the reference scene's estimate that HC-ACCT audits."""
    from tpu_pbrt_torch.serve.residency import scene_hbm_bytes

    m = model if model is not None else serve_model()
    ref_bytes = int(scene_hbm_bytes(reference_scene()))

    def entry(nbytes: int, **detail) -> Dict[str, Any]:
        return {"hbm_bytes": int(nbytes), "fingerprint": _fingerprint(detail), "detail": detail}

    return {
        "serve.film_state": entry(m["film_state_bytes"], film=m["film"],
                                  per_pixel=film_state_bytes(1, 1)),
        "serve.job": entry(m["job_bytes"], depth=m["depth"],
                           counter_bytes_per_slice=COUNTER_BYTES_PER_SLICE),
        "serve.prefetch": entry(m["prefetch_bytes"], enabled=m["prefetch"]),
        "serve.staging": entry(m["staging_bytes"], film=m["film"]),
        "serve.worst_case": entry(m["total_bytes"], resident_bytes=m["resident_bytes"],
                                  max_active=m["max_active"], depth=m["depth"]),
        "scene.reference": entry(ref_bytes, film=list(REF_FILM)),
    }


def load_budgets(path: Optional[Path] = None) -> Dict:
    p = Path(path) if path is not None else BUDGETS_PATH
    if not p.exists():
        return {"tolerance": DEFAULT_TOLERANCE, "entries": {}, "capacity": {}}
    return json.loads(p.read_text())


def save_budgets(entries: Dict[str, Dict[str, Any]], path: Optional[Path] = None,
                 tolerance: float = DEFAULT_TOLERANCE,
                 capacity: Optional[Dict[str, int]] = None) -> Path:
    """Write the budgets file; the capacity table is kept from the file
    unless a new one is given."""
    import torch

    p = Path(path) if path is not None else BUDGETS_PATH
    if capacity is None:
        capacity = load_budgets(p).get("capacity", {})
    data = {
        "_comment": (
            "Static device-memory footprints of the port's serve model (hbmcheck): the film "
            "state, the per-job worst case, the prefetch slot, the develop staging, the "
            "worst case in all, and the residency estimate of the reference scene; and the "
            "capacity table (card name -> bytes, read from the card by --derive-hbm-caps). "
            "Regenerate with `python -m tpu_pbrt_torch.analysis.hbmcheck --update-budgets` "
            "after an intentional serve or film change."),
        "tolerance": tolerance,
        "hbm_headroom": HBM_HEADROOM,
        "torch_version": torch.__version__.split("+")[0],
        "capacity": {k: int(v) for k, v in sorted(capacity.items())},
        "entries": {k: dict(v) for k, v in sorted(entries.items())},
    }
    p.write_text(json.dumps(data, indent=2, sort_keys=True) + "\n")
    return p


def check_budgets(entries: Dict[str, Dict[str, Any]],
                  budgets: Dict) -> Tuple[List[str], List[str]]:
    errors: List[str] = []
    warnings: List[str] = []
    tol = float(budgets.get("tolerance", DEFAULT_TOLERANCE))
    committed = budgets.get("entries", {})
    for key, info in sorted(entries.items()):
        b = committed.get(key)
        if b is None:
            errors.append(f"{key}: no committed HBM budget — run `python -m "
                          "tpu_pbrt_torch.analysis.hbmcheck --update-budgets` and commit "
                          "hbm_budgets.json")
            continue
        base = int(b.get("hbm_bytes", 0))
        if base > 0:
            ratio = info["hbm_bytes"] / base
            if ratio > 1.0 + tol:
                errors.append(f"{key}: static footprint regressed {ratio:.2f}x ({base} -> "
                              f"{info['hbm_bytes']} B, tolerance {tol:.0%}) — shrink it or, "
                              "if intentional, refresh with --update-budgets")
            elif ratio < 1.0 - tol:
                warnings.append(f"{key}: static footprint improved {ratio:.2f}x ({base} -> "
                                f"{info['hbm_bytes']} B) — ratchet with --update-budgets")
        if b.get("fingerprint") and b["fingerprint"] != info["fingerprint"]:
            warnings.append(f"{key}: model structure fingerprint changed ({b['fingerprint']} "
                            f"-> {info['fingerprint']}) — refresh hbm_budgets.json if the "
                            "footprint above looks right")
    for key in committed:
        if key not in entries and not key.startswith("_"):
            warnings.append(f"{key}: committed HBM budget has no live model term — remove it "
                            "with --update-budgets")
    return errors, warnings


# --------------------------------------------------------------------------
# the derived caps: the model inverted per card
# --------------------------------------------------------------------------


def card_capacity() -> Dict[str, int]:
    """{card name: total bytes} of cuda:0, read from the card."""
    import torch

    props = torch.cuda.get_device_properties(0)
    return {props.name: int(props.total_memory)}


def derive_hbm_caps(headroom: float = HBM_HEADROOM,
                    capacity: Optional[Dict[str, int]] = None) -> Dict:
    """Invert the serve model per card: with the other knobs at their
    configured values, the largest safe resident-scene budget (MB), the
    largest safe max_active and the deepest safe window."""
    from tpu_pbrt_torch.config import cfg

    rx, ry = REF_FILM
    fb = film_state_bytes(rx, ry)
    depth = int(cfg.pipeline)
    jb = job_hbm_bytes(fb, depth)
    pf = fb if cfg.serve_prefetch else 0
    st = develop_staging_bytes(rx, ry)
    cfg_res_mb = float(cfg.serve_resident_mb) if cfg.serve_resident_mb else None
    res_bytes = int(cfg_res_mb * 1e6) if cfg_res_mb else 0
    out: Dict[str, Any] = {
        "headroom": headroom,
        "configured": {"serve_resident_mb": cfg_res_mb, "pipeline_depth": depth,
                       "max_active": REF_MAX_ACTIVE, "prefetch": bool(cfg.serve_prefetch),
                       "film": [rx, ry]},
        "cards": {},
    }
    for card, cap in sorted((capacity or capacity_table()).items()):
        budget = int(cap * headroom)
        resident_raw = budget - REF_MAX_ACTIVE * jb - pf - st
        max_resident_mb = max(resident_raw // 1_000_000, 0)
        free = budget - res_bytes - pf - st
        # a depth-d job (d > 1) holds (d + 1) films and d counter slots
        per_job = free // max(REF_MAX_ACTIVE, 1)
        out["cards"][card] = {
            "hbm_bytes": int(cap),
            "budget_bytes": budget,
            "job_bytes": jb,
            "max_resident_mb": int(max_resident_mb),
            "max_resident_mb_aligned": int(max_resident_mb // 1024 * 1024),
            "max_active": int(max(free // jb, 0)),
            "max_pipeline_depth": max(int((per_job - fb) // (fb + COUNTER_BYTES_PER_SLICE)), 1),
        }
    return out


def check_hbm_caps(derived: Optional[Dict] = None) -> List[str]:
    """HC-CAP over the derived caps: every configured serve knob must sit
    at or under its model-safe maximum on the smallest card."""
    d = derived if derived is not None else derive_hbm_caps()
    cards = d["cards"].values()
    worst_res = min(p["max_resident_mb"] for p in cards)
    worst_active = min(p["max_active"] for p in cards)
    worst_depth = min(p["max_pipeline_depth"] for p in cards)
    c = d["configured"]
    errors: List[str] = []
    if c["serve_resident_mb"] is not None and c["serve_resident_mb"] > worst_res:
        errors.append(f"HC-CAP: TORCH_PBRT_SERVE_RESIDENT_MB={c['serve_resident_mb']:g} exceeds "
                      f"the model-safe maximum {worst_res} MB on the smallest card — resident "
                      "scenes at the cap would overflow the card under the live-job load")
    if c["max_active"] > worst_active:
        errors.append(f"HC-CAP: the reference max_active={c['max_active']} exceeds the "
                      f"model-safe maximum {worst_active} at the configured resident budget")
    if c["pipeline_depth"] > worst_depth:
        errors.append(f"HC-CAP: TORCH_PBRT_PIPELINE={c['pipeline_depth']} exceeds the "
                      f"model-safe maximum depth {worst_depth} at the configured resident "
                      "budget — the in-flight snapshots would overflow the card")
    return errors


# --------------------------------------------------------------------------
# entry points
# --------------------------------------------------------------------------


def run_hbmcheck(update: bool = False, budgets_path: Optional[Path] = None,
                 root: Optional[str] = None,
                 check_caps_too: bool = True) -> Tuple[List[str], List[str]]:
    """The whole pass: HC-LEAK over the tree, HC-ACCT, HC-ALIAS, HC-CAP
    (capacity, the budget gate or its refresh, the derived caps).
    Returns (errors, warnings)."""
    errors: List[str] = [str(v) for v in hc_leak_tree(root)]
    warnings: List[str] = []
    errors.extend(acct_check())
    errors.extend(alias_audit())
    budgets = load_budgets(budgets_path)
    capacity = budgets.get("capacity") or None
    model = serve_model()
    if capacity is None:
        errors.append("HC-CAP: no capacity table committed — run --derive-hbm-caps on the card")
    else:
        errors.extend(check_capacity(model, capacity=capacity))
    entries = collect_entries(model)
    if update:
        save_budgets(entries, budgets_path,
                     tolerance=float(budgets.get("tolerance", DEFAULT_TOLERANCE)))
    else:
        e, w = check_budgets(entries, budgets)
        errors.extend(e)
        warnings.extend(w)
    if check_caps_too and capacity is not None:
        try:
            errors.extend(check_hbm_caps(derive_hbm_caps(capacity=capacity)))
        except Exception as e:  # noqa: BLE001 - a crashed derivation is a finding
            errors.append(f"HC-CAP derivation crashed: {type(e).__name__}: {e}")
    return errors, warnings


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m tpu_pbrt_torch.analysis.hbmcheck")
    ap.add_argument("--derive-hbm-caps", action="store_true",
                    help="invert the serve model per card: the largest safe (resident MB, "
                         "max_active, window depth); on a card, first write its capacity "
                         "into the budgets file")
    ap.add_argument("--update-budgets", action="store_true")
    ap.add_argument("--budgets", default=None, help="the budgets file (default: the committed "
                    "tpu_pbrt_torch/analysis/hbm_budgets.json)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    args = ap.parse_args(argv)
    path = Path(args.budgets) if args.budgets else None

    if args.derive_hbm_caps:
        import torch

        budgets = load_budgets(path)
        if torch.cuda.is_available():
            capacity = dict(budgets.get("capacity", {}), **card_capacity())
            save_budgets(collect_entries() if args.update_budgets else budgets.get("entries", {}),
                         path, tolerance=float(budgets.get("tolerance", DEFAULT_TOLERANCE)),
                         capacity=capacity)
            print(f"capacity {card_capacity()} -> {path or BUDGETS_PATH}")
        elif args.update_budgets:
            save_budgets(collect_entries(), path,
                         tolerance=float(budgets.get("tolerance", DEFAULT_TOLERANCE)))
        derived = derive_hbm_caps(capacity=capacity_table(load_budgets(path)))
        if args.format == "json":
            print(json.dumps(derived, indent=2, sort_keys=True))
        else:
            c = derived["configured"]
            res = f"{c['serve_resident_mb']:g}" if c["serve_resident_mb"] is not None \
                else "unbounded"
            print(f"configured: serve_resident_mb={res} pipeline={c['pipeline_depth']} "
                  f"max_active={c['max_active']} prefetch={c['prefetch']} "
                  f"(headroom {derived['headroom']:.0%})")
            for name, p in sorted(derived["cards"].items()):
                print(f"{name}: {p['hbm_bytes']} B -> budget {p['budget_bytes']} B; "
                      f"max_resident_mb {p['max_resident_mb']} (aligned "
                      f"{p['max_resident_mb_aligned']}), max_active {p['max_active']}, "
                      f"max_pipeline_depth {p['max_pipeline_depth']}; job {p['job_bytes']} B")
        errors = check_hbm_caps(derived)
        for e in errors:
            print(f"ERROR: {e}")
        return 1 if errors else 0

    errors, warnings = run_hbmcheck(update=args.update_budgets, budgets_path=path)
    if args.format == "json":
        print(json.dumps({"errors": errors, "warnings": warnings, "ok": not errors}))
    else:
        for w in warnings:
            print(f"WARN: {w}")
        for e in errors:
            print(f"ERROR: {e}")
        if args.update_budgets:
            print(f"hbm budgets refreshed -> {path or BUDGETS_PATH}")
    return 1 if errors else 0


if __name__ == "__main__":
    import sys

    sys.exit(_main())
