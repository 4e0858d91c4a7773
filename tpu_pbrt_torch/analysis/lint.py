"""AST lint over the port's source tree (counterpart of tpu_pbrt/analysis/lint.py).

The reference's rules fire inside traced code, found by a call graph
seeded at jax.jit / lax loop boundaries. The port traces nothing: its hot
set is the code every wave runs, found by a call graph seeded at the
wave's entry points (`HOT_SEEDS`: the pool's `pool_chunk`, the bounce
and probe waves, stream traversal and the film deposits) and propagated
by name, as the reference's is (a bare call binds to its module or its
`from X import`; an attribute call to any function of that name in the
package but the generic ones). The rules keep the reference's ids:

JL-SYNC      a host sync inside the hot set: `.item()`, `.tolist()`,
             `.cpu()`, `.numpy()`, and `bool()` / `int()` / `float()` of a
             device value (a torch call, a reduction such as `x.any()`, a
             name the function assigned from one, or an expression over
             one). Each waits for the device on CUDA. The syncs a
             wave is built on (the traversal's loop test and block count,
             the bounce loop's test, the pool's one read per wave: the
             ones `stats["host_reads_per_wave_mean"]` and
             `stats["loop_host_reads_per_wave"]` count) carry a pragma
             each, and PRAGMA_BUDGET is their number.
JL-F64       float64 in the hot set (`torch.float64`, `torch.double`,
             `.double()`, a "float64" string, `np.float64`), outside
             core/xla_math.py's f64 forms (`F64_FORMS`).
JL-DTYPE     `torch.arange / zeros / ones / empty / full / linspace`
             without a dtype in the hot set: `arange` of ints and `full`
             of an int default to int64.
JL-ENV       `os.environ` / `os.getenv` anywhere in the package outside
             config.py and the allowlisted command-line tools.

The reference's JL-CALLBACK (host callback primitives), JL-MUT (a store
into a captured array in traced code) and JL-DONATE (jax.jit without
donation) have no counterpart: torch has no callback primitive (a host
round trip is a JL-SYNC), in-place writes are the port's idiom (the film
is written in place, analysis/audit.py checks it stays in place), and
there is no donation to ask for.

`# torchlint: disable=RULE[,RULE]` on a line (or on a `def` line, for its
body), or `# torchlint: disable-file=RULE` anywhere in a file, suppresses.
"""

from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

RULES: Dict[str, str] = {
    "JL-PARSE": "file does not parse",
    "JL-SYNC": "host sync inside the hot set",
    "JL-F64": "float64 inside the hot set",
    "JL-DTYPE": "dtype-less torch constructor inside the hot set",
    "JL-ENV": "os.environ read outside tpu_pbrt_torch/config.py",
}

#: rule -> "error" (exit 1) or "warning" (reported, exit 0)
SEVERITY: Dict[str, str] = {rule: "error" for rule in RULES}

#: the sanctioned host reads of the hot set, one pragma each. Counted by
#: the stream tracer's tally (accel/stream.py WAVES): the traversal's loop
#: test (closest hit, any hit) and a flush's block count, the fixed
#: batch's bounce-loop test and the pool's one read per wave
#: (integrators/path.py), the shadow walk's segment-loop test
#: (integrators/common.py::unoccluded_tr). Not counted: the grid medium's
#: ratio-tracking loop test (core/media.py::medium_tr), one read per step
PRAGMA_BUDGET = 7

#: module -> the functions that seed the hot set
HOT_SEEDS: Dict[str, Tuple[str, ...]] = {
    "tpu_pbrt_torch/integrators/path.py": ("pool_chunk", "_bounce_wave", "_probe_wave", "li"),
    "tpu_pbrt_torch/accel/stream.py": ("stream_intersect_split",),
    "tpu_pbrt_torch/core/film.py": ("add_samples", "add_samples_pixel"),
}

#: module -> functions whose float64 is by design (the CPU forms of the
#: reference's fused multiply-add and correctly rounded square root, and
#: glibc's sinf / cosf / powf, which work in double)
F64_FORMS: Dict[str, Tuple[str, ...]] = {
    "tpu_pbrt_torch/core/xla_math.py": ("_fma_f64", "sqrt", "_sincos", "_sincos_poly", "pow"),
}

#: rule -> {path suffix: reason}: whole files whose job contradicts the rule
ALLOWLIST: Dict[str, Dict[str, str]] = {
    "JL-ENV": {
        "tpu_pbrt_torch/config.py": "the one sanctioned reader of the TORCH_PBRT_ knobs",
        "tpu_pbrt_torch/bench.py": "the bench's BENCH_* knobs and its probe's fault seam are "
                                   "read before the package is imported (the reference's "
                                   "bench.py does the same)",
        "tpu_pbrt_torch/chaos/__main__.py": "the recovery matrix sets each scenario's knobs in "
                                            "its own subprocess's environment",
        "tpu_pbrt_torch/kernels/build.py": "CUDA_HOME, the toolkit nvcc is found in",
        "tpu_pbrt_torch/parallel/mesh.py": "RANK / WORLD_SIZE / LOCAL_RANK, torchrun's contract, "
                                           "read when a group is joined",
    },
}

_PRAGMA_RE = re.compile(r"#\s*torchlint:\s*disable=([A-Z0-9,\-\s]+)")
_PRAGMA_FILE_RE = re.compile(r"#\s*torchlint:\s*disable-file=([A-Z0-9,\-\s]+)")

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_DTYPE_CTORS = {"arange", "zeros", "ones", "empty", "full", "linspace"}
#: method names too generic to resolve by name across the package
_GENERIC_NAMES = {
    "add", "get", "set", "copy", "next", "update", "pop", "append", "extend", "items", "keys",
    "values", "shape", "put", "clear", "to", "sum", "view", "reshape", "where", "any", "all",
    "max", "min", "sort", "clone", "float", "int", "long", "bool", "abs", "mean", "stack",
    "cat", "split", "run", "step", "render", "close", "join", "start",
}
#: attribute bases whose reads are static host values
_STATIC_BASES = {"self", "cls", "cfg", "np", "math", "os"}
#: host-side modules no wave calls into: an attribute call that names one
#: of their functions is another object's method (a filter's `evaluate` is
#: not the health monitor's)
HOT_EXCLUDE: Tuple[str, ...] = (
    "tpu_pbrt_torch/analysis/", "tpu_pbrt_torch/serve/", "tpu_pbrt_torch/fleet/",
    "tpu_pbrt_torch/load/", "tpu_pbrt_torch/chaos/", "tpu_pbrt_torch/scene/",
    "tpu_pbrt_torch/utils/", "tpu_pbrt_torch/obs/health.py", "tpu_pbrt_torch/obs/trace.py",
    "tpu_pbrt_torch/obs/flight.py", "tpu_pbrt_torch/obs/metrics.py",
    "tpu_pbrt_torch/parallel/checkpoint.py", "tpu_pbrt_torch/kernels/build.py",
    "tpu_pbrt_torch/scenes.py", "tpu_pbrt_torch/main.py", "tpu_pbrt_torch/bench.py",
    "tpu_pbrt_torch/profile_render.py",
)
#: tensor methods whose result is a device value to be read
_REDUCERS = {"any", "all", "sum", "max", "min", "amax", "amin", "mean", "prod", "count_nonzero",
             "argmax", "argmin", "norm"}


def _rel(path: Path, repo_root: Path) -> str:
    try:
        return path.resolve().relative_to(repo_root.resolve()).as_posix()
    except ValueError:
        return path.resolve().as_posix()


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    message: str
    severity: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} [{self.severity}] {self.message}"


# --------------------------------------------------------------------------
# the hot set: a call graph seeded at the wave's entry points
# --------------------------------------------------------------------------


def _call_name(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


class _FnIndex(ast.NodeVisitor):
    """Every function with its name, lexical parent, the calls it makes
    (bare-name and attribute apart) and the module's `from X import y`."""

    def __init__(self) -> None:
        self.by_name: Dict[str, List[int]] = {}
        self.parent: Dict[int, Optional[int]] = {}
        self.name_calls: Dict[int, Set[str]] = {}
        self.attr_calls: Dict[int, Set[str]] = {}
        self.imports: Dict[str, str] = {}
        self._stack: List[int] = []

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module:
            for a in node.names:
                self.imports[a.asname or a.name] = node.module
        self.generic_visit(node)

    def _enter(self, node: ast.AST, name: Optional[str]) -> None:
        key = id(node)
        self.parent[key] = self._stack[-1] if self._stack else None
        self.name_calls[key] = set()
        self.attr_calls[key] = set()
        if name:
            self.by_name.setdefault(name, []).append(key)
        self._stack.append(key)

    def visit_FunctionDef(self, node) -> None:
        self._enter(node, node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._enter(node, None)
        self.generic_visit(node)
        self._stack.pop()

    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node.func)
        if self._stack and name:
            calls = self.name_calls if isinstance(node.func, ast.Name) else self.attr_calls
            calls[self._stack[-1]].add(name)
        self.generic_visit(node)


def _hot_map(trees: Dict[str, ast.AST], seeds: Dict[str, Iterable[str]]) -> Dict[str, Set[int]]:
    """Per module, the ids of the function nodes in the hot set: the seeds
    and everything reachable from them (nested defs included)."""
    indexes: Dict[str, _FnIndex] = {}
    by_name: Dict[str, List[Tuple[str, int]]] = {}
    by_dotted: Dict[str, str] = {}
    hot: Set[Tuple[str, int]] = set()
    for mod, t in trees.items():
        idx = _FnIndex()
        idx.visit(t)
        indexes[mod] = idx
        dotted = mod[:-3].replace("/", ".")
        if dotted.endswith(".__init__"):
            dotted = dotted[: -len(".__init__")]
        by_dotted[dotted] = mod
        if mod.startswith(HOT_EXCLUDE):
            continue
        for name, keys in idx.by_name.items():
            by_name.setdefault(name, []).extend((mod, k) for k in keys)
        for name in seeds.get(mod, ()):
            hot |= {(mod, k) for k in idx.by_name.get(name, ())}

    def resolve(mod: str, name: str, is_attr: bool) -> List[Tuple[str, int]]:
        idx = indexes[mod]
        if not is_attr:
            if name in idx.by_name:
                return [(mod, k) for k in idx.by_name[name]]
            src = idx.imports.get(name)
            if src is not None and src in by_dotted and not by_dotted[src].startswith(HOT_EXCLUDE):
                smod = by_dotted[src]
                return [(smod, k) for k in indexes[smod].by_name.get(name, ())]
            return []
        if name in _GENERIC_NAMES:
            return [(mod, k) for k in idx.by_name.get(name, ())]
        return by_name.get(name, [])

    frontier = list(hot)
    while frontier:
        mod, key = frontier.pop()
        idx = indexes[mod]
        for other, parent in idx.parent.items():
            if parent == key and (mod, other) not in hot:
                hot.add((mod, other))
                frontier.append((mod, other))
        for is_attr, names in ((False, idx.name_calls.get(key, ())),
                               (True, idx.attr_calls.get(key, ()))):
            for name in names:
                for target in resolve(mod, name, is_attr):
                    if target not in hot:
                        hot.add(target)
                        frontier.append(target)
    out: Dict[str, Set[int]] = {mod: set() for mod in trees}
    for mod, key in hot:
        out[mod].add(key)
    return out


# --------------------------------------------------------------------------
# per-file rules
# --------------------------------------------------------------------------


def _literalish(node: ast.expr) -> bool:
    """Expressions that cannot be a device value: constants, static
    attribute reads (cfg.x, self.x, .shape), host computations (len,
    np.*, math.*)."""
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Attribute):
        if node.attr in ("shape", "ndim", "dtype", "device", "is_cuda"):
            return True
        base = node.value
        while isinstance(base, ast.Attribute):
            base = base.value
        return isinstance(base, ast.Name) and base.id in _STATIC_BASES
    if isinstance(node, ast.Subscript):
        return _literalish(node.value)
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) and \
                f.value.id in ("np", "math"):
            return True
        if isinstance(f, ast.Attribute) and f.attr in ("size", "numel", "dim", "bit_length"):
            return True
        return _call_name(f) in {"len", "int", "max", "min", "getattr", "round", "abs"} and \
            all(_literalish(a) for a in node.args)
    if isinstance(node, (ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare, ast.IfExp)):
        kids = [c for c in ast.iter_child_nodes(node) if isinstance(c, ast.expr)]
        return all(_literalish(c) for c in kids)
    return False


def _device_expr(node: ast.expr, device_names: Set[str]) -> bool:
    """Whether an expression is (or reads) a device value: a torch call, a
    reduction method (`x.any()`, `(a < b).sum()`), a name assigned from one
    in the same function, or an expression over one."""
    if isinstance(node, ast.Name):
        return node.id in device_names
    if isinstance(node, ast.Call):
        f = node.func
        if isinstance(f, ast.Attribute):
            if isinstance(f.value, ast.Name) and f.value.id == "torch":
                return True
            if f.attr in _REDUCERS:
                return True
            return _device_expr(f.value, device_names) and f.attr not in _SYNC_METHODS
        return False
    if isinstance(node, (ast.Subscript, ast.Attribute)):
        return _device_expr(node.value, device_names)
    if isinstance(node, (ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare)):
        return any(_device_expr(c, device_names) for c in ast.iter_child_nodes(node)
                   if isinstance(c, ast.expr))
    return False


class _RuleVisitor(ast.NodeVisitor):
    def __init__(self, path: str, hot: Set[int], report) -> None:
        self.path = path
        self.hot = hot
        self.report = report
        self._fn_stack: List[int] = []
        self._fn_lines: List[int] = []
        self._fn_names: List[str] = []
        #: per enclosing function: names assigned from a device value
        self._device: List[Set[str]] = []
        self._f64_ok = F64_FORMS.get(path, ())

    def _in_hot(self) -> bool:
        return any(k in self.hot for k in self._fn_stack)

    def _f64_allowed(self) -> bool:
        return any(n in self._f64_ok for n in self._fn_names)

    def visit_FunctionDef(self, node) -> None:
        self._fn_stack.append(id(node))
        self._fn_lines.append(node.lineno)
        self._fn_names.append(getattr(node, "name", "<lambda>"))
        self._device.append(set())
        self.generic_visit(node)
        self._device.pop()
        self._fn_names.pop()
        self._fn_lines.pop()
        self._fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        if self._device:
            dev = _device_expr(node.value, self._device[-1])
            for t in node.targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name):
                        (self._device[-1].add if dev else self._device[-1].discard)(n.id)

    def _report(self, rule: str, lineno: int, message: str) -> None:
        self.report(rule, lineno, message, tuple(self._fn_lines))

    # JL-ENV, module-wide
    def visit_Attribute(self, node: ast.Attribute) -> None:
        if node.attr in ("environ", "getenv") and isinstance(node.value, ast.Name) and \
                node.value.id in ("os", "_os"):
            self._report("JL-ENV", node.lineno, "environment read outside tpu_pbrt_torch/"
                         "config.py — add the knob to config.Config and read cfg.<name>")
        if self._in_hot() and not self._f64_allowed() and node.attr in ("float64", "double") \
                and isinstance(node.value, ast.Name) and node.value.id in ("torch", "np"):
            self._report("JL-F64", node.lineno, f"{node.value.id}.{node.attr} in the hot set "
                         "doubles the bytes of every value it reaches")
        self.generic_visit(node)

    def visit_Constant(self, node: ast.Constant) -> None:
        if self._in_hot() and not self._f64_allowed() and node.value in ("float64", "double"):
            self._report("JL-F64", node.lineno, "float64 dtype string in the hot set")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = _call_name(node.func)
        if name and self._in_hot():
            self._check_sync(node, name)
            self._check_dtype(node, name)
            if name == "double" and isinstance(node.func, ast.Attribute) and \
                    not self._f64_allowed():
                self._report("JL-F64", node.lineno, ".double() in the hot set")
        self.generic_visit(node)

    def _check_sync(self, node: ast.Call, name: str) -> None:
        if name in _SYNC_METHODS and isinstance(node.func, ast.Attribute) and not (
                isinstance(node.func.value, ast.Name) and node.func.value.id in ("np", "torch")):
            self._report("JL-SYNC", node.lineno, f".{name}() in the hot set waits for the device")
        elif name in ("float", "bool", "int") and isinstance(node.func, ast.Name):
            names = self._device[-1] if self._device else set()
            if node.args and _device_expr(node.args[0], names):
                self._report("JL-SYNC", node.lineno, f"{name}() of a device value waits for the "
                             "device — keep it a tensor, or read it once per wave")

    def _check_dtype(self, node: ast.Call, name: str) -> None:
        if name not in _DTYPE_CTORS or not isinstance(node.func, ast.Attribute):
            return
        base = node.func.value
        if not (isinstance(base, ast.Name) and base.id == "torch"):
            return
        if any(kw.arg == "dtype" or kw.arg is None for kw in node.keywords):
            return
        self._report("JL-DTYPE", node.lineno, f"torch.{name} without a dtype — "
                     "pin torch.float32 / torch.int32")


def _pragmas(source: str) -> Tuple[Dict[int, Set[str]], Set[str], int]:
    """(line -> disabled rules, file-wide disabled rules, pragma count), from
    real comment tokens only (a docstring naming the syntax is no pragma)."""
    per_line: Dict[int, Set[str]] = {}
    per_file: Set[str] = set()
    count = 0
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError):
        return per_line, per_file, 0
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _PRAGMA_FILE_RE.search(tok.string)
        if m:
            per_file |= {r.strip() for r in m.group(1).split(",") if r.strip()}
            count += 1
            continue
        m = _PRAGMA_RE.search(tok.string)
        if m:
            per_line[tok.start[0]] = {r.strip() for r in m.group(1).split(",") if r.strip()}
            count += 1
    return per_line, per_file, count


def lint_file(path: Path, repo_root: Path, hot: Optional[Set[int]] = None,
              tree: Optional[ast.AST] = None,
              seeds: Iterable[str] = ()) -> Tuple[List[Violation], int]:
    """Lint one file. Returns (violations, pragma count). `hot`/`tree` come
    from lint_tree's package-wide pass; on its own a file's hot set is
    seeded at `seeds` (function names) and its HOT_SEEDS entry."""
    rel = _rel(path, repo_root)
    source = path.read_text()
    if tree is None:
        try:
            tree = ast.parse(source, filename=str(path))
        except SyntaxError as e:
            return [Violation("JL-PARSE", rel, e.lineno or 0, f"file does not parse: {e.msg}",
                              "error")], 0
    line_pragmas, file_pragmas, n_pragmas = _pragmas(source)
    if hot is None:
        hot = _hot_map({rel: tree}, {rel: (*seeds, *HOT_SEEDS.get(rel, ()))})[rel]
    out: List[Violation] = []

    def report(rule: str, lineno: int, message: str, scope_lines: Tuple[int, ...] = ()) -> None:
        if rule in file_pragmas or rule in line_pragmas.get(lineno, ()):
            return
        if any(rule in line_pragmas.get(ln, ()) for ln in scope_lines):
            return
        if any(rel.endswith(sfx) for sfx in ALLOWLIST.get(rule, {})):
            return
        out.append(Violation(rule, rel, lineno, message, SEVERITY.get(rule, "error")))

    _RuleVisitor(rel, hot, report).visit(tree)
    out = sorted(set(out), key=lambda v: (v.path, v.line, v.rule))
    return out, n_pragmas


def package_files(repo_root: Path) -> List[Path]:
    return sorted((repo_root / "tpu_pbrt_torch").rglob("*.py"))


@lru_cache(maxsize=512)
def _parse_cached(path: str, mtime_ns: int, size: int) -> ast.AST:
    return ast.parse(Path(path).read_text(), filename=path)


def _parse(path: Path) -> ast.AST:
    """The file's syntax tree, parsed once per content (size and mtime)."""
    st = path.stat()
    return _parse_cached(str(path), st.st_mtime_ns, st.st_size)


def lint_tree(root: Optional[Path] = None, paths: Optional[Iterable[Path]] = None,
              seeds: Optional[Dict[str, Iterable[str]]] = None) -> Tuple[List[Violation], int]:
    """Lint the tpu_pbrt_torch package (or explicit paths). Returns
    (violations, total pragma count)."""
    repo_root = root if root is not None else Path(__file__).resolve().parents[2]
    paths = [Path(p) for p in (paths if paths is not None else package_files(repo_root))]
    trees: Dict[str, ast.AST] = {}
    parse_errors: List[Violation] = []
    for p in paths:
        rel = _rel(p, repo_root)
        try:
            trees[rel] = _parse(p)
        except SyntaxError as e:
            parse_errors.append(Violation("JL-PARSE", rel, e.lineno or 0,
                                          f"file does not parse: {e.msg}", "error"))
    hot_map = _hot_map(trees, seeds if seeds is not None else HOT_SEEDS)
    violations: List[Violation] = list(parse_errors)
    pragmas = 0
    for p in paths:
        rel = _rel(p, repo_root)
        if rel not in trees:
            continue
        v, n = lint_file(p, repo_root, hot=hot_map[rel], tree=trees[rel])
        violations.extend(v)
        pragmas += n
    return violations, pragmas


def hot_functions(root: Optional[Path] = None) -> List[str]:
    """`path:function` of every function in the hot set (to inspect it)."""
    repo_root = root if root is not None else Path(__file__).resolve().parents[2]
    trees = {_rel(p, repo_root): _parse(p) for p in package_files(repo_root)}
    hot = _hot_map(trees, HOT_SEEDS)
    out = []
    for mod, t in trees.items():
        for node in ast.walk(t):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and id(node) in hot[mod]:
                out.append(f"{mod}:{node.name}")
    return sorted(out)
