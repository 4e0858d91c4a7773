"""protocheck's stub harness (port of tpu_pbrt/analysis/protocheck.py's
dynamic half, `_harness`): the real RenderService driven through stub
chunk dispatches.

The reference's protocheck verifies the serve/dispatch protocol, the
state machine of serve/service.py, serve/queue.py and the dispatch
window, by exploring decision sequences on a service whose chunks are
stubs: instant, bit-deterministic film deposits, so film identity
across interleavings is checkable exactly. The load harness
(load/replay.py) submits the same stub pairs to replay hours of traffic
in seconds. This module holds that harness over the port's FilmState
and WavefrontIntegrator; the explorer, its invariants and its mutation
corpus are still to be ported beside it.

The stub plan follows the port's ChunkPlan contract: `dispatch(state,
c)` deposits chunk c into the film in place and returns its accounting.

`_pragma_lines` and `_shallow_walk` are the reference's static helpers,
which the port's hbmcheck takes from here as the reference's does (the
pragma grammar is the port's lint's, `# torchlint: disable=`).
"""

from __future__ import annotations

import ast
import os
from typing import Any, Dict, Optional, Tuple

from tpu_pbrt_torch.analysis.lint import _PRAGMA_FILE_RE, _PRAGMA_RE

#: every stub chunk reports exactly this many rays — the counter
#: reconciliation (PROTO-COUNT) is then n_chunks * this
RAYS_PER_CHUNK = 64

_HARNESS: Optional[Dict[str, Any]] = None


def _pragma_lines(src: str) -> Tuple[Dict[int, set], set]:
    """(lineno -> disabled rules, file-level disabled rules) — the same
    `# torchlint: disable=` grammar the lint uses, so one suppression
    idiom covers every analysis layer."""
    per_line: Dict[int, set] = {}
    file_wide: set = set()
    for i, line in enumerate(src.splitlines(), 1):
        m = _PRAGMA_FILE_RE.search(line)
        if m:
            file_wide |= {r.strip() for r in m.group(1).split(",")}
        m = _PRAGMA_RE.search(line)
        if m:
            per_line.setdefault(i, set()).update(
                r.strip() for r in m.group(1).split(",")
            )
    return per_line, file_wide


def _shallow_walk(node: ast.AST):
    """Yield `node`'s body nodes without descending into nested
    function/lambda scopes — SV-CLOCK's one-sample-per-scope contract
    is per function, and a deferred `write()` closure is its own
    scope."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def repo_root() -> str:
    """The checkout root (tpu_pbrt_torch/analysis/protocheck.py -> up 3)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _harness() -> Dict[str, Any]:
    """Build (once) the stub scene/plan/integrator classes. Lazy and
    cached, as the reference's: the classes subclass the port's
    WavefrontIntegrator, which this module does not import until
    asked."""
    global _HARNESS
    if _HARNESS is not None:
        return _HARNESS
    import zlib

    import numpy as np
    import torch

    from tpu_pbrt_torch.core.film import FilmState
    from tpu_pbrt_torch.integrators.common import WavefrontIntegrator

    class StubFilm:
        """2x2 film with the real FilmState layout (host tensors);
        develop() mirrors the radiance/weight normalization shape
        deterministically."""

        full_resolution = (2, 2)

        def init_state(self, device="cpu"):
            return FilmState(
                rgb=torch.zeros((2, 2, 3), dtype=torch.float32, device=device),
                weight=torch.zeros((2, 2), dtype=torch.float32, device=device),
                splat=torch.zeros((2, 2, 3), dtype=torch.float32, device=device),
            )

        def develop(self, state, splat_scale: float = 1.0):
            rgb = state.rgb.detach().cpu().numpy()
            w = np.maximum(state.weight.detach().cpu().numpy(), 1e-9)[..., None]
            return rgb / w + state.splat.detach().cpu().numpy() * np.float32(splat_scale)

    class StubScene:
        def __init__(self):
            self.dev: Dict[str, Any] = {}  # no device-resident tables
            self.film = StubFilm()
            self.device = torch.device("cpu")

    def _contrib(c: int) -> torch.Tensor:
        # distinct deterministic per-chunk deposit: accumulation-order
        # bugs change the film bit pattern even on a 2x2 stub
        val = (zlib.crc32(f"chunk:{c}".encode()) % 1021) / 1021.0
        return torch.full((2, 2, 3), float(np.float32(val)), dtype=torch.float32)

    class StubPlan:
        """Duck-typed ChunkPlan: every field/method the service touches,
        with dispatch() an in-place accumulate — idempotent, instant, and
        bit-deterministic, so film identity across interleavings is
        checkable exactly."""

        def __init__(self, n_chunks: int, depth: int):
            self.n_chunks = int(n_chunks)
            self.pipeline_depth = max(1, int(depth))
            self.spp = 1
            self.film = StubFilm()
            self.fingerprint = f"stub:n{n_chunks}:d{depth}"
            self.tracer = "stub"
            self.use_regen = False
            self.pool = 1

        def capacity_audit(self) -> None:
            pass

        def dispatch(self, state, c: int):
            state.rgb.add_(_contrib(c))
            state.weight.add_(1.0)
            return RAYS_PER_CHUNK

        def aux_parts(self, aux):
            return (aux, None, None, None, None)

    class StubIntegrator(WavefrontIntegrator):
        """Subclasses the real base WITHOUT overriding render() — the
        submit-time chunked-loop check must accept it via the real
        entry point — and with its own tiny ctor (no scene plumbing)."""

        def __init__(self, n_chunks: int, depth: int):  # noqa: D107
            self.n_chunks = int(n_chunks)
            self.depth = int(depth)
            self.name = "stub"

        def prepare_chunks(self, scene=None, mesh=None, chunk=None):
            return StubPlan(self.n_chunks, self.depth)

    def reference_state(n_chunks: int):
        """The sequential-schedule film: chunks 0..n-1 accumulated in
        cursor order — the bit-identity baseline every explored
        interleaving's terminal film is compared against."""
        plan = StubPlan(n_chunks, 1)
        state = plan.film.init_state()
        for c in range(n_chunks):
            plan.dispatch(state, c)
        return state

    _HARNESS = {
        "StubFilm": StubFilm,
        "StubScene": StubScene,
        "StubPlan": StubPlan,
        "StubIntegrator": StubIntegrator,
        "reference_state": reference_state,
    }
    return _HARNESS
