"""Device layout of the render loop: the process-group mesh (port of
tpu_pbrt/parallel/mesh.py).

The reference splits a render over a JAX device mesh inside one SPMD
program and merges the film with a `psum`. Here a mesh is a
`torch.distributed` process group with one rank per process and one
device per rank: NCCL between cards, gloo between CPU processes (and
between ranks that share one card, which NCCL refuses). Every rank runs
the same deterministic render loop on its own slice of each chunk's work
range; the film contribution and the chunk's accounting are all-reduced
with a sum, so every rank holds the replicated film, and rank 0 alone
writes checkpoints and images. One Python host per card keeps each
card's host-side launch cost off the others' path.

- `Mesh`: this process's rank, the group's size, its device and the
  collectives the render loop uses (sum / max all-reduce, all-gather,
  broadcast, barrier, and `agree` on a chunk's outcome), staged through
  the host where gloo is given CUDA tensors, and the serving ranks'
  `broadcast_object` of rank 0's decision records; `take_log` returns
  their wall seconds by kind.
- `launch`: start N ranks as spawned processes (a `file://` rendezvous in
  a private directory), give each its device, run `fn(mesh, *args)` in
  each and return the ranks' results; `share_device=True` puts every
  rank on the one card (gloo), an explicit layout and never a silent
  substitute; `lead_here=True` runs rank 0 in the calling process.
- `mesh_ranks`: the ranks a `--mesh` spec asks for.
- `maybe_init_distributed`: join a group described by the environment
  (`--multihost`: RANK, WORLD_SIZE, LOCAL_RANK and the coordinator
  address of `config.coordinator_address`).
- `make_mesh` / `resolve_mesh`: the live group as a Mesh; a request for
  more ranks than the group holds renders on one device, with a warning.
- `device_spread`: a rank's scalar as a one-hot vector that the chunk's
  sum all-reduce turns into the per-rank vector.
- `sharded_chunk_renderer` / `sharded_pool_renderer`: a rank's chunk body,
  the ranks' agreement on its outcome (`failure_code`, `agreed_failure`,
  `join_failure`), then the one all-reduce of its film contribution and
  aux.
- `resolve_pipeline_depth`: the in-flight window depth.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

#: seconds a rank waits in a collective (and the launcher for its ranks)
#: before the group is declared failed
COLLECTIVE_TIMEOUT_S = 600.0

_OPS = ("sum", "max")


@dataclass
class Mesh:
    """This process's place in a render mesh: one rank of a process group,
    one device per rank. `size` ranks render a chunk together; `layout`
    says how the ranks map onto devices and which backend joins them."""

    rank: int
    size: int
    device: torch.device
    backend: str
    layout: str = ""
    group: Any = None
    #: {kind: [wall seconds]} of the collectives since take_log
    _log: dict = field(default_factory=dict, repr=False)

    def _stage(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.is_cuda

    def _timed(self, kind: str, fn):
        t0 = time.perf_counter()
        out = fn()
        self._log.setdefault(kind, []).append(time.perf_counter() - t0)
        return out

    def all_reduce_(self, tensors: Sequence[torch.Tensor], op: str = "sum") -> None:
        """Reduce `tensors` over the ranks in place: one collective per dtype
        (the tensors flattened into one buffer), every rank left with the
        same values."""
        import torch.distributed as dist

        if op not in _OPS:
            raise ValueError(f"all_reduce op {op!r}: one of {_OPS}")
        rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        by_dtype = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)

        def run():
            for ts in by_dtype.values():
                flat = torch.cat([t.reshape(-1) for t in ts])
                buf = flat.cpu() if self._stage(flat) else flat
                dist.all_reduce(buf, op=rop, group=self.group)
                if buf is not flat:
                    flat.copy_(buf)
                if flat.is_cuda:
                    torch.cuda.synchronize(flat.device)
                off = 0
                for t in ts:
                    t.copy_(flat[off: off + t.numel()].view_as(t))
                    off += t.numel()

        self._timed("all_reduce", run)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (equal shapes) concatenated along dim 0 in rank
        order, on every rank."""
        import torch.distributed as dist

        def run():
            src = t.contiguous()
            buf = src.cpu() if self._stage(src) else src
            parts = [torch.empty_like(buf) for _ in range(self.size)]
            dist.all_gather(parts, buf, group=self.group)
            out = torch.cat(parts)
            return out.to(t.device) if out.device != t.device else out

        return self._timed("all_gather", run)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> None:
        """Rank `src`'s `t` on every rank, in place."""
        import torch.distributed as dist

        def run():
            buf = t.cpu() if self._stage(t) else t
            dist.broadcast(buf, src=src, group=self.group)
            if buf is not t:
                t.copy_(buf)

        self._timed("broadcast", run)

    def broadcast_object(self, obj: Any = None, src: int = 0) -> Any:
        """Rank `src`'s picklable `obj` on every rank (timed as
        "decision": the serving ranks follow rank 0's decision records
        through it)."""
        import torch.distributed as dist

        def run():
            box = [obj]
            dev = self.device if self.backend == "nccl" else None
            dist.broadcast_object_list(box, src=src, group=self.group, device=dev)
            return box[0]

        return self._timed("decision", run)

    def agree(self, code: int) -> int:
        """The largest `code` any rank holds (a max all-reduce of one
        element, timed as "wait": it is also the wait for the slowest
        rank). Every rank makes one such call per chunk attempt, so the
        ranks act on the chunk's outcome together."""
        import torch.distributed as dist

        def run():
            on_card = self.backend == "nccl"
            buf = torch.tensor([int(code)], dtype=torch.int64,
                               device=self.device if on_card else "cpu")
            dist.all_reduce(buf, op=dist.ReduceOp.MAX, group=self.group)
            return int(buf.item())

        return self._timed("wait", run)

    def barrier(self) -> None:
        """Wait for every rank (timed as "wait")."""
        import torch.distributed as dist

        def run():
            if self.backend == "nccl":
                dist.barrier(group=self.group, device_ids=[self.device.index or 0])
            else:
                dist.barrier(group=self.group)

        self._timed("wait", run)

    def take_log(self) -> dict:
        """{kind: [wall seconds of each collective]} since the last call
        (kinds: wait, all_reduce, all_gather, broadcast, decision)."""
        out, self._log = self._log, {}
        return out


def mesh_ranks(spec: str) -> int:
    """'--mesh 2' or the reference's '2,4' (their product); 1 without."""
    import math

    return math.prod(int(x) for x in spec.split(",")) if spec else 1


def _layout(n: int, device: torch.device, backend: str, share: bool) -> str:
    if device.type == "cpu":
        return f"{n} ranks, one process each, on the CPU ({backend})"
    if share:
        return f"{n} ranks, one process each, sharing cuda:{device.index or 0} ({backend})"
    return f"{n} ranks, one process and one card each, cuda:0-{n - 1} ({backend})"


def _rank_device(device: str, rank: int, share: bool) -> torch.device:
    from tpu_pbrt_torch.config import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        idx = 0 if share else rank
        if idx >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} needs cuda:{idx}, but {torch.cuda.device_count()} "
                               "card(s) are visible (share_device=True puts every rank on one)")
        dev = torch.device("cuda", idx)
        torch.cuda.set_device(dev)
    return dev


def default_backend(device: str, share_device: bool = False) -> str:
    """NCCL between cards, gloo on the CPU and between ranks sharing a card."""
    return "nccl" if str(device).startswith("cuda") and not share_device else "gloo"


def _run_rank(rank, n, init_method, backend, device, share, threads, fn, args) -> dict:
    """One rank's body: join the group, run fn(mesh, *args), leave the
    group. Returns {"ok": True, "value": ...} or the traceback."""
    import torch.distributed as dist

    try:
        if threads:
            torch.set_num_threads(threads)
        dev = _rank_device(device, rank, share)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        mesh = Mesh(rank=rank, size=n, device=dev, backend=backend,
                    layout=_layout(n, dev, backend, share))
        try:
            return {"ok": True, "value": fn(mesh, *args)}
        finally:
            dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 - reported to the launcher, which fails the run
        return {"ok": False, "error": traceback.format_exc()}


def _rank_main(rank, n, init_method, backend, device, share, threads, fn, args, out_dir):
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    result = _run_rank(rank, n, init_method, backend, device, share, threads, fn, args)
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)


def _watch_ranks(procs, first: int):
    """While rank 0 runs in this process, a spawned rank that ends has
    left the group: rank 0 would wait in its next collective until the
    group's timeout. The watcher ends this process at once instead, with
    the rank named on stderr. Returns the event that stops the watch."""
    import sys
    import threading

    done = threading.Event()

    def watch():
        while not done.wait(0.5):
            for r, p in enumerate(procs, start=first):
                if not p.is_alive() and not done.is_set():
                    print(f"mesh: rank {r} ended (exit code {p.exitcode}) while rank 0 "
                          "was running; stopping every rank", file=sys.stderr, flush=True)
                    for q in procs:
                        if q.is_alive():
                            q.kill()
                    os._exit(1)

    threading.Thread(target=watch, daemon=True).start()
    return done


def launch(fn: Callable, n_ranks: int, args: tuple = (), device: str = "cuda",
           backend: Optional[str] = None, share_device: bool = False,
           threads: Optional[int] = None, timeout: float = COLLECTIVE_TIMEOUT_S,
           lead_here: bool = False) -> list:
    """Run `fn(mesh, *args)` on `n_ranks` ranks, each a spawned process
    with its own device (cuda:rank, or cuda:0 for every rank with
    `share_device=True`, or the CPU), joined in one process group through
    a `file://` rendezvous in a private directory. Returns the ranks'
    results in rank order. A rank that raises, dies or outlasts `timeout`
    fails the launch (RuntimeError with its traceback); every process is
    stopped before this returns. `fn` and `args` must pickle; `threads`
    sets each rank's torch CPU threads (default: the calling process's
    torch threads shared over the ranks). `lead_here=True` runs rank 0 in the calling process (which
    keeps its standard input: the serving daemon's rank 0 reads it) and
    spawns the others; `timeout` then bounds their wait after rank 0."""
    import multiprocessing as mp

    backend = backend or default_backend(device, share_device)
    threads = threads or max(1, torch.get_num_threads() // n_ranks)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="tpu_pbrt_torch_mesh_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        first = 1 if lead_here else 0
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, n_ranks, init, backend, device, share_device, threads, fn,
                                   args, tmp))
                 for r in range(first, n_ranks)]
        for p in procs:
            p.start()
        errors = []
        try:
            lead = None
            if lead_here:
                done = _watch_ranks(procs, first)
                try:
                    lead = _run_rank(0, n_ranks, init, backend, device, share_device,
                                     None, fn, args)
                finally:
                    done.set()
            # a rank 0 that failed sends no more decisions: its followers
            # are stopped at once instead of waiting out their collective
            wait_s = timeout if lead is None or lead["ok"] else 5.0
            deadline = time.monotonic() + wait_s
            for r, p in enumerate(procs, start=first):
                p.join(max(0.0, deadline - time.monotonic()))
                if p.is_alive():
                    errors.append(f"rank {r}: still running after {wait_s:.0f} s")
                    break
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        if lead is not None:
            if lead["ok"]:
                results.append(lead["value"])
            else:
                errors.insert(0, f"rank 0:\n{lead['error']}")
        for r, p in enumerate(procs, start=first):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: exited with code {p.exitcode} and no result")
                continue
            with open(path, "rb") as f:
                res = pickle.load(f)
            if res["ok"]:
                results.append(res["value"])
            else:
                errors.append(f"rank {r}:\n{res['error']}")
        if errors:
            raise RuntimeError("mesh launch failed:\n" + "\n".join(errors))
        return results


def maybe_init_distributed(options=None) -> bool:
    """Join the process group the environment describes (RANK, WORLD_SIZE,
    LOCAL_RANK, and `config.coordinator_address()` as the rendezvous)
    when `options.multihost` is set or a coordinator address is; NCCL on
    CUDA, gloo on the CPU (`options.device`). Idempotent; returns whether
    a group is live. A failed join warns and renders on one device, as
    the reference does. Sets the `distributed_init_seconds` gauge."""
    import torch.distributed as dist

    from tpu_pbrt_torch.config import coordinator_address

    addr = coordinator_address()
    if not (bool(getattr(options, "multihost", False)) or addr):
        return False
    if dist.is_available() and dist.is_initialized():
        return True
    from tpu_pbrt_torch.obs.metrics import METRICS
    from tpu_pbrt_torch.utils.error import Warning as _W

    t0 = time.perf_counter()
    try:
        if not addr:
            raise ValueError("no coordinator address (TORCH_PBRT_COORDINATOR_ADDRESS)")
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        device = str(getattr(options, "device", None) or "cuda")
        if device.startswith("cuda"):
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
        dist.init_process_group(default_backend(device), init_method=f"tcp://{addr}",
                                rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    except (KeyError, RuntimeError, ValueError) as e:
        _W(f"torch.distributed could not join the group: {e}; rendering on one device")
        return False
    METRICS.gauge("distributed_init_seconds",
                  "wall seconds torch.distributed.init_process_group took").set(
        time.perf_counter() - t0)
    return True


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The live process group as a Mesh: this process's rank on `device`
    (default: cuda:LOCAL_RANK, or the CPU for a gloo group). n_devices,
    when given, must be the group's size."""
    import torch.distributed as dist

    n = dist.get_world_size()
    if n_devices is not None and int(n_devices) != n:
        raise ValueError(f"a mesh of {n_devices} ranks in a group of {n}")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
                  else torch.device("cpu"))
    device = torch.device(device)
    return Mesh(rank=dist.get_rank(), size=n, device=device, backend=backend,
                layout=_layout(n, device, backend, False))


def resolve_mesh(mesh_shape, device=None) -> Optional[Mesh]:
    """Options.mesh_shape (the CLI's '--mesh 2' or '2,4') -> a Mesh over
    the live process group, or None for one device. A request wider than
    the group (or made outside one) renders on one device, with a
    warning, as the reference's degrade does. Sets the `mesh_devices`
    gauge (1 for one device)."""
    import torch.distributed as dist

    from tpu_pbrt_torch.obs.metrics import METRICS

    mesh = None
    if mesh_shape:
        n_req = int(np.prod(tuple(mesh_shape)))
        live = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        if n_req > 1 and live == n_req:
            mesh = make_mesh(n_req, device)
        elif n_req > 1:
            from tpu_pbrt_torch.utils.error import Warning as _W

            _W(f"a mesh of {n_req} devices was asked for, but {live} rank(s) are live; "
               "rendering on one device")
    METRICS.gauge("mesh_devices", "devices in the resolved render mesh").set(
        1 if mesh is None else mesh.size)
    return mesh


def resolve_pipeline_depth(mesh=None) -> int:
    """How many chunk-slices the render loop keeps dispatched ahead of the
    host: TORCH_PBRT_PIPELINE (default 2), at least 1; depth 1 is the
    synchronous dispatch/block/host-work loop.

    The strict film-firewall modes (TORCH_PBRT_NONFINITE=raise|retry)
    force depth 1: they read each chunk's scrub count before the next
    dispatch may trust the film, a per-chunk sync the window cannot hide,
    and checking at once keeps the failure on the chunk that scrubbed.
    `mesh` is accepted for the reference's call signature."""
    from tpu_pbrt_torch.config import cfg

    if cfg.nonfinite != "scrub":
        return 1
    return max(1, int(cfg.pipeline))


def device_spread(value, mesh: Mesh) -> torch.Tensor:
    """A rank's scalar as an (n,) int64 one-hot vector: the chunk's sum
    all-reduce turns it into the per-rank vector on every rank (the
    per-rank wave counts' spread), without a collective of its own."""
    out = torch.zeros((mesh.size,), dtype=torch.int64, device=mesh.device)
    out[mesh.rank] = int(value)
    return out


#: a chunk attempt's outcome on one rank, agreed as the ranks' max: it
#: ran, it failed and a re-dispatch is exact, it failed and poisoned the
#: film (the ladder rolls back), or it failed for good
OK, CLEAN, POISONED, FATAL = 0, 1, 2, 3


def failure_code(e: BaseException) -> int:
    from tpu_pbrt_torch.integrators.common import DEVICE_ERRORS, ChunkDispatchError

    if isinstance(e, ChunkDispatchError):
        return POISONED if e.poisons_state else CLEAN
    return POISONED if isinstance(e, DEVICE_ERRORS) else FATAL


def agreed_failure(mesh: Mesh, code: int, err: Optional[BaseException]) -> BaseException:
    """The exception every rank raises for a chunk whose agreed outcome is
    `code` (not OK); `err` is this rank's own failure, or None. A FATAL
    outcome ends the render on every rank: the failing rank re-raises its
    own error, the others a RuntimeError that the ladder does not catch."""
    from tpu_pbrt_torch.integrators.common import ChunkDispatchError

    if code == FATAL:
        if err is not None and failure_code(err) == FATAL:
            return err
        return RuntimeError(f"rank {mesh.rank}: another rank of the mesh failed for good")
    where = f"rank {mesh.rank}: {err}" if err is not None else "on another rank"
    exc = ChunkDispatchError(f"mesh chunk failed ({where})", poisons_state=code == POISONED)
    exc.__cause__ = err
    return exc


def join_failure(mesh: Mesh, err: BaseException) -> BaseException:
    """For a rank whose chunk attempt failed before its step (the chaos
    seam): join the agreement the other ranks wait in, and return the
    agreed exception to raise."""
    return agreed_failure(mesh, mesh.agree(failure_code(err)), err)


def _reduce_step(mesh: Mesh, body):
    def step(start):
        err = None
        try:
            contrib, aux = body(start)
            if contrib[0].is_cuda:
                torch.cuda.synchronize(contrib[0].device)
        except Exception as e:
            err = e
        # the wait for the slowest rank and the chunk's agreed outcome,
        # then the merge itself: a rank that failed never leaves the
        # others in a collective it skips
        code = mesh.agree(OK if err is None else failure_code(err))
        if code != OK:
            raise agreed_failure(mesh, code, err)
        mesh.all_reduce_(list(contrib) + [a for a in aux if isinstance(a, torch.Tensor)])
        return contrib, aux

    return step


def sharded_chunk_renderer(mesh: Mesh, per_device_fn):
    """The fixed batch's chunk step over the mesh: per_device_fn(start
    pair) -> (film contribution, aux tensors) on this rank's slice, then
    one sum all-reduce of both; every rank returns the merged totals.
    Before the reduce the ranks agree on the chunk's outcome (one max
    all-reduce): where any rank failed, every rank raises the same
    failure, and the render loop's recovery ladder runs in lockstep (a
    device error poisons the film: every rank rolls back)."""
    return _reduce_step(mesh, per_device_fn)


def sharded_pool_renderer(mesh: Mesh, per_device_drain):
    """The persistent pool's analog of sharded_chunk_renderer: each rank
    drains its own work slice through its own pool, with no collective
    inside the drain (the ranks may run different wave counts); the
    agreement and the sum all-reduce after it are the chunk's only
    synchronization."""
    return _reduce_step(mesh, per_device_drain)
