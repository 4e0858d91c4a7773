"""The port's entry points, recorded, and the hot-path invariants checked on
them (counterpart of tpu_pbrt/analysis/audit.py).

Where the reference traces each entry point to a jaxpr, the port runs it
once under analysis/record.py's OpRecorder, at the reference's tiny
scene (`_stream_scene`: the ~2.2k-triangle killeroo stand-in, maxdepth
3), and checks what the run dispatched:

- **film in place** (the reference's `check_film_donation`): a chunk's
  deposits write the film tensors in place, so their storage (data_ptr)
  is the same after a pool chunk and after a ChunkPlan dispatch;
- **no rebuild** (`check_recompile_guard`): two same-shape renders build
  no kernel, and the second render's chunk plan decomposes the work as
  the first's (chunk, pool, chunks, tracer, fingerprint). The port has
  no compiled program to cache; a plan is a host-side dataclass built
  per render;
- **host reads match** (`check_transfer_guard`): every host sync the
  pool chunk dispatched (the host reads, host-device copies and
  data-sized ops of the record) is one the stream tracer's tally counts:
  their number equals the traversal's host reads plus the loop's
  (`stats["host_reads_per_wave_mean"] + stats["loop_host_reads_per_wave"]`
  per wave);
- **f64 confined** (`find_f64`): float64 only inside core/xla_math.py's
  f64 forms: on the CPU `_fma_f64` and `sqrt` and, on both devices, the
  sine, cosine and power (`_sincos`, `_sincos_poly`, `pow`: glibc's sinf,
  cosf and powf work in double, and the port copies them so that the
  card rounds as the reference does). So the CUDA path is not free of
  float64: these three stay, elementwise on wave-width tensors, where
  the H100 SXM5's non-tensor FP64 runs at about half its FP32 rate
  (34 against 67 TFLOP/s). No other float64 on either device;
- **no callbacks** (`find_callbacks`): no host read of wave-width data
  (lane data taken to the host and back) and no Python loop over lanes
  (one source line dispatching a wave width of one-element ops in one
  wave).

Entry points: the pool wave (`PathIntegrator.pool_chunk`), the fixed
batch's `path.li`, stream traversal (`accel/stream.py::
stream_intersect_split`), both film deposits, the mesh step
(`parallel/mesh.py::sharded_pool_renderer` over a one-rank gloo group)
and the serve step (the ChunkPlan dispatch a RenderService slice runs).
analysis/cost.py rolls the same records up into static costs.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from tpu_pbrt_torch.analysis.record import FRAME_OPS, OpRecord, OpRecorder

#: the work items and pool slots of a recorded pool chunk: one refill of
#: a 64-slot pool (the reference traces 256 items through 64 slots; its
#: loop body is charged once, the port pays for every wave it records)
POOL_WORK, POOL_SLOTS = 64, 64
#: rays of the recorded fixed-batch li, stream traversal and deposits
LI_RAYS, STREAM_RAYS, DEPOSIT_SAMPLES = 64, 128, 64

#: core/xla_math.py functions whose float64 is by design: on the CPU all,
#: on CUDA the sine, cosine and power only (`_fma_f64` and `sqrt` branch
#: to f32 ops there)
F64_FORMS = {"cpu": ("_fma_f64", "sqrt", "_sincos", "_sincos_poly", "pow"),
             "cuda": ("_sincos", "_sincos_poly", "pow")}
_XLA_MATH = "tpu_pbrt_torch/core/xla_math.py:"

# --------------------------------------------------------------------------
# audited scenes (built once per process and device)
# --------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _stream_scene(spp: int = 2, device: str = "cpu"):
    """The ~2.2k-triangle killeroo stand-in under `path`: big enough for the
    stream tracer (7 treelets), small enough to record fast."""
    from tpu_pbrt_torch.scenes import compile_api, make_killeroo_like

    return compile_api(make_killeroo_like(res=16, spp=spp, integrator="path", maxdepth=3,
                                          n_theta=24, n_phi=48, device=device))


@dataclass
class EntryRun:
    """One recorded run of an entry point: its records, the waves it ran
    (the loop reads; 1 for an entry point without a wave loop) and the
    width of a wave (lanes or rays)."""

    entry: str
    rec: OpRecorder
    waves: int
    wave_width: int
    device: str
    #: the stream tracer's tally over the run (accel/stream.py WaveTally)
    tally: Optional[dict] = None


def _device(device: Optional[str]) -> str:
    """The device type a recorded run uses: CUDA unless the caller names
    the CPU (config.resolve_device; no card and no "cpu": it raises)."""
    from tpu_pbrt_torch.config import resolve_device

    return resolve_device(device).type


def record_entry(entry: str, fn: Callable, wave_width: int, device: Optional[str] = None,
                 frames=FRAME_OPS) -> EntryRun:
    """Run fn() once under an OpRecorder, the stream tracer's tally reset
    before; its waves are the loop reads it made (at least 1)."""
    from tpu_pbrt_torch.accel import stream

    device = _device(device)
    stream.WAVES.reset()
    with OpRecorder(frames=frames) as rec:
        fn()
        if device == "cuda":
            torch.cuda.synchronize()
    w = stream.WAVES
    tally = dict(waves=w.waves, host_reads=w.host_reads, loop_reads=w.loop_reads,
                 flush_calls=sum(m["flush_calls"] for m in w.by_mode.values()))
    waves = max(rec.waves(), 1)
    return EntryRun(entry, rec, waves, wave_width, device, tally)


def record_pool_chunk(device: Optional[str] = None) -> EntryRun:
    """One pool chunk: POOL_WORK items drained through POOL_SLOTS slots."""
    device = _device(device)
    scene, integ = _stream_scene(device=device)
    film = scene.film

    def run():
        fs = film.init_state(device)
        return fs, integ.pool_chunk(scene.dev, fs, 0, 0, POOL_WORK, POOL_SLOTS, film=film,
                                    cam=scene.camera)

    return record_entry("pool_chunk", run, POOL_SLOTS, device)


def record_li(device: Optional[str] = None) -> EntryRun:
    """The fixed batch's li on LI_RAYS rays from the origin along +z."""
    device = _device(device)
    scene, integ = _stream_scene(device=device)
    n = LI_RAYS
    o = torch.zeros((n, 3), dtype=torch.float32, device=device)
    d = torch.tensor([0.0, 0.0, 1.0], device=device).expand(n, 3).contiguous()
    px = torch.zeros((n,), dtype=torch.int32, device=device)
    return record_entry("path.li", lambda: integ.li(scene.dev, o, d, px, px, px), n, device)


def record_stream(device: Optional[str] = None) -> EntryRun:
    """One fused traversal wave: STREAM_RAYS rays, the first half finalized
    (camera rays), the rest bare prim ids (queued shadow rays)."""
    device = _device(device)
    from tpu_pbrt_torch.accel.stream import stream_intersect_split

    scene, _ = _stream_scene(device=device)
    dev = scene.dev
    n = STREAM_RAYS
    o = torch.zeros((n, 3), dtype=torch.float32, device=device)
    d = torch.tensor([0.0, 0.0, 1.0], device=device).expand(n, 3).contiguous()
    return record_entry("stream_intersect_split", lambda: stream_intersect_split(
        dev["tstream"], dev["tri_verts"], o, d, float("inf"), n // 2,
        tv9T=dev.get("tri_verts9T")), n, device)


def record_film_deposit(pixel_path: bool = False, device: Optional[str] = None) -> EntryRun:
    device = _device(device)
    scene, _ = _stream_scene(device=device)
    film = scene.film
    n = DEPOSIT_SAMPLES
    L = torch.zeros((n, 3), dtype=torch.float32, device=device)
    wt = torch.ones((n,), dtype=torch.float32, device=device)
    fs = film.init_state(device)
    if pixel_path:
        px = torch.zeros((n,), dtype=torch.int32, device=device)
        done = torch.ones((n,), dtype=torch.bool, device=device)
        return record_entry("film.add_samples_pixel",
                            lambda: film.add_samples_pixel(fs, px, px, L, done, wt), n, device)
    pf = torch.zeros((n, 2), dtype=torch.float32, device=device)
    return record_entry("film.add_samples", lambda: film.add_samples(fs, pf, L, wt), n, device)


@contextlib.contextmanager
def one_rank_mesh(device: str):
    """A one-rank gloo process group in this process (a file rendezvous in
    a private directory) as a Mesh; the group is destroyed on exit. An
    existing group is used as it is."""
    import torch.distributed as dist

    from tpu_pbrt_torch.parallel.mesh import Mesh

    own = not dist.is_initialized()
    with tempfile.TemporaryDirectory(prefix="tpu_pbrt_torch_audit_") as tmp:
        if own:
            dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "rdv"),
                                    world_size=1, rank=0)
        try:
            yield Mesh(rank=dist.get_rank(), size=dist.get_world_size(),
                       device=torch.device(device), backend=dist.get_backend(),
                       layout="1 rank (audit)")
        finally:
            if own:
                dist.destroy_process_group()


def record_mesh_step(device: Optional[str] = None) -> EntryRun:
    """sharded_pool_renderer's step over a one-rank gloo group: the
    rank's drain into a fresh film, the chunk's agreement and the film
    and accounting all-reduce (prepare_chunks' per_device_drain)."""
    device = _device(device)
    from tpu_pbrt_torch.parallel.mesh import device_spread, sharded_pool_renderer

    scene, integ = _stream_scene(device=device)
    film = scene.film

    with one_rank_mesh(device) as mesh:
        def per_device_drain(c):
            contrib = film.init_state(device)
            _, nrays, live, waves, trunc, ctr = integ.pool_chunk(
                scene.dev, contrib, 0, 0, POOL_WORK, POOL_SLOTS, film=film, cam=scene.camera)
            i64 = dict(dtype=torch.int64, device=device)
            aux = (torch.as_tensor(nrays, **i64).reshape(()),
                   torch.as_tensor(live, **i64).reshape(()), torch.tensor(waves, **i64),
                   torch.tensor(trunc, **i64), *(() if ctr is None else tuple(ctr)),
                   device_spread(waves, mesh))
            return contrib, aux

        step = sharded_pool_renderer(mesh, per_device_drain)
        return record_entry("mesh_step", lambda: step(0), POOL_SLOTS, device)


def record_serve_step(device: Optional[str] = None) -> EntryRun:
    """The chunk-slice dispatch a RenderService step runs
    (ChunkPlan.dispatch) at a service-shaped slice of POOL_WORK items."""
    device = _device(device)
    from tpu_pbrt_torch.config import cfg

    scene, integ = _stream_scene(device=device)
    saved = cfg.pool
    cfg.pool = POOL_SLOTS
    try:
        plan = integ.prepare_chunks(scene, chunk=POOL_WORK)
    finally:
        cfg.pool = saved
    state = scene.film.init_state(device)
    return record_entry("serve_step", lambda: plan.dispatch(state, 0), plan.pool, device)


def entry_points(device: Optional[str] = None) -> Dict[str, Callable[[], EntryRun]]:
    """name -> () -> EntryRun: the audited entry points, each recorded at
    the reference's tiny scene on `device`."""
    device = _device(device)
    return {
        "pool_chunk": lambda: record_pool_chunk(device),
        "path.li": lambda: record_li(device),
        "stream_intersect_split": lambda: record_stream(device),
        "film.add_samples": lambda: record_film_deposit(False, device),
        "film.add_samples_pixel": lambda: record_film_deposit(True, device),
        "mesh_step": lambda: record_mesh_step(device),
        "serve_step": lambda: record_serve_step(device),
    }


# --------------------------------------------------------------------------
# checks over records
# --------------------------------------------------------------------------


def find_f64(records: List[OpRecord], device: str) -> List[str]:
    """Every op with a float64 operand or result outside F64_FORMS[device]
    (empty = clean)."""
    allowed = F64_FORMS.get(device, ())
    bad = []
    for r in records:
        if r.kind not in ("op", "kernel"):
            continue
        if not any(m.dtype == torch.float64 for m in r.ins + r.outs):
            continue
        fn = r.frame.rsplit(" ", 1)[-1] if r.frame else ""
        if r.frame.startswith(_XLA_MATH) and fn in allowed:
            continue
        bad.append(f"{r.name} -> float64 at {r.frame or '?'}")
    return bad


#: module -> why its host reads of wave-width data are no callback
CALLBACK_EXEMPT = {
    "tpu_pbrt_torch/parallel/mesh.py:": "a gloo group's collectives stage CUDA tensors through "
                                         "the host (Mesh._stage); NCCL keeps them on the cards",
}


def find_callbacks(records: List[OpRecord], wave_width: int) -> List[str]:
    """Host round trips of lane data (a host read of at least a wave width
    of elements) and Python loops over lanes (one source line dispatching,
    in one wave, at least a wave width of ops whose results each hold one
    element: a lane taken apart). Empty = clean."""
    found = []
    for r in records:
        if r.kind == "host_read" and r.ins and r.ins[0].numel >= max(wave_width, 2) and \
                not r.frame.startswith(tuple(CALLBACK_EXEMPT)):
            found.append(f"{r.name}() of {r.ins[0].numel} elements at {r.frame}")
    per_line: Dict[tuple, int] = {}
    for r in records:
        if r.kind == "op" and r.frame and r.outs and all(m.numel <= 1 for m in r.outs):
            key = (r.wave, r.frame)
            per_line[key] = per_line.get(key, 0) + 1
    for (wave, frame), n in sorted(per_line.items()):
        if n >= max(wave_width, 2):
            found.append(f"{n} one-element ops from {frame} in wave {wave}: a loop over lanes")
    return found


def host_sync_check(run: EntryRun) -> List[str]:
    """The run's host syncs against the stream tracer's tally: equal in
    number (see module doc)."""
    syncs = run.rec.syncs()
    want = run.tally["host_reads"] + run.tally["loop_reads"]
    if len(syncs) == want:
        return []
    from collections import Counter

    where = Counter(f"{r.name} at {r.frame}" for r in syncs).most_common(6)
    return [f"{run.entry}: {len(syncs)} host syncs recorded over {run.waves} waves, the tally "
            f"counts {want} (traversal {run.tally['host_reads']} + loop "
            f"{run.tally['loop_reads']}): {where}"]


def record_invariants(run: EntryRun) -> List[str]:
    fails = []
    f64 = find_f64(run.rec.records, run.device)
    if f64:
        fails.append(f"{run.entry}: float64 outside xla_math's f64 forms ({f64[0]}; "
                     f"{len(f64)} total)")
    cbs = find_callbacks(run.rec.records, run.wave_width)
    if cbs:
        fails.append(f"{run.entry}: {cbs[0]} ({len(cbs)} total)")
    return fails


def check_film_in_place(device: Optional[str] = None) -> List[str]:
    """The film tensors keep their storage across a pool chunk and across a
    ChunkPlan dispatch (the deposits write them in place)."""
    device = _device(device)
    scene, integ = _stream_scene(device=device)
    film = scene.film
    fails = []
    fs = film.init_state(device)
    before = [t.data_ptr() for t in fs]
    out = integ.pool_chunk(scene.dev, fs, 0, 0, POOL_WORK, POOL_SLOTS, film=film,
                           cam=scene.camera)[0]
    if out is not fs or [t.data_ptr() for t in out] != before:
        fails.append("pool_chunk: the film state left its storage")
    plan = integ.prepare_chunks(scene, chunk=POOL_WORK)
    state = film.init_state(device)
    before = [t.data_ptr() for t in state]
    plan.dispatch(state, 0)
    if [t.data_ptr() for t in state] != before:
        fails.append("ChunkPlan.dispatch: the film state left its storage")
    if float(state.weight.sum()) <= 0.0:
        fails.append("ChunkPlan.dispatch: nothing was deposited")
    return fails


def check_no_rebuild(device: Optional[str] = None) -> List[str]:
    """Two same-shape renders: no kernel built by the second, and its plan
    decomposes the work as the first's."""
    device = _device(device)
    from tpu_pbrt_torch.kernels import build

    scene, integ = _stream_scene(spp=1, device=device)
    plans = []
    orig = integ.prepare_chunks

    def spy(*a, **k):
        plans.append(orig(*a, **k))
        return plans[-1]

    integ.prepare_chunks = spy
    try:
        integ.render(scene)
        builds, libs = dict(build.BUILDS), set(build._libs)
        integ.render(scene)
    finally:
        del integ.prepare_chunks
    fails = []
    if dict(build.BUILDS) != builds or set(build._libs) != libs:
        fails.append(f"second same-shape render built kernels ({builds} -> {build.BUILDS})")
    keys = ("chunk", "n_chunks", "pool", "use_regen", "tracer", "fingerprint", "total")
    if len(plans) != 2 or any(getattr(plans[0], k) != getattr(plans[1], k) for k in keys):
        fails.append("second same-shape render planned its chunks differently")
    return fails


def check_host_reads(device: Optional[str] = None, run: Optional[EntryRun] = None) -> List[str]:
    """The pool chunk's host syncs (`run`, or a fresh record) equal the
    tally's reads, and a smoke render's image is finite."""
    device = _device(device)
    fails = host_sync_check(run or record_pool_chunk(device))
    scene, integ = _stream_scene(spp=1, device=device)
    img = np.asarray(integ.render(scene).image, np.float32)
    if not np.isfinite(img).all():
        fails.append("smoke render produced non-finite pixels")
    return fails


def run_audit(device: Optional[str] = None,
              runs: Optional[Dict[str, EntryRun]] = None) -> List[str]:
    """Every audit; returns failure strings (empty = all invariants hold).
    A check that raises is reported as a failure, never raised. `runs`:
    entry points already recorded (name -> EntryRun), recorded here
    otherwise."""
    device = _device(device)
    failures: List[str] = []
    for name, fn in entry_points(device).items():
        try:
            run = runs[name] if runs and name in runs else fn()
            failures.extend(record_invariants(run))
        except Exception as e:  # noqa: BLE001 - the report must be complete
            failures.append(f"{name}: audit crashed: {type(e).__name__}: {e}")
    pool = (runs or {}).get("pool_chunk")
    for label, fn in (("film in place", check_film_in_place),
                      ("no rebuild", check_no_rebuild),
                      ("host reads", lambda d: check_host_reads(d, pool))):
        try:
            failures.extend(fn(device))
        except Exception as e:  # noqa: BLE001
            failures.append(f"{label}: audit crashed: {type(e).__name__}: {e}")
    return failures
