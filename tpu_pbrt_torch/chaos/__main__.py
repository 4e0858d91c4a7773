"""`python -m tpu_pbrt_torch.chaos` — the deterministic recovery matrix
(port of tpu_pbrt/chaos/__main__.py).

Renders the small cornell scene once undisturbed, then replays it under
every chaos scenario — poisoned dispatch, clean re-dispatch, torn /
crashed / bit-flipped checkpoint writes, corrupt-checkpoint resume, NaN
wave, retry-budget exhaustion, the loss of a mesh rank — asserting that
each recovery converges to a final film **bit-identical** to the
undisturbed render (chunks are pure functions of the work range and the
counter-based sampler is replay-exact, so recovery is EXACT, not
approximate). The one deliberate exception is `nan-wave-scrub`, which
validates the DEGRADE semantics instead: the firewall zeroes the
contaminated deposits, the final image stays fully finite, and
`nonfinite_deposits > 0` is reported in telemetry.

The matrix is also the health watchdog's truth table: the `serve-wedge`
and `serve-backoff-storm` rows inject serve drains the watchdog MUST
flag, and every other (clean) row asserts it stays silent — a
false-positive gate run after each pass.

The fleet rows extend the ladder across replicas: `fleet-replica-kill`
kills a serve replica mid-job and asserts the job resumes on the
survivor from the durable spool bit-identically, and
`fleet-router-restart` restarts the ROUTER, adopts the same replicas
from their `stats` verbs, and drains every job to the same bits.

The port's rows differ from the reference's in two places:

- `fused-tracer`: the port has no switch that puts the plain versions of
  the kernels on the card (a wrapper given CUDA tensors launches its
  kernel), so the row renders the killeroo-like scene through the
  device's own tracer ("fused" on CUDA: both hand-written kernels, whose
  launches it counts; "plain" on the CPU) through a mid-render dispatch
  failure, bit-identical to the same tracer's undisturbed render.
- `mesh-device-loss`: a mesh is two ranks (parallel/mesh.py launch: two
  processes, sharing one card over gloo when fewer cards are visible),
  and the row compares with the undisturbed render of the same mesh.

Every row runs on the card unless `--device cpu` asks for the CPU.

    python -m tpu_pbrt_torch.chaos                 # full matrix, on CUDA
    python -m tpu_pbrt_torch.chaos --device cpu    # full matrix, on the CPU
    python -m tpu_pbrt_torch.chaos --list          # scenario names
    python -m tpu_pbrt_torch.chaos --only torn-ckpt-fallback,nan-wave-scrub
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

# matrix workload: small enough to compile fast, big enough for 8 chunks
# (the recovery ladder needs chunk structure)
RES = int(os.environ.get("CHAOS_RES", "20"))
SPP = int(os.environ.get("CHAOS_SPP", "4"))
MAXDEPTH = 3
N_CHUNKS = 8
CHUNK = RES * RES * SPP // N_CHUNKS
#: ranks of the mesh-device-loss row
MESH_RANKS = 2

#: the device every row renders on (main's --device; CUDA by default)
DEVICE = "cuda"

#: the cached undisturbed render (film arrays + ray count), by device
_REFS = {}


def _setup_env(device=None):
    """Process setup for a matrix run: the device every row renders on,
    the matrix's chunking and a snappy deterministic retry backoff (the
    reference's XLA flags have no counterpart: the port compiles no
    programs)."""
    global DEVICE
    from tpu_pbrt_torch.config import resolve_device

    DEVICE = str(resolve_device(device))
    os.environ.setdefault("TORCH_PBRT_CHUNK", str(CHUNK))
    os.environ.setdefault("TORCH_PBRT_RETRY_BACKOFF", "0.01")


@contextlib.contextmanager
def _env(**overrides):
    """Set TORCH_PBRT_* knobs for one scenario and reload the config
    snapshot (the matrix is test tooling, not production code)."""
    from tpu_pbrt_torch.config import cfg

    old = {k: os.environ.get(k) for k in overrides}
    os.environ.update({k: str(v) for k, v in overrides.items()})
    cfg._load()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        cfg._load()


def _fresh(device=None):
    from tpu_pbrt_torch.scenes import compile_api, make_cornell

    api = make_cornell(res=RES, spp=SPP, integrator="path", maxdepth=MAXDEPTH,
                       device=device or DEVICE)
    return compile_api(api)


def _film(result):
    st = result.film_state
    return [t.detach().cpu().numpy() for t in (st.rgb, st.weight, st.splat)]


def _identical(a, b) -> bool:
    import numpy as np

    return all(np.array_equal(x, y) for x, y in zip(a, b))


def _overrides(env=None):
    out = {
        "TORCH_PBRT_CHUNK": CHUNK,
        "TORCH_PBRT_RETRY_BACKOFF": os.environ.get("TORCH_PBRT_RETRY_BACKOFF", "0.01"),
    }
    out.update(env or {})
    return out


def _run(plan=None, seed=0, ckpt=None, ckpt_every=1, env=None):
    """One render under a chaos plan. Returns (result_or_exception,
    CHAOS fired report). The registry is always cleared afterwards."""
    from tpu_pbrt_torch.chaos import CHAOS

    with _env(**_overrides(env)):
        if plan:
            CHAOS.install(plan, seed=seed)
        try:
            scene, integ = _fresh()
            kw = {}
            if ckpt:
                kw = dict(checkpoint_path=ckpt, checkpoint_every=ckpt_every)
            out = integ.render(scene, **kw)
        except Exception as e:  # noqa: BLE001 — scenario asserts on it
            out = e
        finally:
            rep = CHAOS.report()
            CHAOS.clear()
    return out, rep


def _mesh_rank(mesh, plan, ckpt):
    """One rank of the mesh row: the undisturbed mesh render, then the
    same render under `plan` with a checkpoint every chunk. Rank 0's
    films, rays and fired report come back; a raised render is returned
    as its message."""
    from tpu_pbrt_torch.chaos import CHAOS

    scene, integ = _fresh(mesh.device)
    clean = integ.render(scene, mesh=mesh)
    CHAOS.install(plan, seed=0)
    try:
        r = integ.render(scene, mesh=mesh, checkpoint_path=ckpt, checkpoint_every=1)
        got = (_film(r), r.rays_traced)
    except Exception as e:  # noqa: BLE001 — scenario asserts on it
        got = f"{type(e).__name__}: {e}"
    finally:
        rep = CHAOS.report()
        CHAOS.clear()
    return (_film(clean), clean.rays_traced), got, rep


def _reference():
    if DEVICE not in _REFS:
        r, _ = _run()
        if isinstance(r, Exception):
            raise r
        _REFS[DEVICE] = (_film(r), r.rays_traced)
    return _REFS[DEVICE]


def _check_recovered(r, rep, *, want_fired=None, ref=None) -> tuple:
    """Shared postcondition: every fault fired the expected number of
    times and the final film is bit-identical to the undisturbed one.
    `r` is a RenderResult, an exception, or (films, rays) of a mesh run."""
    if isinstance(r, Exception):
        return False, f"render raised {type(r).__name__}: {r}"
    if isinstance(r, str):
        return False, f"render raised {r}"
    fired = {e["fault"]: e["fired"] for e in rep}
    for spec, want in (want_fired or {}).items():
        got = next((v for k, v in fired.items() if k.startswith(spec)), None)
        if got != want:
            return False, f"fault {spec} fired {got}, wanted {want}"
    ref_film, ref_rays = ref or _reference()
    film, rays = r if isinstance(r, tuple) else (_film(r), r.rays_traced)
    if not _identical(film, ref_film):
        return False, "final film NOT bit-identical to undisturbed render"
    if rays != ref_rays:
        return False, f"rays_traced {rays} != {ref_rays}"
    return True, f"bit-identical; fired={fired}"


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------


def scen_clean_redispatch(tmp):
    """A chunk dispatch dies WITHOUT touching the film (worker loss
    before the dispatch ran): plain re-dispatch is exact."""
    r, rep = _run(plan="dispatch:fail@chunk=1")
    return _check_recovered(r, rep, want_fired={"dispatch:fail": 1})


def scen_poison_rollback(tmp):
    """A mid-dispatch loss poisons the film accumulator: roll back to
    the last durable checkpoint and replay."""
    r, rep = _run(plan="dispatch:poison@chunk=3", ckpt=os.path.join(tmp, "film.ckpt"))
    ok, detail = _check_recovered(r, rep, want_fired={"dispatch:poison": 1})
    if ok and r.stats.get("recovery", {}).get("rollbacks") != 1:
        return False, "expected exactly 1 checkpoint rollback"
    return ok, detail


def scen_poison_restart(tmp):
    """Poisoning failure with NO checkpoint configured: the only safe
    recovery is a from-scratch restart — still exact."""
    r, rep = _run(plan="dispatch:poison@chunk=2")
    ok, detail = _check_recovered(r, rep, want_fired={"dispatch:poison": 1})
    if ok and r.stats.get("recovery", {}).get("restarts") != 1:
        return False, "expected exactly 1 restart"
    return ok, detail


def scen_torn_ckpt_fallback(tmp):
    """Checkpoint write 3 publishes a TORN file; the poisoning failure
    that follows must fall back to the rotated .prev and still recover
    exactly."""
    r, rep = _run(plan="ckpt:torn@write=3,dispatch:poison@chunk=3",
                  ckpt=os.path.join(tmp, "film.ckpt"))
    return _check_recovered(r, rep, want_fired={"ckpt:torn": 1, "dispatch:poison": 1})


def scen_crash_ckpt_write(tmp):
    """Simulated crash between the tmp write and the rename: the write
    simply never happened; recovery uses the previous durable file."""
    r, rep = _run(plan="ckpt:crash@write=3,dispatch:poison@chunk=3",
                  ckpt=os.path.join(tmp, "film.ckpt"))
    return _check_recovered(r, rep, want_fired={"ckpt:crash": 1, "dispatch:poison": 1})


def scen_bitflip_ckpt_fallback(tmp):
    """A bit-flipped checkpoint fails the content checksum at load;
    rollback falls back to .prev."""
    r, rep = _run(plan="ckpt:bitflip@write=3,dispatch:poison@chunk=3",
                  ckpt=os.path.join(tmp, "film.ckpt"))
    return _check_recovered(r, rep, want_fired={"ckpt:bitflip": 1, "dispatch:poison": 1})


def scen_nan_wave_retry(tmp):
    """A NaN wave under TORCH_PBRT_NONFINITE=retry: the firewall detects
    the scrubbed deposits at the chunk boundary, the chunk is treated as
    poisoned and re-rendered clean — recovery is EXACT."""
    r, rep = _run(plan="nan:wave@1&chunk=1", ckpt=os.path.join(tmp, "film.ckpt"),
                  env={"TORCH_PBRT_NONFINITE": "retry"})
    ok, detail = _check_recovered(r, rep, want_fired={"nan:wave": 1})
    if ok and r.stats.get("recovery", {}).get("nonfinite_retries") != 1:
        return False, "expected exactly 1 firewall retry"
    return ok, detail


def scen_nan_wave_scrub(tmp):
    """A NaN wave under the DEFAULT scrub mode: degrade, don't die — the
    final image is fully finite and the contamination is counted in
    nonfinite_deposits (the acceptance telemetry signal). Deliberately
    NOT bit-identical: the scrubbed samples deposited zero."""
    import numpy as np

    r, rep = _run(plan="nan:wave@1&chunk=1")
    if isinstance(r, Exception):
        return False, f"render raised {type(r).__name__}: {r}"
    fired = sum(e["fired"] for e in rep)
    if fired != 1:
        return False, f"nan fault fired {fired} times, wanted 1"
    img = np.asarray(r.image)
    if not np.isfinite(img).all():
        return False, "final image carries non-finite pixels"
    nf = r.stats.get("telemetry", {}).get("counters", {}).get("nonfinite_deposits", 0)
    if not nf > 0:
        return False, f"nonfinite_deposits = {nf}, wanted > 0"
    return True, f"image finite; nonfinite_deposits={nf}"


def _run_exhaustion(tmp):
    """Shared phase 1 for the exhaustion scenarios: chunk 5 fails every
    attempt, the retry budget (2) exhausts, and the loop writes an
    emergency checkpoint before raising."""
    ck = os.path.join(tmp, "film.ckpt")
    r, rep = _run(plan="dispatch:fail@chunk=5&times=99", ckpt=ck,
                  env={"TORCH_PBRT_RETRY_MAX": "2"})
    if not isinstance(r, RuntimeError):
        return ck, f"expected RuntimeError, got {type(r).__name__}"
    from tpu_pbrt_torch.parallel.checkpoint import load_checkpoint

    _, cursor, _, _ = load_checkpoint(ck)
    if cursor != 5:
        return ck, f"emergency checkpoint cursor {cursor}, wanted 5"
    return ck, None


def scen_exhaustion_emergency_resume(tmp):
    """Retry-budget exhaustion: the render dies loudly, but the
    emergency checkpoint preserves every completed chunk — a later
    resume finishes the job bit-identically."""
    ck, err = _run_exhaustion(tmp)
    if err:
        return False, err
    r2, rep2 = _run(ckpt=ck)  # no plan: the infra 'recovered'
    return _check_recovered(r2, rep2)


def scen_corrupt_resume(tmp):
    """Corrupt-checkpoint resume: the current checkpoint file is
    bit-flipped ON DISK after the crash; the resume must fall back to
    .prev and re-render the missing chunks exactly."""
    ck, err = _run_exhaustion(tmp)
    if err:
        return False, err
    size = os.path.getsize(ck)
    with open(ck, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))
    r2, rep2 = _run(ckpt=ck)
    return _check_recovered(r2, rep2)


def scen_mesh_device_loss(tmp):
    """The loss of a mesh rank in the chunk drain (simulated: the chunk
    fails as state-poisoning on every rank, which agree on it before the
    film all-reduce — parallel/mesh.py's failure model): rollback +
    re-dispatch over two ranks recovers bit-identically to the
    undisturbed MESH render."""
    import importlib

    import torch

    from tpu_pbrt_torch.parallel.mesh import launch

    # spawned ranks unpickle the rank function by its module's import path
    this = importlib.import_module("tpu_pbrt_torch.chaos.__main__")
    dev = torch.device(DEVICE)
    share = dev.type == "cuda" and torch.cuda.device_count() < MESH_RANKS
    with _env(**_overrides()):
        ref, got, rep = launch(this._mesh_rank, MESH_RANKS,
                               args=("mesh:lost@chunk=1", os.path.join(tmp, "film.ckpt")),
                               device=dev.type, share_device=share, threads=1)[0]
    return _check_recovered(got, rep, want_fired={"mesh:lost": 1}, ref=ref)


def scen_fused_tracer(tmp):
    """The device's own tracer through a mid-render dispatch failure:
    the killeroo-like scene (the matrix's cornell box takes the brute
    feature product and never touches the stream tracer) rendered
    through the recovery ladder must be bit-identical to the same
    tracer's undisturbed render. On CUDA the tracer is "fused" (both
    hand-written kernels, whose launches the row counts), on the CPU
    "plain"; the port has no switch that puts a plain version on the
    card."""
    from tpu_pbrt_torch.chaos import CHAOS
    from tpu_pbrt_torch.kernels import LAUNCHES, reset_launches

    want = "fused" if DEVICE.startswith("cuda") else "plain"

    def render(plan=None):
        with _env(**_overrides()):
            if plan:
                CHAOS.install(plan, seed=0)
            try:
                from tpu_pbrt_torch.scenes import compile_api, make_killeroo_like

                api = make_killeroo_like(res=16, spp=2, integrator="path", maxdepth=3,
                                         n_theta=24, n_phi=48, device=DEVICE)
                scene, integ = compile_api(api)
                out = integ.render(scene)
            finally:
                rep = CHAOS.report()
                CHAOS.clear()
        return out, rep

    ref, _ = render()
    reset_launches()
    r, rep = render(plan="dispatch:fail@chunk=1")
    launches = dict(LAUNCHES)
    fired = {e["fault"]: e["fired"] for e in rep}
    if sum(fired.values()) != 1:
        return False, f"dispatch fault fired {fired}, wanted 1"
    if r.stats.get("tracer_mode") != want:
        return False, f"tracer_mode={r.stats.get('tracer_mode')!r}, wanted {want!r}"
    if want == "fused" and not all(launches.values()):
        return False, f"a kernel was never launched: {launches}"
    if not _identical(_film(r), _film(ref)):
        return False, f"{want} film NOT bit-identical to its undisturbed render"
    if r.rays_traced != ref.rays_traced:
        return False, f"rays {r.rays_traced} != {ref.rays_traced}"
    return True, f"{want} recovered bit-identical; fired={fired}; launches={launches}"


def scen_pipeline(tmp):
    """The in-flight dispatch window: a poisoning dispatch loss with
    TORCH_PBRT_PIPELINE=3 slices in flight — the window is flushed, the
    loop rolls back to the last durable checkpoint (whose cadence writes
    were DEFERRED under in-flight compute via the film snapshot) and the
    recovered film is bit-identical to the undisturbed render. Pins two
    contracts at once: depth-N == depth-1 bits, and the recovery ladder
    carrying over unchanged with a non-empty window."""
    r, rep = _run(plan="dispatch:poison@chunk=3", ckpt=os.path.join(tmp, "film.ckpt"),
                  env={"TORCH_PBRT_PIPELINE": "3"})
    ok, detail = _check_recovered(r, rep, want_fired={"dispatch:poison": 1})
    if ok and r.stats.get("recovery", {}).get("rollbacks") != 1:
        return False, "expected exactly 1 checkpoint rollback"
    return ok, detail


def _serve_retry_storm(steps, env):
    """Shared rig for the watchdog rows: a serve job whose chunk-0
    dispatch fails EVERY attempt (times=99) with zero retry backoff and
    an unreachable retry budget — `steps` scheduler steps of pure
    no-progress retrying, then the health verdict. Returns (service,
    HealthReport) evaluated INSIDE the env overrides."""
    from tpu_pbrt_torch.chaos import CHAOS
    from tpu_pbrt_torch.obs.health import evaluate
    from tpu_pbrt_torch.obs.metrics import METRICS

    overrides = {"TORCH_PBRT_CHUNK": CHUNK, "TORCH_PBRT_RETRY_BACKOFF": "0",
                 "TORCH_PBRT_RETRY_MAX": "999"}
    overrides.update(env or {})
    with _env(**overrides):
        from tpu_pbrt_torch.serve.service import RenderService

        METRICS.reset()
        scene, integ = _fresh()
        service = RenderService(quiet=True, device=DEVICE)
        service.submit(compiled=(scene, integ), tenant="chaos")
        CHAOS.install("dispatch:fail@chunk=0&times=99", seed=0)
        try:
            for _ in range(steps):
                service.step()
            rep = evaluate(service)
        finally:
            CHAOS.clear()
            METRICS.reset()
    return service, rep


def scen_serve_wedge(tmp):
    """Health-watchdog row: a serve drain that retries the same chunk
    forever — runnable work, K+ step() calls, no cursor advance — MUST
    flag `wedge` (the failure mode that otherwise only surfaces as a
    client timeout)."""
    from tpu_pbrt_torch.obs.health import Thresholds

    k = Thresholds().resolved_wedge_steps()
    service, rep = _serve_retry_storm(steps=k + 2, env=None)
    if service.last_progress_step != 0:
        return False, "rig broke: the wedged job made progress"
    if "wedge" not in rep.firing():
        return False, f"wedge NOT flagged after {k + 2} stuck steps: {rep.to_dict()}"
    return True, f"flagged {rep.firing()} after {k + 2} stuck steps"


def scen_serve_backoff_storm(tmp):
    """Health-watchdog row: the SAME retry streak caught EARLY — enough
    steps for the job's live attempt counter to cross the storm
    threshold, but well inside the wedge window. `backoff_storm` must
    flag; `wedge` must NOT (the two conditions separate a hot retry
    loop from a dead drain)."""
    from tpu_pbrt_torch.obs.health import Thresholds

    th = Thresholds()
    steps = th.storm_attempts + 1
    if steps >= th.resolved_wedge_steps():
        return False, "rig broke: storm window not inside wedge window"
    service, rep = _serve_retry_storm(steps=steps, env=None)
    job = next(iter(service.jobs.values()))
    if job.attempt < th.storm_attempts:
        return False, f"rig broke: attempt {job.attempt} under threshold"
    if "backoff_storm" not in rep.firing():
        return False, f"backoff_storm NOT flagged: {rep.to_dict()}"
    if "wedge" in rep.firing():
        return False, (f"wedge flagged {steps} steps in (threshold "
                       f"{th.resolved_wedge_steps()}): {rep.to_dict()}")
    return True, f"flagged {rep.firing()} at attempt {job.attempt}"


def _fleet_rig(tmp):
    """Shared rig for the fleet rows: two real in-process replicas under
    one VirtualClock behind a FleetRouter, matrix chunking on both sides
    so the failover resume replays the exact chunk boundaries the
    undisturbed reference used."""
    from tpu_pbrt_torch.fleet.router import FleetRouter, LocalReplica
    from tpu_pbrt_torch.utils.clock import VirtualClock

    clock = VirtualClock(start=0.0, tick=1e-6)
    fleet = [LocalReplica(rid, clock=clock, chunk=CHUNK, device=DEVICE,
                          spool_dir=os.path.join(tmp, rid))
             for rid in ("r0", "r1")]
    router = FleetRouter(fleet, clock=clock, spool_dir=os.path.join(tmp, "fleet"))
    return clock, fleet, router


def scen_fleet_replica_kill(tmp):
    """Fleet failover row: a replica is KILLED mid-job past a durable
    checkpoint; the router fails the job over to the survivor, which
    resumes from the spool — the final film must be bit-identical to the
    undisturbed render (chunks are idempotent, the cursor is durable,
    and film accumulation from the cursor is sequential)."""
    from tpu_pbrt_torch.obs.metrics import METRICS
    from tpu_pbrt_torch.serve.service import DONE

    with _env(TORCH_PBRT_CHUNK=CHUNK, TORCH_PBRT_RETRY_BACKOFF="0.01"):
        METRICS.reset()
        _, _, router = _fleet_rig(tmp)
        try:
            scene, integ = _fresh()
            job = router.submit(compiled=(scene, integ), resident_key="chaos:cornell",
                                checkpoint_every=1, tenant="chaos")
            victim = router.owner(job)
            survivor = "r1" if victim == "r0" else "r0"
            for _ in range(4 * N_CHUNKS):
                if router.poll(job)["chunks_done"] >= 2:
                    break
                if router.step() is None:
                    return False, "no progress before the kill"
            else:
                return False, "never reached chunk 2 before the kill"
            at_kill = router.poll(job)["chunks_done"]
            moved = router.kill_replica(victim)
            if moved != [job]:
                return False, f"failover moved {moved}, wanted [{job!r}]"
            if router.owner(job) != survivor:
                return False, f"{job} on {router.owner(job)}, wanted {survivor}"
            router.drain_fleet()
            p = router.poll(job)
            if p["status"] != DONE:
                return False, f"job ended {p['status']!r} after failover"
            r = router.result(job)
        finally:
            METRICS.reset()
    ref_film, _ = _reference()
    if not _identical(_film(r), ref_film):
        return False, "failover film NOT bit-identical to undisturbed render"
    return True, (f"bit-identical after kill({victim})->resume({survivor}) "
                  f"at chunk {at_kill} ({p['failovers']} failover)")


def scen_fleet_router_restart(tmp):
    """Fleet restart row: the ROUTER dies between decisions and a fresh
    one adopts the same replicas, rebuilding its routing table from each
    replica's `stats` verb — no job is lost, the drain completes every
    adopted job, and the films stay bit-identical."""
    from tpu_pbrt_torch.fleet.router import FleetRouter
    from tpu_pbrt_torch.obs.metrics import METRICS
    from tpu_pbrt_torch.serve.service import DONE

    with _env(TORCH_PBRT_CHUNK=CHUNK, TORCH_PBRT_RETRY_BACKOFF="0.01"):
        METRICS.reset()
        clock, fleet, router = _fleet_rig(tmp)
        try:
            scene, integ = _fresh()
            jobs = [router.submit(compiled=(scene, integ), resident_key=f"chaos:cornell{i}",
                                  checkpoint_every=1, tenant="chaos")
                    for i in range(2)]
            for _ in range(3):  # some mid-flight progress, then "crash"
                router.step()
            router2 = FleetRouter.adopt(fleet, clock=clock, spool_dir=os.path.join(tmp, "fleet"))
            lost = [j for j in jobs if j not in router2.jobs]
            if lost:
                return False, f"adopt lost job(s): {lost}"
            for j in jobs:
                if router2.owner(j) != router.owner(j):
                    return False, f"adopt re-homed {j}: {router.owner(j)} -> {router2.owner(j)}"
            router2.drain_fleet()
            polls = {j: router2.poll(j) for j in jobs}
            bad = {j: p["status"] for j, p in polls.items() if p["status"] != DONE}
            if bad:
                return False, f"adopted job(s) did not finish: {bad}"
            films = [_film(router2.result(j)) for j in jobs]
        finally:
            METRICS.reset()
    ref_film, _ = _reference()
    for j, film in zip(jobs, films):
        if not _identical(film, ref_film):
            return False, f"{j}: film NOT bit-identical after restart"
    return True, f"{len(jobs)} job(s) adopted across a router restart, all bit-identical"


SCENARIOS = {
    "fused-tracer": scen_fused_tracer,
    "pipeline": scen_pipeline,
    "clean-redispatch": scen_clean_redispatch,
    "poison-rollback": scen_poison_rollback,
    "poison-restart": scen_poison_restart,
    "torn-ckpt-fallback": scen_torn_ckpt_fallback,
    "crash-ckpt-write": scen_crash_ckpt_write,
    "bitflip-ckpt-fallback": scen_bitflip_ckpt_fallback,
    "nan-wave-retry": scen_nan_wave_retry,
    "nan-wave-scrub": scen_nan_wave_scrub,
    "exhaustion-emergency-resume": scen_exhaustion_emergency_resume,
    "corrupt-resume": scen_corrupt_resume,
    "mesh-device-loss": scen_mesh_device_loss,
    "serve-wedge": scen_serve_wedge,
    "serve-backoff-storm": scen_serve_backoff_storm,
    "fleet-replica-kill": scen_fleet_replica_kill,
    "fleet-router-restart": scen_fleet_router_restart,
}

#: rows whose whole POINT is to trip the watchdog — every other row
#: must leave the registry-derived health conditions clean (the
#: watchdog's false-positive gate over the recovery matrix)
_WATCHDOG_ROWS = {"serve-wedge", "serve-backoff-storm"}


def run_row(name: str, tmp: str) -> tuple:
    """One row with the false-positive gate after it: (ok, detail)."""
    try:
        ok, detail = SCENARIOS[name](tmp)
    except Exception as e:  # noqa: BLE001 — a broken scenario is a FAIL
        ok, detail = False, f"{type(e).__name__}: {e}"
    if ok and name not in _WATCHDOG_ROWS:
        # false-positive gate: a CLEAN recovery row must not trip the
        # registry-derived health conditions
        from tpu_pbrt_torch.obs.health import evaluate

        hrep = evaluate(None)
        if not hrep.ok:
            ok, detail = False, f"health watchdog fired on a clean row: {hrep.firing()}"
    return ok, detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpu_pbrt_torch.chaos")
    ap.add_argument("--list", action="store_true", help="list scenarios")
    ap.add_argument("--only", default="", help="comma-separated subset of scenario names to run")
    ap.add_argument("--device", default=None,
                    help="torch device every row renders on: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.list:
        for name, fn in SCENARIOS.items():
            print(f"{name}: {' '.join((fn.__doc__ or '').split())}")
        return 0

    only = {s for s in args.only.split(",") if s}
    unknown = only - set(SCENARIOS)
    if unknown:
        ap.error(f"unknown scenario(s): {sorted(unknown)}")
    try:
        _setup_env(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"tpu-pbrt-torch: {e} (on the command line: --device cpu)", file=sys.stderr)
        return 1
    import tempfile

    failed = []
    ran = 0
    t_all = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        for name in SCENARIOS:
            if only and name not in only:
                continue
            ran += 1
            sdir = os.path.join(tmp, name)
            os.makedirs(sdir, exist_ok=True)
            t0 = time.time()
            ok, detail = run_row(name, sdir)
            print(f"chaos {name}: {'PASS' if ok else 'FAIL'} ({detail}) [{time.time() - t0:.1f}s]",
                  flush=True)
            if not ok:
                failed.append(name)
    print(json.dumps({"chaos_matrix": {
        "scenarios": ran, "passed": ran - len(failed), "failed": failed,
        "seconds": round(time.time() - t_all, 1), "device": DEVICE}}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
