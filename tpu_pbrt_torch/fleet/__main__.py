"""`python -m tpu_pbrt_torch.fleet` — the fleet-router frontend.

`--selftest` is the smoke: two REAL in-process replicas
under one VirtualClock behind a FleetRouter, exercising the whole
handoff protocol on a real (small) cornell scene:

- scene-affinity: a resubmit of the same scene routes to the same
  replica and pays zero scene compiles (residency warm hit);
- fleet-edge shedding: with the capacity knee clamped down, an
  over-offered burst is refused at the edge before any compile;
- kill-one failover: a replica is killed mid-job past a durable
  checkpoint; the job resumes on the survivor from the spool and the
  final film is BIT-identical to the undisturbed solo render;
- cross-replica trace: when tracing is armed (TORCH_PBRT_TRACE_PATH),
  the exported timeline carries ONE root span per job across the
  re-route.

`--daemon-smoke` additionally round-trips one job through a real
child JSONL daemon (DaemonReplica): submit with a router trace id,
drain verb, graceful shutdown. Slower (a process spawn and a scene
compile in the child); not part of the default smoke.

The replicas run on CUDA unless `--device cpu` asks for the CPU.

Exit 0 = pass.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpu_pbrt_torch.fleet",
        description="tpu-pbrt-torch fleet router over N serve replicas",
    )
    p.add_argument(
        "--selftest", action="store_true",
        help="run the fleet smoke (2 in-process replicas, affinity + "
        "edge shed + kill-one failover bit-identity) and exit",
    )
    p.add_argument(
        "--daemon-smoke", action="store_true",
        help="also round-trip one job through a child JSONL daemon "
        "(slow: a process spawn)",
    )
    p.add_argument("--device", default=None,
                   help="torch device of the replicas: cuda (the default) or cpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--chunk", type=int, default=256,
        help="slice width in camera rays (preemption quantum)",
    )
    return p


def selftest(args) -> int:
    import numpy as np

    from tpu_pbrt_torch.fleet import FleetPolicy, FleetRouter, LocalReplica
    from tpu_pbrt_torch.obs.flight import FLIGHT
    from tpu_pbrt_torch.obs.trace import TRACE
    from tpu_pbrt_torch.scene.api import Options, compile_string
    from tpu_pbrt_torch.scenes import cornell_box_text
    from tpu_pbrt_torch.serve.service import DONE, ShedError
    from tpu_pbrt_torch.utils.clock import VirtualClock

    def say(msg):
        print(f"fleet-selftest: {msg}", file=sys.stderr)

    fails = []
    text = cornell_box_text(res=32, spp=1, integrator="path", maxdepth=3)

    say("rendering solo reference")
    scene, integ = compile_string(text, Options(quiet=True), device=args.device)
    ref = np.asarray(integ.render(scene).image, np.float32)

    clock = VirtualClock(start=0.0, tick=1e-6)
    tmp = tempfile.mkdtemp(prefix="tpu_pbrt_torch_fleet_selftest_")
    # the recorders share the virtual timeline (restored at exit), so
    # the exported trace is internally consistent for scope --check
    flight_prev = (FLIGHT._clock, FLIGHT._t0)
    FLIGHT.set_clock(clock)
    trace_prev = (TRACE._clock, TRACE._t0)
    TRACE.set_clock(clock)
    try:
        replicas = [
            LocalReplica(
                rid, clock=clock, seed=args.seed, chunk=args.chunk,
                spool_dir=os.path.join(tmp, rid), device=args.device,
            )
            for rid in ("r0", "r1")
        ]
        router = FleetRouter(
            replicas, clock=clock, spool_dir=os.path.join(tmp, "fleet"),
        )

        # -- scene affinity + residency warm hit ---------------------------
        j1 = router.submit(text=text, checkpoint_every=1, tenant="alice")
        rid1 = router.owner(j1)
        say(f"submitted {j1} -> {rid1}")
        router.drain_fleet()
        if router.poll(j1)["status"] != DONE:
            fails.append(f"{j1} did not finish: {router.poll(j1)}")
        j2 = router.submit(text=text, tenant="bob")
        rid2 = router.owner(j2)
        if rid2 != rid1:
            fails.append(
                f"affinity broken: same scene routed {rid1} then {rid2}"
            )
        router.drain_fleet()
        warm = router.replicas[rid1].service.residency.stats()
        if warm["scene_compiles"] != 1 or warm["hits"] < 1:
            fails.append(
                f"warm resubmit was not a residency hit on {rid1}: {warm}"
            )
        for j in (j1, j2):
            img = np.asarray(
                router.result(j).image, np.float32
            )
            if not np.array_equal(img, ref):
                fails.append(f"{j}: routed film differs from solo render")

        # -- fleet-edge shedding (knee clamped to force it) ----------------
        tight = FleetRouter(
            replicas, clock=clock,
            policy=FleetPolicy(knee_req_s=0.5, rate_window_s=2.0),
            spool_dir=os.path.join(tmp, "edge"),
        )
        admitted, shed = 0, 0
        for i in range(4):
            try:
                tight.submit(text=text, tenant="burst",
                             job_id=f"edge{i}")
                admitted += 1
            except ShedError as e:
                shed += 1
                if "fleet-edge" not in e.reason:
                    fails.append(f"edge shed carries wrong reason: {e.reason}")
        # knee 0.5 x 2 replicas x 2 s window = 2 admitted, then refusal
        if admitted != 2 or shed != 2 or tight.edge_sheds != 2:
            fails.append(
                f"edge shedding not deterministic: {admitted} admitted, "
                f"{shed} shed (counted {tight.edge_sheds})"
            )
        say(f"edge shed {shed}/4 over-knee submits")
        tight.drain_fleet()

        # -- kill-one failover: bit-identity from the spool ----------------
        jk = router.submit(text=text, checkpoint_every=1, tenant="alice")
        victim = router.owner(jk)
        survivor = "r1" if victim == "r0" else "r0"
        stepped = 0
        while router.poll(jk)["chunks_done"] < 2:
            if router.step() is None or stepped > 200:
                fails.append(f"{jk} made no progress pre-kill")
                break
            stepped += 1
        say(
            f"killing {victim} with {jk} at chunk "
            f"{router.poll(jk)['chunks_done']}"
        )
        moved = router.kill_replica(victim)
        if moved != [jk]:
            fails.append(f"failover moved {moved}, expected [{jk!r}]")
        if router.owner(jk) != survivor:
            fails.append(
                f"{jk} failed over to {router.owner(jk)}, "
                f"expected {survivor}"
            )
        router.drain_fleet()
        pk = router.poll(jk)
        if pk["status"] != DONE:
            fails.append(f"{jk} did not finish after failover: {pk}")
        else:
            img = np.asarray(router.result(jk).image, np.float32)
            if not np.array_equal(img, ref):
                fails.append(
                    "failover film differs bitwise from the undisturbed "
                    "solo render"
                )
            if pk["failovers"] != 1:
                fails.append(f"{jk} records {pk['failovers']} failovers")
        say(f"failover film bit-identical: {pk['status']}")

        if args.daemon_smoke:
            fails += _daemon_smoke(say, text, tmp, args.device)

        traced = TRACE.maybe_export()
        if traced:
            say(f"trace exported to {traced}")
    finally:
        FLIGHT._clock, FLIGHT._t0 = flight_prev
        TRACE._clock, TRACE._t0 = trace_prev

    line = {
        "selftest": "tpu_pbrt_torch.fleet",
        "ok": not fails,
        "jobs": len(router.jobs),
        "routes": len(router.routes),
        "edge_sheds": tight.edge_sheds,
        "failovers": sum(r.failovers for r in router.jobs.values()),
        "clock_samples": clock.samples,
    }
    if fails:
        line["failures"] = fails
        for f in fails:
            say(f"FAIL: {f}")
    print(json.dumps(line))
    return 0 if not fails else 1


def _daemon_smoke(say, text, tmp, device=None) -> list:
    """One job through a real child JSONL daemon: submit with a router
    trace id, poll to done, drain verb, graceful shutdown."""
    from tpu_pbrt_torch.fleet.daemon import DaemonReplica

    fails = []
    say("daemon smoke: spawning child serve daemon")
    rep = DaemonReplica(
        "d0", spool_dir=os.path.join(tmp, "d0"), chunk=256, device=device,
    )
    try:
        job = rep.submit(text=text, job_id="dj1", trace_id="t:dj1")
        deadline = 240
        import time

        t0 = time.monotonic()
        while rep.status(job) not in ("done", "failed", None):
            if time.monotonic() - t0 > deadline:
                fails.append("daemon job did not finish in time")
                break
            time.sleep(0.2)
        if rep.status(job) != "done":
            fails.append(f"daemon job ended {rep.status(job)!r}")
        ans = rep.drain()
        if not (ans.get("ok") and ans.get("draining")
                and ans.get("quiescent")):
            fails.append(f"daemon drain answered {ans}")
        code = rep.shutdown()
        if code != 0:
            fails.append(f"daemon exited {code}")
    finally:
        if rep.proc.poll() is None:
            rep.proc.kill()
    return fails


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if args.selftest or args.daemon_smoke:
        from tpu_pbrt_torch.config import resolve_device

        try:
            resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            print(f"tpu-pbrt-torch: {e} (on the command line: --device cpu)", file=sys.stderr)
            return 1
        return selftest(args)
    build_arg_parser().print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
