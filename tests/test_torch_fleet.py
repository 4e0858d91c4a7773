"""The port's fleet router (tpu_pbrt_torch/fleet/) on the CPU, held to
the reference's tests/test_fleet.py behaviours.

- The consistent-hash ring is a pure function of the replica ids and
  routes every key to the replica the reference's ring picks; losing a
  replica moves only its own keys; the sizing formula is the
  reference's.
- The fleet script of tests/torch_golden/make_serve_reference.py
  (same-scene affinity, a double delivery, the edge shed of a clamped
  knee, a kill failover through the spool, a drain failover, a router
  restart) makes the reference's routing and failover decisions
  (serve_reference.json), and every film, the failed-over ones
  included, is bit-identical to the port's undisturbed solo render.
- A DaemonReplica round-trips a job through a child
  `python -m tpu_pbrt_torch.serve --device cpu`.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from tpu_pbrt.fleet import router as jr
from tpu_pbrt_torch.fleet.router import KNEE_REQ_S, FleetRouter, LocalReplica, fleet_size
from tpu_pbrt_torch.scene.api import Options, compile_string
from tpu_pbrt_torch.utils.clock import VirtualClock

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "torch_golden"))
import make_serve_reference as gen  # noqa: E402

with open(os.path.join(HERE, "torch_golden", "serve_reference.json")) as f:
    GOLDEN = json.load(f)["fleet"]


def _router(tmp_path, n=3, mod=None):
    """A router over n replicas whose services never render (ring tests)."""
    clock = VirtualClock(start=0.0, tick=1e-6)
    if mod is None:
        reps = [LocalReplica(f"r{k}", clock=clock, spool_dir=str(tmp_path / f"r{k}"),
                             device="cpu") for k in range(n)]
        return FleetRouter(reps, clock=clock, spool_dir=str(tmp_path / "fleet"))
    reps = [mod.LocalReplica(f"r{k}", clock=clock, spool_dir=str(tmp_path / f"j{k}"))
            for k in range(n)]
    return mod.FleetRouter(reps, clock=clock, spool_dir=str(tmp_path / "jfleet"))


@pytest.fixture(scope="module")
def scripted(tmp_path_factory):
    return gen.run_fleet("tpu_pbrt_torch", str(tmp_path_factory.mktemp("fleet")), device="cpu")


def test_ring_matches_the_reference(tmp_path):
    ours, theirs = _router(tmp_path), _router(tmp_path, mod=jr)
    keys = [f"scene{i}" for i in range(64)]
    routes = [ours.route_key(k) for k in keys]
    assert routes == [theirs.route_key(k) for k in keys]
    assert routes == [_router(tmp_path / "again").route_key(k) for k in keys]
    assert len(set(routes)) == 3


def test_replica_loss_moves_only_its_own_keys(tmp_path):
    router, theirs = _router(tmp_path), _router(tmp_path, mod=jr)
    keys = [f"scene{i}" for i in range(64)]
    before = {k: router.route_key(k) for k in keys}
    router.replicas["r1"].draining = True
    theirs.replicas["r1"].draining = True
    for k in keys:
        after = router.route_key(k)
        assert after == theirs.route_key(k)
        assert after != "r1" if before[k] == "r1" else after == before[k]


@pytest.mark.parametrize("offered", [0.0, KNEE_REQ_S, KNEE_REQ_S + 0.1, 10 * KNEE_REQ_S, 1e4])
def test_fleet_size_matches_the_reference(offered):
    assert fleet_size(offered) == jr.fleet_size(offered)
    assert fleet_size(offered, 2.5) == jr.fleet_size(offered, 2.5)


@pytest.mark.parametrize("key", ["affinity", "edge", "kill", "drain", "adopt", "routes", "polls",
                                 "stats"])
def test_fleet_decisions_match_the_reference(scripted, key):
    assert json.loads(json.dumps(scripted[0][key])) == GOLDEN[key]


def test_failed_over_films_bit_identical_to_undisturbed(scripted):
    texts = {res: gen.scene_text("tpu_pbrt_torch", res) for res in (gen.RES, gen.RES // 2)}
    solo = {}
    for res, text in texts.items():
        scene, integ = compile_string(text, Options(quiet=True), device="cpu")
        solo[res] = np.asarray(integ.render(scene).image, np.float32)
    images = scripted[1]
    assert sorted(images) == ["a1", "a2", "d1", "k1", "r1"]
    for name, img in images.items():
        ref = solo[gen.RES // 2 if name in ("d1", "r1") else gen.RES]
        assert np.array_equal(np.asarray(img, np.float32), ref), f"{name} differs"
    assert scripted[0]["polls"]["k1"]["failovers"] == 1
    assert scripted[0]["polls"]["d1"]["failovers"] == 1


def test_adopted_jobs_cannot_fail_over(tmp_path):
    clock = VirtualClock(start=0.0, tick=1e-6)
    reps = [LocalReplica(f"r{k}", clock=clock, chunk=gen.CHUNK, device="cpu",
                         spool_dir=str(tmp_path / f"r{k}")) for k in range(2)]
    router = FleetRouter(reps, clock=clock, spool_dir=str(tmp_path / "fleet"))
    router.submit(text=gen.scene_text("tpu_pbrt_torch", 8), job_id="jr", checkpoint_every=1)
    router.step()
    adopted = FleetRouter.adopt(reps, clock=clock, spool_dir=str(tmp_path / "fleet"))
    with pytest.raises(RuntimeError, match="submit source"):
        adopted._failover_job("jr", adopted.owner("jr"))
    adopted.drain_fleet()
    assert adopted.poll("jr")["status"] == "done"


def test_daemon_replica_roundtrip(tmp_path):
    from tpu_pbrt_torch.fleet.daemon import DaemonReplica

    text = gen.scene_text("tpu_pbrt_torch", 8)
    rep = DaemonReplica("d0", spool_dir=str(tmp_path / "d0"), chunk=gen.CHUNK, device="cpu")
    try:
        job = rep.submit(text=text, job_id="dj", trace_id="t:dj")
        deadline = time.monotonic() + 240
        while rep.status(job) not in ("done", "failed", None):
            assert time.monotonic() < deadline, "daemon job timed out"
            time.sleep(0.1)
        assert rep.status(job) == "done"
        res = rep.result(job)
        scene, integ = compile_string(text, Options(quiet=True), device="cpu")
        solo = integ.render(scene)
        assert res["rays"] == solo.rays_traced
        assert res["mean"] == float(solo.image.mean())
        assert rep.health()["ok"]
        ans = rep.drain()
        assert ans["ok"] and ans["draining"] and ans["quiescent"]
        assert rep.shutdown() == 0
    finally:
        if rep.proc.poll() is None:
            rep.proc.kill()
