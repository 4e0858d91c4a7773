"""Serving over a mesh of ranks on the CPU (two gloo ranks, each a
spawned process): the port of tests/test_serve.py's acceptance case
over a mesh, held bit for bit to the port's own mesh solo render.

- Two concurrent jobs with a preempt and resume (rank 0 decides, rank 1
  follows its decision records): both films bit-identical to the mesh
  solo render at the same chunk, `preemptions == 1`.
- The mesh solo render within the reference's multi-device tolerances of
  the port's one-device render (rtol 1e-4, atol 1e-5), rays equal (a
  mesh film equals the one-device film only up to the order of its
  additions).
- A failure on rank 1 alone (the chaos seam firing only there, as a
  poisoning loss) and `mesh:lost@chunk=1` on every rank, during served
  slices with a checkpoint every slice: the ranks agree on the slice's
  outcome, rank 0 rolls the job back, and the films end bit-identical.
- A `LocalReplica(mesh=...)` killed past a durable checkpoint: its job
  fails over to the other mesh replica, which resumes from the spool,
  bit-identical.
- The JSONL daemon `python -m tpu_pbrt_torch.serve --mesh 2 --device
  cpu`: submit, poll, result, metrics, health, shutdown; its result
  image equals the mesh solo render.
- Rank 0's decisions (schedule, polls, FLIGHT phases) equal the
  reference's for the same script
  (tests/torch_golden/make_serve_mesh_reference.py): the reference's
  served-mesh run does not complete under the installed JAX (the file
  records its error), so the port is held to the reference's one-device
  run of the script, whose decisions do not depend on the mesh.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_pbrt_torch.parallel.mesh import launch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(HERE, "torch_golden"))
import make_serve_mesh_reference as gen  # noqa: E402

CHUNK = gen.CHUNK
TEXT = gen.base.scene_text("tpu_pbrt_torch")
with open(os.path.join(HERE, "torch_golden", "serve_mesh_reference.json")) as f:
    GOLDEN = json.load(f)


def _film(result):
    st = result.film_state
    return [t.numpy().copy() for t in (st.rgb, st.weight, st.splat)]


def _served(mesh, tmp, plan, rank1_only=False):
    """One job served over the mesh with a checkpoint every slice, under
    a chaos plan installed on every rank (or on rank 1 alone)."""
    from tpu_pbrt_torch.chaos import CHAOS
    from tpu_pbrt_torch.serve import RenderService
    from tpu_pbrt_torch.utils.clock import VirtualClock

    os.makedirs(tmp, exist_ok=True)
    if plan and (mesh.rank == 1 or not rank1_only):
        CHAOS.install(plan)
    try:
        svc = RenderService(mesh=mesh, chunk=CHUNK, spool_dir=tmp,
                            clock=VirtualClock(start=0.0, tick=1e-6))

        def lead(svc):
            j = svc.submit(text=TEXT, checkpoint_every=1)
            svc.drain()
            r = svc.result(j)
            return _film(r), r.rays_traced, r.stats.get("recovery")

        return svc.lead_or_follow(lead)
    finally:
        CHAOS.clear()


def _failover(mesh, tmp):
    from tpu_pbrt_torch.fleet.router import FleetRouter, LocalReplica
    from tpu_pbrt_torch.scene.api import Options, compile_string
    from tpu_pbrt_torch.utils.clock import VirtualClock

    clock = VirtualClock(start=0.0, tick=1e-6)
    reps = [LocalReplica(f"m{k}", clock=clock, chunk=CHUNK, mesh=mesh,
                         spool_dir=os.path.join(tmp, f"m{k}")) for k in range(2)]
    pair = compile_string(TEXT, Options(quiet=True), device=mesh.device)
    if mesh.rank:
        reps[0].service.follow(compiled={"cornell": pair})
        return None
    router = FleetRouter(reps, clock=clock, spool_dir=os.path.join(tmp, "fleet"))
    try:
        job = router.submit(compiled=pair, resident_key="cornell", checkpoint_every=1)
        victim = router.owner(job)
        while router.poll(job)["chunks_done"] < 2:
            assert router.step() is not None, router.poll(job)
        moved = router.kill_replica(victim)
        router.drain_fleet()
        return {"victim": victim, "moved": moved, "owner": router.owner(job),
                "poll": router.poll(job), "film": _film(router.result(job))}
    finally:
        reps[0].service.close()


def _suite(mesh, tmp):
    from tpu_pbrt_torch.scene.api import Options, compile_string
    from tpu_pbrt_torch.serve import RenderService

    out = {}
    scene, integ = compile_string(TEXT, Options(quiet=True), device=mesh.device)
    solo = integ.render(scene, mesh=mesh, chunk=CHUNK)
    out["solo"] = (_film(solo), solo.image, solo.rays_traced)
    if mesh.rank == 0:
        one = integ.render(scene, chunk=CHUNK)
        out["one_device"] = (one.image, one.rays_traced)
        rec, images, svc = gen.run_script("tpu_pbrt_torch", os.path.join(tmp, "script"),
                                          mesh=mesh)
        svc.close()
        out["script"] = json.loads(json.dumps(rec))
        out["script_images"] = images
        out["script_films"] = {j: _film(svc.result(j)) for j in images}
        out["mesh_stats"] = svc.mesh_stats()
    else:
        RenderService(mesh=mesh, chunk=CHUNK).follow()
    out["rank1_fail"] = _served(mesh, os.path.join(tmp, "r1"), "dispatch:poison@chunk=1",
                                rank1_only=True)
    out["mesh_lost"] = _served(mesh, os.path.join(tmp, "lost"), "mesh:lost@chunk=1")
    out["failover"] = _failover(mesh, tmp)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("serve_mesh"))
    return launch(_suite, 2, args=(tmp,), device="cpu", threads=1, timeout=300)


def _equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a, b))


def test_concurrent_jobs_on_mesh_bit_identical_with_preempt(ranks):
    r0 = ranks[0]
    film, image, _ = r0["solo"]
    for j, img in r0["script_images"].items():
        assert np.isfinite(img).all()
        assert np.array_equal(img, image), f"{j} differs from the mesh solo render"
        assert _equal(r0["script_films"][j], film)
    assert r0["script"]["polls"]["j2"]["preemptions"] == 1
    # every rank held the same film: rank 1's solo equals rank 0's
    assert _equal(ranks[1]["solo"][0], film)
    ms = r0["mesh_stats"]
    assert ms["ranks"] == 2 and ms["slices"] == 8 and ms["decision"]["n"] > ms["slices"]


def test_mesh_solo_matches_the_one_device_render(ranks):
    _, image, rays = ranks[0]["solo"]
    one, one_rays = ranks[0]["one_device"]
    assert rays == one_rays
    np.testing.assert_allclose(image, one, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["rank1_fail", "mesh_lost"])
def test_a_failed_served_slice_rolls_every_rank_back(ranks, case):
    film, _, rays = ranks[0]["solo"]
    got, got_rays, recovery = ranks[0][case]
    assert _equal(got, film), f"{case}: the served film differs from the mesh solo render"
    assert got_rays == rays
    assert recovery["redispatches"] == 1 and recovery["rollbacks"] == 1


def test_mesh_replica_failover_resumes_from_the_spool(ranks):
    fo = ranks[0]["failover"]
    assert fo["moved"] and fo["owner"] != fo["victim"]
    assert fo["poll"]["status"] == "done" and fo["poll"]["failovers"] == 1
    assert _equal(fo["film"], ranks[0]["solo"][0])


@pytest.mark.parametrize("key", ["schedule", "polls", "flight"])
def test_rank0_decisions_match_the_reference(ranks, key):
    want = GOLDEN["mesh"] or GOLDEN["one_device"]
    assert ranks[0]["script"][key] == want[key]
    if GOLDEN["mesh"] is None:
        assert GOLDEN["mesh_error"]  # the generator says why


def test_jsonl_daemon_over_two_ranks(ranks, tmp_path):
    from tpu_pbrt_torch.utils.imageio import read_pfm

    out_img = str(tmp_path / "a.pfm")
    env = dict(os.environ, PYTHONPATH=ROOT)
    p = subprocess.Popen([sys.executable, "-m", "tpu_pbrt_torch.serve", "--mesh", "2",
                          "--device", "cpu", "--chunk", str(CHUNK)],
                         cwd=ROOT, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    import threading

    watchdog = threading.Timer(240, p.kill)  # a hung daemon ends the reads below
    watchdog.start()
    try:
        def send(req):
            p.stdin.write(json.dumps(req) + "\n")
            p.stdin.flush()

        def read():
            return json.loads(p.stdout.readline())

        send({"op": "submit", "text": TEXT, "job": "a"})
        assert read() == {"ok": True, "op": "submit", "job": "a"}
        send({"op": "poll", "job": "a"})
        lines = [read()]
        while not any(d.get("event") for d in lines):
            lines.append(read())
        assert {"event": "done", "job": "a"}.items() <= lines[-1].items()
        send({"op": "result", "job": "a", "out": out_img})
        send({"op": "metrics"})
        send({"op": "health"})
        send({"op": "shutdown", "drain": True})
        res, met, health = read(), read(), read()
        rc = p.wait(timeout=120)
    finally:
        watchdog.cancel()
        if p.poll() is None:
            p.kill()
    assert rc == 0, p.stderr.read()[-2000:]
    assert res["ok"] and res["rays"] == ranks[0]["solo"][2]
    assert np.array_equal(read_pfm(out_img), ranks[0]["solo"][1])
    assert met["ok"] and "tpu_pbrt_serve_slice_seconds" in met["exposition"]
    assert health["ok"] and health["firing"] == []
