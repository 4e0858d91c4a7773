"""The port's render service (tpu_pbrt_torch/serve/) on the CPU, held to
the reference's tests/test_serve.py behaviours.

Oracles:

- POLICY: the port's FairScheduler, SloPolicy, parse_slo_spec and
  preemption_victim make the reference's decisions on the same
  sequences (pure host calls on both packages' objects).
- DECISIONS: the service script of
  tests/torch_golden/make_serve_reference.py (submits, a shed, steps, a
  preempt and resume, a cancel, a warm resubmit, a film-slot
  preemption under max_active=1, on a VirtualClock) gives the
  reference's schedule, submit and step answers, poll dicts, residency
  counts, per-job FLIGHT phases and time-free metric values
  (serve_reference.json).
- FILMS: at 1 spp every pixel holds one sample, so every served film
  (interleaved, preempted, parked, resumed) is bit-identical to the
  port's own solo render.
- RESIDENCY: a warm resubmit pays 0 scene compiles and 0 kernel builds;
  cancel releases the pin and the spool; the LRU evicts by footprint
  and never evicts pinned entries.
- The JSONL daemon answers submit, shed and metrics verbs.
- `scenes.killeroo_file`, the main path's scene as a file for the
  daemons, renders make_killeroo_like's image.
"""

import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from tpu_pbrt.serve import queue as jq
from tpu_pbrt_torch.scene.api import Options, compile_string
from tpu_pbrt_torch.serve import (
    FairScheduler,
    RenderService,
    ResidencyCache,
    ShedError,
    SloPolicy,
    parse_slo_spec,
    preemption_victim,
    scene_hbm_bytes,
)

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "torch_golden"))
import make_serve_reference as gen  # noqa: E402

TEXT = gen.scene_text("tpu_pbrt_torch")
CHUNK = gen.CHUNK  # 32*32*1 = 1024 work items -> 4 slices per job
with open(os.path.join(HERE, "torch_golden", "serve_reference.json")) as f:
    GOLDEN = json.load(f)["service"]


@pytest.fixture(scope="module")
def solo_ref():
    """The port's solo run-to-completion render (its own compile and
    integrator, the device's default chunk)."""
    scene, integ = compile_string(TEXT, Options(quiet=True), device="cpu")
    return np.asarray(integ.render(scene).image, np.float32)


@pytest.fixture(scope="module")
def scripted(tmp_path_factory):
    return gen.run_service("tpu_pbrt_torch", str(tmp_path_factory.mktemp("serve")), device="cpu")


def _service(**kw):
    kw.setdefault("chunk", CHUNK)
    kw.setdefault("seed", 0)
    return RenderService(device="cpu", **kw)


# --------------------------------------------------------------------------
# queue policy against the reference's objects
# --------------------------------------------------------------------------


class _J:
    def __init__(self, seq, tenant="t", priority=0):
        self.seq, self.tenant, self.priority = seq, tenant, priority


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_scheduler_matches_the_reference(seed):
    def run(mod):
        s = mod.FairScheduler(seed=seed)
        s.set_weight("heavy", 2.0)
        s.set_weight("light", 1.0)
        jobs = [_J(1, "heavy"), _J(2, "light"), _J(3, "other"), _J(4, "light", 5)]
        order = []
        for k in range(40):
            live = jobs if k < 10 else jobs[:3]
            j = s.pick(live)
            order.append((j.seq, s.peek(live).seq))
            s.charge(j.tenant)
            if k == 20:
                s.reenter("other", busy_tenants={"heavy", "light"})
        return order, s.stats()

    ours = run(sys.modules[FairScheduler.__module__])
    assert ours == run(jq)
    counts = [sum(1 for seq, _ in ours[0][10:] if seq == k) for k in (1, 2, 3)]
    assert counts[0] > max(counts[1:])  # weight 2 against two weight-1 tenants


def test_priority_and_victims_match_the_reference():
    low, mid, high = _J(1, "a", 0), _J(2, "b", 2), _J(3, "c", 5)
    for mod in (sys.modules[FairScheduler.__module__], jq):
        s = mod.FairScheduler(seed=0)
        assert [s.pick([low, high]).seq for _ in range(3)] == [3, 3, 3]
    for active, cand in (([low, mid], high), ([mid], _J(4, "d", 2)), ([low], mid), ([], high)):
        ours = preemption_victim(active, cand)
        theirs = jq.preemption_victim(active, cand)
        assert (ours and ours.seq) == (theirs and theirs.seq)


@pytest.mark.parametrize("spec", ["", "8", "default=3", "0=4,5=32", "0=4,default=9", "1.5"])
def test_slo_specs_and_admission_match_the_reference(spec):
    cast = float if "." in spec else int
    assert parse_slo_spec(spec, cast) == jq.parse_slo_spec(spec, cast)
    ours = SloPolicy(depth=parse_slo_spec(spec, cast), wait_s=parse_slo_spec(spec, cast))
    theirs = jq.SloPolicy(depth=jq.parse_slo_spec(spec, cast), wait_s=jq.parse_slo_spec(spec, cast))
    for prio in (0, 5, 7):
        for depth in (0, 3, 4, 40):
            for wait in (None, 1.0, 100.0):
                assert ours.admit(prio, depth, wait) == theirs.admit(prio, depth, wait)


@pytest.mark.parametrize("bad", ["x", "0=", "=3", "a=1"])
def test_bad_slo_spec_raises_like_the_reference(bad):
    with pytest.raises(ValueError):
        jq.parse_slo_spec(bad, int)
    with pytest.raises(ValueError):
        parse_slo_spec(bad, int)


# --------------------------------------------------------------------------
# residency (host units over fake scenes)
# --------------------------------------------------------------------------


class _FakeFilm:
    full_resolution = (4, 4)


class _FakeScene:
    def __init__(self, kb):
        self.dev = {"a": torch.zeros(kb * 256, dtype=torch.float32),  # kb KiB
                    "nested": {"b": [torch.zeros(3, dtype=torch.int32)]}}
        self.film = _FakeFilm()


def test_residency_lru_eviction_respects_pins():
    base = scene_hbm_bytes(_FakeScene(0))
    assert base == 3 * 4 + 16 * 28  # the nested int32 table + one film state
    cache = ResidencyCache(max_bytes=2 * (base + 100 * 1024) + 1024)
    for key, kb in (("s1", 100), ("s2", 100), ("s3", 100)):
        cache.get_or_compile(key, lambda kb=kb: (_FakeScene(kb), object()))
    assert cache.get("s1") is None  # LRU (s1) evicted to fit the budget
    assert cache.get("s2") is not None and cache.get("s3") is not None
    assert cache.evictions == 1 and cache.scene_compiles == 3
    cache.pin("s2")
    _ = cache.get("s3")  # make s2 the coldest
    cache.get_or_compile("s4", lambda: (_FakeScene(100), object()))
    assert cache.get("s2") is not None, "pinned entry was evicted"
    n = cache.scene_compiles
    cache.get_or_compile("s4", lambda: (_FakeScene(100), object()))
    assert cache.scene_compiles == n and cache.hits == 1


# --------------------------------------------------------------------------
# the scripted service against the reference's decisions
# --------------------------------------------------------------------------


@pytest.mark.parametrize("key", ["events", "schedule", "polls", "residency", "sheds", "flight",
                                 "metrics", "max_active"])
def test_service_decisions_match_the_reference(scripted, key):
    ours = json.loads(json.dumps(scripted[0][key]))
    assert ours == GOLDEN[key]


def test_served_films_bit_identical_to_solo(scripted, solo_ref):
    images = scripted[1]
    assert sorted(images) == ["j1", "j2", "j3", "j5", "max_active/hi", "max_active/lo"]
    for name, img in images.items():
        img = np.asarray(img, np.float32)
        assert np.isfinite(img).all()
        assert np.array_equal(img, solo_ref), f"{name} differs from solo"


# --------------------------------------------------------------------------
# service behaviours
# --------------------------------------------------------------------------


def test_warm_resubmit_zero_scene_compiles_and_kernel_builds(solo_ref):
    from tpu_pbrt_torch.kernels.build import BUILDS

    svc = _service()
    j1 = svc.submit(text=TEXT)
    svc.drain()
    builds = dict(BUILDS)
    j2 = svc.submit(text=TEXT)
    svc.drain()
    stats = svc.residency.stats()
    assert stats["scene_compiles"] == 1 and stats["hits"] == 1, stats
    assert BUILDS == builds
    for j in (j1, j2):
        assert np.array_equal(np.asarray(svc.result(j).image, np.float32), solo_ref)


def test_cancel_releases_residency_and_spool():
    svc = _service(max_resident_bytes=1)  # a budget nothing fits
    j = svc.submit(text=TEXT)
    key = svc.jobs[j].resident_key
    assert svc.residency.get(key) is not None  # pinned: over budget, kept
    svc.step()
    ckpt = svc.jobs[j].checkpoint_path
    svc.preempt(j)
    assert os.path.exists(ckpt), "preempt must write the emergency checkpoint"
    assert svc.jobs[j].state is None and svc.jobs[j].status == "paused"
    assert svc.step() is None, "a paused job must not schedule"
    svc.cancel(j)
    assert svc.jobs[j].status == "cancelled"
    assert svc.residency.get(key) is None  # unpinned: the eviction reclaimed it
    assert not os.path.exists(ckpt)


def test_preview_streams_partial_develop(tmp_path, solo_ref):
    from tpu_pbrt_torch.utils.imageio import read_image

    svc = _service()
    out = tmp_path / "preview.pfm"
    j = svc.submit(text=TEXT, preview_every=1, preview_path=str(out))
    svc.step()
    assert out.exists(), "preview cadence wrote nothing"
    img = np.asarray(read_image(str(out)), np.float32)
    assert img.shape == solo_ref.shape and np.isfinite(img).all()
    assert np.isfinite(np.asarray(svc.preview(j))).all()
    svc.drain()
    assert svc.jobs[j].previews >= 1


def test_unsliceable_integrator_and_mesh_rejected():
    from tpu_pbrt_torch.scenes import cornell_box_text

    svc = _service()
    with pytest.raises(ValueError, match="cannot be served"):
        svc.submit(text=cornell_box_text(res=16, spp=1, integrator="sppm"))
    # a mesh serves (tests/test_torch_serve_mesh.py); what is not a Mesh
    # is rejected
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        RenderService(mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            RenderService()


def test_step_failure_quarantines_job_not_service(solo_ref):
    from tpu_pbrt_torch.parallel.checkpoint import save_checkpoint

    svc = _service()
    good = svc.submit(text=TEXT)
    bad = svc.submit(text=TEXT, tenant="other")
    film = svc.residency.get(svc.jobs[bad].resident_key).scene.film
    save_checkpoint(svc.jobs[bad].checkpoint_path, film.init_state(), 0, 0,
                    fingerprint="some-other-render-config")
    svc.drain()
    assert svc.jobs[bad].status == "failed" and svc.jobs[bad].error
    assert np.array_equal(np.asarray(svc.result(good).image, np.float32), solo_ref)
    assert svc.residency.get(svc.jobs[bad].resident_key).pins == 0


def test_slo_wait_shed_recovers_no_lockout():
    from collections import deque

    svc = _service(slo=SloPolicy(wait_s=parse_slo_spec("0.5", float)))
    j1 = svc.submit(text=TEXT, tenant="alice")  # depth 0: wait not consulted
    svc._recent_waits[0] = deque([1.0] * 8, maxlen=32)
    with pytest.raises(ShedError, match="queue-wait p90"):
        svc.submit(text=TEXT, tenant="bob")
    assert svc.sheds == 1
    svc.drain()  # the queue empties; the stale window must not lock the class
    j2 = svc.submit(text=TEXT, tenant="bob")
    svc.drain()
    assert svc.jobs[j1].status == "done" and svc.jobs[j2].status == "done"


def test_metrics_kill_switch_empty_exposition(solo_ref, monkeypatch):
    from tpu_pbrt_torch.config import cfg
    from tpu_pbrt_torch.obs.metrics import METRICS

    monkeypatch.setattr(cfg, "metrics", False)
    METRICS.reset()
    svc = _service(slo=SloPolicy(depth=parse_slo_spec("1", int)))
    j = svc.submit(text=TEXT, tenant="alice")
    with pytest.raises(ShedError):
        svc.submit(text=TEXT, tenant="alice")  # depth shedding still works
    svc.drain()
    assert svc.metrics_exposition() == "" and METRICS.exposition() == ""
    assert np.array_equal(np.asarray(svc.result(j).image, np.float32), solo_ref)


def test_daemon_metrics_verb_and_shed_roundtrip():
    from tpu_pbrt_torch.obs.metrics import METRICS, validate_exposition
    from tpu_pbrt_torch.serve.__main__ import run_daemon

    METRICS.reset()
    svc = _service(slo=SloPolicy(depth=parse_slo_spec("1", int)))
    cmds = "".join(json.dumps(c) + "\n" for c in [
        {"op": "submit", "text": TEXT, "tenant": "alice"},
        {"op": "submit", "text": TEXT, "tenant": "bob"},
        {"op": "metrics"},
        {"op": "stats"},
        {"op": "health"},
        {"op": "shutdown", "drain": True},
    ])
    out = io.StringIO()
    assert run_daemon(svc, in_stream=io.StringIO(cmds), out=out) == 0
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    submits = [d for d in lines if d.get("op") == "submit"]
    assert submits[0] == {"ok": True, "op": "submit", "job": "j1"}
    assert submits[1] == {"ok": False, "op": "submit", "shed": True, "tenant": "bob",
                          "priority": 0, "reason": "queue depth 1 at class-0 target 1"}
    met = [d for d in lines if d.get("op") == "metrics"]
    assert len(met) == 1 and met[0]["ok"]
    exp = met[0]["exposition"]
    assert validate_exposition(exp) == []
    for needle in ("tpu_pbrt_serve_shed_total", 'tenant="bob"', "tpu_pbrt_serve_queue_depth",
                   "tpu_pbrt_residency_misses_total"):
        assert needle in exp
    health = [d for d in lines if d.get("op") == "health"][0]
    assert health["ok"] and "wedge" in [c["name"] for c in health["conditions"]]
    assert [d["job"] for d in lines if d.get("event") == "done"] == ["j1"]


def test_killeroo_file_is_the_main_path_scene():
    """scenes.killeroo_file (what a daemon is submitted by path) compiles to
    make_killeroo_like's geometry and renders its image (small blob)."""
    from tpu_pbrt_torch.scene.api import compile_file
    from tpu_pbrt_torch.scenes import compile_api, killeroo_file, make_killeroo_like

    path = killeroo_file(8, 2, n_theta=12, n_phi=24)
    a_scene, a_integ = compile_api(make_killeroo_like(8, 2, n_theta=12, n_phi=24, device="cpu"))
    b_scene, b_integ = compile_file(path, Options(quiet=True), device="cpu")
    assert torch.equal(a_scene.dev["tri_verts"], b_scene.dev["tri_verts"])
    a, b = a_integ.render(a_scene), b_integ.render(b_scene)
    assert a.rays_traced == b.rays_traced and np.array_equal(a.image, b.image)
