"""The port's render loop infrastructure (tpu_pbrt_torch/integrators/
common.py: DispatchWindow, the recovery ladder, the film firewall's
modes, the capacity audit) against the reference's, and port against
port.

- `redispatch_backoff` and `live_film_carries` equal the reference's on
  a grid of (chunk, attempt) and depths; `resolve_pipeline_depth` forces
  depth 1 under the strict firewall modes, as the reference's does.
- DispatchWindow's behaviours of tests/test_pipeline.py::TestDispatchWindow
  (depth clamp, retire order, deferred actions at their cursor, flush
  with discard, flush that quiesces, wait attribution) hold in both
  packages.
- For each chaos plan of tests/torch_golden/make_infra_reference.py
  (dispatch:poison, dispatch:fail, nan:wave under retry, a torn
  checkpoint read back through .prev, retry exhaustion) the port's
  `stats["recovery"]`, its FLIGHT heartbeats (phase, chunk, attempt,
  backoff, error), the error it raises, the checkpoint it leaves and the
  faults' fired counts equal the reference's, stored by that generator.
- Port against port, bit for bit: the film at depths 1, 2 and 3, with
  and without deferred checkpoints; every recovered render equals the
  clean one; a resume from a checkpoint written deferred at depth 2, and
  one after an emergency checkpoint, equal the uninterrupted render.
- TORCH_PBRT_NONFINITE=raise raises NonFiniteRadianceError; raise or
  retry with the telemetry killed raises ValueError.
- The capacity audit reports 0 drops on a killeroo-class scene and
  raises once the headroom is cut until pairs drop.
- A kernel build error (simulated on the CPU) reaches the caller at
  once, not retried, the recovery untouched; a torch.AcceleratorError
  raised in a dispatch enters the ladder as a poisoning failure.
- `utils/stats.py::profile_trace` writes a Chrome trace.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tpu_pbrt import config as jconfig
from tpu_pbrt.integrators import common as jcommon
from tpu_pbrt.utils.clock import VirtualClock as JVirtualClock
from tpu_pbrt_torch.chaos import CHAOS
from tpu_pbrt_torch.config import cfg
from tpu_pbrt_torch.integrators import common as tcommon
from tpu_pbrt_torch.integrators.common import (
    ChunkDispatchError,
    ChunkPlan,
    DispatchWindow,
    NonFiniteRadianceError,
)
from tpu_pbrt_torch.parallel import checkpoint as tck
from tpu_pbrt_torch.parallel.mesh import resolve_pipeline_depth
from tpu_pbrt_torch.scenes import compile_api, make_cornell, make_killeroo_like
from tpu_pbrt_torch.utils.clock import VirtualClock

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_golden")
sys.path.insert(0, GOLDEN)
from make_infra_reference import CASES, CHUNK, MAXDEPTH, RES, SPP, run_case  # noqa: E402


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """The registry and the knobs are process-wide: every test starts
    from the same ones and leaves them so."""
    CHAOS.clear()
    for k, v in (("chunk", CHUNK), ("pipeline", 2), ("retry_backoff", 0.01), ("retry_max", 8),
                 ("nonfinite", "scrub"), ("telemetry", True)):
        monkeypatch.setattr(cfg, k, v)
    yield
    CHAOS.clear()


def _cornell():
    scene, integ = compile_api(make_cornell(res=RES, spp=SPP, integrator="path",
                                            maxdepth=MAXDEPTH, device="cpu"))
    integ.clock = VirtualClock()
    return scene, integ


def _render(depth=2, plan="", **kw):
    cfg.pipeline = depth
    CHAOS.install(plan)
    scene, integ = _cornell()
    return integ.render(scene, **kw)


def _same_film(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.film_state, b.film_state))


@pytest.fixture(scope="module")
def clean():
    """The reference render of the loop tests: depth 1, no faults."""
    CHAOS.clear()
    saved = {k: getattr(cfg, k) for k in ("chunk", "pipeline")}
    cfg.chunk, cfg.pipeline = CHUNK, 1
    try:
        scene, integ = _cornell()
        res = integ.render(scene)
    finally:
        for k, v in saved.items():
            setattr(cfg, k, v)
    assert res.stats["chunks"] == 3 and res.stats["regen"]
    return res


# -- pure functions -----------------------------------------------------------


@pytest.mark.parametrize("base,cap", [(0.25, 30.0), (0.01, 0.05), (0.0, 30.0)])
def test_redispatch_backoff_and_carries_match_reference(base, cap, monkeypatch):
    monkeypatch.setattr(cfg, "retry_backoff", base)
    monkeypatch.setattr(cfg, "retry_backoff_cap", cap)
    monkeypatch.setattr(jconfig.cfg, "retry_backoff", base)
    monkeypatch.setattr(jconfig.cfg, "retry_backoff_cap", cap)
    for c in range(12):
        for a in range(1, 10):
            assert tcommon.redispatch_backoff(c, a) == jcommon.redispatch_backoff(c, a)
    for d in range(-1, 9):
        assert tcommon.live_film_carries(d) == jcommon.live_film_carries(d)


@pytest.mark.parametrize("mode,pipe,want", [("scrub", 3, 3), ("scrub", 0, 1), ("raise", 4, 1),
                                            ("retry", 2, 1)])
def test_strict_firewall_forces_depth_1(mode, pipe, want, monkeypatch):
    from tpu_pbrt.parallel.mesh import resolve_pipeline_depth as jdepth

    monkeypatch.setattr(cfg, "nonfinite", mode)
    monkeypatch.setattr(cfg, "pipeline", pipe)
    monkeypatch.setattr(jconfig.cfg, "nonfinite", mode)
    monkeypatch.setattr(jconfig.cfg, "pipeline", pipe)
    assert resolve_pipeline_depth() == jdepth() == want


# -- DispatchWindow, in both packages ----------------------------------------

WINDOWS = [pytest.param(DispatchWindow, id="port"),
           pytest.param(jcommon.DispatchWindow, id="reference")]


@pytest.mark.parametrize("W", WINDOWS)
def test_window_depth_clamped_and_retire_order(W):
    w = W(0)
    assert w.depth == 1
    w = W(2)
    w.push(0, np.int32(0))
    w.push(1, np.int32(1))
    assert w.full() and len(w) == 2
    assert w.retire_one() == 0
    assert not w.full() and len(w) == 1


@pytest.mark.parametrize("W", WINDOWS)
def test_window_deferred_runs_at_cursor_retirement(W):
    w = W(3)
    ran = []
    w.push(0, np.int32(0))
    w.defer(2, lambda: ran.append("cursor2"))  # needs chunk 1 retired
    w.push(1, np.int32(1))
    assert w.retire_one() == 0 and ran == []
    assert w.retire_one() == 1 and ran == ["cursor2"]


@pytest.mark.parametrize("W", WINDOWS)
@pytest.mark.parametrize("discard", [True, False])
def test_window_flush(W, discard):
    w = W(2)
    ran = []
    w.push(0, np.int32(0))
    w.defer(1, lambda: ran.append("x"))
    w.flush(discard=discard)
    assert len(w) == 0 and ran == ([] if discard else ["x"])


@pytest.mark.parametrize("W", WINDOWS)
def test_window_wait_attributed(W):
    waits = []
    clock = (VirtualClock if W is DispatchWindow else JVirtualClock)()
    w = W(1, on_wait=waits.append, clock=clock)
    w.push(0, np.int32(0))
    w.retire_one()
    assert waits == [0.0]


def test_window_turns_a_device_error_into_a_poisoning_failure():
    class Handle:
        def synchronize(self):
            raise torch.AcceleratorError("an illegal memory access")

    w = DispatchWindow(2)
    w.push(0, Handle())
    with pytest.raises(ChunkDispatchError) as e:
        w.retire_one()
    assert e.value.poisons_state


# -- recovery against the reference ------------------------------------------


@pytest.fixture(scope="module")
def reference_cases():
    with open(os.path.join(GOLDEN, "infra_reference.json")) as f:
        return json.load(f)["cases"]


@pytest.mark.parametrize("name", list(CASES))
def test_recovery_matches_reference(name, reference_cases, clean, tmp_path):
    got, res = run_case("tpu_pbrt_torch", name, str(tmp_path), device="cpu")
    want = reference_cases[name]
    assert got["flight"] == want["flight"]
    for key in ("recovery", "error", "checkpoint", "fired", "plan"):
        assert got[key] == want[key], key
    if res is not None:
        # every recovered render equals the clean one bit for bit
        assert _same_film(res, clean)
        assert res.rays_traced == clean.rays_traced


# -- port against port ----------------------------------------------------------


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("every", [0, 1])
def test_depths_are_bit_identical(depth, every, clean, tmp_path):
    kw = {"checkpoint_path": str(tmp_path / "ck.npz"), "checkpoint_every": every} if every else {}
    res = _render(depth, **kw)
    assert res.stats["pipeline_depth"] == depth
    assert _same_film(res, clean) and res.rays_traced == clean.rays_traced
    assert res.stats["telemetry"]["counters"] == clean.stats["telemetry"]["counters"]
    assert {"dispatch_compile", "device_wait", "deposit_develop"} <= set(res.stats["phase_seconds"])
    if depth > 1:
        assert "dispatch_ahead" in res.stats["phase_seconds"]
    if every:
        assert tck.load_checkpoint(str(tmp_path / "ck.npz"))[1] == 3


class _Crash(Exception):
    pass


def test_resume_from_a_deferred_checkpoint(clean, tmp_path, monkeypatch):
    """At depth 2 the checkpoint at cursor 2 is written once chunk 1 has
    retired, after chunk 2 was dispatched into the film in place: it must
    hold chunks [0, 2) only. A crash in chunk 2's deposit (after its
    film writes) leaves that file; the resume equals the clean render."""
    path = str(tmp_path / "ck.npz")
    writes = []
    tck.register_write_observer(lambda p, nxt, rays: writes.append(nxt))
    real = ChunkPlan.dispatch

    def crash_after_2(plan, state, c):
        aux = real(plan, state, c)
        if c == 2:
            raise _Crash
        return aux

    try:
        monkeypatch.setattr(ChunkPlan, "dispatch", crash_after_2)
        with pytest.raises(_Crash):
            _render(2, checkpoint_path=path, checkpoint_every=1)
        monkeypatch.setattr(ChunkPlan, "dispatch", real)
        assert writes == [1, 2]
        st, nxt, _, _ = tck.load_checkpoint(path)
        assert nxt == 2 and not torch.equal(st.rgb, clean.film_state.rgb)
        res = _render(2, checkpoint_path=path, checkpoint_every=1)
    finally:
        tck._WRITE_OBSERVERS.clear()
    assert _same_film(res, clean) and res.rays_traced == clean.rays_traced


def test_resume_after_an_emergency_checkpoint(clean, tmp_path, monkeypatch):
    path = str(tmp_path / "ck.npz")
    monkeypatch.setattr(cfg, "retry_max", 1)
    with pytest.raises(RuntimeError, match="chunk 2 failed 2 times"):
        _render(2, "dispatch:fail@chunk=2&times=9", checkpoint_path=path, checkpoint_every=0)
    assert tck.load_checkpoint(path)[1] == 2
    res = _render(2, checkpoint_path=path)
    assert _same_film(res, clean) and res.rays_traced == clean.rays_traced


def test_restart_without_a_checkpoint(clean):
    res = _render(2, "dispatch:poison@chunk=1")
    assert res.stats["recovery"]["restarts"] == 1 and _same_film(res, clean)


def test_scrub_counts_and_raise_mode_raises(monkeypatch):
    res = _render(2, "nan:wave@1&chunk=1")
    assert res.stats["telemetry"]["counters"]["nonfinite_deposits"] > 0
    assert np.isfinite(res.image).all() and "recovery" not in res.stats
    monkeypatch.setattr(cfg, "nonfinite", "raise")
    with pytest.raises(NonFiniteRadianceError, match="chunk 1"):
        _render(2, "nan:wave@1&chunk=1")


@pytest.mark.parametrize("mode", ["raise", "retry"])
def test_strict_modes_need_telemetry(mode, monkeypatch):
    monkeypatch.setattr(cfg, "nonfinite", mode)
    monkeypatch.setattr(cfg, "telemetry", False)
    with pytest.raises(ValueError, match="telemetry"):
        _render(1)


def test_kernel_build_error_is_not_retried(monkeypatch):
    """A wrapper whose kernel does not build raises at once: no retry, no
    fallback, the ladder untouched."""
    calls = []

    def no_build(plan, state, c):
        calls.append(c)
        raise RuntimeError("nvcc failed: flush.cu(1): error")

    monkeypatch.setattr(ChunkPlan, "dispatch", no_build)
    seen = []
    CHAOS.register_hook(lambda c, a: seen.append((c, a)))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _render(2)
    assert calls == [0] and seen == [(0, 0)]


def test_device_error_enters_the_ladder(clean, monkeypatch):
    real = ChunkPlan.dispatch
    fired = []

    def lost(plan, state, c):
        if c == 1 and not fired:
            fired.append(c)
            raise torch.AcceleratorError("CUDA error: an illegal memory access")
        return real(plan, state, c)

    monkeypatch.setattr(ChunkPlan, "dispatch", lost)
    res = _render(2)
    assert res.stats["recovery"]["restarts"] == 1 and _same_film(res, clean)


def test_capacity_audit(monkeypatch):
    """The camera wave of a 4,096-ray chunk over a killeroo in 16-triangle
    treelets: no pair dropped at the default headroom; with the headroom
    cut to 0 and a 4,096-pair slab the worklists overflow and the audit
    raises (a warning under TORCH_PBRT_ALLOW_DROPS)."""
    monkeypatch.setattr(cfg, "leaf_tris", 16)
    scene, integ = compile_api(make_killeroo_like(res=32, spp=4, n_theta=24, n_phi=48,
                                                  maxdepth=1, device="cpu"))
    plan = integ.prepare_chunks(scene, chunk=4096)
    plan.capacity_audit()
    assert integ._audit_memo[(id(scene), 4096)][1] == 0
    integ._audit_memo.clear()
    monkeypatch.setattr(cfg, "headroom", 0.0)
    monkeypatch.setattr(cfg, "slab", 4096)
    with pytest.raises(RuntimeError, match="dropped .* traversal pairs"):
        plan.capacity_audit()
    assert integ._audit_memo[(id(scene), 4096)][1] > 0
    monkeypatch.setattr(cfg, "allow_drops", True)
    plan.capacity_audit()  # a warning, not a raise


def test_profile_trace_exports_a_chrome_trace(tmp_path):
    import torch.nn.functional as F

    from tpu_pbrt_torch.utils.stats import profile_trace

    with profile_trace(None):  # no directory: nothing is traced
        pass
    with profile_trace(str(tmp_path / "prof")):
        F.relu(torch.ones(64) - 0.5).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        doc = json.load(f)
    assert doc["traceEvents"]
