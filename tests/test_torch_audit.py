"""The port's recorded-run audit (tpu_pbrt_torch/analysis/audit.py), the
counterpart of tests/test_jaxpr_audit.py: the entry points recorded at
the reference's tiny scenes hold the hot-path invariants (film in place,
no rebuild, host syncs equal to the stream tracer's tally, float64
confined to core/xla_math.py's f64 forms, no callbacks), and each check
flags its seeded fixture. The same recorded runs are gated against the
committed `cpu` budgets (analysis/cost.py), so that each entry point is
recorded once."""

import pytest
import torch

from tpu_pbrt_torch.analysis import audit, cost
from tpu_pbrt_torch.analysis.record import OpRecorder
from tpu_pbrt_torch.core import xla_math as xm

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs():
    """Every entry point of audit.entry_points, recorded once on the CPU."""
    return {name: fn() for name, fn in audit.entry_points("cpu").items()}


@pytest.fixture(scope="module")
def pool_run(runs):
    return runs["pool_chunk"]


def test_pool_chunk_host_syncs_equal_the_tally(pool_run):
    """Every host sync of the pool chunk is a read the tally counts: the
    traversal's (loop tests, block counts) and the pool's one per wave."""
    assert audit.host_sync_check(pool_run) == []
    t = pool_run.tally
    assert pool_run.waves == t["loop_reads"] == t["waves"] >= 2
    names = {(r.kind, r.name) for r in pool_run.rec.syncs()}
    assert names == {("host_read", "tolist"), ("host_read", "int")}


def test_kernel_calls_recorded_once_per_launch_site(pool_run):
    """The traversal's kernels are recorded as one op per wrapper call, as
    many as the tally's flush and expand calls."""
    kernels = [r for r in pool_run.rec.records if r.kind == "kernel"]
    assert {r.name for r in kernels} == {"flush_chunk", "expand"}
    assert sum(r.name == "flush_chunk" for r in kernels) == pool_run.tally["flush_calls"]
    assert all(r.frame.startswith("tpu_pbrt_torch/accel/stream.py:") for r in kernels)


@pytest.mark.parametrize("entry", ["pool_chunk", "path.li", "stream_intersect_split",
                                   "film.add_samples", "film.add_samples_pixel"])
def test_entry_point_invariants(entry, runs):
    run = runs[entry]
    assert audit.record_invariants(run) == []
    assert run.rec.ops()


def test_untallied_host_read_is_flagged():
    x = torch.arange(8, dtype=torch.float32)
    run = audit.record_entry("fixture", lambda: (x.sum().item(), torch.tensor([1.0, 2.0])), 8,
                             "cpu")
    fails = audit.host_sync_check(run)
    assert fails and "2 host syncs" in fails[0]
    assert [r.kind for r in run.rec.syncs()] == ["host_read", "upload"]


def test_f64_confined_to_xla_math_forms():
    a = torch.linspace(0.1, 2.0, 64)
    with OpRecorder() as rec:
        xm.fma32(a, a, a)
        xm.sqrt(a)
        xm.sin(a)
    assert audit.find_f64(rec.records, "cpu") == []
    # on the card fma32 and sqrt take no f64 branch: their f64 there is a leak
    bad = audit.find_f64(rec.records, "cuda")
    assert bad and all("_fma_f64" in b or " sqrt" in b for b in bad)
    with OpRecorder() as rec:
        (a.double() * 2.0).float()
    assert audit.find_f64(rec.records, "cpu")


def test_callbacks_flagged():
    x = torch.ones(64)

    def lane_loop():
        y = torch.empty(64)
        for i in range(64):
            y[i] = x[i] * 2.0
        return y

    with OpRecorder() as rec:
        lane_loop()
    found = audit.find_callbacks(rec.records, 64)
    assert found and "a loop over lanes" in found[0]
    with OpRecorder() as rec:
        x.tolist()
    assert audit.find_callbacks(rec.records, 64)
    with OpRecorder() as rec:
        (x * 2.0).sum().item()
    assert audit.find_callbacks(rec.records, 64) == []


def test_film_stays_in_place():
    assert audit.check_film_in_place("cpu") == []


def test_same_shape_renders_rebuild_nothing():
    assert audit.check_no_rebuild("cpu") == []


def test_one_rank_mesh_step_reduces_the_pool_drain(runs, pool_run):
    """The mesh step over a one-rank gloo group: the same drain as the pool
    chunk (its FLOPs), plus the chunk's agreement and all-reduce (more
    ops); the group is torn down afterwards."""
    import torch.distributed as dist

    run = runs["mesh_step"]
    assert not dist.is_initialized()
    assert audit.record_invariants(run) == []
    mesh, pool = cost.rollup_run(run)[0], cost.rollup_run(pool_run)[0]
    assert mesh.waves == pool.waves and mesh.flops == pool.flops and mesh.ops > pool.ops


# -- the repo gate --------------------------------------------------------------


@pytest.fixture(scope="module")
def repo_cost(runs):
    return cost.run_cost(device="cpu", runs=runs)


@pytest.mark.parametrize("entry", sorted(audit.entry_points("cpu")))
def test_repo_entry_point_within_committed_cpu_budget(repo_cost, entry):
    """Each entry point of the shipped tree records within the committed
    cpu budget (FLOPs, bytes and ops per wave within 10%), with no
    un-waived finding; the gate as a whole reports no error."""
    errors, warnings, rollups, findings = repo_cost
    assert errors == [], errors
    assert entry in rollups and rollups[entry].ops > 0
    assert not [f for f in findings if f.entry == entry and f.waived is None]
    assert not [w for w in warnings if w.startswith(f"{entry}:") and "regressed" in w]
