"""The port's static cost model (tpu_pbrt_torch/analysis/cost.py) and its op
recorder (analysis/record.py) against the reference's jaxcost
(tpu_pbrt/analysis/cost.py), and the budget gate.

Covered:
- on the same small functions (a matmul, an elementwise chain, a sum, a
  scatter-add, a gather) the port's record and the reference's
  `analyze_jaxpr` charge equal FLOPs and bytes; the f32 -> f64 -> f32
  round trip (JC-CHURN) and the oversized broadcast (JC-BCAST) are
  flagged by both, and the near misses by neither;
- each port rule flags its seeded fixture and passes its near miss
  (JC-RELAYOUT, JC-GATHER with its sort exemption);
- a kernel wrapper on the CPU is recorded as one op, charged the counts
  of kernels/flush.py::flush_work and kernels/expand.py::expand_work,
  and its plain version's ops are not recorded;
- the per-wave rollup divides by the loop reads, and the fingerprint is
  stable and changes with the op sequence;
- the gate: a regression is an error, --update-budgets clears it and
  keeps the tolerance, a missing entry is an error, an improvement a
  ratchet warning, fingerprint drift a warning (the repo's entry points
  are gated against the committed `cpu` budgets in
  tests/test_torch_audit.py, over the runs recorded there).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pbrt.analysis import cost as jcost
from tpu_pbrt_torch.accel import stream
from tpu_pbrt_torch.analysis import audit, cost
from tpu_pbrt_torch.analysis.record import OpRecorder

torch.set_num_threads(1)


def _port(fn, *args, wave=64):
    with OpRecorder(frames=True) as rec:
        fn(*args)
    roll, findings = cost.rollup_records(rec.records, "fixture", 1, wave)
    return roll, [f for f in findings if f.waived is None], rec


def _ref(fn, *args, wave=64):
    roll, findings = jcost.analyze_jaxpr(jax.make_jaxpr(fn)(*args), "fixture", wave)
    return roll, [f for f in findings if f.waived is None]


def _gather_dn():
    return jax.lax.GatherDimensionNumbers(offset_dims=(), collapsed_slice_dims=(0,),
                                          start_index_map=(0,))


def _scatter_dn():
    return jax.lax.ScatterDimensionNumbers(update_window_dims=(), inserted_window_dims=(0,),
                                           scatter_dims_to_operand_dims=(0,))


rng = np.random.default_rng(7)
A, B = rng.standard_normal((128, 64), np.float32), rng.standard_normal((64, 32), np.float32)
X, Y = rng.standard_normal(4096, np.float32), rng.standard_normal(4096, np.float32)
TAB = rng.standard_normal(65536, np.float32)
IDX = rng.integers(0, 65536, 2048).astype(np.int32)
UPD = rng.standard_normal(2048, np.float32)

#: name -> (port function, its torch inputs, reference function, its jax inputs)
SAME_COST = {
    "matmul": (lambda a, b: a @ b, (A, B), lambda a, b: a @ b, (A, B)),
    "elementwise": (lambda x, y: torch.exp(x) * 2.0 + y, (X, Y),
                    lambda x, y: jnp.exp(x) * 2.0 + y, (X, Y)),
    "sum": (lambda x: torch.sum(x), (X,), lambda x: jnp.sum(x), (X,)),
    "scatter_add": (lambda t, i, u: t.index_add(0, i, u), (TAB, IDX, UPD),
                    lambda t, i, u: jax.lax.scatter_add(t, i, u, _scatter_dn()),
                    (TAB, IDX[:, None], UPD)),
    "gather": (lambda t, i: t.index_select(0, i), (TAB, IDX),
               lambda t, i: jax.lax.gather(t, i, _gather_dn(), (1,),
                                           mode=jax.lax.GatherScatterMode.PROMISE_IN_BOUNDS),
               (TAB, IDX[:, None])),
}


@pytest.mark.parametrize("name", sorted(SAME_COST))
def test_flops_and_bytes_equal_reference(name):
    pfn, pargs, jfn, jargs = SAME_COST[name]
    roll, _, rec = _port(pfn, *(torch.from_numpy(np.array(a)) for a in pargs))
    jroll, _ = _ref(jfn, *(jnp.asarray(a) for a in jargs))
    assert (roll.flops, roll.hbm_bytes) == (jroll.flops, jroll.hbm_bytes), \
        ([r.name for r in rec.records], jroll)
    assert roll.flops > 0 and roll.hbm_bytes > 0


def test_f32_f64_f32_round_trip_flagged_by_both():
    x = np.ones(128, np.float32)
    _, found, _ = _port(lambda v: v.double().float() * 2.0, torch.from_numpy(x))
    assert any(f.rule == "JC-CHURN" and "float32->torch.float64->torch.float32" in f.detail
               for f in found), found
    with jax.enable_x64(True):
        jx = jax.make_jaxpr(lambda v: v.astype(jnp.float64).astype(jnp.float32) * 2.0)(x)
    _, jfound = jcost.analyze_jaxpr(jx, "fixture", 64)
    assert any(f.rule == "JC-CHURN" for f in jfound)
    # the near miss: below CHURN_MIN_ELEMS
    small = torch.ones(cost.CHURN_MIN_ELEMS - 1)
    _, found, _ = _port(lambda v: v.double().float(), small)
    assert not any(f.rule == "JC-CHURN" for f in found)


def test_oversized_broadcast_flagged_by_both():
    x = np.ones(512, np.float32)
    _, found, _ = _port(lambda v: v[:, None].expand(512, 4096).contiguous() * 1.5,
                        torch.from_numpy(x))
    assert any(f.rule == "JC-BCAST" for f in found), found
    _, jfound = _ref(lambda v: jnp.broadcast_to(v[:, None], (512, 4096)) * 1.5, jnp.asarray(x))
    assert any(f.rule == "JC-BCAST" for f in jfound)
    # the near miss: a scalar broadcast, and a broadcast view never copied
    _, found, _ = _port(lambda v: torch.ones(512, 4096) + v[0], torch.from_numpy(x))
    assert not any(f.rule == "JC-BCAST" for f in found)
    _, found, _ = _port(lambda v: v[:, None].expand(512, 4096) * 1.5, torch.from_numpy(x))
    assert not any(f.rule == "JC-BCAST" for f in found)


def test_relayout_copy_flagged_and_small_ignored():
    _, found, _ = _port(lambda v: v.t().contiguous(), torch.ones(4096, 64))
    assert any(f.rule == "JC-RELAYOUT" for f in found)
    _, found, _ = _port(lambda v: v.t().contiguous(), torch.ones(16, 8))
    assert not any(f.rule == "JC-RELAYOUT" for f in found)


def test_narrow_gather_flagged_unless_sorted():
    tab = torch.ones(65536)
    idx = torch.zeros(32768, dtype=torch.int64)
    _, found, _ = _port(lambda t, i: t[i.clamp(0, 65535)], tab, idx)
    assert any(f.rule == "JC-GATHER" for f in found)
    _, found, _ = _port(lambda t, i: t[torch.sort(i).values.clamp(0, 65535)], tab, idx)
    assert not any(f.rule == "JC-GATHER" for f in found)
    _, found, _ = _port(lambda t: t[torch.arange(32768, dtype=torch.int64) + 3], tab)
    assert not any(f.rule == "JC-GATHER" for f in found)


def _expand_args():
    from tests.test_torch_kernels import _expand_inputs

    key_in, node, rayE, prim, boxT, cidT, tb = _expand_inputs(S=700)
    box48 = np.ascontiguousarray(boxT.reshape(48, -1))
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in
                 (key_in, node, rayE, prim, box48, cidT)) + (tb, False)


def test_kernel_wrapper_recorded_as_one_op_with_its_counts():
    from tpu_pbrt_torch.kernels.expand import expand, expand_work
    from tpu_pbrt_torch.kernels.fixtures import flush_inputs
    from tpu_pbrt_torch.kernels.flush import flush_chunk, flush_work

    fargs = tuple(torch.from_numpy(a) for a in flush_inputs(16, L=64))
    eargs = _expand_args()
    for fn, args, work in ((flush_chunk, fargs, flush_work), (expand, eargs, expand_work)):
        with OpRecorder() as rec:
            fn(*args)
        assert [(r.kind, r.name) for r in rec.records] == [("kernel", fn.__name__)]
        roll, _ = cost.rollup_records(rec.records, "kernel")
        flops, nbytes = work(*args)
        assert (roll.flops, roll.hbm_bytes, roll.ops) == (round(flops), round(nbytes), 1.0)
        assert flops > 0 and nbytes > 0


def test_rollup_is_per_wave():
    x = torch.ones(1024)

    def waves(n):
        for _ in range(n):
            torch.exp(x)
            stream.WAVES.add_loop_read()

    one = audit.record_entry("toy", lambda: waves(1), 64, "cpu")
    four = audit.record_entry("toy", lambda: waves(4), 64, "cpu")
    r1, r4 = cost.rollup_run(one)[0], cost.rollup_run(four)[0]
    assert (four.waves, r4.waves) == (4, 4)
    assert (r4.flops, r4.hbm_bytes, r4.ops) == (r1.flops, r1.hbm_bytes, r1.ops)


def test_fingerprint_stable_and_change_sensitive():
    x = torch.ones(64)
    r1 = _port(lambda v: v * 2.0, x)[0]
    r2 = _port(lambda v: v * 2.0, x)[0]
    r3 = _port(lambda v: v * 2.0 + 1.0, x)[0]
    assert r1.fingerprint == r2.fingerprint != r3.fingerprint


# -- the budget gate ----------------------------------------------------------


def _toy_entries(scale: int, fn=lambda v: torch.sum(v * 2.0 + 1.0)):
    def run(frames=True):
        x = torch.ones(1024 * scale)
        return audit.record_entry("toy", lambda: fn(x), 64, "cpu", frames=frames)

    return {"toy": run}


def _gate(path, scale, update=False, device="cpu", **kw):
    """run_cost over the toy entry point (recorded on the CPU), gating or
    updating `device`'s budgets in `path`."""
    return cost.run_cost(update=update, budgets_path=path, entries=_toy_entries(scale, **kw),
                         device=device)


def test_budget_gate_regression_and_update(tmp_path):
    path = tmp_path / "budgets.json"
    assert _gate(path, 1, update=True)[0] == []
    assert _gate(path, 1)[0] == []
    errors = _gate(path, 4)[0]
    assert errors and "toy" in errors[0] and "regressed" in errors[0]
    _gate(path, 4, update=True)
    assert _gate(path, 4)[0] == []
    # the entries are keyed by device type: a cuda update keeps the cpu ones
    _gate(path, 1, update=True, device="cuda")
    data = json.loads(path.read_text())
    assert set(data["entries"]) == {"cpu", "cuda"}
    assert data["entries"]["cpu"]["toy"]["flops"] == 4 * data["entries"]["cuda"]["toy"]["flops"]


def test_update_preserves_tolerance_and_is_deterministic(tmp_path):
    path = tmp_path / "budgets.json"
    _gate(path, 1, update=True)
    data = json.loads(path.read_text())
    data["tolerance"] = 0.05
    path.write_text(json.dumps(data))
    _gate(path, 2, update=True)
    first = path.read_text()
    assert json.loads(first)["tolerance"] == 0.05
    _gate(path, 2, update=True)
    assert path.read_text() == first


def test_budget_gate_missing_entry_is_error(tmp_path):
    errors = _gate(tmp_path / "b.json", 1)[0]
    assert errors and "no committed cpu budget" in errors[0]


def test_budget_improvement_is_ratchet_warning(tmp_path):
    path = tmp_path / "budgets.json"
    _gate(path, 4, update=True)
    errors, warnings, _, _ = _gate(path, 1)
    assert errors == [] and any("improved" in w for w in warnings)


def test_fingerprint_drift_is_warning_not_error(tmp_path):
    path = tmp_path / "budgets.json"
    _gate(path, 1, update=True)
    errors, warnings, _, _ = _gate(path, 1, fn=lambda v: torch.sum((v - 1.0) * 2.0))
    assert errors == [] and any("fingerprint changed" in w for w in warnings)
