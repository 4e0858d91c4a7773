"""The port's chaos fault-injection package (tpu_pbrt_torch/chaos, a
copy of tpu_pbrt/chaos/__init__.py) against the reference's: the cases
of tests/test_chaos.py::{TestPlanParsing, TestRegistry} run through both
packages and must give the same results, and the injected dispatch
failures are each package's own ChunkDispatchError."""

import pytest
import torch

import tpu_pbrt.chaos as jchaos
import tpu_pbrt.integrators.common as jcommon
import tpu_pbrt_torch.chaos as tchaos
import tpu_pbrt_torch.integrators.common as tcommon

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

PKGS = [pytest.param((tchaos, tcommon), id="port"),
        pytest.param((jchaos, jcommon), id="reference")]


@pytest.fixture(autouse=True)
def _clear():
    for m in (tchaos, jchaos):
        m.CHAOS.clear()
    yield
    for m in (tchaos, jchaos):
        m.CHAOS.clear()


def _fields(plan):
    return [(f.site, f.kind, f.params, f.times, f.fired) for f in plan]


@pytest.mark.parametrize("spec", [
    "dispatch:poison@chunk=3,ckpt:torn@write=2,nan:wave@5&chunk=1,probe:hang@attempt=1",
    "dispatch:fail@chunk=2&times=99", "mesh:lost", "", "  ,  ", "ckpt:bitflip@3",
])
def test_plans_parse_alike(spec):
    assert _fields(tchaos.parse_plan(spec)) == _fields(jchaos.parse_plan(spec))
    for f in tchaos.parse_plan(spec):
        assert tchaos.parse_plan(f.spec())[0] == f


@pytest.mark.parametrize("bad", ["bogus:fail@chunk=1", "dispatch:explode", "nan:wave@x=y",
                                 "dispatch", "ckpt:torn@write=banana",
                                 "dispatch:fail@chunck=3", "nan:wave@5&chnk=2",
                                 "ckpt:torn@chunk=1"])
def test_invalid_plans_fail_loudly_alike(bad):
    msgs = []
    for m in (tchaos, jchaos):
        with pytest.raises(ValueError) as e:
            m.parse_plan(bad)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_protocol_fault_space_alike():
    assert tchaos.protocol_fault_space(3) == jchaos.protocol_fault_space(3)


@pytest.mark.parametrize("pkg", PKGS)
def test_fires_exactly_once_and_exhausts(pkg):
    chaos, common = pkg
    chaos.CHAOS.install("dispatch:fail@chunk=1")
    with pytest.raises(common.ChunkDispatchError) as ei:
        chaos.CHAOS.dispatch(1, 0)
    assert not ei.value.poisons_state
    chaos.CHAOS.dispatch(1, 1)
    chaos.CHAOS.dispatch(1, 0)
    assert chaos.CHAOS.report() == [{"fault": "dispatch:fail@chunk=1", "fired": 1, "times": 1}]


@pytest.mark.parametrize("pkg", PKGS)
def test_attempt_matching_and_kinds(pkg):
    chaos, common = pkg
    chaos.CHAOS.install("dispatch:fail@chunk=0&attempt=1")
    chaos.CHAOS.dispatch(0, 0)
    with pytest.raises(common.ChunkDispatchError):
        chaos.CHAOS.dispatch(0, 1)
    chaos.CHAOS.install("dispatch:poison@chunk=2")
    with pytest.raises(common.ChunkDispatchError) as ei:
        chaos.CHAOS.dispatch(2, 0)
    assert ei.value.poisons_state
    chaos.CHAOS.install("mesh:lost@chunk=1")
    chaos.CHAOS.dispatch(1, 0, mesh=False)
    with pytest.raises(common.ChunkDispatchError) as ei:
        chaos.CHAOS.dispatch(1, 0, mesh=True)
    assert ei.value.poisons_state


@pytest.mark.parametrize("pkg", PKGS)
def test_hooks_bitflip_nan_and_probe(pkg):
    chaos, _ = pkg
    reg = chaos.CHAOS
    seen = []
    reg.register_hook(lambda c, a: seen.append((c, a)))
    reg.dispatch(4, 2)
    reg.clear()
    reg.dispatch(4, 2)
    assert seen == [(4, 2)]
    offs = []
    for seed in (7, 7, 8):
        reg.install("ckpt:bitflip@write=1", seed=seed)
        offs.append(reg.bitflip_offset(10_000))
    assert offs[0] == offs[1] != offs[2]
    reg.install("ckpt:torn@write=2,ckpt:crash@write=3")
    assert [reg.checkpoint_fault() for _ in range(4)] == [None, "torn", "crash", None]
    reg.install("nan:wave@3&chunk=2")
    assert reg.has_nan() and reg.trace_key() == (True,)
    assert [reg.nan_wave_for(c) for c in (0, 2, 2)] == [-1, 3, -1]
    reg.install("probe:hang@attempt=2")
    assert not reg.probe_hang(1) and reg.probe_hang(2) and not reg.probe_hang(2)
    reg.clear()
    assert reg.trace_key() == (False,) and not reg.active()


def test_registries_agree_on_a_sequence_of_seams():
    """The same plan, the same calls: the same raises and the same report."""
    spec = "dispatch:fail@chunk=1&times=2,dispatch:poison@chunk=3,ckpt:torn@write=2,nan:wave@1&chunk=0"
    logs = []
    for chaos, common in ((tchaos, tcommon), (jchaos, jcommon)):
        chaos.CHAOS.install(spec, seed=5)
        log = []
        for c, a in [(0, 0), (1, 0), (1, 1), (1, 2), (3, 0), (3, 1)]:
            try:
                chaos.CHAOS.dispatch(c, a)
                log.append("ok")
            except common.ChunkDispatchError as e:
                log.append((str(e), e.poisons_state))
        log.append([chaos.CHAOS.checkpoint_fault() for _ in range(3)])
        log.append([chaos.CHAOS.nan_wave_for(c) for c in (0, 0, 1)])
        log.append(chaos.CHAOS.report())
        logs.append(log)
    assert logs[0] == logs[1]
