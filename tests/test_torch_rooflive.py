"""The port's live-vs-static roofline (tpu_pbrt_torch/obs/rooflive.py) against
the reference's (tpu_pbrt/obs/rooflive.py), and the bench line's static
fields and telemetry block (tpu_pbrt_torch/bench.py) against the keys of
the reference bench's line (bench.py)."""

import ast
import json
from pathlib import Path

import pytest
import torch

from tpu_pbrt.obs import rooflive as jroof
from tpu_pbrt_torch.obs import rooflive as troof

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

#: (waves, seconds, static bytes, static flops)
CASES = [
    (52, 4.75, 954_906_083, 239_043_308),
    (13, 0.5, 35_030_431, None),
    (13, 0.5, None, 24_088_021),
    (0, 1.0, 1000, 1000),
    (7, 0.0, 1000, 1000),
    (None, 2.0, 1000, 1000),
]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", None])
@pytest.mark.parametrize("case", CASES)
def test_live_vs_static_equals_reference_off_the_table(case, kind):
    """With a device kind in neither table (no TPU, no H100) the two
    return the same fields, the ratio null."""
    waves, seconds, b, f = case
    kw = dict(waves=waves, seconds=seconds, static_bytes_per_wave=b, static_flops_per_wave=f,
              device_kind=kind)
    got, want = troof.live_vs_static(**kw), jroof.live_vs_static(**kw)
    assert got == want and got["live_vs_static_ratio"] is None


def test_h100_ratio_and_no_tpu_figure():
    kind = "NVIDIA H100 80GB HBM3"
    assert troof.platform_hbm_peak(kind) == 3.35e12
    assert troof.platform_hbm_peak("cpu") is None
    for tpu in ("TPU v4", "TPU v5 lite", "TPU v5p", "TPU v6e"):
        assert troof.platform_hbm_peak(tpu) is None
    out = troof.live_vs_static(waves=52, seconds=4.0, static_bytes_per_wave=10**9,
                               static_flops_per_wave=10**8, device_kind=kind, n_devices=2)
    assert out["live_bytes_per_sec"] == 13e9
    assert out["hbm_peak_bytes_per_sec"] == 6.7e12
    assert out["live_vs_static_ratio"] == round(13e9 / 6.7e12, 6)


def test_load_static_budget_by_device(tmp_path):
    p = tmp_path / "budgets.json"
    p.write_text(json.dumps({"entries": {"cuda": {"pool_chunk": {"hbm_bytes": 5}},
                                         "cpu": {"pool_chunk": {"hbm_bytes": 7}}}}))
    assert troof.load_static_budget("pool_chunk", str(p))["hbm_bytes"] == 5
    assert troof.load_static_budget("pool_chunk", str(p), device="cpu")["hbm_bytes"] == 7
    assert troof.load_static_budget("nope", str(p)) == {}
    assert troof.load_static_budget("pool_chunk", str(tmp_path / "missing.json")) == {}
    # the committed file holds the cpu entries the tests gate
    assert troof.load_static_budget("pool_chunk", device="cpu")["ops"] > 0


def _reference_telemetry_keys():
    """The string keys of the reference bench's `telemetry` dict literal
    (bench.py) and of its live_vs_static block."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            t = node.targets[0]
            if isinstance(t, ast.Subscript) and getattr(t.slice, "value", None) == "telemetry":
                keys = {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
                return keys | set(jroof.live_vs_static(waves=None, seconds=None))
    raise AssertionError("no telemetry block in bench.py")


def test_bench_telemetry_block_has_every_reference_key():
    from tpu_pbrt_torch.bench import STATIC_KEYS, telemetry_block
    from tpu_pbrt_torch.scenes import compile_api, make_killeroo_like

    scene, integ = compile_api(make_killeroo_like(res=8, spp=1, maxdepth=2, n_theta=12,
                                                  n_phi=24, device="cpu"))
    res = integ.render(scene)
    block = telemetry_block(res, scene, {"static_bytes_per_wave": 10**6,
                                         "static_flops_per_wave": 10**5})
    want = _reference_telemetry_keys()
    assert len(want) == 10 and set(block) == want
    assert block["tracer_mode"] == "plain" and block["fused_blocks_per_flush"] > 0
    assert block["counters"]["rays_traced"] == res.rays_traced
    assert block["live_bytes_per_sec"] == 10**6 * (res.stats["n_waves"] / res.seconds)
    assert block["live_vs_static_ratio"] is None  # the CPU has no peak
    ref_static = {"static_flops_per_wave", "static_bytes_per_wave", "static_intensity"}
    assert ref_static <= set(STATIC_KEYS)


def test_bench_wave_line_on_the_cpu(monkeypatch):
    """The bench's static leg: a subprocess (`python -m
    tpu_pbrt_torch.analysis.cost --bench-wave`) records one wave of the
    bench's own scene and returns the static fields of its JSON line."""
    from tpu_pbrt_torch.bench import STATIC_KEYS, static_wave_cost

    # one CPU thread in the subprocess, as in this worker
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    line = static_wave_cost(8, 1, timeout_s=300, device="cpu")
    assert set(line) == set(STATIC_KEYS)
    for k in ("static_flops_per_wave", "static_bytes_per_wave", "static_ops_per_wave"):
        assert line[k] > 0
    assert line["static_intensity"] == round(line["static_flops_per_wave"]
                                             / line["static_bytes_per_wave"], 3)


def test_bench_wave_overrun_is_left_out():
    """A static leg over its time limit is killed and nulls the fields."""
    from tpu_pbrt_torch.bench import static_wave_cost

    assert static_wave_cost(8, 1, timeout_s=0.01, device="cpu") == {}
