"""The port's command line (tpu_pbrt_torch/main.py) on the CPU.

- `main([scene, "--quick", "--device", "cpu", "-o", out.pfm, ...])`
  returns 0 and writes the render's developed image: the PFM holds float32,
  so the file read back must equal `RenderResult.image` bit for bit;
- `--mesh 2` renders over two gloo CPU ranks and writes the image
  (rank 0), within rtol 1e-4 / atol 1e-5 of the one-device CLI render;
  `--multihost` outside a process group warns and renders on one device,
  bit-identical; `--serve --mesh 2` serves the command line's scene
  over two ranks and writes the mesh render's image bit for bit, and
  `--serve --multihost` outside a group serves on one device and writes
  the one-device image;
- `--serve` runs the render service's JSONL daemon on stdin: a script
  that submits the Cornell box's quick crop, polls and shuts down
  answers every line and writes the same image as the CLI's render;
- `--trace`, `--metrics-path` and `--faults` run: the trace file passes
  the trace validator with every `render/slice` span closed, the metrics
  file passes the exposition validator with the render's phases in it,
  and a render under `dispatch:poison@chunk=1` writes the same image as
  the uninterrupted one;
- `--spp-chunk N` sets the chunk, and with it the checkpoint's resume
  fingerprint: the one the reference writes under TPU_PBRT_CHUNK=N (the
  reference's CLI parses --spp-chunk without reading it);
- a malformed scene exits 1 and names file:line;
- without `--device` and without a GPU it exits 1 (no silent CPU
  fallback).
"""

import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from tpu_pbrt.parallel import checkpoint as jck
from tpu_pbrt_torch import main as cli
from tpu_pbrt_torch.integrators.common import WavefrontIntegrator
from tpu_pbrt_torch.parallel import checkpoint as tck
from tpu_pbrt_torch.scene import api
from tpu_pbrt_torch.utils.imageio import read_pfm

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORNELL = os.path.join(ROOT, "scenes", "cornell-path.pbrt")


def test_cli_renders_and_writes_the_image(tmp_path, monkeypatch):
    results = []
    real = api.render_file

    def render_file(*a, **kw):
        results.append(real(*a, **kw))
        return results[-1]

    monkeypatch.setattr(api, "render_file", render_file)
    out = str(tmp_path / "cornell.pfm")
    # --quick: 64x64 at 8 spp; the crop window keeps the CPU render short
    rc = cli.main([CORNELL, "--quick", "--device", "cpu", "-o", out, "--quiet",
                   "--cropwindow", "0.25", "0.5", "0.25", "0.5"])
    assert rc == 0 and len(results) == 1
    res = results[0]
    assert res.image.shape == (16, 16, 3) and res.image.max() > 0
    assert np.array_equal(read_pfm(out), res.image)
    assert res.stats["regen"]  # the pool is the CLI's render path too


def test_spp_chunk_sets_the_chunk_and_the_fingerprint(tmp_path, monkeypatch):
    plans = []
    real = WavefrontIntegrator.prepare_chunks

    def prepare_chunks(self, *a, **kw):
        plans.append(real(self, *a, **kw))
        return plans[-1]

    monkeypatch.setattr(WavefrontIntegrator, "prepare_chunks", prepare_chunks)
    ck = str(tmp_path / "ck.npz")
    rc = cli.main([CORNELL, "--quick", "--device", "cpu", "--quiet", "--spp-chunk", "512",
                   "--checkpoint", ck, "--cropwindow", "0.25", "0.5", "0.25", "0.5"])
    assert rc == 0 and len(plans) == 1
    plan = plans[0]
    assert (plan.chunk, plan.n_chunks) == (512, 4)  # 16x16 pixels at 8 spp
    fp = plan.fingerprint
    assert fp.startswith("chunk=512;")
    assert fp == jck.render_fingerprint(chunk=512, spp=plan.spp, total=plan.total,
                                        scene=plan.scene)
    assert tck.load_checkpoint(ck, fp)[1] == 4
    with pytest.raises(ValueError, match="different render configuration"):
        tck.load_checkpoint(ck, fp.replace("chunk=512", "chunk=131072"))


QUICK = ["--quick", "--device", "cpu", "--quiet", "--spp-chunk", "512",
         "--cropwindow", "0.25", "0.5", "0.25", "0.5"]


@pytest.mark.parametrize("flag", ["--mesh=2", "--multihost"])
def test_unported_flag_exits_2(flag, quick_image, tmp_path, monkeypatch):
    # serving over a mesh is ported: `--serve` with the flag serves the
    # command line's scene (rank 0 reads the shutdown from stdin) and
    # exits 0 with the image of the same render unserved
    monkeypatch.delenv("TORCH_PBRT_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.setattr(sys, "stdin", io.StringIO('{"op": "shutdown", "drain": true}\n'))
    out = str(tmp_path / "served.pfm")
    assert cli.main([CORNELL, *QUICK, "--serve", flag, "-o", out]) == 0
    if flag == "--multihost":
        np.testing.assert_array_equal(read_pfm(out), quick_image)
    else:
        ref = str(tmp_path / "mesh.pfm")
        assert cli.main([CORNELL, *QUICK, "--mesh", "2", "-o", ref]) == 0
        np.testing.assert_array_equal(read_pfm(out), read_pfm(ref))


@pytest.fixture(scope="module")
def quick_image(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("clean") / "clean.pfm")
    assert cli.main([CORNELL, *QUICK, "-o", out]) == 0
    return read_pfm(out)


def test_mesh_flag_renders_over_two_ranks(quick_image, tmp_path):
    out = str(tmp_path / "mesh.pfm")
    assert cli.main([CORNELL, *QUICK, "--mesh", "2", "-o", out]) == 0
    np.testing.assert_allclose(read_pfm(out), quick_image, rtol=1e-4, atol=1e-5)


def test_multihost_outside_a_group_renders_on_one_device(quick_image, tmp_path, monkeypatch):
    monkeypatch.delenv("TORCH_PBRT_COORDINATOR_ADDRESS", raising=False)
    out = str(tmp_path / "multihost.pfm")
    assert cli.main([CORNELL, *QUICK, "--multihost", "-o", out]) == 0
    np.testing.assert_array_equal(read_pfm(out), quick_image)


@pytest.mark.parametrize("flag", ["--trace", "--metrics-path", "--faults"])
def test_observability_and_fault_flags_run(flag, quick_image, tmp_path):
    from tpu_pbrt_torch.chaos import CHAOS
    from tpu_pbrt_torch.obs.metrics import METRICS, validate_exposition
    from tpu_pbrt_torch.obs.trace import TRACE, validate_trace

    out = str(tmp_path / "img.pfm")
    arg = {"--trace": str(tmp_path / "t.json"), "--metrics-path": str(tmp_path / "m.prom"),
           "--faults": "dispatch:poison@chunk=1"}[flag]
    try:
        assert cli.main([CORNELL, *QUICK, "-o", out, flag, arg]) == 0
        if flag == "--trace":
            doc = json.load(open(arg))
            assert validate_trace(doc) == []
            slices = [e for e in doc["traceEvents"] if e.get("name") == "render/slice"]
            assert len(slices) == 8  # 4 chunks: a begin and an end each
            assert "main/render_file" in {e.get("name") for e in doc["traceEvents"]}
        elif flag == "--metrics-path":
            text = open(arg).read()
            assert validate_exposition(text) == [] and 'phase="device_wait"' in text
        else:
            assert CHAOS.report() == [{"fault": arg, "fired": 1, "times": 1}]
    finally:
        CHAOS.clear()
        TRACE.configure(None)
        TRACE.reset()
        METRICS.configure(None)
    assert np.array_equal(read_pfm(out), quick_image)


def test_serve_runs_a_jsonl_script(quick_image, tmp_path, monkeypatch, capsys):
    out = str(tmp_path / "served.pfm")
    script = [
        {"op": "submit", "scene": CORNELL, "job": "a", "quick": True,
         "crop": [0.25, 0.5, 0.25, 0.5], "chunk": 512, "outfile": out},
        {"op": "poll", "job": "a"},
        {"op": "health"},
        {"op": "shutdown", "drain": True},
    ]
    monkeypatch.setattr(sys, "stdin", io.StringIO("".join(json.dumps(c) + "\n" for c in script)))
    assert cli.main(["--serve", "--quiet", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    answers = [x for x in lines if "op" in x]
    assert [x["op"] for x in answers] == ["submit", "poll", "health"]
    assert all(x["ok"] for x in answers)
    assert [x for x in lines if "event" in x] == [
        {"event": "done", "job": "a", "rays": lines[-1]["rays"], "seconds": lines[-1]["seconds"]}]
    assert np.array_equal(read_pfm(out), quick_image)


def test_malformed_scene_exits_1_with_file_and_line(tmp_path, capsys):
    bad = tmp_path / "bad.pbrt"
    bad.write_text('Film "image"\nWorldBegin\nBogusDirective 1 2\nWorldEnd\n')
    assert cli.main([str(bad), "--device", "cpu", "--quiet"]) == 1
    assert "bad.pbrt:3" in capsys.readouterr().err


def test_default_device_without_gpu_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    assert cli.main([CORNELL, "--quick"]) == 1
    assert "device='cpu'" in capsys.readouterr().err
