"""The port's bench probe (tpu_pbrt_torch/bench.py `probe_backend`), the
port of tests/test_chaos.py's TestBenchProbe, on the CPU through the
probe's `device` argument:

- `probe:hang@attempt=1` in TORCH_PBRT_FAULTS makes attempt 1 a
  subprocess that outlives the timeout; the capped-backoff retry then
  succeeds, with per-attempt accounting in the returned tuple and the
  `probe` / `probe_backoff` heartbeats in the flight file;
- when every attempt hangs the probe reports failure, and the bench's
  main then prints an `infra_outage` line and exits 1 without rendering
  (no CPU fallback).
"""

import json

import torch

import tpu_pbrt_torch.bench as bench

torch.set_num_threads(1)


class TestBenchProbe:
    def _arm(self, tmp_path, monkeypatch, faults):
        import time

        monkeypatch.setenv("TORCH_PBRT_FAULTS", faults)
        monkeypatch.setattr(bench, "_FLIGHT_PATH", str(tmp_path / "f.jsonl"))
        # rebase the budget clock: T_START is import-time
        monkeypatch.setattr(bench, "T_START", time.time())

    def _lines(self, tmp_path):
        return [json.loads(ln) for ln in open(tmp_path / "f.jsonl").read().splitlines()]

    def test_probe_recovers_from_simulated_hang(self, tmp_path, monkeypatch):
        self._arm(tmp_path, monkeypatch, "probe:hang@attempt=1")
        ok, detail, retries, wait_s = bench.probe_backend(
            timeout_s=10.0, max_attempts=2, backoff_base_s=0.05, device="cpu")
        assert ok and retries == 1, detail
        assert detail.startswith("cpu |")
        assert wait_s >= 10.0  # the hung attempt burned its full timeout
        lines = self._lines(tmp_path)
        phases = [ln["phase"] for ln in lines]
        assert "probe_backoff" in phases
        assert any(ln.get("chaos_hang") for ln in lines)
        assert any(ln.get("ok") for ln in lines)

    def test_every_attempt_hanging_exits_nonzero_without_rendering(self, tmp_path, monkeypatch,
                                                                    capsys):
        self._arm(tmp_path, monkeypatch, "probe:hang@attempt=1,probe:hang@attempt=2")
        got = bench.probe_backend(timeout_s=1.0, max_attempts=2, backoff_base_s=0.05,
                                  device="cpu")
        ok, detail, retries, _ = got
        assert not ok and retries == 1 and "hung" in detail
        assert [ln.get("ok") for ln in self._lines(tmp_path) if "ok" in ln] == [False, False]

        import tpu_pbrt_torch.scenes as scenes

        def no_render(*a, **k):
            raise AssertionError("the bench rendered after a failed probe")

        monkeypatch.delenv("BENCH_SKIP_PROBE", raising=False)
        monkeypatch.setattr(bench, "probe_backend", lambda **kw: got)
        monkeypatch.setattr(scenes, "make_killeroo_like", no_render)
        assert bench.main() == 1
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["infra_outage"] is True and line["probe_retries"] == 1
        assert line["value"] == 0.0
