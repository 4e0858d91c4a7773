"""The recovery matrix's mesh, serve and fleet rows on the CPU
(tpu_pbrt_torch/chaos/__main__.py): `mesh-device-loss` over two gloo
ranks bit-identical to the undisturbed mesh render; the watchdog rows
(`serve-wedge`, `serve-backoff-storm`) flag what they must and nothing
else; the fleet rows fail over and adopt bit-identically; and the
matrix's entry point prints its `chaos_matrix` line with `"failed": []`
and exits 0, or exits 1 on a FAIL.
"""

import json

import pytest
import torch

from tpu_pbrt_torch.chaos import __main__ as matrix

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(matrix, "DEVICE", "cpu")


@pytest.mark.parametrize("name", ["mesh-device-loss", "fleet-replica-kill",
                                  "fleet-router-restart"])
def test_row_passes_on_the_cpu(name, tmp_path):
    ok, detail = matrix.run_row(name, str(tmp_path))
    assert ok, f"{name}: {detail}"


@pytest.mark.parametrize("name,flag,silent", [("serve-wedge", "wedge", None),
                                              ("serve-backoff-storm", "backoff_storm", "wedge")])
def test_watchdog_row_flags(name, flag, silent, tmp_path):
    ok, detail = matrix.run_row(name, str(tmp_path))
    assert ok, f"{name}: {detail}"
    from tpu_pbrt_torch.obs.health import Thresholds

    th = Thresholds()
    steps = th.resolved_wedge_steps() + 2 if name == "serve-wedge" else th.storm_attempts + 1
    _, rep = matrix._serve_retry_storm(steps=steps, env=None)
    assert flag in rep.firing()
    if silent:
        assert silent not in rep.firing()


def test_a_clean_row_that_trips_the_watchdog_fails(tmp_path, monkeypatch):
    """The false-positive gate: a row that passes but leaves a health
    condition firing is a FAIL."""
    from tpu_pbrt_torch.obs import health

    class Firing:
        ok = False

        def firing(self):
            return ["wedge"]

    monkeypatch.setattr(health, "evaluate", lambda *a, **k: Firing())
    monkeypatch.setitem(matrix.SCENARIOS, "clean-redispatch", lambda tmp: (True, "stub"))
    ok, detail = matrix.run_row("clean-redispatch", str(tmp_path))
    assert not ok and "watchdog fired on a clean row" in detail


def test_entry_point_prints_the_matrix_line(capsys, monkeypatch):
    monkeypatch.setattr(matrix, "_setup_env", lambda device=None: None)
    assert matrix.main(["--only", "serve-wedge,serve-backoff-storm", "--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    line = json.loads(last)["chaos_matrix"]
    assert line["scenarios"] == line["passed"] == 2 and line["failed"] == []
    monkeypatch.setitem(matrix.SCENARIOS, "serve-wedge", lambda tmp: (False, "stub"))
    assert matrix.main(["--only", "serve-wedge", "--device", "cpu"]) == 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "chaos_matrix"]["failed"] == ["serve-wedge"]
