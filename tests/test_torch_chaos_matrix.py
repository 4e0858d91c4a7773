"""The port's recovery matrix (`python -m tpu_pbrt_torch.chaos`) on the
CPU, its rows under the reference's names (tpu_pbrt/chaos/__main__.py
SCENARIOS), each a case here: the render-loop rows (the device's own
tracer through a dispatch failure, the in-flight window, clean
re-dispatch, rollback, restart, torn / crashed / bit-flipped checkpoint
writes, the NaN wave under retry and under scrub, retry exhaustion and
its resume, a corrupt resume), each bit-identical to the undisturbed
render but `nan-wave-scrub` (a finite image, `nonfinite_deposits > 0`),
and each followed by the health watchdog's false-positive gate. The
mesh, serve and fleet rows are tests/test_torch_chaos_matrix_serve.py.
"""

import pytest
import torch

from tpu_pbrt.chaos import __main__ as ref_matrix
from tpu_pbrt_torch.chaos import __main__ as matrix

torch.set_num_threads(1)

RENDER_ROWS = ["fused-tracer", "pipeline", "clean-redispatch", "poison-rollback",
               "poison-restart", "torn-ckpt-fallback", "crash-ckpt-write",
               "bitflip-ckpt-fallback", "nan-wave-retry", "nan-wave-scrub",
               "exhaustion-emergency-resume", "corrupt-resume"]


@pytest.fixture(autouse=True)
def _on_the_cpu(monkeypatch):
    monkeypatch.setattr(matrix, "DEVICE", "cpu")


def test_list_names_the_reference_rows(capsys):
    assert matrix.main(["--list"]) == 0
    names = [ln.split(":", 1)[0] for ln in capsys.readouterr().out.splitlines()]
    assert names == list(ref_matrix.SCENARIOS) == list(matrix.SCENARIOS)
    assert matrix._WATCHDOG_ROWS == ref_matrix._WATCHDOG_ROWS
    assert set(RENDER_ROWS) | {"mesh-device-loss", "serve-wedge", "serve-backoff-storm",
                               "fleet-replica-kill", "fleet-router-restart"} == set(names)


@pytest.mark.parametrize("name", RENDER_ROWS)
def test_row_passes_on_the_cpu(name, tmp_path):
    ok, detail = matrix.run_row(name, str(tmp_path))
    assert ok, f"{name}: {detail}"
