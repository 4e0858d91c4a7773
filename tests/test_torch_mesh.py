"""The render over a mesh of ranks (tpu_pbrt_torch/parallel/mesh.py) on
the CPU: two gloo ranks, each a spawned process, against the port's own
one-device render. The reference's multi-device renders fail under the
jax of this repository's test machine, and the port's one-device renders
are held to the reference by the goldens, so the mesh is held to the
port's one-device render at the reference's own multi-device tolerances
(tests/test_distributed.py: rays equal, rtol 1e-4, atol 1e-5).

- `path` on the Cornell box, 24x24x8, maxdepth 3, in chunks of 2,048
  work items (1,024 a rank), through the persistent pool and through
  the fixed batch; both ranks hold the same film.
- The per-rank wave spread: one entry per rank, summing to the pool's
  waves; one film all-reduce per chunk.
- `resolve_mesh` wider than the live group renders on one device, with
  its warning and the `mesh_devices` gauge at 1.

The dry run is tests/test_torch_mesh_dryrun.py, the recoveries and the
four-rank `directlighting` tests/test_torch_mesh_recovery.py, and BDPT,
SPPM and MLT tests/test_torch_mesh_lt.py.
"""

import numpy as np
import pytest
import torch

from tpu_pbrt_torch.config import cfg
from tpu_pbrt_torch.parallel.mesh import launch
from tpu_pbrt_torch.scenes import compile_api, make_cornell

torch.set_num_threads(1)

CHUNK = 2048
RTOL, ATOL = 1e-4, 1e-5


def _cornell(device):
    return compile_api(make_cornell(res=24, spp=8, integrator="path", maxdepth=3, device=device))


def _suite(mesh):
    """Rank side: the pool and the fixed batch over the mesh."""
    scene, integ = _cornell(mesh.device)
    out = {}
    for regen in (True, False):
        cfg.regen = regen
        res = integ.render(scene, mesh=mesh, chunk=CHUNK)
        out[regen] = (res.image, res.rays_traced, res.stats)
    return out


@pytest.fixture(scope="module")
def ranks():
    return launch(_suite, 2, device="cpu", threads=1)


@pytest.fixture(scope="module")
def solo():
    scene, integ = _cornell("cpu")
    out = {}
    saved = cfg.regen
    try:
        for regen in (True, False):
            cfg.regen = regen
            res = integ.render(scene, chunk=CHUNK)
            out[regen] = (res.image, res.rays_traced, res.stats)
    finally:
        cfg.regen = saved
    return out


@pytest.mark.parametrize("regen", [True, False], ids=["pool", "fixed"])
def test_path_over_two_ranks_matches_one_device(ranks, solo, regen):
    img, rays, stats = ranks[0][regen]
    img1, rays1, _ = ranks[1][regen]
    simg, srays, sstats = solo[regen]
    assert rays == rays1 == srays
    np.testing.assert_array_equal(img, img1)
    np.testing.assert_allclose(img, simg, rtol=RTOL, atol=ATOL)
    assert img.mean() > 0.01
    assert stats.get("regen", False) == regen == sstats.get("regen", False)
    m = stats["mesh"]
    assert (m["ranks"], m["backend"], m["chunk_per_rank"]) == (2, "gloo", CHUNK // 2)
    assert len(m["allreduce_ms"]) == stats["chunks"] == 3


def test_wave_spread_has_one_entry_per_rank(ranks, solo):
    stats = ranks[0][True][2]
    spread = stats["telemetry"]["wave_spread"]
    assert len(spread["per_device_waves"]) == 2
    assert sum(spread["per_device_waves"]) == stats["n_waves"]
    assert min(spread["per_device_waves"]) > 0
    # the counters are the chunk totals: every work item deposited once
    assert stats["telemetry"]["counters"]["rays_traced"] == ranks[0][True][1]
    assert ranks[1][True][2]["telemetry"] == stats["telemetry"]


def test_resolve_mesh_wider_than_the_group_degrades(recwarn):
    from tpu_pbrt_torch.obs.metrics import METRICS
    from tpu_pbrt_torch.parallel.mesh import resolve_mesh

    assert resolve_mesh((4,), device="cpu") is None
    assert METRICS.gauge("mesh_devices").value() == 1
    assert resolve_mesh((2, 2), device="cpu") is None
    assert resolve_mesh(None) is None
    assert METRICS.gauge("mesh_devices").value() == 1


def test_resolve_mesh_warns():
    from tpu_pbrt_torch.parallel.mesh import resolve_mesh
    from tpu_pbrt_torch.utils import error

    before = error._n_warnings
    resolve_mesh((3,), device="cpu")
    assert error._n_warnings == before + 1
    resolve_mesh((1,), device="cpu")  # one device asked for: nothing to warn about
    assert error._n_warnings == before + 1
