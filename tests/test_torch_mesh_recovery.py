"""Recovery and resume over a mesh of ranks on the CPU (gloo), each held
bit for bit to the undisturbed render of the same mesh width (a mesh
film equals the one-device film only to the order of its additions):

- `mesh:lost@chunk=1` (the chaos seam that fires on every rank at the
  same chunk): the recovery ladder rolls every rank back to the
  checkpoint rank 0 wrote, and the re-dispatch ends bit-identical;
- a render killed while dispatching chunk 2 on every rank, then resumed
  from rank 0's checkpoint file, ends bit-identical;
- a failure on rank 1 alone (a device error inside its drain of chunk 1,
  or the chaos seam firing there before its step): the ranks agree on
  the chunk's outcome, roll back together, and end bit-identical;
- `directlighting` over four ranks renders, and matches the port's
  one-device render at the reference's multi-device tolerances.
"""

import os

import numpy as np
import pytest
import torch

from tpu_pbrt_torch.config import cfg
from tpu_pbrt_torch.parallel.mesh import launch
from tpu_pbrt_torch.scenes import compile_api, make_cornell

torch.set_num_threads(1)

CHUNK = 1024


class _Stop(Exception):
    pass


def _recoveries(mesh, ckpt_dir):
    from tpu_pbrt_torch.chaos import CHAOS
    from tpu_pbrt_torch.integrators.common import ChunkPlan
    from tpu_pbrt_torch.utils.clock import VirtualClock

    cfg.regen = True
    scene, integ = compile_api(make_cornell(res=24, spp=8, integrator="path", maxdepth=3,
                                            device=mesh.device))
    integ.clock = VirtualClock()
    clean = integ.render(scene, mesh=mesh, chunk=CHUNK)
    CHAOS.install("mesh:lost@chunk=1")
    try:
        lost = integ.render(scene, mesh=mesh, chunk=CHUNK, checkpoint_every=1,
                            checkpoint_path=os.path.join(ckpt_dir, "lost.npz"))
    finally:
        CHAOS.clear()

    real = ChunkPlan.dispatch

    def stop_at_2(plan, state, c):
        if c == 2:
            raise _Stop
        return real(plan, state, c)

    path = os.path.join(ckpt_dir, "killed.npz")
    ChunkPlan.dispatch = stop_at_2
    try:
        integ.render(scene, mesh=mesh, chunk=CHUNK, checkpoint_path=path, checkpoint_every=1)
        raise AssertionError("the render was not stopped")
    except _Stop:
        pass
    finally:
        ChunkPlan.dispatch = real
    mesh.barrier()  # rank 0's deferred checkpoint writes have landed
    from tpu_pbrt_torch.parallel.checkpoint import load_checkpoint

    cursor = load_checkpoint(path)[1]
    resumed = integ.render(scene, mesh=mesh, chunk=CHUNK, checkpoint_path=path,
                           checkpoint_every=1)

    # rank 1 alone: a device error inside its drain of chunk 1 (the
    # second pool_chunk call), once
    real_pool = integ.pool_chunk
    calls = []

    def device_error_on_rank_1(*a, **kw):
        calls.append(1)
        if mesh.rank == 1 and len(calls) == 2:
            raise torch.AcceleratorError("injected device error on rank 1")
        return real_pool(*a, **kw)

    integ.pool_chunk = device_error_on_rank_1
    try:
        device_error = integ.render(scene, mesh=mesh, chunk=CHUNK, checkpoint_every=1,
                                    checkpoint_path=os.path.join(ckpt_dir, "dev.npz"))
    finally:
        del integ.pool_chunk

    # rank 1 alone: the chaos seam fires before its step of chunk 1
    from tpu_pbrt_torch.integrators.common import ChunkDispatchError

    def seam_on_rank_1(c, attempt):
        if mesh.rank == 1 and c == 1 and attempt == 0:
            raise ChunkDispatchError("injected on rank 1", poisons_state=True)

    CHAOS.register_hook(seam_on_rank_1)
    try:
        seam = integ.render(scene, mesh=mesh, chunk=CHUNK, checkpoint_every=1,
                            checkpoint_path=os.path.join(ckpt_dir, "seam.npz"))
    finally:
        CHAOS.clear()
    return {k: (r.image, r.rays_traced, r.stats) for k, r in
            (("clean", clean), ("lost", lost), ("resumed", resumed),
             ("device_error", device_error), ("seam", seam))} | {"cursor": cursor}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return launch(_recoveries, 2, args=(str(tmp_path_factory.mktemp("mesh_ckpt")),),
                  device="cpu", threads=1)


@pytest.mark.parametrize("case", ["lost", "resumed", "device_error", "seam"])
def test_recovery_equals_the_undisturbed_mesh_render(ranks, case):
    for r in ranks:
        img, rays, stats = r[case]
        cimg, crays, cstats = r["clean"]
        assert cstats["chunks"] == 5
        assert rays == crays
        np.testing.assert_array_equal(img, cimg)
        ctr = {k: v for k, v in stats["telemetry"]["counters"].items()
               if k not in ("chunks_redispatched", "retry_backoff_ms")}  # the retry's own
        assert ctr == cstats["telemetry"]["counters"]
    np.testing.assert_array_equal(ranks[0][case][0], ranks[1][case][0])


def test_lost_mesh_rolled_back_and_resume_started_at_its_cursor(ranks):
    for r in ranks:
        rec = r["lost"][2]["recovery"]
        assert rec["redispatches"] == 1 and rec["rollbacks"] == 1
        assert r["cursor"] == 2
        assert "recovery" not in r["resumed"][2]


@pytest.mark.parametrize("case", ["device_error", "seam"])
def test_one_rank_failure_rolls_every_rank_back_together(ranks, case):
    for r in ranks:
        rec = r[case][2]["recovery"]
        assert rec["redispatches"] == 1 and rec["rollbacks"] == 1


def _direct(mesh):
    scene, integ = compile_api(make_cornell(res=16, spp=4, device=mesh.device))
    res = integ.render(scene, mesh=mesh)
    return res.image, res.rays_traced, res.stats["mesh"]


def test_directlighting_over_four_ranks():
    out = launch(_direct, 4, device="cpu", threads=1)
    scene, integ = compile_api(make_cornell(res=16, spp=4, device="cpu"))
    solo = integ.render(scene)
    for img, rays, m in out:
        assert m["ranks"] == 4 and rays == solo.rays_traced
        np.testing.assert_array_equal(img, out[0][0])
    np.testing.assert_allclose(out[0][0], solo.image, rtol=1e-4, atol=1e-5)
    assert solo.image.mean() > 0.01
