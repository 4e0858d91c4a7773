"""The port's twin of __graft_entry__.dryrun_multichip
(tpu_pbrt_torch/parallel/dryrun.py) over two gloo CPU ranks: the Cornell
box under `path` at 32x32x8 and a mesh SPPM step, every rank holding the
same films; the `path` leg against the port's one-device render (rays
equal, rtol 1e-4, atol 1e-5, the reference's multi-device tolerances)."""

import numpy as np
import torch

from tpu_pbrt_torch.parallel.dryrun import dryrun_multichip
from tpu_pbrt_torch.scenes import compile_api, make_cornell

torch.set_num_threads(1)


def test_dryrun_twin_passes():
    out = dryrun_multichip(2, device="cpu")
    assert out["path"][0] > 0 and out["sppm"][0] > 0
    scene, integ = compile_api(make_cornell(res=32, spp=8, integrator="path", maxdepth=3,
                                            device="cpu"))
    solo = integ.render(scene)
    assert out["path"][0] == solo.rays_traced
    np.testing.assert_allclose(out["path"][1], solo.image, rtol=1e-4, atol=1e-5)
