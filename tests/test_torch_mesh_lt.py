"""The light-transport integrators over two gloo CPU ranks against the
port's one-device render (the reference's multi-device legs fail under
the jax of this repository's test machine; the port's one-device renders
are held to the reference by the goldens):

- `bdpt` (the fixed batch; its t = 1 splats ride the film all-reduce):
  rays equal, rtol 1e-4, atol 1e-5;
- `sppm` (pixels and photons sharded by their global ids, the deposits
  all-gathered, the largest radius a max all-reduce): within
  tests/test_sppm.py's multi-device bounds, max relative difference
  below 2e-2 and mean below 2e-3;
- `mlt` (the chains sharded by their global ids, the splat plane
  all-reduced at the end of every block of 16 steps): within
  tests/test_mlt.py's, mean below 1e-3 and max relative below 1e-2.
"""

import numpy as np
import pytest
import torch

from tpu_pbrt_torch.parallel.mesh import launch
from tpu_pbrt_torch.scenes import compile_api, make_caustic_like, make_cornell

torch.set_num_threads(1)

SPPM_PARAMS = '"integer numiterations" [2] "integer photonsperiteration" [4096] "float radius" [0.1]'


def _render(kind, mesh=None, device="cpu"):
    if kind == "sppm":
        scene, integ = compile_api(make_caustic_like(res=16, spp=1, integrator="sppm",
                                                     params=SPPM_PARAMS, n_theta=12, n_phi=24,
                                                     device=device))
    elif kind == "mlt":
        scene, integ = compile_api(make_cornell(res=16, spp=1, integrator="mlt", maxdepth=3,
                                                device=device))
        integ.n_bootstrap, integ.n_chains, integ.mutations_per_pixel = 1024, 256, 16
    else:
        scene, integ = compile_api(make_cornell(res=12, spp=4, integrator="bdpt", maxdepth=3,
                                                device=device))
    res = integ.render(scene, mesh=mesh)
    return res.image, res.rays_traced, res.stats


def _suite(mesh):
    return {kind: _render(kind, mesh, mesh.device) for kind in ("bdpt", "sppm", "mlt")}


@pytest.fixture(scope="module")
def ranks():
    return launch(_suite, 2, device="cpu", threads=1)


@pytest.mark.parametrize("kind", ["bdpt", "sppm", "mlt"])
def test_light_transport_over_two_ranks_matches_one_device(ranks, kind):
    img, rays, stats = ranks[0][kind]
    np.testing.assert_array_equal(img, ranks[1][kind][0])
    assert stats["mesh"]["ranks"] == 2
    simg, srays, _ = _render(kind)
    assert img.mean() > 0.001 and np.isfinite(img).all()
    assert rays == srays
    if kind == "bdpt":
        np.testing.assert_allclose(img, simg, rtol=1e-4, atol=1e-5)
    elif kind == "sppm":
        rel = np.abs(img - simg) / np.maximum(np.abs(simg), 1e-3)
        assert rel.max() < 2e-2 and rel.mean() < 2e-3
    else:
        assert abs(img.mean() - simg.mean()) / simg.mean() < 1e-3
        assert np.abs(img - simg).max() / simg.max() < 1e-2
