"""The scene-breadth stand-in rendered by the port on the CPU against the
JAX package's CPU renders (tests/torch_golden/breadth_*.npz, written by
`make_golden.py breadth`).

The scene is `tpu_pbrt_torch.scenes.make_breadth_like` at its small
tessellation (`BREADTH_SMALL`: eight `ObjectInstance`s of a 528-triangle
PLY blob, a 17x17 `heightfield2`, the five quadrics, a level-2
`loopsubdiv` tetrahedron and 16 `curve` strands, 12,608 triangles in
64-triangle treelets; the spot, goniometric, projection and infinite
lights) at 16x16, 4 spp, `path` at maxdepth 5 through the persistent
pool with 256 slots, once per camera and filter: perspective + gaussian,
realistic (the built-in doublet) + mitchell, orthographic + triangle,
environment + sinc. The reference declares the blob as the
`trianglemesh` of the arrays read back from the PLY file (its `plymesh`
cannot compile). The traced rays and the pool's waves must equal the
reference's; the image MSE must stay within BREADTH_TOL (measured:
1.7e-14, 8.7e-15, 2.1e-16 and 6.8e-16), the f32 sums of the wide filter
footprints and the lens trace rounding apart from XLA's by an ulp.
"""

import os

import numpy as np
import pytest
import torch

from tpu_pbrt_torch.config import cfg as tcfg
from tpu_pbrt_torch.scenes import BREADTH_SMALL, compile_api, make_breadth_like

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "torch_golden")
#: golden -> (camera, filter) (make_golden.py's BREADTH_CASES)
CASES = {
    "breadth_perspective": ("perspective", "gaussian"),
    "breadth_realistic": ("realistic", "mitchell"),
    "breadth_orthographic": ("orthographic", "triangle"),
    "breadth_environment": ("environment", "sinc"),
}
#: the image MSE bound against each golden
BREADTH_TOL = 1e-12


@pytest.mark.parametrize("name", sorted(CASES))
def test_breadth_matches_golden(name, monkeypatch):
    camera, filt = CASES[name]
    for k, v in dict(leaf_tris=64, regen=True, pool=256).items():
        monkeypatch.setattr(tcfg, k, v)
    scene, integ = compile_api(make_breadth_like(16, 4, camera=camera, filter=filt,
                                                 **BREADTH_SMALL, device="cpu"))
    res = integ.render(scene)
    ref = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    assert scene.n_tris == int(ref["n_tris"]) == 12608 and "tstream" in scene.dev
    assert res.image.shape == (16, 16, 3) and np.isfinite(res.image).all()
    assert res.stats["regen"] and res.stats["pool"] == 256 and res.stats["n_drop"] == 0
    assert res.rays_traced == int(ref["rays_traced"])
    assert res.stats["n_waves"] == int(ref["n_waves"])
    mse = float(np.mean((res.image.astype(np.float64) - ref["image"]) ** 2))
    assert mse <= BREADTH_TOL, mse
    assert res.image.mean() > 0.01
