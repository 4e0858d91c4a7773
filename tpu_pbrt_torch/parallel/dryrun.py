"""A dry run of the render over a mesh (the port's twin of
__graft_entry__.py::dryrun_multichip): the Cornell box under `path` at
32x32, 8 spp, maxdepth 3, its work split over the ranks and its film
all-reduced, then a mesh SPPM step (pixels and photons sharded, the
photon deposits all-gathered) at 16x16, 2 iterations of 1,024 photons,
so the splat-plane path crosses the mesh too. Each leg must render a
finite, non-black image of its shape on every rank.

    python -m tpu_pbrt_torch.parallel.dryrun [N] [--device cuda|cpu] [--share-device]

N = 2 by default. On cards (the default device) one rank per card
(NCCL), or every rank on one card with --share-device (gloo); without a
card it fails unless asked for the CPU (`--device cpu`: N gloo CPU
ranks).
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional


def _rank(mesh) -> dict:
    import numpy as np

    from tpu_pbrt_torch.scenes import compile_api, make_cornell

    scene, integ = compile_api(make_cornell(res=32, spp=8, integrator="path", maxdepth=3,
                                            device=mesh.device))
    result = integ.render(scene, mesh=mesh)
    assert result.image.shape == (32, 32, 3)
    assert np.isfinite(result.image).all()
    assert float(result.image.max()) > 0.0, "dry run rendered a black image"

    scene2, integ2 = compile_api(make_cornell(res=16, spp=2, integrator="sppm", maxdepth=2,
                                              device=mesh.device))
    integ2.n_iterations = 2
    integ2.photons_per_iter = 1024
    result2 = integ2.render(scene2, mesh=mesh)
    assert result2.image.shape == (16, 16, 3)
    assert np.isfinite(result2.image).all()
    assert float(result2.image.max()) > 0.0, "mesh SPPM rendered black"
    return {"path": (result.rays_traced, result.image), "sppm": (result2.rays_traced,
                                                                 result2.image)}


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     share_device: bool = False) -> dict:
    """Both legs over `n_devices` ranks on `device` (CUDA unless the
    caller names the CPU; no card raises); returns rank 0's
    {"path" | "sppm": (rays, image)}. Every rank must hold the same
    images (the film is replicated)."""
    import numpy as np

    from tpu_pbrt_torch.config import resolve_device
    from tpu_pbrt_torch.parallel.mesh import launch

    device = resolve_device(device).type
    results = launch(_rank, n_devices, device=device, share_device=share_device,
                     threads=1 if device == "cpu" else None)
    for r in results[1:]:
        for leg in ("path", "sppm"):
            assert r[leg][0] == results[0][leg][0]
            assert np.array_equal(r[leg][1], results[0][leg][1]), f"{leg}: the ranks' films differ"
    return results[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m tpu_pbrt_torch.parallel.dryrun")
    p.add_argument("n", nargs="?", type=int, default=2, help="ranks (default 2)")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu (gloo ranks)")
    p.add_argument("--share-device", action="store_true",
                   help="every rank on cuda:0 (gloo), for a one-card machine")
    args = p.parse_args(argv)
    from tpu_pbrt_torch.config import resolve_device

    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"dryrun: {e} (on the command line: --device cpu)", file=sys.stderr)
        return 1
    out = dryrun_multichip(args.n, args.device, args.share_device)
    print(f"dryrun over {args.n} ranks: path {out['path'][0]} rays, sppm {out['sppm'][0]} rays")
    return 0


if __name__ == "__main__":
    sys.exit(main())
