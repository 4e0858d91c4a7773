"""The whole slice on the CPU: the small killeroo (528 mesh triangles, so
the stream tracer, cut into 64-triangle treelets) rendered by the port's
fixed-batch loop (TORCH_PBRT_REGEN=0, the fused camera+shadow layout)
against the JAX package's render of the same scene with the fixed-batch
loop (TPU_PBRT_REGEN=0). The persistent pool, the default render path,
is held against the JAX pool render in tests/test_torch_pool.py.

The JAX render takes longer here than this file's budget, so its image
is read from tests/torch_golden/killeroo_small.npz, written by
tests/torch_golden/make_golden.py (which records the JAX commit).

Tolerances: every sample stream is a pure function of (pixel, sample,
dimension), so the two images differ only by float summation order
(measured: MSE 4.4e-15, max |diff| 6e-7). MSE <= 1e-10 and >= 99% of
pixel channels within 1e-5 leave room for a rare near-tie flip of one
sample's triangle at a shared edge; the traced-ray count must be exact.
"""

import os

import numpy as np
import pytest

from tpu_pbrt_torch.config import cfg as tcfg
from tpu_pbrt_torch.scenes import compile_api, make_killeroo_like

GOLDEN = os.path.join(os.path.dirname(__file__), "torch_golden", "killeroo_small.npz")
SMALL = dict(res=16, spp=4, n_theta=12, n_phi=24, maxdepth=5)


def test_small_killeroo_matches_jax_render(monkeypatch):
    ref = np.load(GOLDEN)
    monkeypatch.setattr(tcfg, "leaf_tris", 64)
    monkeypatch.setattr(tcfg, "regen", False)
    scene, integ = compile_api(make_killeroo_like(**SMALL, device="cpu"))
    assert scene.n_tris == int(ref["n_tris"])
    assert scene.dev["tstream"].n_treelets == int(ref["n_treelets"])
    res = integ.render(scene)
    img, want = res.image, ref["image"]
    assert img.shape == want.shape == (16, 16, 3) and np.isfinite(img).all()
    assert res.stats["waves"] > 0  # the stream tracer ran
    assert res.rays_traced == int(ref["rays_traced"])
    assert float(np.mean((img - want) ** 2)) <= 1e-10
    assert np.mean(np.abs(img - want) <= 1e-5) >= 0.99
    assert res.mray_per_sec > 0 and res.seconds > 0


def test_render_result_counts_rays_per_wave(monkeypatch):
    """rays_traced counts one ray per live lane per bounce plus one shadow
    ray per NEE sample, as the reference does: at maxdepth 0 the camera
    vertex neither samples a light nor continues, so a render traces
    exactly one ray per camera sample. The fixed batch traces the fused
    layout, so that is ONE 2R wave (camera rays + an all-dead shadow
    half): no shadow ray is left pending, so no second wave runs."""
    monkeypatch.setattr(tcfg, "leaf_tris", 64)
    monkeypatch.setattr(tcfg, "regen", False)
    kw = {**SMALL, "res": 8, "spp": 1, "maxdepth": 0}
    scene, integ = compile_api(make_killeroo_like(**kw, device="cpu"))
    res = integ.render(scene)
    assert res.rays_traced == 8 * 8
    assert res.stats["waves"] == 1 and res.stats["chunks"] == 1
