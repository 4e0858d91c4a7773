"""The direct-lighting family on the CPU: `estimate_direct`, the
`directlighting`, `whitted` and `ao` integrators and the CLI on the
repository's Cornell box, against the JAX package.

- `estimate_direct` (integrators/common.py) against the reference's eager
  call on the same camera rays' first vertices, on the small Cornell box
  (the brute feature intersector), the small killeroo (the stream
  tracer: the any-hit shadow wave and the closest-hit BSDF wave) and the
  small crown of make_golden.py (glass and metal under its sky, the
  environment branch), for light_idx=None (one light through the light
  distribution) and for per-lane rows that cycle through every light
  row. Tolerance: the same
  lanes nonzero, values within atol 2e-6 (measured up to 6.6e-7: the
  camera directions differ by an ulp where XLA's and PyTorch's
  transcendentals round apart, and it carries through). Also on the null
  quad of tests/test_media.py, whose shadow rays walk through the quad
  in up to 4 segments (vis_segments), to the same tolerance.
- Renders through the fixed-batch chunk loop, against the JAX CPU
  goldens of tests/torch_golden/make_golden.py (`DIRECT_CASES`: the small
  Cornell box under directlighting "all" and "one", ao; the small
  killeroo under directlighting and ao): MSE <= 1e-10 (the streams are
  pure functions of the work item, so only float order differs) and the
  traced-ray count exact. The port stops the bounce loop once no lane is
  alive, which the exact ray count and image show changes nothing.
- `whitted` equals `directlighting`/"all" bit for bit, whatever strategy
  the scene names; an unknown strategy warns and takes "all"; more than
  16 lights under "all" fall back to "one" with a warning.
- `python -m tpu_pbrt_torch.main scenes/cornell-box.pbrt --quick
  --device cpu` renders the repository's own scene file.
"""

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

import torch

from tpu_pbrt import config as jconfig
from tpu_pbrt.integrators.direct import DirectLightingIntegrator as JDirect
from tpu_pbrt.scene.paramset import ParamSet as JParamSet
from tpu_pbrt_torch import main as cli
from tpu_pbrt_torch import scenes as tscenes
from tpu_pbrt_torch.config import cfg as tcfg
from tpu_pbrt_torch.integrators import common as tcommon
from tpu_pbrt_torch.integrators.direct import DirectLightingIntegrator as TDirect
from tpu_pbrt_torch.scene import api
from tpu_pbrt_torch.scene.paramset import ParamSet as TParamSet
from tpu_pbrt_torch.utils import error as terror
from tpu_pbrt_torch.utils.imageio import read_pfm

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "torch_golden")
sys.path.insert(0, GOLDEN)
from make_golden import DIRECT_CASES, LEAF_TRIS, configure, direct_case_api  # noqa: E402

CORNELL_FILE = os.path.join(os.path.dirname(HERE), "scenes", "cornell-box.pbrt")


@pytest.fixture
def small_treelets(monkeypatch):
    """The goldens' 64-triangle treelets, on both packages."""
    monkeypatch.setenv("TPU_PBRT_LEAF_TRIS", str(LEAF_TRIS))
    monkeypatch.setattr(tcfg, "leaf_tris", LEAF_TRIS)
    jconfig.reload()
    yield
    monkeypatch.undo()
    jconfig.reload()


def _port(name):
    return tscenes.compile_api(direct_case_api(tscenes, name, dict(device="cpu")))


@pytest.fixture(scope="module")
def direct_estimate():
    """The reference's estimate_direct on each scene's chunk of camera hits
    (tests/torch_golden/make_module_reference.py direct)."""
    return np.load(os.path.join(GOLDEN, "direct_estimate.npz"))


@pytest.mark.parametrize("name", ["cornell_direct", "killeroo_direct", "crown_small"])
def test_estimate_direct_matches_reference(name, small_treelets, tmp_path, direct_estimate):
    """estimate_direct on one chunk of camera hits, with every light and
    with one light row per lane, against the reference's stored outputs on
    the same scene and sample streams: the same lanes lit (every row
    lighting some), radiance within 2e-6."""
    from make_module_reference import direct_api

    st, it_ = tscenes.compile_api(direct_api("tpu_pbrt_torch", name, str(tmp_path),
                                             device="cpu"))
    assert ("tstream" in st.dev) == (name != "cornell_direct")
    assert ("envmap" in st.dev) == (name == "crown_small")
    plan = it_.prepare_chunks(st)
    assert plan.chunk == int(direct_estimate[f"{name}_chunk"])
    x0, x1, y0, _ = plan.bounds
    k = np.arange(plan.chunk, dtype=np.int32)
    _, pxt, pyt, s_t, _, ot, dt, _ = it_.work_to_rays(
        st.camera, plan.spp, x0, y0, x1 - x0, plan.npix, 0, 0, torch.from_numpy(k))
    itt = tcommon.make_interaction(st.dev, tcommon.scene_intersect(st.dev, ot, dt, float("inf")),
                                   ot, dt)
    mpt = it_.mat_at(st.dev, itt)
    n_l = st.n_lights
    assert n_l == int(direct_estimate[f"{name}_n_lights"])
    rows = (k % n_l).astype(np.int32)
    for tag, idx_t, extra in (("all", None, 0), ("row", torch.from_numpy(rows), 1000)):
        a = direct_estimate[f"{name}_{tag}"]
        b = tcommon.estimate_direct(
            st.dev, it_.light_distr, itt, mpt, pxt, pyt, s_t, 0, light_idx=idx_t,
            salt_extra=extra, sampler=(it_.skind, it_.spp)).numpy()
        lit = a.max(-1) > 0
        assert lit.sum() > 100
        if idx_t is not None:  # every row lights some lane
            assert set(rows[lit]) == set(range(n_l))
        np.testing.assert_array_equal(b.max(-1) > 0, lit)
        np.testing.assert_allclose(b, a, rtol=0, atol=2e-6)


@pytest.mark.parametrize("name", list(DIRECT_CASES))
def test_render_matches_jax_golden(name, small_treelets):
    ref = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    scene, integ = _port(name)
    assert scene.n_tris == int(ref["n_tris"])
    res = integ.render(scene)
    img, want = res.image, ref["image"]
    assert img.shape == want.shape and np.isfinite(img).all() and want.mean() > 0.01
    assert res.rays_traced == int(ref["rays_traced"])
    assert float(np.mean((img.astype(np.float64) - want) ** 2)) <= 1e-10
    modes = res.stats["wave_modes"]
    if "tstream" in scene.dev:
        # every shadow ray went through the stream tracer's any-hit waves
        n_any = scene.n_lights if DIRECT_CASES[name][1] == "directlighting" else 1
        assert modes["any_hit"]["waves"] == n_any and modes["closest_hit"]["waves"] > 0
        assert res.stats["n_drop"] == 0
    else:
        assert modes == {}  # the brute intersector traces no stream wave


def test_whitted_equals_directlighting_all():
    api_d = tscenes.make_cornell(res=16, spp=4, device="cpu")
    d_scene, d_integ = tscenes.compile_api(api_d)
    api_w = configure(tscenes.make_cornell(res=16, spp=4, device="cpu"), "whitted",
                      (("string strategy", ["one"]),))
    w_scene, w_integ = tscenes.compile_api(api_w)
    assert (d_integ.strategy, w_integ.strategy) == ("all", "all")
    a, b = d_integ.render(d_scene), w_integ.render(w_scene)
    assert np.array_equal(a.image, b.image) and a.rays_traced == b.rays_traced


@pytest.mark.parametrize("n_lights,strategy", [(1, "all"), (16, "all"), (17, "all"),
                                               (17, "one"), (3, "bogus")])
def test_strategy_selection_matches_reference(n_lights, strategy):
    """An unknown strategy warns and takes "all"; "all" over more than 16
    lights warns and falls back to "one"; as in the reference."""
    scene = SimpleNamespace(light_distribution_name="power", spatial_distr=None,
                            light_distr=None, has_null_materials=False, n_lights=n_lights,
                            sampler=SimpleNamespace(name="zerotwosequence", spp=4))
    got = []
    for cls, params in ((JDirect, JParamSet()), (TDirect, TParamSet())):
        params.add("string strategy", [strategy])
        n0 = terror._n_warnings
        integ = cls(params, scene, None)
        got.append((integ.strategy, integ.n_light_loop))
    assert got[0] == got[1]
    assert terror._n_warnings - n0 == (strategy == "bogus") + (n_lights > 16 and strategy != "one")


def test_unoccluded_walk_through_null_interfaces_is_not_ported(direct_estimate):
    """(Named when the walk raised.) The walk is ported: on the null quad
    of tests/test_media.py under directlighting, estimate_direct's shadow
    rays cross the quad in up to 4 segments (vis_segments, set by the
    scene's null surfaces), as the reference's do (its stored outputs):
    the same lanes lit, values within 2e-6."""
    from make_module_reference import null_quad_api

    st, it_ = tscenes.compile_api(null_quad_api("tpu_pbrt_torch", device="cpu"))
    assert st.has_null_materials and it_.vis_segments == 4
    assert int(direct_estimate["null_quad_vis_segments"]) == 4
    plan = it_.prepare_chunks(st)
    x0, x1, y0, _ = plan.bounds
    k = np.arange(plan.total, dtype=np.int32)
    _, pxt, pyt, s_t, _, ot, dt, _ = it_.work_to_rays(
        st.camera, plan.spp, x0, y0, x1 - x0, plan.npix, 0, 0, torch.from_numpy(k))
    itt = tcommon.make_interaction(st.dev, tcommon.scene_intersect(st.dev, ot, dt, float("inf")),
                                   ot, dt)
    a = direct_estimate["null_quad_all"]
    b = tcommon.estimate_direct(st.dev, it_.light_distr, itt, it_.mat_at(st.dev, itt),
                                pxt, pyt, s_t, 0, vis_segments=4,
                                sampler=(it_.skind, it_.spp)).numpy()
    lit = a.max(-1) > 0
    assert lit.mean() > 0.2
    np.testing.assert_array_equal(b.max(-1) > 0, lit)
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-6)


def test_cli_renders_the_cornell_box_file(tmp_path, monkeypatch):
    results = []
    real = api.render_file

    def render_file(*a, **kw):
        results.append(real(*a, **kw))
        return results[-1]

    monkeypatch.setattr(api, "render_file", render_file)
    out = str(tmp_path / "cornell.pfm")
    rc = cli.main([CORNELL_FILE, "--quick", "--device", "cpu", "-o", out, "--quiet"])
    assert rc == 0 and len(results) == 1
    res = results[0]
    # --quick: a quarter of the file's 256x256 and 16 spp
    assert res.image.shape == (64, 64, 3) and res.spp == 4 and np.isfinite(res.image).all()
    assert 0.05 < res.image.mean() < 1.0
    assert np.array_equal(read_pfm(out), res.image)
    assert "regen" not in res.stats  # the fixed batch: directlighting's render path
