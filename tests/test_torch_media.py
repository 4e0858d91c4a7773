"""Participating media, null interfaces and `volpath` on the CPU, against
the JAX package.

- Module parity (tpu_pbrt_torch/core/media.py against tpu_pbrt/core/
  media.py) on seeded numpy inputs handed to both: `hg_p` and
  `hg_sample` at g in {-0.6, 0, 5e-4 (the |g| < 1e-3 branch), 0.5, 0.9},
  `grid_density` on an 8^3 grid, `medium_tr` and `medium_sample` on a
  homogeneous table and on one with an 8^3 grid row (ratio and delta
  tracking). Booleans (in-medium) must match exactly; floats agree to
  RTOL relative + ATOL absolute (measured: at most 1.9e-7 relative, one
  or two ulps where XLA's and PyTorch's exp, log, sin and cos round
  apart). Delta tracking sums up to 256 logs, so its distances agree to
  T_RTOL relative (measured 6e-6).
- The shadow walk through null interfaces (`common.unoccluded_tr` with 4
  segments) against the reference's, on the null cube of
  tests/test_media.py (the brute intersector) and on the small cloud
  (the stream tracer): rays from inside and outside the medium, with
  their media. Visibility exact; transmittance to RTOL / ATOL.
- Renders against the JAX CPU goldens of tests/torch_golden/
  make_golden.py (`MEDIA_CASES`): the scene texts of tests/test_media.py
  (TestVolPath's three, TestNullInterface's volpath cube and path null
  quad, TestVolumeFurnace at g 0.5), a grid medium in the null cube and
  the small cloud. The reference compiles its chunk under `jit`, where
  XLA fuses multiplies into adds; the port rounds each. A path whose
  branch sits on a one-ulp edge can then go the other way: a cosine
  sample at a grazing angle, an in-medium test, and above all the
  reference's Russian roulette, whose survivor scale beta * (1 / (1 - q))
  leaves a beta of 1 or 1 - 2^-24 by the last bits of beta, which a
  second roll at the same depth (after a null crossing, or in a furnace
  whose every weight is 1) compares against 1. The reference's own eager
  run of vol_beer traces 3 rays fewer than its jit run. So each golden
  has a pinned bound on the traced-ray difference and on the MSE,
  GOLDEN_TOL (measured values beside them); the goldens without such
  edges match rays exactly, and so do the furnace and the small cloud
  with Russian roulette off (`_rr_off`), where about 4% and 2% of the
  paths roll on that edge with it on. Paths that carry no energy (a
  purely absorbing medium) are traced on, as in the reference: their
  flips move the ray count and not the image.
- The port alone, analytic: Beer-Lambert through an absorbing fog within
  5% (TestVolPath's scene), the scattering furnace within 8%, a null
  quad within 5% of the open scene; `path` on a scene with null
  surfaces takes the fixed batch (the split layout), not the pool.
"""

import os
import sys

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from tpu_pbrt import config as jconfig
from tpu_pbrt.core import media as jmd
from tpu_pbrt_torch import scenes as tscenes
from tpu_pbrt_torch.config import cfg as tcfg
from tpu_pbrt_torch.core import media as tmd
from tpu_pbrt_torch.integrators import common as tcommon
from tpu_pbrt_torch.scene.api import Options as TOptions
from tpu_pbrt_torch.scene.api import parse_string as tparse_string
from tpu_pbrt_torch.scene.api import pbrt_init as tpbrt_init

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "torch_golden")
sys.path.insert(0, GOLDEN)
from make_golden import (  # noqa: E402
    LEAF_TRIS,
    MEDIA_CASES,
    media_api,
    media_text,
)

N = 4096
RTOL, ATOL = 2e-6, 1e-7
T_RTOL = 2e-5
#: golden -> (MSE bound, traced-ray difference bound); measured in the comments
GOLDEN_TOL = {
    "vol_beer": (1e-14, 12),  # 4.9e-16; 6 of 6,613 rays (zero-energy paths)
    "vol_no_medium": (1e-14, 0),  # 3.6e-17
    "vol_fog_shadow": (1e-9, 6),  # 4.4e-11; 3 of 7,168 rays
    "null_cube_volpath": (1e-14, 0),  # 8.9e-16
    "null_quad_path": (1e-14, 0),  # 5.2e-16
    "furnace_g05": (3e-3, 10),  # 1.1e-3; 3 of 4,136 rays (the roulette's edge)
    "grid_null_cube": (1e-14, 0),  # 2.9e-16
    "cloud_small": (1e-3, 4),  # 3.7e-4; 1 of 6,633 rays (the roulette's edge)
    "furnace_g05_rr_off": (1e-12, 0),  # 4.8e-14
    "cloud_small_rr_off": (1e-10, 0),  # 2.7e-12
}


def _both(x):
    """The same numpy values as a JAX array and a torch tensor (copies)."""
    return jnp.asarray(np.array(x, copy=True)), torch.from_numpy(np.array(x, copy=True))


def _close(t, j, rtol=RTOL, atol=ATOL, what=""):
    np.testing.assert_allclose(t.numpy() if torch.is_tensor(t) else t, np.asarray(j),
                               rtol=rtol, atol=atol, err_msg=what)


def _dirs(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("g", [-0.6, 0.0, 5e-4, 0.5, 0.9])
def test_hg_p_matches_reference(g):
    rng = np.random.default_rng(1)
    mu = np.concatenate([np.linspace(-1, 1, 2001), rng.uniform(-1, 1, N)]).astype(np.float32)
    gg = np.full(mu.shape, g, np.float32)
    (mj, mt), (gj, gt) = _both(mu), _both(gg)
    _close(tmd.hg_p(mt, gt), jmd.hg_p(mj, gj), what=f"hg_p g={g}")
    # normalized over the sphere (pbrt's hg.cpp test), on the port alone
    x = np.linspace(-1, 1, 20001)
    p = tmd.hg_p(torch.from_numpy(x.astype(np.float32)),
                 torch.full((x.size,), g, dtype=torch.float32)).numpy()
    assert abs(2 * np.pi * np.trapezoid(p, x) - 1.0) < 1e-3


@pytest.mark.parametrize("g", [-0.6, 0.0, 5e-4, 0.5, 0.9])
def test_hg_sample_matches_reference(g):
    rng = np.random.default_rng(2)
    wo = _dirs(rng, N)
    u = rng.uniform(0, 1, (2, N)).astype(np.float32)
    gg = np.full(N, g, np.float32)
    (woj, wot), (gj, gt), (u1j, u1t), (u2j, u2t) = map(_both, (wo, gg, u[0], u[1]))
    wi_j, pdf_j = jmd.hg_sample(woj, gj, u1j, u2j)
    wi_t, pdf_t = tmd.hg_sample(wot, gt, u1t, u2t)
    _close(wi_t, wi_j, what=f"hg_sample wi g={g}")
    _close(pdf_t, pdf_j, what=f"hg_sample pdf g={g}")


def _tables(grid: bool):
    """A homogeneous row (coloured sigma) and, with `grid`, an 8^3 grid row
    placed on [-1, 1]^3: (JAX MediumTable, port MediumTable)."""
    rng = np.random.default_rng(3)
    rows = [dict(type=tmd.MEDIUM_HOMOGENEOUS, sa=np.array([0.05, 0.1, 0.2]),
                 ss=np.array([2.5, 1.0, 0.5]), g=0.5, grid=-1)]
    dens, w2m, stm = None, None, 0.0
    if grid:
        dens = rng.uniform(0, 1, (8, 8, 8)).astype(np.float32)
        rows.append(dict(type=tmd.MEDIUM_GRID, sa=np.full(3, 0.3), ss=np.full(3, 1.5), g=0.0,
                         grid=0))
        m2w = np.eye(4)
        m2w[:3, :3] *= 2
        m2w[:3, 3] = -1
        w2m, stm = np.linalg.inv(m2w).astype(np.float32), float(1.8 * dens.max())
    fields = tmd.medium_table_numpy(rows, dens, w2m, stm)
    return (jmd.MediumTable(*(jnp.asarray(np.array(f)) for f in fields)),
            tmd.MediumTable(*(torch.from_numpy(np.array(f)) for f in fields)))


def _segments(grid: bool):
    """Seeded rays in and around the media: o, d, t (some inf), medium id,
    pixel and sample ids."""
    rng = np.random.default_rng(4)
    o = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    d = _dirs(rng, N)
    t = rng.uniform(0, 4, N).astype(np.float32)
    t[::7] = np.inf
    med = rng.integers(-1, 2 if grid else 1, N).astype(np.int32)
    pix = rng.integers(0, 64, (2, N)).astype(np.int32)
    s = rng.integers(0, 16, N).astype(np.int32)
    return o, d, t, med, pix[0], pix[1], s


def test_grid_density_matches_reference():
    tj, tt = _tables(grid=True)
    p = np.random.default_rng(5).uniform(-1.2, 1.2, (N, 3)).astype(np.float32)
    pj, pt = _both(p)
    a, b = jmd.grid_density(tj, pj), tmd.grid_density(tt, pt)
    _close(b, a, what="grid_density")
    assert (np.asarray(a) > 0).mean() > 0.4 and (np.asarray(a) == 0).any()


@pytest.mark.parametrize("grid", [False, True], ids=["homogeneous", "grid"])
def test_medium_tr_matches_reference(grid):
    tj, tt = _tables(grid)
    o, d, t, med, px, py, s = _segments(grid)
    args = [_both(x) for x in (med, o, d, np.minimum(t, 5.0), px, py, s)]
    a = jmd.medium_tr(tj, *(x[0] for x in args), 40)
    b = tmd.medium_tr(tt, *(x[1] for x in args), 40)
    _close(b, a, what="medium_tr")
    assert (np.asarray(a) < 1).mean() > 0.3
    # a scene without media carries the reference's one-row empty table
    for x, y in zip(tmd.empty_medium_table(), jmd.empty_medium_table()):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("grid", [False, True], ids=["homogeneous", "grid"])
def test_medium_sample_matches_reference(grid):
    tj, tt = _tables(grid)
    o, d, t, med, px, py, s = _segments(grid)
    args = [_both(x) for x in (med, o, d, t, px, py, s)]
    a = jmd.medium_sample(tj, *(x[0] for x in args), 40)
    b = tmd.medium_sample(tt, *(x[1] for x in args), 40)
    np.testing.assert_array_equal(b.sampled_medium.numpy(), np.asarray(a.sampled_medium))
    assert 0.2 < np.asarray(a.sampled_medium).mean() < 0.8
    _close(b.t, a.t, rtol=T_RTOL if grid else RTOL, what="medium_sample t")
    _close(b.weight, a.weight, what="medium_sample weight")


@pytest.fixture
def small_treelets(monkeypatch):
    """The goldens' 64-triangle treelets, on both packages."""
    monkeypatch.setenv("TPU_PBRT_LEAF_TRIS", str(LEAF_TRIS))
    monkeypatch.setattr(tcfg, "leaf_tris", LEAF_TRIS)
    jconfig.reload()
    yield
    monkeypatch.undo()
    jconfig.reload()


def _port_api(name):
    return media_api(name, tparse_string, tpbrt_init, TOptions, tscenes.make_cloud_like,
                     device="cpu")


@pytest.mark.parametrize("name", ["null_cube_volpath", "cloud_small"])
def test_unoccluded_tr_walk_matches_reference(name, small_treelets):
    """unoccluded_tr on 1,024 seeded shadow rays (half inside the medium)
    against the reference's stored visibility and transmittance
    (tests/torch_golden/make_module_reference.py media)."""
    from make_module_reference import walk_inputs_tr

    st, _ = tscenes.compile_api(_port_api(name))
    assert st.has_null_materials and ("tstream" in st.dev) == (name == "cloud_small")
    ref = np.load(os.path.join(GOLDEN, "media_walk.npz"))
    vj, trj = ref[f"{name}_vis"], ref[f"{name}_tr"]
    vt, trt = tcommon.unoccluded_tr(st.dev, *(torch.from_numpy(x) for x in walk_inputs_tr()), 77,
                                    segments=4)
    np.testing.assert_array_equal(vt.numpy(), vj)
    if name == "cloud_small":  # the ground and the light quad occlude
        assert 0.2 < vj.mean() < 0.95
    else:  # nothing but null walls: every walk gets through
        assert vj.all()
    _close(trt, trj, what="unoccluded_tr tr")
    assert (trj[vj] < 0.99).mean() > 0.2  # the media attenuate


def _port_render(name):
    scene, integ = tscenes.compile_api(_port_api(name))
    return scene, integ.render(scene)


@pytest.mark.parametrize("name", MEDIA_CASES)
def test_render_matches_jax_golden(name, small_treelets):
    ref = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    scene, res = _port_render(name)
    assert scene.n_tris == int(ref["n_tris"])
    img, want = res.image, ref["image"]
    assert img.shape == want.shape and np.isfinite(img).all() and want.mean() > 0.01
    mse_max, rays_max = GOLDEN_TOL[name]
    assert float(np.mean((img.astype(np.float64) - want) ** 2)) <= mse_max
    assert abs(res.rays_traced - int(ref["rays_traced"])) <= rays_max
    # volpath and scenes with null surfaces render through the fixed batch
    assert "regen" not in res.stats and res.stats["n_drop"] == 0
    assert ("tstream" in scene.dev) == name.startswith(("furnace", "cloud"))


def test_beer_lambert_absorption():
    """TestVolPath's scene at its size: the centre pixels see the area
    light through an absorbing fog, Le exp(-sigma_a * 3)."""
    text = media_text("vol_beer").replace('"integer pixelsamples" [16]',
                                          '"integer pixelsamples" [512]')
    text = text.replace('"integer xresolution" [8] "integer yresolution" [8]',
                        '"integer xresolution" [16] "integer yresolution" [16]')
    img = tparse_string(text, render=True, device="cpu").result.image
    expected = 5.0 * np.exp(-0.4 * 3.0)
    assert abs(float(img[7:9, 7:9].mean()) - expected) / expected < 0.05


def test_furnace_and_null_quad_analytic():
    """The scattering furnace (g 0.5) sees the shell's L0 = 2 within 8%; a
    null quad between the light and the floor changes a `path` render by
    under 5%. Under the (0,2)-sequence `path` takes the persistent pool on
    the open scene and the fixed batch (the split layout) on the null one."""
    _, res = _port_render("furnace_g05")
    assert abs(float(res.image.mean()) - 2.0) / 2.0 < 0.08
    text = media_text("null_quad_path").replace('"halton"', '"zerotwosequence"')
    start = text.index('AttributeBegin\n  Material "none"')
    open_text = text[:start] + text[text.index("AttributeEnd", start) + len("AttributeEnd"):]
    null = tparse_string(text, render=True, device="cpu").result
    open_ = tparse_string(open_text, render=True, device="cpu").result
    assert "regen" not in null.stats and open_.stats.get("regen")
    m_null, m_open = float(null.image.mean()), float(open_.image.mean())
    assert m_open > 0.01 and abs(m_null - m_open) / m_open < 0.05
