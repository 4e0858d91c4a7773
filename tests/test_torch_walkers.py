"""The port's packet, wide and binary BVH walkers (accel/{packet,wide,traverse}.py,
TORCH_PBRT_BVH) against the JAX package's compiled walkers on the same
seeded numpy rays and triangles, and renders under each walker.

- The reference's walker cases of tests/test_accel.py, as live calls:
  each walker's winning prim ids and hit masks equal the compiled
  reference walker's exactly; t within T_TOL of its t (measured equal);
  the hit masks equal the brute-force oracle's, t within the reference
  test's 1e-5 of it. The wide walker runs through the binary cases.
- The compiler's selection order (binary and wide over the brute product,
  packet only above BRUTE_MAX_TRIS) and the motion-blur warning.
- Renders of the Cornell box (36 triangles) and the small killeroo (532)
  under each knob, against the stream render of the same image and
  against the reference's render with the same knob, stored by
  tests/torch_golden/make_walker_reference.py; and the command line
  under each knob.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.test_accel import random_rays, random_tris
from tests.test_torch_xla_math import jit_ref, rounded_apart
from tpu_pbrt.accel import build as rbuild
from tpu_pbrt.accel import packet as rpacket
from tpu_pbrt.accel import traverse as rtrav
from tpu_pbrt.accel import treelet as rtreelet
from tpu_pbrt.accel import wide as rwide
from tpu_pbrt_torch.accel import build as tbuild
from tpu_pbrt_torch.accel import packet as tpacket
from tpu_pbrt_torch.accel import traverse as ttrav
from tpu_pbrt_torch.accel import treelet as ttreelet
from tpu_pbrt_torch.accel import wide as twide
from tpu_pbrt_torch.config import cfg as tcfg
from tpu_pbrt_torch.scene.api import parse_string
from tpu_pbrt_torch.scenes import compile_api, make_cornell, make_killeroo_like

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "torch_golden")
#: t of a port walker against the compiled reference walker's (relative)
T_TOL = 1e-6
#: walker render against the reference's golden with the same knob:
#: (image MSE bound, |rays - the reference's| bound); measured MSE
#: 3.5e-17 - 9.7e-16 with rays equal
GOLDEN_TOL = (1e-13, 0)
#: walker render against the stream render of the same image (the repo's
#: render bar); measured 0.0 - 1.6e-14 with rays equal
STREAM_TOL = 1e-4
#: edge rays of _edge_rays that miss both triangles in the compiled reference
LEAKS_COMPILED = 87
T = torch.from_numpy


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


#: the reference walkers' inputs are padded to one shape per walker (rays,
#: nodes, triangles, treelets), so each compiles once for every case
R_PAD, NODE_PAD, TRI_PAD, WIDE_PAD, TREELET_PAD, TOP_PAD = 768, 1024, 3072, 256, 96, 32


def _pad(a, n, fill):
    a = np.asarray(a)
    extra = np.full((n - a.shape[0],) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, extra])


def _pad_rays(o, d):
    return (_pad(o, R_PAD, 0.0), _pad(d, R_PAD, 1.0))


class _Walker:
    """One walker of each package over one set of triangles; the
    reference's tables padded with unreachable rows (see R_PAD)."""

    def __init__(self, kind, tris, method="sah"):
        self.kind = kind
        bvh_r = rbuild.build_bvh(*rbuild.triangle_bounds(tris), method=method)
        bvh_t = tbuild.build_bvh(*tbuild.triangle_bounds(tris), method=method)
        np.testing.assert_array_equal(bvh_t.prim_order, bvh_r.prim_order)
        self.tris = tris[bvh_r.prim_order]
        if kind == "binary":
            ref = rtrav.bvh_as_device_dict(bvh_r)
            fill = {"bounds_min": np.inf, "bounds_max": -np.inf}
            self.ref = {k: jnp.asarray(_pad(v, NODE_PAD, fill.get(k, 0))) for k, v in ref.items()}
            self.port = {k: T(v) for k, v in ttrav.bvh_as_device_dict(bvh_t).items()}
            self.tv_r, self.tv_t = jnp.asarray(_pad(self.tris, TRI_PAD, 0.0)), _t(self.tris)
        elif kind == "wide":
            w = rwide.build_wide(bvh_r)
            self.ref = rwide.WideBVH(jnp.asarray(_pad(w.child_bmin, WIDE_PAD, np.inf)),
                                     jnp.asarray(_pad(w.child_bmax, WIDE_PAD, -np.inf)),
                                     jnp.asarray(_pad(w.child_idx, WIDE_PAD, rwide._EMPTY)))
            self.port = twide.wide_as_device(twide.build_wide_numpy(bvh_t), "cpu")
            padded = rwide.pad_tri_verts(self.tris)
            self.tv_r = jnp.asarray(_pad(padded, TRI_PAD, 0.0))
            self.tv_t = T(twide.pad_tri_verts(self.tris))
        else:
            tp = rtreelet.build_treelet_pack(self.tris, bvh_r)
            top = rwide.WideBVH(jnp.asarray(_pad(tp.top.child_bmin, TOP_PAD, np.inf)),
                                jnp.asarray(_pad(tp.top.child_bmax, TOP_PAD, -np.inf)),
                                jnp.asarray(_pad(tp.top.child_idx, TOP_PAD, rwide._EMPTY)))
            self.ref = rtreelet.TreeletPack(
                top, *(jnp.asarray(_pad(getattr(tp, f), TREELET_PAD, 0))
                       for f in ("featT", "center", "offset", "count")))
            self.port = ttreelet.pack_from_numpy(
                ttreelet.build_treelet_pack_numpy(self.tris, bvh_t), "cpu")

    def closest(self, o, d, t_max):
        """(port Hit, compiled reference Hit), the reference's cut to R."""
        R = o.shape[0]
        op, dp = _pad_rays(o, d)
        tm = np.float32(t_max)
        if self.kind == "binary":
            got = ttrav.bvh_intersect(self.port, self.tv_t, _t(o), _t(d), t_max)
            ref = rtrav.bvh_intersect(self.ref, self.tv_r, op, dp, tm)
        elif self.kind == "wide":
            got = twide.wide_intersect(self.port, self.tv_t, _t(o), _t(d), t_max)
            ref = rwide.wide_intersect(self.ref, self.tv_r, op, dp, tm)
        else:
            got = tpacket.packet_intersect(self.port, _t(o), _t(d), t_max)
            ref = rpacket.packet_intersect(self.ref, op, dp, tm)
        return got, type(ref)(*(np.asarray(x)[:R] for x in ref[:4]))

    def any_hit(self, o, d, t_max):
        if self.kind == "binary":
            return ttrav.bvh_intersect_p(self.port, self.tv_t, _t(o), _t(d), t_max)
        if self.kind == "wide":
            return twide.wide_intersect_p(self.port, self.tv_t, _t(o), _t(d), t_max)
        return tpacket.packet_intersect_p(self.port, _t(o), _t(d), t_max)


def _equal_to_reference(hit_t, hit_r):
    np.testing.assert_array_equal(hit_t.prim.numpy(), np.asarray(hit_r.prim))
    m = hit_t.prim.numpy() >= 0
    np.testing.assert_allclose(hit_t.t.numpy()[m], np.asarray(hit_r.t)[m], rtol=T_TOL, atol=0)
    for f in ("b0", "b1"):
        np.testing.assert_allclose(getattr(hit_t, f).numpy()[m], np.asarray(getattr(hit_r, f))[m],
                                   rtol=0, atol=1e-6)


def _oracle(tris, o, d):
    return ttrav.brute_force_intersect(_t(tris), _t(o), _t(d), 1e30, chunk=128)


@pytest.mark.parametrize("method", ["sah", "hlbvh", "middle", "equal"])
@pytest.mark.parametrize("kind", ["binary", "wide"])
def test_bvh_matches_brute_force(kind, method):
    """tests/test_accel.py::test_bvh_matches_brute_force for both per-ray
    walkers over every split method."""
    rng = np.random.default_rng(7)
    tris = random_tris(300, rng)
    w = _Walker(kind, tris, method)
    o, d = random_rays(500, rng)
    hit, hit_r = w.closest(o, d, 1e30)
    _equal_to_reference(hit, hit_r)
    bf = _oracle(w.tris, o, d)
    m = hit.prim.numpy() >= 0
    np.testing.assert_array_equal(m, bf.prim.numpy() >= 0)
    assert m.sum() > 20
    np.testing.assert_allclose(hit.t.numpy()[m], bf.t.numpy()[m], rtol=1e-5, atol=1e-5)
    assert (hit.prim.numpy() == bf.prim.numpy())[m].mean() > 0.99


@pytest.mark.parametrize("kind", ["binary", "wide", "packet"])
def test_intersect_p_consistent_with_closest_hit(kind):
    rng = np.random.default_rng(11)
    tris = random_tris(200 if kind != "packet" else 1500, rng)
    w = _Walker(kind, tris)
    o, d = random_rays(400, rng)
    hit, hit_r = w.closest(o, d, 1e30)
    _equal_to_reference(hit, hit_r)
    np.testing.assert_array_equal(w.any_hit(o, d, 1e30).numpy(), hit.prim.numpy() >= 0)


@pytest.mark.parametrize("kind", ["binary", "wide", "packet"])
def test_t_max_respected(kind):
    """tests/test_accel.py::test_t_max_respected and
    test_packet_t_max_respected: a miss keeps t = t_max on the per-ray
    walkers and reads inf on the packet walker, as in the reference."""
    tri = np.asarray([[[0.0, -1, -1], [0, 1, -1], [0, 0, 1]]], np.float32)
    w = _Walker(kind, tri)
    o = np.asarray([[-5.0, 0, 0]], np.float32)
    d = np.asarray([[1.0, 0, 0]], np.float32)
    for t_max, want in ((10.0, 0), (4.0, -1)):
        hit, hit_r = w.closest(o, d, t_max)
        assert int(hit.prim[0]) == int(hit_r.prim[0]) == want
        np.testing.assert_array_equal(hit.t.numpy(), np.asarray(hit_r.t))
    assert not bool(w.any_hit(o, d, 4.0)[0])


def _edge_rays():
    quad = np.array([[[0, 0, 0], [1, 0, 0], [1, 1, 0]], [[0, 0, 0], [1, 1, 0], [0, 1, 0]]],
                    dtype=np.float32)
    rng = np.random.default_rng(3)
    s = rng.uniform(0.05, 0.95, 256).astype(np.float32)
    targets = np.stack([s, s, np.zeros_like(s)], axis=1)
    o = targets + np.array([0.3, -0.2, 2.5], dtype=np.float32)
    d = targets - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return quad, o, d


@rounded_apart
def test_watertight_shared_edge():
    """tests/test_accel.py::test_watertight_shared_edge: rays aimed at the
    shared edge of a quad's two triangles hit at least one of them, with
    every product rounded apart, as the reference's test runs it (op by
    op); the port equals that reference bit for bit."""
    quad, o, d = _edge_rays()
    n_hits = 0
    for tri in quad:
        got = ttrav.intersect_triangle(_t(o), _t(d), *(_t(tri[i]) for i in range(3)), 1e30)
        want = rtrav.intersect_triangle(jnp.asarray(o), jnp.asarray(d),
                                        *(jnp.asarray(tri[i]) for i in range(3)), 1e30)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        n_hits = n_hits + got[0].numpy().astype(int)
    assert (n_hits >= 1).all(), "edge rays leaked through the shared edge"


def test_intersect_triangle_bit_equal_to_compiled_reference():
    """In the default rounding (the edge functions and the shear fused as
    the compiled reference fuses them) intersect_triangle equals the
    reference compiled with jax.jit at the renders' optimisation level,
    bit for bit. There the shared edge is not watertight: rays through
    the edge miss both triangles in the compiled reference too (ROADMAP
    Queue 3)."""
    quad, o, d = _edge_rays()
    n_hits = 0
    for tri in quad:
        got = ttrav.intersect_triangle(_t(o), _t(d), *(_t(tri[i]) for i in range(3)), 1e30)
        want = jit_ref(rtrav.intersect_triangle)(o, d, tri[0], tri[1], tri[2], np.float32(1e30))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        n_hits = n_hits + got[0].numpy().astype(int)
    assert (n_hits == 0).sum() == LEAKS_COMPILED


@pytest.mark.parametrize("kind", ["binary", "wide", "packet"])
def test_slab_nan_edge_on_ray_not_rejected(kind):
    """A ray with d[axis] == 0 whose origin lies on a node's slab plane:
    the 0 * inf NaN is taken as inside the slab."""
    tri = np.asarray([[[2, -1, -0.01], [2, 1, -0.01], [2, 0, 1]]], np.float32)
    w = _Walker(kind, tri)
    hit, hit_r = w.closest(np.zeros((1, 3), np.float32), np.asarray([[1, 0, 0]], np.float32), 1e30)
    assert int(hit.prim[0]) == int(hit_r.prim[0]) == 0
    np.testing.assert_allclose(float(hit.t[0]), 2.0, rtol=1e-5)


def test_packet_matches_oracle():
    """tests/test_accel.py::test_packet_matches_oracle: 3,000 triangles in
    64-triangle treelets, 700 rays (6 packets, the last one padded)."""
    rng = np.random.default_rng(23)
    tris = random_tris(3000, rng)
    w = _Walker("packet", tris)
    assert w.port.n_treelets > 8
    o, d = random_rays(700, rng)
    hit, hit_r = w.closest(o, d, 1e30)
    _equal_to_reference(hit, hit_r)
    bf = _oracle(w.tris, o, d)
    m = hit.prim.numpy() >= 0
    np.testing.assert_array_equal(m, bf.prim.numpy() >= 0)
    np.testing.assert_allclose(hit.t.numpy()[m], bf.t.numpy()[m], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(w.any_hit(o, d, 1e30).numpy(), m)
    n_pop, n_tl = tpacket.packet_traverse_stats(w.port, _t(o), _t(d), 1e30)
    assert n_pop.shape == (6,) and int(n_tl.sum()) > 0


@pytest.mark.parametrize("knob,cornell,killeroo", [
    ("stream", "bfeat", "tstream"), ("packet", "bfeat", "tpack"),
    ("wide", "wbvh", "wbvh"), ("binary", "bvh", "bvh")])
def test_compiler_selection_order(knob, cornell, killeroo, monkeypatch):
    """The reference's order: binary and wide win over the brute product;
    packet applies above BRUTE_MAX_TRIS (256); the residency estimate
    counts the walker's tables; the card's default chunk follows the
    structure built (2^13 for a walker's tables only)."""
    from types import SimpleNamespace

    from tpu_pbrt_torch.integrators.common import GPU_CHUNK, WALKER_CHUNK, device_chunk
    from tpu_pbrt_torch.serve.residency import scene_hbm_bytes

    monkeypatch.setattr(tcfg, "bvh", knob)
    accels = {"tstream", "tpack", "wbvh", "bvh", "bfeat"}
    for make, want in ((lambda: make_cornell(res=8, spp=1, device="cpu"), cornell),
                       (lambda: make_killeroo_like(8, 1, n_theta=12, n_phi=24, device="cpu"),
                        killeroo)):
        scene, _ = compile_api(make())
        assert accels & set(scene.dev) == {want}
        accel = scene.dev[want]
        tables = accel.values() if isinstance(accel, dict) else accel
        walker = sum(x.numel() * x.element_size() for x in torch.utils._pytree.tree_leaves(
            list(tables)))
        assert scene_hbm_bytes(scene) > walker > 0
        on_card = SimpleNamespace(dev=scene.dev, device=torch.device("cuda"))
        walked = want in ("tpack", "wbvh", "bvh")
        assert device_chunk(on_card) == (WALKER_CHUNK if walked else GPU_CHUNK)


_MOVING = """
Integrator "path" "integer maxdepth" [2]
Sampler "random" "integer pixelsamples" [1]
Film "image" "integer xresolution" [8] "integer yresolution" [8]
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" [53] "float shutteropen" [0] "float shutterclose" [1]
WorldBegin
LightSource "point" "rgb I" [4 4 4] "point from" [0 0 -3]
AttributeBegin
  ActiveTransform EndTime
  Translate 0.3 0 0
  ActiveTransform All
  Shape "trianglemesh" "integer indices" [0 2 1 0 3 2]
    "point P" [-1.5 -0.5 0  -0.5 -0.5 0  -0.5 0.5 0  -1.5 0.5 0]
AttributeEnd
{grid}
"""


def _grid(n=12):
    """A static (n x n)-quad mesh behind the quad: 2 n^2 triangles."""
    xs = np.linspace(-2, 2, n + 1)
    p = " ".join(f"{x:.4f} {y:.4f} 1" for y in xs for x in xs)
    idx = []
    for j in range(n):
        for i in range(n):
            a = j * (n + 1) + i
            idx += [a, a + 1, a + n + 2, a, a + n + 2, a + n + 1]
    return (f'Shape "trianglemesh" "integer indices" [{" ".join(map(str, idx))}] '
            f'"point P" [{p}]')


@pytest.mark.parametrize("knob", ["packet", "wide", "binary"])
def test_motion_renders_shutter_start_with_warning(knob, monkeypatch):
    """Under motion blur the walkers give pbrt's Warning and render the
    shutter-start frame: the moving scene's image equals the same scene
    with the ActiveTransform lines dropped."""
    from tpu_pbrt_torch.scene import compiler

    monkeypatch.setattr(tcfg, "bvh", knob)
    warned = []
    monkeypatch.setattr(compiler, "Warning", warned.append)
    moving = _MOVING.format(grid=_grid())
    start = "\n".join(ln for ln in moving.split("\n")
                      if not (ln.startswith("  ActiveTransform") or ln == "  Translate 0.3 0 0"))
    out = {}
    for name, text in (("moving", moving), ("start", start)):
        scene, integ = compile_api(parse_string(text, device="cpu"))
        assert ("tri_verts1" in scene.dev) == (name == "moving")
        out[name] = integ.render(scene)
    assert sum("motion blur is only supported" in w for w in warned) == 1, warned
    assert out["moving"].rays_traced == out["start"].rays_traced
    np.testing.assert_allclose(out["moving"].image, out["start"].image, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def stream_renders():
    from tests.torch_golden.make_walker_reference import SCENES
    from tpu_pbrt_torch import scenes

    out = {}
    prev = (tcfg.bvh, tcfg.pool)
    tcfg.bvh, tcfg.pool = "stream", 256
    try:
        for name in SCENES:
            scene, integ = compile_api(_api(scenes, name))
            out[name] = integ.render(scene)
    finally:
        tcfg.bvh, tcfg.pool = prev
    return out


def _api(scenes, name):
    from tests.torch_golden.make_walker_reference import build_api

    return build_api(scenes, name, device="cpu")


@pytest.mark.parametrize("scene_name", ["cornell", "killeroo"])
@pytest.mark.parametrize("knob", ["packet", "wide", "binary"])
def test_walker_render_matches_reference_and_stream(scene_name, knob, stream_renders,
                                                    monkeypatch):
    from tpu_pbrt_torch import scenes
    from tpu_pbrt_torch.accel.traverse import WALKS

    monkeypatch.setattr(tcfg, "bvh", knob)
    monkeypatch.setattr(tcfg, "pool", 256)
    WALKS.reset()
    scene, integ = compile_api(_api(scenes, f"{scene_name}_{knob}"))
    res = integ.render(scene)
    ref = np.load(os.path.join(GOLDEN, f"walker_{scene_name}_{knob}.npz"))
    assert scene.n_tris == int(ref["n_tris"])
    assert str(ref["accel"]) in scene.dev
    assert np.isfinite(res.image).all() and res.stats["regen"]
    mse_bar, ray_bar = GOLDEN_TOL
    assert abs(res.rays_traced - int(ref["rays_traced"])) <= ray_bar
    assert float(np.mean((res.image.astype(np.float64) - ref["image"]) ** 2)) <= mse_bar
    st = stream_renders[scene_name]
    assert float(np.mean((res.image.astype(np.float64) - st.image) ** 2)) <= STREAM_TOL
    assert res.rays_traced == st.rays_traced
    # the walkers really walked (the packet knob keeps the brute product
    # on the Cornell box), and their loop tests were counted
    walked = str(ref["accel"]) != "bfeat"
    assert (WALKS.waves > 0) == walked and (WALKS.host_reads > 0) == walked


@pytest.mark.parametrize("knob", ["packet", "wide", "binary"])
def test_cli_renders_under_each_walker(knob, tmp_path, monkeypatch):
    """`TORCH_PBRT_BVH=<knob> python -m tpu_pbrt_torch.main scene.pbrt
    --device cpu` (the knob as the config reads it): the Cornell box file
    renders through the walker (the packet knob keeps its brute product)
    and writes the image."""
    from tpu_pbrt_torch import main as cli
    from tpu_pbrt_torch.scene import api
    from tpu_pbrt_torch.utils.imageio import read_pfm

    monkeypatch.setattr(tcfg, "bvh", knob)
    results = []
    real = api.render_file
    monkeypatch.setattr(api, "render_file", lambda *a, **k: results.append(real(*a, **k))
                        or results[-1])
    out = str(tmp_path / "w.pfm")
    scene_file = os.path.join(os.path.dirname(GOLDEN), "..", "scenes", "cornell-path.pbrt")
    assert cli.main([scene_file, "--quick", "--device", "cpu", "--quiet", "-o", out,
                     "--cropwindow", "0.25", "0.375", "0.25", "0.375"]) == 0
    res = results[0]
    assert np.array_equal(read_pfm(out), res.image) and res.image.max() > 0
    assert ("walker" in res.stats) == (knob != "packet")
