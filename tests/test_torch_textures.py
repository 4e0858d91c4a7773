"""The port's texture evaluator (tpu_pbrt_torch/core/texture_eval.py)
against the JAX package's (tpu_pbrt/core/texture_eval.py), called eagerly
on seeded inputs handed to both as separate copies, and the reference's
own oracles (tests/test_textures.py) on the port alone.

- The atlas (the sRGB decode, every pyramid level, the layout) equals the
  reference's bit for bit, and so do the pyramids of 16x16 to 33x64
  images, odd sizes among them, and of 1x4 and 2x8 ones, whose 1-row
  levels take the edge padding; the lattice hash equals it exactly on int32
  coordinates out to the extremes; noise3, FBm and turbulence equal it
  bit for bit (no transcendental enters them).
- Every node kind and mapping (imagemap under uv / planar / spherical
  mapping with wrap repeat, black and clamp, scale, mix, bilerp, uv
  under cylindrical mapping, 2D and 3D checkerboard, dots under spherical
  mapping, fbm, wrinkled, windy, marble), at level 0, through the EWA
  filter with a (R, 4) footprint and through the scalar-lod trilinear
  path: within 2 ulp where the same float32 operations run on both
  sides, and within 2 ulp + TOL_T absolute where a transcendental
  (log2, acos, atan2, sin) or the texture-space transform enters. The
  reference contracts p @ w2t[:3, :3].T through XLA's dot, whose rounding
  depends on the batch shape; the port writes the product out term by
  term. Measured: at most 2.0e-6 absolute, on values of order 1.
- The port's fast form (each texture on its own lanes, per-lane mip
  levels gathered, EWA taps and FBm octaves batched) equals a literal
  transcription of the reference's masked form (every texture on every
  lane, a where over ids; a bilinear lookup at every level; sequential
  taps and octaves) bit for bit.
- The reference's oracles: an equal-arm checkerboard renders like the
  constant; a 2x2 imagemap round-trips at texel centres; each pyramid
  level is the box average of the one below; the EWA filter keeps detail
  across a narrow minor axis that the isotropic path blurs, and reduces
  to about the trilinear lookup for a round footprint; FBm is
  deterministic, bounded and not constant.
- ray_differentials for the four cameras against the reference's,
  within DIFF_ATOL absolute + DIFF_RTOL relative (the reference's
  transforms contract through XLA's dot), and tests/test_raydiff.py's
  oracle on the port: a fine checker receding to the horizon is
  filtered toward its mean far away, much harder than near, and level-0
  lookups (TORCH_PBRT_MIPFILTER off) stay aliased.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_pbrt.core import texture_eval as jt
from tpu_pbrt.core.transform import Transform as JTransform
from tpu_pbrt_torch import parse_string
from tpu_pbrt_torch.config import cfg as tcfg
from tpu_pbrt_torch.core import texture_eval as tt
from tpu_pbrt_torch.core.transform import Transform as TTransform
from tpu_pbrt_torch.utils.imageio import write_image, write_png

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

#: the absolute bound (beside 2 ulp) where a transcendental or the
#: texture-space transform enters
TOL_T = 4e-6
#: lanes of the parity runs
N = 2048
#: ray differentials: the absolute and relative bound
DIFF_ATOL, DIFF_RTOL = 2e-6, 1e-5


def _t(x):
    """A torch copy: the two frameworks never share an input buffer."""
    return torch.from_numpy(np.array(x, copy=True))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tex")
    y, x = np.mgrid[0:48, 0:40] / np.array([48.0, 40.0])[:, None, None]
    smooth = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (3 * x + k / 3)) * np.cos(4 * np.pi * y)
                       for k in range(3)], -1).astype(np.float32)
    write_image(str(d / "a.pfm"), smooth)
    yb, xb = np.mgrid[0:33, 0:64] / np.array([33.0, 64.0])[:, None, None]
    grad = np.stack([xb, yb, 0.5 + 0.5 * np.sin(6 * xb)], -1)
    write_png(str(d / "b.png"), np.rint(grad * 255).astype(np.uint8))
    rng = np.random.default_rng(4)
    write_image(str(d / "c.pfm"), rng.uniform(size=(16, 16, 3)).astype(np.float32))
    return {k: str(d / f) for k, f in (("a", "a.pfm"), ("b", "b.png"), ("c", "c.pfm"))}


def _w2t(T):
    m = np.array([[0.7, 0.2, 0.1, 0.3], [-0.1, 0.9, 0.2, -0.2], [0.05, -0.3, 1.1, 0.4],
                  [0, 0, 0, 1]])
    return {"world_to_texture": T(m)}


def _image(f, wrap, gamma, mapping):
    return ("imagemap", {"kind": "spectrum", "filename": f, "mapping": mapping,
                         "trilerp": False, "max_aniso": 8.0, "wrap": wrap, "scale": 1.5,
                         "gamma": gamma})


def _nodes(T, f):
    """Every node kind and mapping, as the texture parsers build them, with
    the Transform class of one package. Returns [(node, transcendental)]."""
    uvm = {"type": "uv", "su": 3.0, "sv": 2.0, "du": 0.1, "dv": -0.2}
    pl = {"type": "planar", "v1": np.array([1.0, 0.5, 0.0]), "v2": np.array([0.0, 0.3, 1.0]),
          "du": 0.0, "dv": 0.5}
    sph = dict(type="spherical", **_w2t(T))
    cyl = dict(type="cylindrical", **_w2t(T))
    return [
        (_image(f["a"], "repeat", False, uvm), "lod"),
        (_image(f["b"], "black", True, uvm), "lod"),
        (_image(f["a"], "clamp", False, pl), "lod"),
        (("scale", _image(f["a"], "repeat", False, sph), ("constf", 0.3)), "all"),
        (("mix", ("const", np.array([0.1, 0.2, 0.3])), 0.9,
          ("fbm", {"mapping": _w2t(T), "octaves": 5, "roughness": 0.6})), "all"),
        (("bilerp", {"v00": 0.1, "v01": np.array([0.2, 0.3, 0.4]), "v10": 0.5, "v11": 1.0,
                     "mapping": uvm}), ""),
        (("uv", {"mapping": cyl}), "all"),
        (("checkerboard", {"dim": 2, "tex1": 1.0, "tex2": 0.0, "mapping": pl,
                           "aamode": "none"}), ""),
        (("checkerboard", {"dim": 3, "tex1": np.array([0.9, 0.1, 0.1]), "tex2": 0.2,
                           "mapping": _w2t(T)}), ""),
        (("dots", {"inside": 1.0, "outside": 0.1, "mapping": sph}), ""),
        (("fbm", {"mapping": _w2t(T)}), "all"),
        (("wrinkled", {"mapping": _w2t(T), "octaves": 6}), "all"),
        (("windy", {"mapping": _w2t(T)}), "all"),
        (("marble", {"mapping": _w2t(T), "scale": 2.0, "variation": 0.4}), "all"),
    ]


@pytest.fixture(scope="module")
def lanes():
    rng = np.random.default_rng(0)
    n_tex = 14
    uv = rng.uniform(-2, 3, (N, 2)).astype(np.float32)
    p = rng.uniform(-5, 5, (N, 3)).astype(np.float32)
    tid = rng.integers(-1, n_tex, N).astype(np.int32)
    # a footprint on 80% of the lanes (0 on the rest: the finest level)
    lod4 = (rng.uniform(-0.05, 0.05, (N, 4)) * (rng.uniform(size=(N, 1)) < 0.8)).astype(
        np.float32)
    lod1 = rng.uniform(0, 0.1, N).astype(np.float32)
    return dict(uv=uv, p=p, tid=tid, lods={"level0": None, "ewa": lod4, "scalar": lod1})


@pytest.fixture(scope="module")
def tables(files):
    ja, jev = jt.build_texture_table([n for n, _ in _nodes(JTransform, files)])
    ta, tev = tt.build_texture_table([n for n, _ in _nodes(TTransform, files)])
    return ja, jev, ta, tev


def test_atlas_and_pyramid_bit_equal(tables, files):
    ja, _, ta, _ = tables
    assert ta.dtype == ja.dtype == np.float32 and ta.shape == ja.shape
    np.testing.assert_array_equal(ta.view(np.uint32), ja.view(np.uint32))
    # 5352 texels: the 48x40 map and its levels (shared by three nodes),
    # the 33x64 PNG's levels
    assert ta.shape[0] == sum(w * h for w, h in ((40, 48), (20, 24), (10, 12), (5, 6), (2, 3),
                                                 (1, 1), (64, 33), (32, 16), (16, 8), (8, 4),
                                                 (4, 2), (2, 1), (1, 1)))
    rng = np.random.default_rng(1)
    for shape in ((16, 16), (17, 5), (33, 64), (1, 4), (2, 8)):
        img = rng.uniform(size=shape + (3,)).astype(np.float32)
        for a, b in zip(tt._build_pyramid(img), jt._build_pyramid(img)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tt._srgb_to_linear(img), jt._srgb_to_linear(img))


def test_hash_and_noise_exact():
    rng = np.random.default_rng(2)
    ints = np.concatenate([rng.integers(-2**31, 2**31, (4093, 3)),
                           [[2**31 - 1, -2**31, 0], [-1, 1, -7], [123456789, -98765, 2**30]]]
                          ).astype(np.int32)
    got = tt._hash3(*(_t(ints[:, k]) for k in range(3))).numpy()
    want = np.asarray(jt._hash3(*(jnp.asarray(ints[:, k]) for k in range(3))))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    p = np.concatenate([rng.uniform(-40, 40, (4000, 3)), rng.uniform(-1e6, 1e6, (96, 3))]
                       ).astype(np.float32)
    np.testing.assert_array_equal(tt.noise3(_t(p)).numpy(), np.asarray(jt.noise3(jnp.asarray(p))))
    np.testing.assert_array_equal(tt.fbm(_t(p), 0.6, 5).numpy(),
                                  np.asarray(jt.fbm(jnp.asarray(p), 0.6, 5)))
    np.testing.assert_array_equal(tt.turbulence(_t(p), 0.5, 8).numpy(),
                                  np.asarray(jt.turbulence(jnp.asarray(p), 0.5, 8)))


def _ulp(x):
    return np.spacing(np.abs(x).astype(np.float32)).astype(np.float64)


@pytest.mark.parametrize("mode", ["level0", "ewa", "scalar"])
def test_nodes_match_reference(mode, tables, lanes, files):
    ja, jev, ta, tev = tables
    lod = lanes["lods"][mode]
    args = (lanes["tid"], lanes["uv"], lanes["p"])
    want = np.asarray(jev(jnp.asarray(ja), *map(jnp.asarray, args),
                          None if lod is None else jnp.asarray(lod)))
    got = tev(_t(ta), *map(_t, args), None if lod is None else _t(lod)).numpy()
    tid = lanes["tid"]
    np.testing.assert_array_equal(got[tid < 0], 0.0)
    for i, (_, trans) in enumerate(_nodes(TTransform, files)):
        sel = tid == i
        assert sel.sum() > 100
        a, b = got[sel].astype(np.float64), want[sel].astype(np.float64)
        tol = TOL_T if trans == "all" or (trans == "lod" and mode != "level0") else 0.0
        bad = np.abs(a - b) > 2 * _ulp(b) + tol
        assert not bad.any(), (i, mode, np.abs(a - b).max())


def _literal_trilerp(atlas, levels, u, v, lodc, wrap):
    """The reference's trilinear tap: a bilinear lookup at every level, the
    floor and next level's kept by a where."""
    n = len(levels)
    l0 = tt._i32(torch.floor(lodc))
    fl = lodc - l0.to(torch.float32)
    out0 = torch.zeros(u.shape + (3,))
    out1 = torch.zeros(u.shape + (3,))
    for li, (off, w, h) in enumerate(levels):
        tap = tt._bilinear(atlas, off, w, h, u, v, wrap)
        out0 = torch.where((l0 == li)[..., None], tap, out0)
        out1 = torch.where((torch.clamp(l0 + 1, max=n - 1) == li)[..., None], tap, out1)
    return out0 * (1.0 - fl)[..., None] + out1 * fl[..., None]


def _literal_node(node, atlas_packer):
    """A literal transcription of the reference's evaluator where the port
    departs from its form (imagemap lookups, octave sums, dots); other
    kinds take the port's closure, which is the reference's form."""
    kind = node[0]
    if kind == "imagemap":
        d = node[1]
        levels = atlas_packer.add_image(d["filename"], d["gamma"], d["scale"])
        m, wrap = d["mapping"], d["wrap"]

        def ev(a, uv, p, lod):
            u, v = tt._map2d(m, uv, p)
            if lod is None:
                return tt._bilinear(a, *levels[0], u, v, wrap)
            n = len(levels)
            if lod.ndim == u.ndim + 1:
                su, sv = (abs(m["su"]), abs(m["sv"])) if m["type"] == "uv" else (1.0, 1.0)
                dux, dvx, duy, dvy = lod[:, 0] * su, lod[:, 1] * sv, lod[:, 2] * su, lod[:, 3] * sv
                l2x, l2y = dux * dux + dvx * dvx, duy * duy + dvy * dvy
                major = torch.sqrt(torch.clamp(torch.maximum(l2x, l2y), min=1e-16))
                minor = torch.sqrt(torch.clamp(torch.minimum(l2x, l2y), min=0.0))
                minor = torch.maximum(minor, major / torch.full_like(major, tt.MAX_ANISO))
                mu = torch.where(l2x >= l2y, dux, duy)
                mv = torch.where(l2x >= l2y, dvx, dvy)
                lodc = torch.clamp((n - 1) + torch.log2(torch.clamp(minor, min=1e-8)), 0.0, n - 1.0)
                acc, wsum = torch.zeros(u.shape + (3,)), 0.0
                for t in range(tt.EWA_TAPS):
                    f = (t + 0.5) / tt.EWA_TAPS - 0.5
                    wgt = float(np.exp(-2.0 * (2.0 * f) ** 2))
                    acc = acc + wgt * _literal_trilerp(a, levels, u + f * mu, v + f * mv, lodc,
                                                       wrap)
                    wsum += wgt
                return acc / torch.full_like(acc, float(np.float32(wsum)))
            scale = max(abs(m["su"]), abs(m["sv"])) if m["type"] == "uv" else 1.0
            lvl = (n - 1) + torch.log2(torch.clamp(lod * scale, min=1e-8))
            return _literal_trilerp(a, levels, u, v, torch.clamp(lvl, 0.0, n - 1.0), wrap)

        return ev
    if kind in ("fbm", "wrinkled", "marble"):
        d = node[1]
        m, octaves, omega = d["mapping"], d.get("octaves", 8), d.get("roughness", 0.5)

        def seq(pt, absolute):
            out, lam, o = 0.0, 1.0, 1.0
            for _ in range(octaves):
                n = tt.noise3(pt * lam)
                out = out + o * (torch.abs(n) if absolute else n)
                lam, o = lam * 1.99, o * omega
            return out

        if kind != "marble":
            return lambda a, uv, p, lod: tt._gray(seq(tt._map3d(m, p), kind == "wrinkled"))

        def ev_marble(a, uv, p, lod):
            pt = tt._map3d(m, p) * d["scale"]
            t = 0.5 + 0.5 * torch.sin(pt[..., 1] + d["variation"] * seq(pt, False))
            fi = torch.clamp(t * 6, 0.0, 6 - 1e-4)
            i0 = tt._i32(fi)
            ft = (fi - i0.to(torch.float32))[..., None]
            ramp = torch.from_numpy(tt._MARBLE)
            return (1 - ft) * ramp[i0 + 1] + ft * ramp[i0 + 2]

        return ev_marble
    if kind == "dots":
        d = node[1]

        def ev_dots(a, uv, p, lod):
            u, v = tt._map2d(d["mapping"], uv, p)
            sc, tc = torch.floor(u + 0.5), torch.floor(v + 0.5)
            cell = torch.stack([sc, tc, torch.zeros_like(sc)], -1)
            cx = sc + (0.5 - 0.35) * tt.noise3(cell * 1.5 + 10.0)
            cy = tc + (0.5 - 0.35) * tt.noise3(cell * 2.5 + 20.0)
            sel = (tt.noise3(cell + 0.5) > 0.0) & ((u - cx) * (u - cx) + (v - cy) * (v - cy)
                                                   < 0.35 * 0.35)
            return torch.where(sel[..., None], torch.full_like(cell, d["inside"]),
                               torch.full_like(cell, d["outside"]))

        return ev_dots
    return tt._compile_node(node, atlas_packer)


@pytest.mark.parametrize("mode", ["level0", "ewa", "scalar"])
def test_fast_form_equals_masked_transcription(mode, tables, lanes, files):
    _, _, ta, tev = tables
    nodes = [n for n, _ in _nodes(TTransform, files)]
    atlas_packer = tt._AtlasBuilder()
    fns = [_literal_node(n, atlas_packer) for n in nodes]
    np.testing.assert_array_equal(atlas_packer.finish(), ta)
    lod = lanes["lods"][mode]
    atlas, tid, uv, p = _t(ta), _t(lanes["tid"]), _t(lanes["uv"]), _t(lanes["p"])
    lod = None if lod is None else _t(lod)
    want = torch.zeros(uv.shape[:-1] + (3,))
    for i, fn in enumerate(fns):
        want = torch.where((tid == i)[..., None], fn(atlas, uv, p, lod), want)
    got = tev(atlas, tid, uv, p, lod)
    assert torch.equal(got, want)
    # a slot's candidate ids restrict the evaluation to them (others read 0)
    sub = tev(atlas, tid, uv, p, lod, tids=(0, 5, 9))
    keep = (tid == 0) | (tid == 5) | (tid == 9)
    assert torch.equal(sub, torch.where(keep[..., None], want, torch.zeros_like(want)))


def _imagemap(path):
    node = _image(path, "repeat", False, {"type": "uv", "su": 1.0, "sv": 1.0, "du": 0.0, "dv": 0.0})
    node[1]["scale"] = 1.0
    return node


def test_imagemap_bilinear_roundtrip(tmp_path):
    """A 2x2 image sampled at its texel centres under repeat reproduces the
    texels (tests/test_textures.py)."""
    img = np.array([[[1, 0, 0], [0, 1, 0]], [[0, 0, 1], [1, 1, 0]]], np.float32)
    write_image(str(tmp_path / "t.pfm"), img)
    atlas, ev = tt.build_texture_table([_imagemap(str(tmp_path / "t.pfm"))])
    uv = torch.tensor([[0.25, 0.25], [0.75, 0.25], [0.25, 0.75], [0.75, 0.75]])
    out = ev(torch.from_numpy(atlas), torch.zeros(4, dtype=torch.int32), uv, torch.zeros(4, 3))
    np.testing.assert_allclose(out.numpy(), img.reshape(4, 3), atol=1e-5)


def test_mip_pyramid_box_average():
    img = np.random.default_rng(0).uniform(size=(8, 8, 3)).astype(np.float32)
    levels = tt._build_pyramid(img)
    assert [lv.shape[:2] for lv in levels] == [(8, 8), (4, 4), (2, 2), (1, 1)]
    np.testing.assert_allclose(levels[-1][0, 0], img.mean(axis=(0, 1)), rtol=1e-5)
    np.testing.assert_allclose(levels[1][0, 0], img[:2, :2].mean(axis=(0, 1)), rtol=1e-5)


def test_ewa_keeps_cross_axis_detail(tmp_path):
    """A footprint wide along u and a texel along v averages along u
    without blurring across v; the isotropic path at the same width
    destroys the 8-texel stripes (tests/test_textures.py)."""
    img = np.zeros((64, 64, 3), np.float32)
    img[np.arange(64) // 8 % 2 == 0] = 1.0
    write_image(str(tmp_path / "s.pfm"), img)
    atlas, ev = tt.build_texture_table([_imagemap(str(tmp_path / "s.pfm"))])
    a = torch.from_numpy(atlas)
    args = (a, torch.zeros(1, dtype=torch.int32), torch.tensor([[0.5, 4.5 / 64]]),
            torch.zeros(1, 3))
    out_ewa = float(ev(*args, torch.tensor([[0.25, 0.0, 0.0, 1 / 64]]))[0, 0])
    out_iso = float(ev(*args, torch.tensor([0.25]))[0, 0])
    assert out_ewa > 0.85 and out_iso < 0.7, (out_ewa, out_iso)


def test_ewa_round_footprint_near_trilinear(files):
    atlas, ev = tt.build_texture_table([_imagemap(files["c"])])
    rng = np.random.default_rng(7)
    n = 16
    args = (torch.from_numpy(atlas), torch.zeros(n, dtype=torch.int32),
            _t(rng.uniform(0.1, 0.9, (n, 2)).astype(np.float32)), torch.zeros(n, 3))
    ewa = ev(*args, torch.tensor([[0.1, 0.0, 0.0, 0.1]]).repeat(n, 1))
    tri = ev(*args, torch.full((n,), 0.1))
    assert float((ewa - tri).abs().max()) < 0.15


def test_fbm_deterministic_bounded():
    p = _t(np.random.default_rng(1).uniform(-10, 10, (256, 3)).astype(np.float32))
    n = tt.noise3(p).numpy()
    assert np.all(np.abs(n) <= 1.5) and n.std() > 0.05
    assert torch.equal(tt.fbm(p, 0.5, 6), tt.fbm(p, 0.5, 6))
    q = torch.tensor([[1.0, 2.0, 3.0]])
    assert abs(float(tt.noise3(q - 1e-3)[0]) - float(tt.noise3(q + 1e-3)[0])) < 0.05


_LIT = """
Integrator "directlighting" "integer maxdepth" [5]
Sampler "zerotwosequence" "integer pixelsamples" [8]
Film "image" "integer xresolution" [32] "integer yresolution" [32]
LookAt 0 0 -5  0 0 0  0 1 0
Camera "perspective" "float fov" [60]
WorldBegin
LightSource "distant" "rgb L" [3 3 3] "point from" [0 0 -1] "point to" [0 0 0]
{tex}
Material "matte" {kd}
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-4 -4 0  4 -4 0  4 4 0  -4 4 0] "float uv" [0 0  4 0  4 4  0 4]
WorldEnd
"""


def test_equal_arm_checkerboard_matches_constant():
    """A checkerboard whose two arms are equal renders as the constant
    (the texture machinery is an identity, tests/test_textures.py), and
    a two-albedo checkerboard shows both albedos."""
    def render(tex, kd):
        return parse_string(_LIT.format(tex=tex, kd=kd), render=True, device="cpu").result.image

    checker = ('Texture "kdtex" "spectrum" "checkerboard" "rgb tex1" [{a}] "rgb tex2" [{b}]')
    same = render(checker.format(a="0.4 0.5 0.6", b="0.4 0.5 0.6"), '"texture Kd" "kdtex"')
    const = render("", '"rgb Kd" [0.4 0.5 0.6]')
    np.testing.assert_allclose(same, const, rtol=1e-5, atol=1e-6)
    two = render(checker.format(a="0.9 0.9 0.9", b="0.1 0.1 0.1"), '"texture Kd" "kdtex"')
    lum = two.mean(axis=-1)
    lo, hi = np.percentile(lum[lum > 1e-4], [10, 90])
    assert hi / max(lo, 1e-6) > 4.0, (lo, hi)


def _camera(pkg: str, name: str):
    """A camera of each package from the same parameters."""
    if pkg == "jax":
        from tpu_pbrt.cameras import make_camera
        from tpu_pbrt.core.transform import look_at
        from tpu_pbrt.scene.paramset import ParamSet
        kw = {}
    else:
        from tpu_pbrt_torch.cameras import make_camera
        from tpu_pbrt_torch.core.transform import look_at
        from tpu_pbrt_torch.scene.paramset import ParamSet
        kw = {"device": "cpu"}
    ps = ParamSet()
    if name == "perspective":
        ps.add("float fov", [45.0])
    elif name == "orthographic":
        ps.add("float screenwindow", [-3.4, 3.4, -3.4, 3.4])
    elif name == "realistic":
        ps.add("float focusdistance", [5.2])
        ps.add("float aperturediameter", [4.0])
    c2w = look_at([0, 1.6, -4.4], [0, 0, 1.2], [0, 1, 0]).inverse()
    return make_camera(name, ps, c2w, (48, 32), **kw)


@pytest.mark.parametrize("name", ["perspective", "orthographic", "environment", "realistic"])
def test_ray_differentials_match_reference(name):
    from tpu_pbrt.cameras import ray_differentials as jrd
    from tpu_pbrt_torch.cameras import ray_differentials as trd

    rng = np.random.default_rng(5)
    pf = rng.uniform(0, 1, (512, 2)).astype(np.float32) * np.float32([48, 32])
    got = trd(_camera("torch", name), torch.from_numpy(pf.copy()))
    want = jrd(_camera("jax", name), jnp.asarray(pf))
    moving = 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=DIFF_RTOL, atol=DIFF_ATOL)
        moving += int(np.abs(a.numpy()).max() > 1e-4)
    assert moving == 2  # one origin or direction delta per axis


def _checker_floor(tmp_path, mipfilter: bool, monkeypatch):
    from tpu_pbrt_torch.utils.imageio import write_image

    tex = np.repeat((np.indices((64, 64)).sum(axis=0) % 2).astype(np.float32)[..., None], 3, -1)
    path = tmp_path / "chk.pfm"
    write_image(str(path), tex)
    monkeypatch.setattr(tcfg, "mipfilter", mipfilter)
    text = f"""
Integrator "path" "integer maxdepth" [1]
Sampler "random" "integer pixelsamples" [4]
Film "image" "integer xresolution" [48] "integer yresolution" [48]
LookAt 0 1 0  0 1 10  0 1 0
Camera "perspective" "float fov" [60]
WorldBegin
LightSource "distant" "rgb L" [3.14159 3.14159 3.14159] "point from" [0 1 0] "point to" [0 0 0]
Texture "chk" "color" "imagemap" "string filename" ["{path}"] "float uscale" [100] "float vscale" [100]
Material "matte" "texture Kd" ["chk"]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [-200 0 0  200 0 0  200 0 400  -200 0 400] "float uv" [0 0  1 0  1 1  0 1]
WorldEnd
"""
    return parse_string(text, render=True, device="cpu").result.image


def test_filtering_monotone_with_distance(tmp_path, monkeypatch):
    """tests/test_raydiff.py: under the mip filter the far rows of a
    receding 1-texel checker sit near its 0.5 mean with a variance far
    below the level-0 lookups', and the near rows keep much more contrast
    than the far ones (the footprint grows with distance)."""
    img_f = _checker_floor(tmp_path, True, monkeypatch)
    img_0 = _checker_floor(tmp_path, False, monkeypatch)
    assert np.isfinite(img_f).all() and np.isfinite(img_0).all()
    far_f, far_0, near_f = img_f[25:31, :, 0], img_0[25:31, :, 0], img_f[40:, :, 0]
    assert float(far_f.var()) < 0.35 * float(far_0.var())
    assert abs(float(far_f.mean()) - 0.5) < 0.08
    assert near_f.std() > 3.0 * far_f.std()
    assert abs(float(near_f.mean()) - 0.5) < 0.15
