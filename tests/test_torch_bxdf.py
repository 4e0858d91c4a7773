"""The port's BSDF lobes (tpu_pbrt_torch/core/bxdf.py) against the JAX
package's (tpu_pbrt/core/bxdf.py), on seeded numpy inputs handed to both.

Covered: the Fresnel terms, the Trowbridge-Reitz (GGX) functions and
visible-normal sampling, and bsdf_eval / bsdf_sample for each material
the port lowers (matte with sigma = 0 and sigma > 0, plastic, metal
isotropic and anisotropic, smooth glass, rough glass, mirror) on 4,096
lanes whose wo covers both hemispheres.

Tolerances (measured on these inputs; the JAX side runs op by op, as
`jax.numpy` evaluates a function outside `jit`): both sides run the same
f32 formulas in the same order and agree to the last bit or one ulp
(a three-term sum may round differently), so the Fresnel and GGX terms
and bsdf_eval's f and pdf must agree to 1e-5 relative + 2e-6 absolute on
every lane (measured: at most 3.8e-6 relative). Sampled directions go
through sin/cos (the cosine warp, the normal-incidence slopes), which
the two libraries may round an ulp apart, and a direction near the pole
of the warp or at a grazing half-vector amplifies that: bsdf_sample's
wi, f and pdf must agree to the same bound on at least 99.9% of the lanes
and to 5e-5 absolute + 1e-5 relative on all (measured: one lane in 4,096
of matte and of metal off the strict bound, by at most 1.14e-5). Booleans
(specular, transmission, pdf > 0, and so which glass lobe was drawn)
must match exactly. Under `jit` XLA rounds differently from its own op
by op evaluation (97% of the VNDF samples then differ in the last bits),
so the eager functions are the reference for the port rounding every
product apart (`xla_math.contraction(False)`). The `_contracted` twins
hold the port's default rounding, the one every render runs, to the
reference compiled at the renders' optimisation level (`jit_ref`), with
the same bounds (measured: bit for bit on every lane of bsdf_sample).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from tpu_pbrt.core import bxdf as jb
from tpu_pbrt_torch.core import bxdf as tb
from tests.test_torch_xla_math import JitRef, jit_ref, rounded_apart

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

N = 4096
RTOL, ATOL = 1e-5, 2e-6
#: the cap every sampled lane must meet, and the share that must meet (RTOL, ATOL)
ATOL_CAP, STRICT_SHARE = 5e-5, 0.999

# copper (the metal defaults of pbrt's named spectra, as rgb)
_CU_ETA = [0.200438, 0.924033, 1.102212]
_CU_K = [3.912949, 2.452848, 2.142188]

#: name -> (type, kd, ks, kr, kt, eta, k, rough_u, rough_v, sigma, remap)
MATERIALS = {
    "matte": (1, [0.5, 0.4, 0.3], 0, 0, 0, 1.0, 0, 0.0, 0.0, 0.0, 1),
    "matte_oren_nayar": (1, [0.5, 0.4, 0.3], 0, 0, 0, 1.0, 0, 0.0, 0.0, 20.0, 1),
    "plastic": (2, [0.25, 0.3, 0.2], [0.25, 0.25, 0.3], 0, 0, 1.0, 0, 0.1, 0.1, 0.0, 1),
    "metal": (3, 0, 0, 0, 0, _CU_ETA, _CU_K, 0.05, 0.05, 0.0, 1),
    "metal_aniso": (3, 0, 0, 0, 0, _CU_ETA, _CU_K, 0.3, 0.05, 0.0, 1),
    "glass": (4, 0, 0, 1.0, 1.0, 1.5, 0, 0.0, 0.0, 0.0, 1),
    "glass_rough": (4, 0, 0, 1.0, [0.9, 1.0, 1.0], 1.5, 0, 0.2, 0.1, 0.0, 1),
    "mirror": (5, 0, 0, 0.9, 0, 1.0, 0, 0.0, 0.0, 0.0, 1),
}


def _tables():
    """The MATERIALS rows as one table (numpy), in sorted-name order."""
    names = sorted(MATERIALS)
    rows = [MATERIALS[n] for n in names]
    r3 = lambda v: np.broadcast_to(np.asarray(v, np.float32), (3,))  # noqa: E731
    col3 = lambda i: np.stack([r3(r[i]) for r in rows])  # noqa: E731
    col1 = lambda i, dt: np.array([r[i] for r in rows], dt)  # noqa: E731
    tab = {
        "type": col1(0, np.int32), "kd": col3(1), "ks": col3(2), "kr": col3(3),
        "kt": col3(4), "eta": col3(5), "k": col3(6), "rough_u": col1(7, np.float32),
        "rough_v": col1(8, np.float32), "sigma": col1(9, np.float32),
        "opacity": np.ones((len(rows), 3), np.float32), "remap": col1(10, np.int32),
    }
    return names, tab


def _dirs(rng, n):
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _t(x):
    """A torch copy: the two frameworks never share an input buffer."""
    return torch.from_numpy(np.array(x, copy=True))


def _close(a_t, a_j, rtol=RTOL, atol=ATOL):
    a_t = a_t.numpy() if torch.is_tensor(a_t) else a_t
    np.testing.assert_allclose(a_t, np.asarray(a_j), rtol=rtol, atol=atol)


def _agree(a_t, a_j, what):
    """The sampled-value bound: (RTOL, ATOL) on STRICT_SHARE of the lanes,
    (RTOL, ATOL_CAP) on all of them."""
    a, b = np.asarray(a_t, np.float64), np.asarray(a_j, np.float64)
    d, lim = np.abs(a - b), RTOL * np.abs(b)
    strict = d <= ATOL + lim
    strict = strict.reshape(len(strict), -1).all(axis=1)
    assert strict.mean() >= STRICT_SHARE, f"{what}: {strict.mean():.5f} of lanes within the bound"
    np.testing.assert_array_less(d - lim, ATOL_CAP, err_msg=what)


@pytest.fixture(scope="module")
def lanes():
    """N lanes per material, 8N in all: every test runs on this one shape,
    so the JAX side compiles each of its eager ops once."""
    rng = np.random.default_rng(2024)
    n = N * len(MATERIALS)
    wo, wi = _dirs(rng, n), _dirs(rng, n)
    u = rng.uniform(0, 1, (3, n)).astype(np.float32)
    return wo, wi, u


def _both_jax(mat, mid, wo, wi, u0, u1, u2):
    mp = jb.gather_mat(mat, mid)
    return mp.ax, mp.ay, mp.rough_raw, jb.bsdf_eval(mp, wo, wi), jb.bsdf_sample(mp, wo, u0, u1, u2)


def _shade(lanes, both_jax):
    """Every material on its own 4,096 lanes, all in one batch: the JAX
    side through `both_jax` and the port's.
    Returns {name: (jax outputs, port outputs)} sliced per material."""
    wo_m, wi_m, u_m = lanes
    names, tab = _tables()
    mid = np.repeat(np.arange(len(names), dtype=np.int32), N)
    ja = jax.block_until_ready(both_jax(
        {k: jnp.array(v) for k, v in tab.items()}, jnp.array(mid), jnp.array(wo_m),
        jnp.array(wi_m), *map(jnp.array, u_m)))
    mpt = tb.gather_mat({k: _t(v) for k, v in tab.items()}, _t(mid))
    ta = (mpt.ax, mpt.ay, mpt.rough_raw, tb.bsdf_eval(mpt, _t(wo_m), _t(wi_m)),
          tb.bsdf_sample(mpt, _t(wo_m), *map(_t, u_m)))
    flat_j, tree = jax.tree.flatten(ja)
    flat_t = [x.numpy() for x in jax.tree.leaves(ta)]
    out = {}
    for i, n in enumerate(names):
        sl = slice(i * N, (i + 1) * N)
        out[n] = (jax.tree.unflatten(tree, [np.asarray(x)[sl] for x in flat_j]),
                  jax.tree.unflatten(tree, [x[sl] for x in flat_t]))
    return out


@pytest.fixture(scope="module")
@rounded_apart
def shaded(lanes):
    """The reference op by op (eager) and the port rounding every product
    apart."""
    return _shade(lanes, _both_jax)


@pytest.fixture(scope="module")
def shaded_contracted(lanes):
    """The reference compiled (jax.jit) and the port in its default
    contraction: the rounding every render runs."""
    return _shade(lanes, jit_ref(_both_jax))


@rounded_apart
def test_fresnel_terms(lanes, shaded):
    """Both Fresnel terms against the reference's, called on their own (op
    by op, so the port rounds every product apart here); their compiled
    forms are held bit for bit by test_crown_functions_bit_equal_to_compiled_reference."""
    n = lanes[0].shape[0]
    rng = np.random.default_rng(5)
    cos_i = rng.uniform(-1, 1, n).astype(np.float32)
    eta = rng.uniform(1.0, 2.5, n).astype(np.float32)
    one = np.ones(n, np.float32)
    _close(tb.fresnel_dielectric(_t(cos_i), _t(one), _t(eta)),
           jb.fresnel_dielectric(jnp.asarray(cos_i), jnp.asarray(one), jnp.asarray(eta)))
    # exiting (cos < 0) with a denser outside: total internal reflection
    fr = tb.fresnel_dielectric(_t(np.abs(cos_i)), _t(eta), _t(one)).numpy()
    assert (fr == 1.0).sum() > n // 10
    e3 = rng.uniform(0.1, 2.0, (n, 3)).astype(np.float32)
    k3 = rng.uniform(0.0, 4.0, (n, 3)).astype(np.float32)
    _close(tb.fresnel_conductor(_t(cos_i), _t(e3), _t(k3)),
           jb.fresnel_conductor(jnp.asarray(cos_i), jnp.asarray(e3), jnp.asarray(k3)))


@rounded_apart
def test_trowbridge_reitz_functions(lanes, shaded):
    wo, wi, u = lanes
    n = wo.shape[0]
    rng = np.random.default_rng(6)
    rough = rng.uniform(0.0, 1.0, n).astype(np.float32)
    _close(tb.tr_roughness_to_alpha(_t(rough)), jb.tr_roughness_to_alpha(jnp.asarray(rough)))
    ax = rng.uniform(0.01, 1.0, n).astype(np.float32)
    ay = rng.uniform(0.01, 1.0, n).astype(np.float32)
    wh = _dirs(rng, n)
    jwh, jwo, jwi, jax_, jay = (jnp.asarray(x) for x in (wh, wo, wi, ax, ay))
    twh, two, twi, tax, tay = (_t(x) for x in (wh, wo, wi, ax, ay))
    _close(tb.tr_d(twh, tax, tay), jb.tr_d(jwh, jax_, jay))
    _close(tb.tr_lambda(two, tax, tay), jb.tr_lambda(jwo, jax_, jay))
    _close(tb.tr_g(two, twi, tax, tay), jb.tr_g(jwo, jwi, jax_, jay))
    _close(tb.tr_g1(two, tax, tay), jb.tr_g1(jwo, jax_, jay))
    _close(tb.tr_pdf(two, twh, tax, tay), jb.tr_pdf(jwo, jwh, jax_, jay))
    # slopes, at random and at normal incidence (the sin/cos branch)
    cos_t = np.concatenate([rng.uniform(-1, 1, n - 64), np.full(64, 0.99995)]).astype(np.float32)
    sx_t, sy_t = tb._tr_sample11(_t(cos_t), _t(u[0]), _t(u[1]))
    sx_j, sy_j = jb._tr_sample11(jnp.asarray(cos_t), jnp.asarray(u[0]), jnp.asarray(u[1]))
    _agree(sx_t, sx_j, "slope x")
    _agree(sy_t, sy_j, "slope y")
    wh_t = tb.tr_sample_wh(two, _t(u[0]), _t(u[1]), tax, tay)
    wh_j = jb.tr_sample_wh(jwo, jnp.asarray(u[0]), jnp.asarray(u[1]), jax_, jay)
    _agree(wh_t, wh_j, "wh")
    # the sampled half-vectors face wo's hemisphere
    assert (np.sign(wh_t.numpy()[:, 2]) == np.sign(wo[:, 2])).mean() > 0.99


def test_trowbridge_reitz_functions_contracted(lanes):
    """The default contraction against the compiled reference, bit for
    bit: RoughnessToAlpha and the visible-normal sample (tr_d, tr_lambda,
    tr_g, tr_g1, tr_pdf and _tr_sample11 are held the same way by
    test_crown_functions_bit_equal_to_compiled_reference)."""
    wo, _, u = lanes
    n = wo.shape[0]
    rng = np.random.default_rng(6)
    rough = rng.uniform(0.0, 1.0, n).astype(np.float32)
    ax = rng.uniform(0.01, 1.0, n).astype(np.float32)
    ay = rng.uniform(0.01, 1.0, n).astype(np.float32)
    jr = JitRef(jb)
    np.testing.assert_array_equal(tb.tr_roughness_to_alpha(_t(rough)).numpy(),
                                  np.asarray(jr.tr_roughness_to_alpha(rough)))
    np.testing.assert_array_equal(
        tb.tr_sample_wh(_t(wo), _t(u[0]), _t(u[1]), _t(ax), _t(ay)).numpy(),
        np.asarray(jr.tr_sample_wh(wo, u[0], u[1], ax, ay)))


@pytest.mark.parametrize("name", sorted(MATERIALS))
def test_bsdf_eval_and_sample(name, lanes, shaded):
    _check_shaded(name, lanes, shaded)


@pytest.mark.parametrize("name", sorted(MATERIALS))
def test_bsdf_eval_and_sample_contracted(name, lanes, shaded_contracted):
    _check_shaded(name, lanes, shaded_contracted)


def _check_shaded(name, lanes, shaded):
    i = sorted(MATERIALS).index(name)
    wo = lanes[0][i * N:(i + 1) * N]
    assert (wo[:, 2] < 0).mean() > 0.4 and (wo[:, 2] > 0).mean() > 0.4
    (axj, ayj, rrj, (fj, pj), bj), (axt, ayt, rrt, (ft, pt), bt) = shaded[name]
    _close(axt, axj)
    _close(ayt, ayj)
    np.testing.assert_array_equal(rrt, rrj)

    _close(ft, fj)
    _close(pt, pj)

    np.testing.assert_array_equal(bt.is_specular, bj.is_specular)
    np.testing.assert_array_equal(bt.is_transmission, bj.is_transmission)
    np.testing.assert_array_equal(bt.pdf > 0, bj.pdf > 0)
    _agree(bt.wi, bj.wi, "wi")
    _agree(bt.f, bj.f, "f")
    _agree(bt.pdf, bj.pdf, "pdf")
    live = bt.pdf > 0
    assert live.mean() > 0.3, live.mean()
    if name.startswith("glass"):
        # both lobes drawn, from both sides of the surface
        tr = bt.is_transmission
        assert 0.05 < tr.mean() < 0.95
        assert (tr & (wo[:, 2] < 0)).any() and (tr & (wo[:, 2] > 0)).any()


def _aligned(a, align=64):
    """A copy of `a` whose data starts on an `align`-byte boundary."""
    buf = np.empty(a.nbytes + align, np.uint8)
    off = (-buf.ctypes.data) % align
    out = buf[off:off + a.nbytes].view(a.dtype).reshape(a.shape)
    out[...] = a
    return out


def test_shared_input_buffers_are_not_written(lanes, shaded):
    """One numpy buffer per material column handed to both frameworks at
    once (jnp.asarray and torch.from_numpy), 64-byte aligned so the JAX
    CPU client may take it without a copy: neither side writes to it, and
    the port's material rows (the GGX alphas among them) and its eval and
    sample outputs equal those from private copies, bit for bit."""
    wo_m, wi_m, u_m = lanes
    names, tab = _tables()
    shared = {k: _aligned(v) for k, v in tab.items()}
    before = {k: v.copy() for k, v in shared.items()}
    mid = np.repeat(np.arange(len(names), dtype=np.int32), N)
    jt = {k: jnp.asarray(v) for k, v in shared.items()}
    tt = {k: torch.from_numpy(v) for k, v in shared.items()}
    jax.block_until_ready(_both_jax(jt, jnp.asarray(mid), jnp.asarray(wo_m), jnp.asarray(wi_m),
                                    *map(jnp.asarray, u_m)))
    mp = tb.gather_mat(tt, _t(mid))
    got = (mp.ax, mp.ay, tb.bsdf_eval(mp, _t(wo_m), _t(wi_m)),
           tb.bsdf_sample(mp, _t(wo_m), *map(_t, u_m)))
    for k in shared:
        np.testing.assert_array_equal(shared[k], before[k], err_msg=k)
    mp_c = tb.gather_mat({k: _t(v) for k, v in tab.items()}, _t(mid))
    want = (mp_c.ax, mp_c.ay, tb.bsdf_eval(mp_c, _t(wo_m), _t(wi_m)),
            tb.bsdf_sample(mp_c, _t(wo_m), *map(_t, u_m)))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert torch.equal(a, b)
    ja_ax = np.asarray(jb.gather_mat(jt, jnp.asarray(mid)).ax)
    _close(mp.ax, ja_ax)


#: the crown's glass and metal functions held bit for bit against the
#: reference compiled on its own with jax.jit at the renders' optimisation
#: level: name -> the arguments made from the lanes (wo, wi, u) and a
#: second unit vector wh, GGX alphas ax, ay, cosines c, copper's eta, k.
#: _tr_sample11 is held inside tr_sample_wh, the one program the renders
#: compile it in (compiled on its own, XLA fuses A^2 into A^2 - 1)
_CROWN_FUNCS = {
    "fresnel_dielectric": lambda a: (a["c"], np.ones_like(a["c"]), np.full_like(a["c"], 1.5)),
    "fresnel_dielectric_varied": lambda a: (a["c"], a["ay"] + 1.0, a["ax"] + 1.0),
    "fresnel_conductor": lambda a: (a["c"], a["eta"], a["k"]),
    "tr_d": lambda a: (a["wh"], a["ax"], a["ay"]),
    "tr_lambda": lambda a: (a["wo"], a["ax"], a["ay"]),
    "tr_g": lambda a: (a["wo"], a["wi"], a["ax"], a["ay"]),
    "tr_g1": lambda a: (a["wo"], a["ax"], a["ay"]),
    "tr_sample_wh": lambda a: (a["wo"], a["u"][0], a["u"][1], a["ax"], a["ay"]),
    "tr_pdf": lambda a: (a["wo"], a["wh"], a["ax"], a["ay"]),
}


@pytest.fixture(scope="module")
def crown_args(lanes):
    wo, wi, u = lanes
    n = wo.shape[0]
    rng = np.random.default_rng(6)
    c = np.concatenate([rng.uniform(-1, 1, n - 64), np.full(64, 0.99995)]).astype(np.float32)
    return {"wo": wo, "wi": wi, "u": u, "wh": _dirs(rng, n), "c": c,
            "ax": rng.uniform(0.01, 1.0, n).astype(np.float32),
            "ay": rng.uniform(0.01, 1.0, n).astype(np.float32),
            "eta": np.tile(np.float32(_CU_ETA), (n, 1)), "k": np.tile(np.float32(_CU_K), (n, 1))}


def _bits_equal(got, want, what):
    got = [got] if torch.is_tensor(got) else list(got)
    want = [want] if not isinstance(want, (tuple, list)) else list(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if g.dtype == np.float32:
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32), err_msg=what)
        else:
            np.testing.assert_array_equal(g, w, err_msg=what)


@pytest.mark.parametrize("name", sorted(_CROWN_FUNCS))
def test_crown_functions_bit_equal_to_compiled_reference(name, crown_args):
    """Each function of the crown's specular glass and metal GGX, in the
    port's rounding, against the reference's compiled on its own: the
    products XLA fuses into their sums fused (1 - cos^2 in the Fresnel
    terms and in Lambda's trig, 1 + e in D, the conductor's terms as each
    of its fusions rounds them), bit for bit."""
    args = _CROWN_FUNCS[name](crown_args)
    fn = name.removesuffix("_varied")
    got = getattr(tb, fn)(*map(_t, args))
    _bits_equal(got, JitRef(jb).__getattr__(fn)(*args), name)


def _shading_step(bx, vm, lib):
    """One bounce's shading as the path integrator composes it (its
    _bounce_wave): the light-sampling half's bsdf_eval and the
    continuation's bsdf_sample on one material row, in one program, then
    the continuation's world direction and throughput. bx, vm: the bxdf
    and vecmath modules; lib: jnp or torch."""
    absf = lib.abs
    floor = (lambda x: lib.maximum(x, 1e-20)) if lib is jnp else (lambda x: lib.clamp(x, min=1e-20))

    def step(t, m, wo, wi, ss, ts, ns, ul, u1, u2):
        mp = bx.gather_mat(t, m)
        wo_l, wi_l = vm.to_local(wo, ss, ts, ns), vm.to_local(wi, ss, ts, ns)
        f, pdf = bx.bsdf_eval(mp, wo_l, wi_l)
        f = f * absf(vm.dot(wi, ns))[..., None]
        bs = bx.bsdf_sample(mp, wo_l, ul, u1, u2)
        wi_w = vm.normalize(vm.to_world(bs.wi, ss, ts, ns))
        thr = bs.f * (absf(vm.dot(wi_w, ns)) / floor(bs.pdf))[..., None]
        return (f, pdf, *bs, wi_w, thr)
    return step


@pytest.mark.parametrize("name", ["metal", "metal_aniso", "glass"])
def test_crown_materials_bit_equal_to_compiled_reference(name, lanes):
    """The crown's materials in the rounding the renders run, against the
    reference compiled with jax.jit, bit for bit: one bounce's shading
    step composed as the path integrator composes it (bsdf_eval, then
    bsdf_sample with the VNDF reflection and the refraction's terms
    fused, the world direction and the throughput) in a shading frame
    made from the lanes; bsdf_sample compiled on its own; and the metal
    lobe's _glossy_f and _glossy_pdf."""
    from tpu_pbrt.core import vecmath as jv
    from tpu_pbrt_torch.core import vecmath as tv

    wo, wi, u = lanes[0][:N], lanes[1][:N], lanes[2][:, :N]
    rng = np.random.default_rng(11)
    ns = _dirs(rng, N)
    ss = np.cross(ns, _dirs(rng, N))
    ss = (ss / np.linalg.norm(ss, axis=-1, keepdims=True)).astype(np.float32)
    ts = np.cross(ns, ss).astype(np.float32)
    names, tab = _tables()
    mid = np.full(N, names.index(name), np.int32)
    tt = {k: _t(v) for k, v in tab.items()}
    frame = (wo, wi, ss, ts, ns, u[0], u[1], u[2])
    _bits_equal(_shading_step(tb, tv, torch)(tt, _t(mid), *map(_t, frame)),
                jit_ref(_shading_step(jb, jv, jnp))(tab, mid, *frame), f"{name} shading step")
    mp = tb.gather_mat(tt, _t(mid))
    sample = jit_ref(lambda t, m, a, b, c, d: tuple(jb.bsdf_sample(jb.gather_mat(t, m), a, b, c,
                                                                    d)))
    _bits_equal(tuple(tb.bsdf_sample(mp, _t(wo), *map(_t, u))),
                sample(tab, mid, wo, u[0], u[1], u[2]), f"{name} bsdf_sample")
    if name.startswith("metal"):
        for fn in ("_glossy_f", "_glossy_pdf"):
            want = jit_ref(lambda t, m, a, b, fn=fn: getattr(jb, fn)(jb.gather_mat(t, m), a, b))
            _bits_equal(getattr(tb, fn)(mp, _t(wo), _t(wi)), want(tab, mid, wo, wi),
                        f"{name} {fn}")
