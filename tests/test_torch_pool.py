"""The port's persistent pool (`PathIntegrator.pool_chunk`) on the CPU:
against the port's own fixed batch, against the JAX package's pool
render of the small killeroo, and the pieces it is built from.

The JAX pool render takes longer here than this file's budget, so it is
read from tests/torch_golden/killeroo_small_pool.npz, written by
tests/torch_golden/make_golden.py (which records the JAX commit).

Tolerances:
- pool == fixed batch at spp = 1 to 1e-6 (max abs), rays exact: each
  pixel receives one sample either way, so only the deposit path differs;
- pool vs fixed batch at spp = 4: rtol 1e-4, atol 1e-5 (the reference's
  own bound in tests/test_wavefront.py: the pool deposits in termination
  order, so the per-pixel sums round differently), rays exact;
- pool vs the JAX pool golden: rays, waves and every wave counter
  exactly equal (the same lanes regenerate, terminate and deposit in the
  same waves), image MSE <= 1e-10 (float summation order);
- the knobs TORCH_PBRT_DEPOSIT_SEG and TORCH_PBRT_TELEMETRY change no
  image bit and no ray count: the segmented deposit keeps the full-width
  scatter's order, and the counters only observe;
- the sampler draws with a per-lane salt tensor equal the scalar-salt
  draws bit for bit, and the JAX package's draws with a salt array;
- the aligned fixed-batch deposit equals the reference's to 1e-6.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpu_pbrt.core import sampling as js
from tpu_pbrt.core.film import Film as JFilm
from tpu_pbrt.obs import counters as jcounters
from tpu_pbrt_torch.accel import stream as tstream
from tpu_pbrt_torch.config import cfg as tcfg
from tpu_pbrt_torch.core import sampling as ts
from tpu_pbrt_torch.core.film import Film as TFilm
from tpu_pbrt_torch.core.film import merge_film
from tpu_pbrt_torch.obs import counters as tcounters
from tpu_pbrt_torch.scenes import compile_api, make_killeroo_like

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "torch_golden", "killeroo_small_pool.npz")
SMALL = dict(res=16, spp=4, n_theta=12, n_phi=24, maxdepth=5)
POOL_STATS = ("pool", "n_waves", "mean_wave_occupancy", "regen")


def _render(regen: bool, pool: int = 0, knobs=None, **kw):
    knobs = dict(leaf_tris=64, regen=regen, pool=pool, **(knobs or {}))
    saved = {k: getattr(tcfg, k) for k in knobs}
    for k, v in knobs.items():
        setattr(tcfg, k, v)
    try:
        scene, integ = compile_api(make_killeroo_like(**{**SMALL, **kw}, device="cpu"))
        return scene, integ.render(scene)
    finally:
        for k, v in saved.items():
            setattr(tcfg, k, v)


@pytest.fixture(scope="module")
def small_pool():
    return _render(True, pool=256)


@pytest.fixture(scope="module")
def small_fixed():
    return _render(False)[1]


def test_pool_equals_fixed_batch_at_one_spp():
    _, fixed = _render(False, spp=1)
    _, pool = _render(True, spp=1)
    assert pool.stats["regen"] and "regen" not in fixed.stats
    assert pool.rays_traced == fixed.rays_traced > 256
    assert np.max(np.abs(pool.image - fixed.image)) <= 1e-6


def test_pool_matches_fixed_batch_at_four_spp(small_pool, small_fixed):
    _, pool = small_pool
    assert pool.rays_traced == small_fixed.rays_traced
    np.testing.assert_allclose(pool.image, small_fixed.image, rtol=1e-4, atol=1e-5)


def test_small_killeroo_pool_matches_jax_pool_render(small_pool):
    ref = np.load(GOLDEN)
    scene, res = small_pool
    assert scene.n_tris == int(ref["n_tris"])
    assert scene.dev["tstream"].n_treelets == int(ref["n_treelets"])
    assert res.stats["pool"] == int(ref["pool"]) == 256
    assert res.stats["tracer_mode"] == "plain"
    assert res.rays_traced == int(ref["rays_traced"])
    assert res.stats["n_waves"] == int(ref["n_waves"])
    assert res.stats["telemetry"]["counters"] == json.loads(str(ref["counters"]))
    assert res.stats["mean_wave_occupancy"] == pytest.approx(float(ref["mean_wave_occupancy"]),
                                                            rel=1e-12)
    img, want = res.image, ref["image"]
    assert img.shape == want.shape == (16, 16, 3) and np.isfinite(img).all()
    assert float(np.mean((img - want) ** 2)) <= 1e-10
    assert res.stats.get("truncated_chunks") is None and res.completed_fraction == 1.0


def test_pool_reads_the_host_once_per_wave(small_pool):
    _, res = small_pool
    assert res.stats["waves"] == res.stats["n_waves"]  # one fused traversal per pool wave
    assert res.stats["loop_host_reads_per_wave"] == 1.0


def test_pool_occupancy_with_regeneration():
    """16 refills of a 64-slot pool: regeneration keeps it nearly full."""
    _, res = _render(True, pool=64)
    assert res.stats["pool"] == 64
    assert res.stats["mean_wave_occupancy"] > 0.8
    hist = res.stats["telemetry"]["counters"]["occupancy_histogram"]
    assert sum(hist) == res.stats["n_waves"] and hist[-1] > sum(hist) // 2


def test_regen_off_leaves_no_pool_stats(small_fixed):
    for key in POOL_STATS:
        assert key not in small_fixed.stats
    # the fixed batch reports only the film firewall's count
    assert small_fixed.stats["telemetry"]["counters"] == {"nonfinite_deposits": 0}


@pytest.mark.parametrize("seg", [-1, 16, 256])
def test_deposit_width_changes_nothing(small_pool, seg):
    """TORCH_PBRT_DEPOSIT_SEG: full width (< 0 or >= pool) and a
    16-slot window against the default pool/4 = 64: the same image bit for
    bit, the same rays and counters."""
    _, want = small_pool
    _, res = _render(True, pool=256, knobs=dict(deposit_seg=seg))
    assert np.array_equal(res.image, want.image)
    assert res.rays_traced == want.rays_traced
    assert res.stats["telemetry"] == want.stats["telemetry"]


def test_telemetry_off_carries_no_counters(small_pool, small_fixed):
    """TORCH_PBRT_TELEMETRY=0: no counter block on either path, and the
    same image bit for bit and the same rays as with the counters on."""
    assert tcounters.maybe_zeros("cpu") is not None
    saved = tcfg.telemetry
    tcfg.telemetry = False
    try:
        assert tcounters.maybe_zeros("cpu") is None
        assert tcounters.bounce_update(None, alive=None, rays_before=None,
                                       rays_after=None) is None
    finally:
        tcfg.telemetry = saved
    for regen, (_, want) in ((True, small_pool), (False, (None, small_fixed))):
        _, res = _render(regen, pool=256 if regen else 0, knobs=dict(telemetry=False))
        assert "telemetry" not in res.stats and "telemetry" in want.stats
        assert np.array_equal(res.image, want.image)
        assert res.rays_traced == want.rays_traced
        assert res.stats.get("n_waves") == want.stats.get("n_waves")


def test_stream_intersect_split(small_pool):
    """Camera rays and finite-t_max shadow rays toward the area light in
    one batch: the split head is the full closest hit, the tail's bare
    prim is the full closest hit's and agrees with the any-hit test."""
    scene, _ = small_pool
    dev = scene.dev
    rng = np.random.default_rng(5)
    n = 256
    o = torch.from_numpy(np.array([0.0, 1.2, -3.4], np.float32)).expand(n, 3)
    tgt = torch.from_numpy(rng.uniform([-1.5, -0.7, -1.5], [1.5, 1.2, 1.5], (n, 3))
                           .astype(np.float32))
    d = torch.nn.functional.normalize(tgt - o, dim=-1)
    hit = tstream.stream_intersect(dev["tstream"], dev["tri_verts"], o, d, float("inf"))
    p = o + hit.t.clamp(max=10.0)[:, None] * d
    light = torch.from_numpy(rng.uniform([-1, 2.98, -1], [1, 2.98, 1], (n, 3)).astype(np.float32))
    wi = light - p
    dist = wi.norm(dim=-1)
    so = p + 1e-3 * wi / dist[:, None]
    sd = wi / dist[:, None]
    st_max = torch.where(hit.prim >= 0, dist * 0.999, torch.full_like(dist, -1.0))
    O, D = torch.cat([o, so]), torch.cat([d, sd])
    T = torch.cat([torch.full((n,), float("inf")), st_max])
    full = tstream.stream_intersect(dev["tstream"], dev["tri_verts"], O, D, T)
    head, tail = tstream.stream_intersect_split(dev["tstream"], dev["tri_verts"], O, D, T, n,
                                                tv9T=dev["tri_verts9T"])
    for a, b in zip(head, full):
        assert torch.equal(a, b[:n])
    assert torch.equal(tail, full.prim[n:])
    occluded = tstream.stream_intersect_p(dev["tstream"], so, sd, st_max)
    assert torch.equal(tail >= 0, occluded)
    assert 0 < int(occluded.sum()) < int((st_max > 0).sum())  # the test bites


@pytest.mark.parametrize("kind,spp", [("02", 16), ("random", 1)])
def test_sampler_takes_a_per_lane_salt(kind, spp):
    rng = np.random.default_rng(9)
    n = 512
    px, py, s = (rng.integers(0, 64, n).astype(np.int32) for _ in range(3))
    s %= spp
    depth = rng.integers(0, 6, n).astype(np.int32)
    salt = depth * 16 + 4
    tpx, tpy, tss, tsalt = (torch.from_numpy(a) for a in (px, py, s, salt))
    u = ts.sample_1d(kind, spp, tpx, tpy, tss, tsalt)
    u1, u2 = ts.sample_2d(kind, spp, tpx, tpy, tss, tsalt + 1)
    f = ts.uniform_float(tpx, tpy, tss, tsalt + 6)
    for k in range(0, 6):
        m = torch.from_numpy(depth == k)
        sc = int(k * 16 + 4)
        assert torch.equal(u[m], ts.sample_1d(kind, spp, tpx[m], tpy[m], tss[m], sc))
        v1, v2 = ts.sample_2d(kind, spp, tpx[m], tpy[m], tss[m], sc + 1)
        assert torch.equal(u1[m], v1) and torch.equal(u2[m], v2)
        assert torch.equal(f[m], ts.uniform_float(tpx[m], tpy[m], tss[m], sc + 6))
    ju = js.sample_1d(kind, spp, jnp.asarray(px), jnp.asarray(py), jnp.asarray(s),
                      jnp.asarray(salt))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))


def test_aligned_deposit_matches_reference():
    rng = np.random.default_rng(3)
    spp, npc, start = 4, 32, 64
    L = rng.uniform(0, 2, (npc * spp, 3)).astype(np.float32)
    L[5] = np.nan
    wt = rng.uniform(0.5, 1, npc * spp).astype(np.float32)
    fj, ft = JFilm(resolution=(16, 8)), TFilm(resolution=(16, 8))
    assert ft.aligned_chunk_pixels(npc * spp, spp) == fj.aligned_chunk_pixels(npc * spp, spp) == npc
    assert ft.aligned_chunk_pixels(3 * spp, spp) == 0  # 3 pixels do not tile 128
    sj = fj.add_samples_aligned(fj.init_state(), start, spp, None, jnp.asarray(L), jnp.asarray(wt))
    st = ft.add_samples_aligned(ft.init_state(), start, spp, torch.from_numpy(L),
                                torch.from_numpy(wt))
    np.testing.assert_allclose(st.rgb.numpy(), np.asarray(sj.rgb), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(st.weight.numpy(), np.asarray(sj.weight))
    both = merge_film(st, st)
    assert torch.equal(both.rgb, 2 * st.rgb) and torch.equal(both.weight, 2 * st.weight)


def test_wave_counters_match_reference():
    """bounce_update / pool_update / to_host against the reference's on
    the same wave, and the host-side merge and spread."""
    rng = np.random.default_rng(4)
    alive = rng.uniform(size=64) < 0.7
    before = rng.integers(0, 3, 64).astype(np.int32)
    after = before + rng.integers(0, 3, 64).astype(np.int32)
    upd = dict(regenerated=5, terminated=7, deposits=6, compacted=11, nonfinite=1)
    cj = jcounters.bounce_update(jcounters.zeros(), alive=jnp.asarray(alive),
                                 rays_before=jnp.asarray(before), rays_after=jnp.asarray(after))
    cj = jcounters.pool_update(cj, **{k: jnp.int32(v) for k, v in upd.items()})
    ct = tcounters.bounce_update(tcounters.zeros("cpu"), alive=torch.from_numpy(alive),
                                 rays_before=torch.from_numpy(before),
                                 rays_after=torch.from_numpy(after))
    ct = tcounters.pool_update(ct, **{k: torch.tensor(v, dtype=torch.int32)
                                      for k, v in upd.items()})
    assert tcounters.to_host([ct, ct]) == jcounters.to_host([cj, cj])
    a, b = tcounters.to_host([ct]), {"rays_traced": 3, "occupancy_histogram": [1, 2]}
    assert tcounters.merge_host(a, b) == jcounters.merge_host(a, b)
    assert tcounters.spread_stats([3, 5, 7]) == jcounters.spread_stats([3, 5, 7])
    assert tcounters.maybe_zeros("cpu") is not None
