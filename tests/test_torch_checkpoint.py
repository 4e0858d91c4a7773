"""The port's checkpoint/resume (tpu_pbrt_torch/parallel/checkpoint.py and
WavefrontIntegrator.render) against the reference's on-disk format.

- A checkpoint written by tpu_pbrt.parallel.checkpoint loads in the port
  and one written by the port loads in the reference: film arrays bit
  for bit, cursor, rays, fingerprint and counters equal. v2 and v3
  files (no checksum) still load, as in the reference.
- Both packages compute the same resume fingerprint for one scene.
- A torn current file falls back to `.prev`; a fingerprint mismatch
  raises ValueError (never the fallback).
- A small render stopped after its second checkpoint and resumed equals
  the uninterrupted render bit for bit (image, film state, rays and
  counters), and a checkpoint from another chunk size is refused.
- The chaos seams `ckpt:crash|torn|bitflip@write=N` leave the on-disk
  states the reference's leave (tests/test_chaos.py::test_chaos_ckpt_faults),
  each read back through the `.prev` fallback to the same cursor in both
  packages; write observers see every published file and none of the
  faulted ones.
- `begin_host_copy` snapshots the film as it stands: later in-place
  deposits do not reach it. A render at depth 2 stopped while its
  deferred checkpoint at cursor 3 waits on chunk 2 writes that file once
  the slice retires, and the resume equals the uninterrupted render.
"""

import os

import numpy as np
import pytest
import torch

from tpu_pbrt.chaos import CHAOS as JCHAOS
from tpu_pbrt.core.film import FilmState as JFilmState
from tpu_pbrt.parallel import checkpoint as jck
from tpu_pbrt_torch.chaos import CHAOS as TCHAOS
from tpu_pbrt_torch.config import cfg as tcfg
from tpu_pbrt_torch.core.film import FilmState
from tpu_pbrt_torch.integrators.common import ChunkPlan
from tpu_pbrt_torch.parallel import checkpoint as tck
from tpu_pbrt_torch.scenes import compile_api, make_killeroo_like

# pytest-xdist runs the suite in several worker processes, each of which
# would start one torch CPU thread per core and oversubscribe the machine
torch.set_num_threads(1)

FP = "chunk=1024;spp=4;total=1024;tris=532;film=16x16;crop=(0, 16, 0, 16)"
COUNTERS = {"rays_traced": 2911, "film_deposits": 1024, "occupancy_histogram": [3, 1, 0, 7]}
TINY = dict(res=8, spp=4, n_theta=12, n_phi=24, maxdepth=2)


def _film_arrays(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 5, (16, 16, 3)).astype(np.float32),
            rng.uniform(0, 4, (16, 16)).astype(np.float32),
            rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))


def test_reference_checkpoint_loads_in_port(tmp_path):
    path = str(tmp_path / "ref.npz")
    rgb, w, splat = _film_arrays(1)
    jck.save_checkpoint(path, JFilmState(rgb, w, splat), 3, 12345, fingerprint=FP,
                        counters=COUNTERS)
    st, nxt, rays, ctr = tck.load_checkpoint(path, FP)
    for a, b in zip(st, (rgb, w, splat)):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), b)
    assert (nxt, rays, ctr) == (3, 12345, COUNTERS)


def test_port_checkpoint_loads_in_reference(tmp_path):
    path = str(tmp_path / "port.npz")
    rgb, w, splat = _film_arrays(2)
    tck.save_checkpoint(path, FilmState(*(torch.from_numpy(a) for a in (rgb, w, splat))), 5, 777,
                        fingerprint=FP, counters=COUNTERS)
    st, nxt, rays, ctr = jck.load_checkpoint(path, FP)
    for a, b in zip(st, (rgb, w, splat)):
        assert np.array_equal(np.asarray(a), b)
    assert (nxt, rays, ctr) == (5, 777, COUNTERS)
    with np.load(path) as z:
        assert int(z["version"]) == 4 and int(z["checksum"]) > 0


@pytest.mark.parametrize("version", [2, 3])
def test_older_checkpoint_versions_load(tmp_path, version):
    """v2 files carry neither counters nor a checksum, v3 files counters
    but no checksum."""
    path = str(tmp_path / f"v{version}.npz")
    rgb, w, splat = _film_arrays(3)
    extra = {"counters": np.array('{"rays_traced": 9}')} if version == 3 else {}
    with open(path, "wb") as f:
        np.savez_compressed(f, version=version, rgb=rgb, weight=w, splat=splat, next_chunk=2,
                            rays=9, fingerprint=np.array(FP), **extra)
    st, nxt, rays, ctr = tck.load_checkpoint(path, FP)
    assert np.array_equal(st.rgb.numpy(), rgb) and (nxt, rays) == (2, 9)
    assert ctr == ({"rays_traced": 9} if version == 3 else {})
    assert (nxt, rays, ctr) == jck.load_checkpoint(path, FP)[1:]


def test_fingerprint_matches_reference():
    saved = tcfg.leaf_tris
    tcfg.leaf_tris = 64
    try:
        scene, integ = compile_api(make_killeroo_like(res=16, spp=4, n_theta=12, n_phi=24,
                                                      device="cpu"))
    finally:
        tcfg.leaf_tris = saved
    plan = integ.prepare_chunks(scene)
    assert plan.fingerprint == FP
    assert plan.fingerprint == jck.render_fingerprint(chunk=plan.chunk, spp=plan.spp,
                                                      total=plan.total, scene=scene)


def test_torn_checkpoint_falls_back_to_prev(tmp_path):
    path = str(tmp_path / "ck.npz")
    a, b = _film_arrays(4), _film_arrays(5)
    tck.save_checkpoint(path, FilmState(*(torch.from_numpy(x) for x in a)), 1, 10, FP)
    tck.save_checkpoint(path, FilmState(*(torch.from_numpy(x) for x in b)), 2, 20, FP)
    assert tck.load_checkpoint(path, FP)[1] == 2
    data = open(path, "rb").read()
    os.remove(path)  # `.prev` shares the inode: tear a fresh file
    with open(path, "wb") as f:
        f.write(data[: len(data) // 3])
    st, nxt, rays, _ = tck.load_checkpoint(path, FP)
    assert (nxt, rays) == (1, 10) and np.array_equal(st.rgb.numpy(), a[0])
    os.remove(path + ".prev")
    with pytest.raises(tck.CorruptCheckpointError):
        tck.load_checkpoint(path, FP)
    tck.delete_checkpoint(path)
    assert not tck.checkpoint_exists(path)


def test_fingerprint_mismatch_raises(tmp_path):
    path = str(tmp_path / "ck.npz")
    tck.save_checkpoint(path, FilmState(*(torch.from_numpy(x) for x in _film_arrays(6))), 1, 1, FP)
    tck.save_checkpoint(path, FilmState(*(torch.from_numpy(x) for x in _film_arrays(7))), 2, 2, FP)
    with pytest.raises(ValueError, match="different render configuration") as e:
        tck.load_checkpoint(path, FP.replace("chunk=1024", "chunk=2048"))
    assert not isinstance(e.value, tck.CorruptCheckpointError)


class _Stop(Exception):
    pass


def test_resumed_render_is_bit_identical(tmp_path, monkeypatch):
    """4 chunks of 64 work items through the pool: stopped while
    dispatching chunk 2 (after the checkpoints at cursors 1 and 2), then
    resumed from the file."""
    monkeypatch.setattr(tcfg, "leaf_tris", 64)
    scene, integ = compile_api(make_killeroo_like(**TINY, device="cpu"))
    full = integ.render(scene, chunk=64)
    assert full.stats["chunks"] == 4 and full.stats["regen"]

    path = str(tmp_path / "resume.npz")
    real = ChunkPlan.dispatch

    def stop_at_2(plan, state, c):
        if c == 2:
            raise _Stop
        return real(plan, state, c)

    monkeypatch.setattr(ChunkPlan, "dispatch", stop_at_2)
    with pytest.raises(_Stop):
        integ.render(scene, chunk=64, checkpoint_path=path, checkpoint_every=1)
    monkeypatch.setattr(ChunkPlan, "dispatch", real)
    assert tck.load_checkpoint(path)[1] == 2

    resumed = integ.render(scene, chunk=64, checkpoint_path=path, checkpoint_every=1)
    assert np.array_equal(resumed.image, full.image)
    for a, b in zip(resumed.film_state, full.film_state):
        assert torch.equal(a, b)
    assert resumed.rays_traced == full.rays_traced
    assert resumed.stats["telemetry"]["counters"] == full.stats["telemetry"]["counters"]
    assert tck.load_checkpoint(path)[1] == 4  # the final write covers every chunk
    with pytest.raises(ValueError, match="different render configuration"):
        integ.render(scene, chunk=128, checkpoint_path=path)


@pytest.mark.parametrize("kind,published", [("crash", [1]), ("torn", [1]), ("bitflip", [1, 2])])
def test_chaos_checkpoint_faults_match_reference(kind, published, tmp_path):
    """Two writes, the second faulted: both packages read back cursor 1
    (the crash never published; the torn and flipped files fall back to
    .prev), the observers saw the same publications (a bit-flip is
    published: only its checksum tells) and both leave the same files."""
    got = []
    for chaos, ck, state in ((TCHAOS, tck, lambda a: FilmState(*(torch.from_numpy(x) for x in a))),
                             (JCHAOS, jck, lambda a: JFilmState(*a))):
        d = tmp_path / ("port" if ck is tck else "ref")
        d.mkdir()
        path = str(d / "ck.npz")
        seen = []
        obs = lambda p, nxt, rays: seen.append(nxt)  # noqa: E731
        ck.register_write_observer(obs)
        try:
            chaos.install(f"ckpt:{kind}@write=2", seed=3)
            ck.save_checkpoint(path, state(_film_arrays(8)), 1, 10, FP)
            ck.save_checkpoint(path, state(_film_arrays(9)), 2, 20, FP)
            st, nxt, rays, _ = ck.load_checkpoint(path, FP)
        finally:
            ck.unregister_write_observer(obs)
            chaos.clear()
        assert np.array_equal(np.asarray(st.rgb), _film_arrays(8)[0])
        got.append((nxt, rays, seen, sorted(os.listdir(d))))
    assert got[0] == got[1] and got[0][:3] == (1, 10, published)


def test_write_observers_and_clean_writes(tmp_path):
    path = str(tmp_path / "ck.npz")
    seen = []
    obs = lambda p, nxt, rays: seen.append((os.path.basename(p), nxt, rays))  # noqa: E731
    tck.register_write_observer(obs)
    try:
        for i in range(3):
            tck.save_checkpoint(path, FilmState(*(torch.from_numpy(x) for x in _film_arrays(i))),
                                i + 1, 10 * i, FP)
    finally:
        tck.unregister_write_observer(obs)
        tck.unregister_write_observer(obs)  # a second removal is a no-op
    tck.save_checkpoint(path, FilmState(*(torch.from_numpy(x) for x in _film_arrays(5))), 9, 9, FP)
    assert seen == [("ck.npz", 1, 0), ("ck.npz", 2, 10), ("ck.npz", 3, 20)]
    assert tck.load_checkpoint(path + ".prev", FP)[1] == 3


def test_begin_host_copy_is_a_snapshot():
    st = FilmState(*(torch.from_numpy(x.copy()) for x in _film_arrays(3)))
    snap = tck.begin_host_copy(st)
    for a in st:
        a.add_(1.0)  # a later deposit, in place
    got = snap.wait()
    for a, b in zip(got, _film_arrays(3)):
        assert np.array_equal(a.numpy(), b)


def test_resume_from_a_deferred_checkpoint(tmp_path, monkeypatch):
    """Depth 2, a checkpoint every chunk: the one at cursor 3 is deferred
    to chunk 2's retire. Stopped in chunk 3's dispatch, the loop lets the
    window finish, so the file holds cursor 3 and chunks [0, 3) only."""
    monkeypatch.setattr(tcfg, "leaf_tris", 64)
    monkeypatch.setattr(tcfg, "pipeline", 2)
    scene, integ = compile_api(make_killeroo_like(**TINY, device="cpu"))
    full = integ.render(scene, chunk=64)
    path = str(tmp_path / "deferred.npz")
    real = ChunkPlan.dispatch
    writes = []
    obs = lambda p, nxt, rays: writes.append(nxt)  # noqa: E731

    def stop_at_3(plan, state, c):
        if c == 3:
            raise _Stop
        return real(plan, state, c)

    monkeypatch.setattr(ChunkPlan, "dispatch", stop_at_3)
    tck.register_write_observer(obs)
    try:
        with pytest.raises(_Stop):
            integ.render(scene, chunk=64, checkpoint_path=path, checkpoint_every=1)
    finally:
        tck.unregister_write_observer(obs)
    monkeypatch.setattr(ChunkPlan, "dispatch", real)
    assert writes == [1, 2, 3]
    resumed = integ.render(scene, chunk=64, checkpoint_path=path, checkpoint_every=1)
    for a, b in zip(resumed.film_state, full.film_state):
        assert torch.equal(a, b)
    assert resumed.rays_traced == full.rays_traced
