"""Checkpoint / resume for in-progress renders (port of
tpu_pbrt/parallel/checkpoint.py, the same on-disk format).

Film accumulation is associative and every chunk is a pure function of
(scene, work range), so a checkpoint is the accumulated film plus the
chunk cursor; the counter-based sample streams make a resumed render
bit-identical to an uninterrupted one.

Format v4, shared with the reference (a file written by either package
loads in the other): a compressed npz with `version`, `rgb`, `weight`,
`splat`, `next_chunk`, `rays`, `fingerprint`, `counters` (the cumulative
wave-counter dict, JSON) and `checksum` (CRC32 over the film arrays and
the metadata). v2 (no counters, no checksum) and v3 (no checksum) files
still load.

Durability: a write is tmp + fsync(tmp) + rename + fsync(dir), and the
previous good file is kept as `<path>.prev` (hard-linked, so `path`
never goes missing). A torn or bit-flipped current file (checksum
mismatch, unreadable archive) falls back to `.prev`; a version or
fingerprint mismatch is misconfiguration and raises at once.

Chaos seams (tpu_pbrt_torch/chaos): `ckpt:torn|crash|bitflip@write=N`
faults are applied in `save_checkpoint` (a torn final file, a crash
between the tmp write and the rename, a seeded bit-flip), so the `.prev`
fallback is testable on the CPU. Write observers see every valid file
once it is published.

Deferred writes: the port deposits into the film in place, so a
checkpoint written after later chunks were dispatched must be taken from
a snapshot of the film as its cursor left it: `begin_host_copy`.
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch

from tpu_pbrt_torch.chaos import CHAOS
from tpu_pbrt_torch.core.film import FilmState

_FORMAT_VERSION = 4
#: versions load_checkpoint still understands
_COMPAT_VERSIONS = (2, 3, 4)

#: write observers: fn(path, next_chunk, rays) called whenever a valid
#: checkpoint is durably published (after the rename; never for the
#: crash or torn chaos outcomes, which publish nothing usable)
_WRITE_OBSERVERS: list = []


def register_write_observer(fn) -> None:
    _WRITE_OBSERVERS.append(fn)


def unregister_write_observer(fn) -> None:
    try:
        _WRITE_OBSERVERS.remove(fn)
    except ValueError:
        pass


class CorruptCheckpointError(ValueError):
    """The checkpoint file cannot be trusted (torn, short or bit-flipped:
    checksum mismatch or unparseable archive). Distinct from the plain
    ValueError of a version/fingerprint mismatch: corruption triggers the
    `.prev` fallback, misconfiguration never does."""


def _content_checksum(rgb: np.ndarray, weight: np.ndarray, splat: np.ndarray,
                      next_chunk: int, rays: int, fingerprint: str,
                      counters_json: str) -> int:
    crc = 0
    for a in (rgb, weight, splat):
        crc = zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)
    meta = f"{int(next_chunk)}|{int(rays)}|{fingerprint}|{counters_json}"
    return zlib.crc32(meta.encode(), crc) & 0xFFFFFFFF


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _fsync_dir(path: str) -> None:
    """fsync the containing directory so the rename itself is durable;
    best-effort (some filesystems refuse O_RDONLY on directories)."""
    try:
        _fsync_path(os.path.dirname(os.path.abspath(path)) or ".")
    except OSError:
        pass


def _rotate_prev(path: str) -> None:
    """Keep the current checkpoint as `<path>.prev` with no window where
    `path` is missing: hard-link it, and let the caller's os.replace swap
    the new data in. Falls back to a rename without hard links."""
    if not os.path.exists(path):
        return
    prev = path + ".prev"
    try:
        os.remove(prev)
    except FileNotFoundError:
        pass
    try:
        os.link(path, prev)
    except OSError:
        os.replace(path, prev)


class FilmSnapshot:
    """The film state as it stood when `begin_host_copy` was called, on
    the host once `wait()` returns."""

    __slots__ = ("_state", "_event")

    def __init__(self, state: FilmState, event=None):
        self._state = state
        self._event = event

    def wait(self) -> FilmState:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._state


def begin_host_copy(state: FilmState) -> FilmSnapshot:
    """Snapshot a film state for a deferred checkpoint write. On CUDA the
    copy into pinned host memory is enqueued with non_blocking on the
    current stream, so it reads the film after every op already enqueued
    (the chunk the cursor covers) and before any op enqueued later (the
    next chunks, which write the film in place), and streams out under
    their compute; a CUDA event marks its end. On the CPU the film is
    cloned at once."""
    if state.rgb.device.type != "cuda":
        return FilmSnapshot(FilmState(*(a.clone() for a in state)))
    host = []
    for a in state:
        h = torch.empty(a.shape, dtype=a.dtype, pin_memory=True)
        h.copy_(a, non_blocking=True)
        host.append(h)
    event = torch.cuda.Event()
    event.record()
    return FilmSnapshot(FilmState(*host), event)


def checkpoint_exists(path: str) -> bool:
    """True when `path` OR its `.prev` rotation holds a resumable file
    (load_checkpoint recovers through `.prev` when `path` is gone)."""
    return os.path.exists(path) or os.path.exists(path + ".prev")


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def save_checkpoint(path: str, state: FilmState, next_chunk: int, rays_so_far: int,
                    fingerprint: str = "", counters: Optional[Dict[str, Any]] = None):
    """Durably write the film state and cursor. `fingerprint` encodes
    what the cursor's meaning depends on (render_fingerprint);
    load_checkpoint refuses a mismatch. `counters` is the cumulative
    wave-counter dict (None/{} with telemetry killed)."""
    rgb, weight, splat = _host(state.rgb), _host(state.weight), _host(state.splat)
    counters_json = json.dumps(counters or {})
    checksum = _content_checksum(rgb, weight, splat, next_chunk, rays_so_far, fingerprint,
                                 counters_json)
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp,
        version=_FORMAT_VERSION,
        rgb=rgb,
        weight=weight,
        splat=splat,
        next_chunk=next_chunk,
        rays=rays_so_far,
        fingerprint=np.array(fingerprint),
        counters=np.array(counters_json),
        checksum=checksum,
    )
    # np.savez appends .npz when missing
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"

    fault = CHAOS.checkpoint_fault()
    if fault == "bitflip":
        # seeded single-byte corruption: the checksum (or the zip parse)
        # must catch it at load time
        with open(actual_tmp, "r+b") as f:
            off = CHAOS.bitflip_offset(os.path.getsize(actual_tmp))
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))

    # the data must be on disk before the rename publishes it
    _fsync_path(actual_tmp)

    if fault == "crash":
        # a process death between the tmp write and the rename: the tmp
        # file stays behind and the previous checkpoint stays current
        return

    if fault == "torn":
        # a torn write: rotate the good previous file, then publish a
        # truncated current one through its own tmp + replace (after the
        # hard-link rotation an in-place truncate would tear .prev too)
        with open(actual_tmp, "rb") as f:
            data = f.read()
        _rotate_prev(path)
        torn_tmp = actual_tmp + ".torn"
        with open(torn_tmp, "wb") as f:
            f.write(data[: max(len(data) // 3, 1)])
        os.replace(torn_tmp, path)
        os.remove(actual_tmp)
        _fsync_dir(path)
        return

    _rotate_prev(path)
    os.replace(actual_tmp, path)
    _fsync_dir(path)
    for obs in _WRITE_OBSERVERS:
        obs(path, int(next_chunk), int(rays_so_far))


def delete_checkpoint(path: str) -> None:
    """Remove a checkpoint and every sibling the writer can leave behind
    (`.prev`, an orphaned `.tmp.npz`)."""
    for p in (path, path + ".prev", path + ".tmp", path + ".tmp.npz"):
        try:
            os.remove(p)
        except FileNotFoundError:
            pass


def render_fingerprint(*, chunk: int, spp: int, total: int, scene) -> str:
    """The resume-compatibility key: the chunk size (device default or
    knob), spp and the work total, the triangle count and the film's
    resolution and sample bounds; any change invalidates the cursor."""
    film = scene.film
    return (
        f"chunk={chunk};spp={spp};total={total};tris={scene.n_tris};"
        f"film={film.full_resolution[0]}x{film.full_resolution[1]};"
        f"crop={film.sample_bounds()}"
    )


def _load_one(path: str, fingerprint: str = "", device="cpu"):
    """Load and verify ONE checkpoint file: CorruptCheckpointError for
    torn/flipped bytes, plain ValueError for a version or fingerprint
    mismatch."""
    try:
        with np.load(path) as z:
            version = int(z["version"])
            raw = {k: np.asarray(z[k]) for k in ("rgb", "weight", "splat")}
            next_chunk = int(z["next_chunk"])
            rays = int(z["rays"])
            saved_fp = str(z["fingerprint"].item()) if "fingerprint" in z else ""
            counters_json = str(z["counters"].item()) if "counters" in z else "{}"
            saved_crc = int(z["checksum"]) if "checksum" in z else None
    except (OSError, EOFError, KeyError, zipfile.BadZipFile, zlib.error) as e:
        raise CorruptCheckpointError(f"unreadable checkpoint {path}: {e}") from e
    except ValueError as e:
        # numpy raises ValueError on mangled headers/arrays
        raise CorruptCheckpointError(f"unparseable checkpoint {path}: {e}") from e

    if version not in _COMPAT_VERSIONS:
        raise ValueError(f"checkpoint {path}: unsupported version {version}")
    # an empty saved fingerprint (hand-written or pre-metadata file) is
    # accepted; only a conflicting one is an error
    if fingerprint and saved_fp and saved_fp != fingerprint:
        raise ValueError(
            f"checkpoint {path} was written for a different render configuration "
            f"(saved {saved_fp!r}, current {fingerprint!r}); delete it or restore the "
            "original settings to resume"
        )
    if saved_crc is not None:
        crc = _content_checksum(raw["rgb"], raw["weight"], raw["splat"], next_chunk, rays,
                                saved_fp, counters_json)
        if crc != saved_crc:
            raise CorruptCheckpointError(
                f"checkpoint {path}: content checksum mismatch (saved {saved_crc:#010x}, "
                f"computed {crc:#010x}): torn or bit-flipped write"
            )
    try:
        counters = json.loads(counters_json) or {}
    except ValueError:
        # the counters are telemetry; a mangled snapshot must not block
        # the film's resume
        counters = {}
    state = FilmState(*(torch.tensor(raw[k], dtype=torch.float32, device=device)
                        for k in ("rgb", "weight", "splat")))
    return state, next_chunk, rays, counters


def load_checkpoint(path: str, fingerprint: str = "", device="cpu"):
    """-> (FilmState on `device`, next_chunk, rays_so_far, counters).
    Raises ValueError when the checkpoint was written under a different
    render configuration; counters is {} for v2 files. A corrupt current
    file falls back to `<path>.prev`; only when both are unusable does the
    corruption propagate."""
    try:
        return _load_one(path, fingerprint, device)
    except CorruptCheckpointError as e:
        prev = path + ".prev"
        if os.path.exists(prev):
            from tpu_pbrt_torch.utils.error import Warning as _W

            _W(f"checkpoint {path} is corrupt ({e}); falling back to the previous good "
               f"checkpoint {prev}")
            return _load_one(prev, fingerprint, device)
        raise CorruptCheckpointError(
            f"checkpoint {path} is corrupt and no {prev} fallback exists: {e}"
        ) from e
