"""Runtime configuration and device selection for the PyTorch port.

Only the knobs this package reads are here, each read ONCE at import
into the module-level `cfg` (tests set an attribute of `cfg` instead):

- TORCH_PBRT_LEAF_TRIS: triangles per stream-tracer treelet (default 512,
  accel/stream.py STREAM_LEAF_TRIS);
- TORCH_PBRT_SLAB: cap on pairs popped per traversal expand step;
- TORCH_PBRT_HEADROOM: worklist headroom scale (the stream tracer's
  buffers; below 1 a wave may drop pairs, which `n_drop` counts);
- TORCH_PBRT_CHUNK: camera rays per render dispatch;
- TORCH_PBRT_REGEN: the persistent pool (compaction + regeneration) for
  the path integrator, on by default; 0 renders the fixed batch;
- TORCH_PBRT_POOL: pool slots (0: a quarter of the chunk, at least
  min(chunk, 4096));
- TORCH_PBRT_DEPOSIT_SEG: width of the pool's segmented film deposit
  (0: pool/4 once the pool holds 256 slots; >= pool or < 0: full width);
- TORCH_PBRT_TELEMETRY: the pool's wave counters (on by default; 0
  carries none);
- TORCH_PBRT_MIPFILTER: the camera hits' ray-differential footprint and
  the mip filtering of image textures (on by default; 0 looks every
  texture up at its finest level);
- PBRT_PROGRESS_FREQUENCY: seconds between progress-bar updates (pbrt's
  own knob, read by utils/stats.py::ProgressReporter; 0: every update).

These are the reference's TPU_PBRT_CHUNK/_REGEN/_POOL/_DEPOSIT_SEG/
_TELEMETRY/_MIPFILTER under the port's prefix.

There is no switch between the hand-written kernels and their plain
versions: a CUDA tensor always goes through the kernel, a CPU tensor
through the plain version (kernels/).
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def _int(name: str, default: Optional[int]) -> Optional[int]:
    v = os.environ.get(name)
    return default if v in (None, "") else int(v)


def _flag(name: str, default: bool) -> bool:
    """Explicit spellings only: unset, empty or unrecognised keeps the
    default (the reference's rule, so `KNOB=` never flips a switch)."""
    v = os.environ.get(name, "").strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    return default


def _float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return default if v in (None, "") else float(v)


class Config:
    __slots__ = ("leaf_tris", "slab", "headroom", "chunk", "regen", "pool", "deposit_seg",
                 "telemetry", "mipfilter", "progress_frequency")

    def _load(self) -> "Config":
        #: triangles per treelet (None -> accel/stream.STREAM_LEAF_TRIS)
        self.leaf_tris: Optional[int] = _int("TORCH_PBRT_LEAF_TRIS", None)
        #: stream worklist slab cap (pairs per expand step)
        self.slab: int = _int("TORCH_PBRT_SLAB", 1 << 17)
        #: worklist headroom scale
        self.headroom: float = _float("TORCH_PBRT_HEADROOM", 1.0)
        #: camera rays per dispatch (None -> device default)
        self.chunk: Optional[int] = _int("TORCH_PBRT_CHUNK", None)
        #: persistent pool (compaction + regeneration) for `path`
        self.regen: bool = _flag("TORCH_PBRT_REGEN", True)
        #: pool slots (0 -> chunk/4 heuristic)
        self.pool: int = _int("TORCH_PBRT_POOL", 0)
        #: segmented pool deposit width (0 -> auto)
        self.deposit_seg: int = _int("TORCH_PBRT_DEPOSIT_SEG", 0)
        #: the pool's wave counters (obs/counters.py)
        self.telemetry: bool = _flag("TORCH_PBRT_TELEMETRY", True)
        #: trilinear / EWA mip selection from camera-ray differentials
        self.mipfilter: bool = _flag("TORCH_PBRT_MIPFILTER", True)
        #: progress-bar update interval in seconds (None -> 0.25)
        self.progress_frequency: Optional[float] = _float("PBRT_PROGRESS_FREQUENCY", None)
        return self


cfg = Config()._load()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    the CPU. A CUDA request without a visible card raises instead of
    falling back, so a measurement can never silently run on the host.
    On CUDA, float32 products are pinned to full float32 (no TF32): the
    reference contracts at Precision.HIGHEST."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tpu_pbrt_torch renders on a CUDA device by default and none "
                "is available; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
