"""Runtime configuration and device selection for the PyTorch port.

Only the knobs this package reads are here, each read ONCE at import
into the module-level `cfg` (tests set an attribute of `cfg` instead):

- TORCH_PBRT_LEAF_TRIS: triangles per stream-tracer treelet (default 512,
  accel/stream.py STREAM_LEAF_TRIS);
- TORCH_PBRT_SLAB: cap on pairs popped per traversal expand step;
- TORCH_PBRT_HEADROOM: worklist headroom scale (the stream tracer's
  buffers; below 1 a wave may drop pairs, which `n_drop` counts);
- TORCH_PBRT_CHUNK: camera rays per render dispatch.

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


def _float(name: str, default: float) -> float:
    v = os.environ.get(name)
    return default if v in (None, "") else float(v)


class Config:
    __slots__ = ("leaf_tris", "slab", "headroom", "chunk")

    def _load(self) -> "Config":
        #: triangles per treelet (None -> accel/stream.STREAM_LEAF_TRIS)
        self.leaf_tris: Optional[int] = _int("TORCH_PBRT_LEAF_TRIS", None)
        #: stream worklist slab cap (pairs per expand step)
        self.slab: int = _int("TORCH_PBRT_SLAB", 1 << 17)
        #: worklist headroom scale
        self.headroom: float = _float("TORCH_PBRT_HEADROOM", 1.0)
        #: camera rays per dispatch (None -> device default)
        self.chunk: Optional[int] = _int("TORCH_PBRT_CHUNK", None)
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
