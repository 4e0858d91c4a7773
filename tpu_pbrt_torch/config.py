"""Runtime configuration and device selection for the PyTorch port.

Only the knobs this package reads are here, each read ONCE at import
into the module-level `cfg` (tests set an attribute of `cfg` instead):

- TORCH_PBRT_BVH: the acceleration structure, stream (the default) |
  packet | wide | binary (the per-ray and per-packet walkers;
  accel/{packet,wide,traverse}.py);
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
  own knob, read by utils/stats.py::ProgressReporter; 0: every update);
- TORCH_PBRT_PIPELINE: chunk-slices kept in flight by the render loop's
  dispatch window (default 2; 1 is the synchronous loop);
- TORCH_PBRT_COORDINATOR_ADDRESS: "host:port" of rank 0 for a multi-host
  mesh (`--multihost`), read at call time by `coordinator_address()`;
- TORCH_PBRT_AUDIT_DROPS / TORCH_PBRT_ALLOW_DROPS: the pre-render
  capacity audit (on) and its downgrade to a warning (off);
- TORCH_PBRT_FAULTS: the chaos fault plan (chaos/, empty: none);
- TORCH_PBRT_NONFINITE: the film firewall (scrub | raise | retry);
- TORCH_PBRT_RETRY_MAX / _RETRY_BACKOFF / _RETRY_BACKOFF_CAP /
  _RETRY_DEADLINE_S: the recovery ladder's attempt budget, backoff base
  and ceiling in seconds, and its deadline (8, 0.25, 30, 600);
- TORCH_PBRT_SERVE_PREFETCH / _SERVE_CHUNK / _SERVE_RESIDENT_MB /
  _SERVE_SLO_DEPTH / _SERVE_SLO_WAIT_S: the render service's next-job
  prefetch (on), slice width (the device chunk), resident-scene budget
  in MB (12288) and per-priority-class queue-depth and queue-wait
  targets (none); TORCH_PBRT_HEALTH_WEDGE_STEPS: the health watchdog's
  wedge threshold (12 steps);
- TORCH_PBRT_METRICS / _METRICS_PATH / _METRICS_EXEMPLARS,
  TORCH_PBRT_TRACE_PATH, TORCH_PBRT_FLIGHT_PATH / _FLIGHT_MAX_MB: the
  host-side metrics registry, the Chrome-trace file and the flight
  recorder (obs/).

These are the reference's TPU_PBRT_* knobs of the same names under the
port's prefix, with the reference's defaults.

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
    __slots__ = ("bvh", "leaf_tris", "slab", "headroom", "chunk", "regen", "pool", "deposit_seg",
                 "telemetry", "mipfilter", "progress_frequency", "pipeline", "audit_drops",
                 "allow_drops", "faults", "nonfinite", "retry_max", "retry_backoff",
                 "retry_backoff_cap", "retry_deadline", "metrics", "metrics_path",
                 "metrics_exemplars", "trace_path", "flight_path", "flight_max_mb",
                 "serve_prefetch", "serve_chunk", "serve_resident_mb", "serve_slo_depth",
                 "serve_slo_wait_s", "health_wedge_steps")

    def _load(self) -> "Config":
        #: acceleration structure: stream (default) | packet | wide | binary
        self.bvh: str = os.environ.get("TORCH_PBRT_BVH", "stream")
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
        #: in-flight dispatch window depth (parallel/mesh.py
        #: resolve_pipeline_depth; the strict firewall modes force 1)
        self.pipeline: int = _int("TORCH_PBRT_PIPELINE", 2)
        #: pre-render stream-capacity audit (an overflow raises)
        self.audit_drops: bool = _flag("TORCH_PBRT_AUDIT_DROPS", True)
        #: downgrade a detected capacity overflow to a warning
        self.allow_drops: bool = _flag("TORCH_PBRT_ALLOW_DROPS", False)
        #: chaos fault plan, installed once at chaos-package import
        self.faults: str = os.environ.get("TORCH_PBRT_FAULTS", "").strip()
        #: non-finite film firewall: scrub (zero + count), raise, retry
        nf = os.environ.get("TORCH_PBRT_NONFINITE", "").strip().lower()
        self.nonfinite: str = nf if nf in ("scrub", "raise", "retry") else "scrub"
        #: re-dispatch attempts per chunk before the render gives up
        self.retry_max: int = _int("TORCH_PBRT_RETRY_MAX", 8)
        #: re-dispatch backoff base and ceiling, seconds
        self.retry_backoff: float = _float("TORCH_PBRT_RETRY_BACKOFF", 0.25)
        self.retry_backoff_cap: float = _float("TORCH_PBRT_RETRY_BACKOFF_CAP", 30.0)
        #: seconds of one failure streak before the render gives up (0: none)
        self.retry_deadline: float = _float("TORCH_PBRT_RETRY_DEADLINE_S", 600.0)
        #: host-side metrics registry (obs/metrics.py; 0 records nothing)
        self.metrics: bool = _flag("TORCH_PBRT_METRICS", True)
        #: Prometheus text file the registry exports to (--metrics-path)
        self.metrics_path: Optional[str] = os.environ.get("TORCH_PBRT_METRICS_PATH") or None
        #: exemplars kept per histogram series
        self.metrics_exemplars: int = _int("TORCH_PBRT_METRICS_EXEMPLARS", 4)
        #: Chrome-trace JSON path of the span recorder (--trace)
        self.trace_path: Optional[str] = os.environ.get("TORCH_PBRT_TRACE_PATH") or None
        #: append-only JSONL flight-recorder path
        self.flight_path: Optional[str] = os.environ.get("TORCH_PBRT_FLIGHT_PATH") or None
        #: flight-recorder size cap in MB (None: unbounded)
        self.flight_max_mb: Optional[float] = _float("TORCH_PBRT_FLIGHT_MAX_MB", None)
        #: render service: pre-activate the next scheduled job (plan build,
        #: checkpoint film load, residency touch) while the current job's
        #: slice is in flight; never preempts, never changes the schedule
        self.serve_prefetch: bool = _flag("TORCH_PBRT_SERVE_PREFETCH", True)
        #: render-service slice width in camera rays, the preemption
        #: quantum (None: the device chunk)
        self.serve_chunk: Optional[int] = _int("TORCH_PBRT_SERVE_CHUNK", None)
        #: resident-scene budget in MB (LRU eviction above it). The
        #: reference's default, kept so that both caches evict alike in
        #: the parity tests
        self.serve_resident_mb: Optional[float] = _float("TORCH_PBRT_SERVE_RESIDENT_MB", 12288.0)
        #: per-priority-class queue-depth targets: "8" (every class) or
        #: "0=4,5=32" (serve/queue.py parse_slo_spec); empty: none
        self.serve_slo_depth: str = os.environ.get("TORCH_PBRT_SERVE_SLO_DEPTH", "").strip()
        #: per-class p90 queue-wait targets in seconds, same grammar
        self.serve_slo_wait_s: str = os.environ.get("TORCH_PBRT_SERVE_SLO_WAIT_S", "").strip()
        #: consecutive step() calls with runnable jobs and no cursor
        #: advance before the health watchdog reports a wedge
        self.health_wedge_steps: int = _int("TORCH_PBRT_HEALTH_WEDGE_STEPS", 12)
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


def coordinator_address() -> Optional[str]:
    """The multi-host coordinator's "host:port" (rank 0's rendezvous), or
    None: TORCH_PBRT_COORDINATOR_ADDRESS, read at call time (the
    reference's JAX_COORDINATOR_ADDRESS)."""
    return os.environ.get("TORCH_PBRT_COORDINATOR_ADDRESS") or None
