"""Per-wave counter block of the persistent-pool drain (port of
tpu_pbrt/obs/counters.py).

The counters are device tensors carried through `pool_chunk`'s host loop
and updated per wave inside `_bounce_wave` (rays, occupancy bin) and the
pool body (regenerated, terminated, deposits, compacted, non-finite).
They are never read mid-loop: `to_host` fetches every chunk's block with
one read at the end of the render (or at a checkpoint write).

Kill switch: `TORCH_PBRT_TELEMETRY=0` (`cfg.telemetry`). A disabled block
is carried as None and no counting op runs.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, NamedTuple, Optional

import torch

#: occupancy histogram resolution: bin k counts waves whose live-lane
#: fraction fell in [k/N, (k+1)/N) (a full wave lands in the last bin)
N_OCC_BINS = 8

#: host-dict field names, in WaveCounters field order
HOST_FIELDS = (
    "rays_traced",
    "lanes_regenerated",
    "lanes_terminated",
    "film_deposits",
    "lanes_compacted",
    "nonfinite_deposits",
    "occupancy_histogram",
)


class WaveCounters(NamedTuple):
    """Per-drain counter block: int32 device scalars, and the occupancy
    histogram as an int32 (N_OCC_BINS,) tensor."""

    #: rays traced (camera continuations + shadow rays)
    rays: torch.Tensor
    #: pool lanes refilled with fresh camera rays from the work counter
    regenerated: torch.Tensor
    #: lanes whose path died this wave (miss / RR kill / maxdepth)
    terminated: torch.Tensor
    #: film deposits (terminated lanes whose pending NEE also settled)
    deposits: torch.Tensor
    #: live lanes relocated by the compaction sort (slot index changed)
    compacted: torch.Tensor
    #: deposits whose radiance carried NaN/Inf and was scrubbed to zero
    nonfinite: torch.Tensor
    #: per-wave occupancy histogram (live lanes / pool width at trace time)
    occ_hist: torch.Tensor


def enabled() -> bool:
    """The kill-switch gate."""
    from tpu_pbrt_torch.config import cfg

    return bool(cfg.telemetry)


def zeros(device) -> WaveCounters:
    """A fresh counter block on `device`."""
    z = torch.zeros((), dtype=torch.int32, device=device)
    return WaveCounters(
        rays=z, regenerated=z, terminated=z, deposits=z, compacted=z, nonfinite=z,
        occ_hist=torch.zeros((N_OCC_BINS,), dtype=torch.int32, device=device),
    )


def maybe_zeros(device) -> Optional[WaveCounters]:
    """zeros() when telemetry is on, None when it is killed."""
    return zeros(device) if enabled() else None


def bounce_update(ctr: Optional[WaveCounters], *, alive, rays_before,
                  rays_after) -> Optional[WaveCounters]:
    """One trace wave's counting, from inside `_bounce_wave`: the rays of
    this wave and the occupancy-histogram bin of its live-lane fraction.
    `alive` is the pre-trace live mask, rays_before/after the per-lane ray
    accumulators around the wave."""
    if ctr is None:
        return None
    width = alive.shape[0]
    live = alive.sum(dtype=torch.int32)
    wave_rays = (rays_after - rays_before).sum(dtype=torch.int32)
    bin_ix = torch.clamp(torch.div(live * N_OCC_BINS, width, rounding_mode="floor"),
                         0, N_OCC_BINS - 1)
    one_hot = (torch.arange(N_OCC_BINS, dtype=torch.int32, device=alive.device) == bin_ix).to(
        torch.int32)
    return ctr._replace(rays=ctr.rays + wave_rays, occ_hist=ctr.occ_hist + one_hot)


def pool_update(ctr: Optional[WaveCounters], *, regenerated, terminated, deposits,
                compacted, nonfinite=None) -> Optional[WaveCounters]:
    """The drain loop's structural counters, from the `pool_chunk` body:
    each argument is this wave's int32 count. nonfinite is the film
    firewall's scrubbed-deposit count (None leaves the field as it is)."""
    if ctr is None:
        return None
    upd = ctr._replace(
        regenerated=ctr.regenerated + regenerated,
        terminated=ctr.terminated + terminated,
        deposits=ctr.deposits + deposits,
        compacted=ctr.compacted + compacted,
    )
    if nonfinite is not None:
        upd = upd._replace(nonfinite=ctr.nonfinite + nonfinite)
    return upd


# -- host side (the one read at the drain boundary) ------------------------


def to_host(ctrs: Iterable[WaveCounters]) -> Dict[str, Any]:
    """Sum a list of per-chunk counter blocks into the canonical host
    dict (ints + histogram list), reading them all with ONE transfer."""
    ctrs = list(ctrs)
    if not ctrs:
        return {}
    rows = torch.stack([
        torch.cat([torch.stack(list(c[:6])), c.occ_hist]) for c in ctrs
    ]).sum(dim=0, dtype=torch.int64).tolist()
    out: Dict[str, Any] = dict(zip(HOST_FIELDS[:6], rows[:6]))
    out["occupancy_histogram"] = rows[6:]
    return out


def merge_host(a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
    """Sum two host counter dicts (checkpoint-resume seeding: the saved
    cumulative snapshot + this process's drain)."""
    if not a:
        return dict(b)
    if not b:
        return dict(a)
    out: Dict[str, Any] = {}
    for k in set(a) | set(b):
        va, vb = a.get(k), b.get(k)
        if isinstance(va, list) or isinstance(vb, list):
            va = va or []
            vb = vb or []
            n = max(len(va), len(vb))
            va = va + [0] * (n - len(va))
            vb = vb + [0] * (n - len(vb))
            out[k] = [int(x) + int(y) for x, y in zip(va, vb)]
        else:
            out[k] = int(va or 0) + int(vb or 0)
    return out


def spread_stats(per_device_waves) -> Dict[str, Any]:
    """Per-device wave-count spread: how unevenly the per-device drains
    ran. rel_spread = (max - min) / mean; 0 on a single device."""
    waves = [int(w) for w in per_device_waves]
    if not waves:
        return {}
    mean = sum(waves) / len(waves)
    return {
        "per_device_waves": waves,
        "min": min(waves),
        "max": max(waves),
        "mean": mean,
        "rel_spread": (max(waves) - min(waves)) / max(mean, 1e-9),
    }
