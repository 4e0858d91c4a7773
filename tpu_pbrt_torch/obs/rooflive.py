"""Live-vs-static roofline cross-check (counterpart of tpu_pbrt/obs/rooflive.py).

analysis/cost.py computes STATIC per-wave costs (the bytes and FLOPs of
one pool wave, committed in analysis/budgets.json and carried on the
bench line as static_bytes_per_wave / static_flops_per_wave). A render
measures how many waves ran and how long they took, so

    live_bytes_per_sec = static_bytes_per_wave * waves / seconds

is the memory bandwidth the drain sustained under the static model, and
dividing by the card's peak gives the roofline fraction
`live_vs_static_ratio`. Readings:

- near 1: the drain is bandwidth-bound as the static model says;
- far below 1: the waves do not pay their modeled bytes: launch
  latency, host work or idle lanes dominate (the port's waves are
  host-bound, PERF.md section 5);
- above 1: the static model over-counts (a fused kernel moves less than
  the unfused traffic it charges).

The ratio is null when the device's peak is unknown: the CPU, or a card
outside the table. The table holds the H100 only, the card the port is
measured on.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

#: peak memory bandwidth per device, bytes/s (NVIDIA's data sheet: the
#: H100 SXM5's HBM3; used only to normalize the live bandwidth)
PLATFORM_HBM_BYTES_PER_SEC = {
    "h100": 3.35e12,
}


def platform_hbm_peak(device_kind: Optional[str]) -> Optional[float]:
    """Peak memory bytes/s for a device name (torch.cuda.get_device_name,
    substring match, case-insensitive, the longest key wins); None when
    unknown (the CPU included)."""
    if not device_kind:
        return None
    kind = device_kind.lower()
    best = None
    for key, peak in PLATFORM_HBM_BYTES_PER_SEC.items():
        if key in kind and (best is None or len(key) > len(best[0])):
            best = (key, peak)
    return best[1] if best else None


def live_vs_static(
    *,
    waves: Optional[int],
    seconds: Optional[float],
    static_bytes_per_wave: Optional[int] = None,
    static_flops_per_wave: Optional[int] = None,
    device_kind: Optional[str] = None,
    n_devices: int = 1,
) -> Dict[str, Any]:
    """The bench line's telemetry fields. Never raises: a missing input
    nulls the fields that depend on it."""
    out: Dict[str, Any] = {
        "live_bytes_per_sec": None,
        "live_flops_per_sec": None,
        "hbm_peak_bytes_per_sec": None,
        "live_vs_static_ratio": None,
    }
    if not waves or not seconds or seconds <= 0:
        return out
    wave_rate = waves / seconds
    if static_bytes_per_wave:
        out["live_bytes_per_sec"] = static_bytes_per_wave * wave_rate
    if static_flops_per_wave:
        out["live_flops_per_sec"] = static_flops_per_wave * wave_rate
    peak = platform_hbm_peak(device_kind)
    if peak and out["live_bytes_per_sec"]:
        total_peak = peak * max(n_devices, 1)
        out["hbm_peak_bytes_per_sec"] = total_peak
        out["live_vs_static_ratio"] = round(out["live_bytes_per_sec"] / total_peak, 6)
    return out


def load_static_budget(entry: str = "pool_chunk", budgets_path: Optional[str] = None,
                       device: str = "cuda") -> Dict[str, Any]:
    """The committed static budget of an entry point on a device type
    (analysis/budgets.json), for a caller with no bench-shaped record at
    hand. {} when the file or the entry is missing: advisory, never
    fatal."""
    path = (Path(budgets_path) if budgets_path
            else Path(__file__).resolve().parent.parent / "analysis" / "budgets.json")
    try:
        doc = json.loads(path.read_text())
    except (OSError, ValueError):
        return {}
    return dict(doc.get("entries", {}).get(device, {}).get(entry, {}))
