"""Statistics registry and progress reporting (port of tpu_pbrt/utils/stats.py).

pbrt-v3 src/core/stats.{h,cpp} and progressreporter.{h,cpp}: the
STAT_COUNTER / STAT_RATIO / STAT_PERCENT / STAT_INT_DISTRIBUTION /
STAT_MEMORY_COUNTER registry with pbrt's categorized "Statistics:"
report ("category/Title" names), phase wall times around host loops,
and the +-style ETA bar on stderr (PBRT_PROGRESS_FREQUENCY, quiet mode).
The integrators that run their own render loop (sppm, mlt) report here.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict, Optional


class StatsRegistry:
    """Global named counters and distributions (stats.cpp StatsAccumulator)."""

    def __init__(self):
        self.counters: Dict[str, int] = defaultdict(int)
        self.memory: Dict[str, int] = defaultdict(int)
        self.ratios: Dict[str, list] = defaultdict(lambda: [0, 0])
        self.percents: Dict[str, list] = defaultdict(lambda: [0, 0])
        self.distributions: Dict[str, list] = defaultdict(lambda: [0, 0, None, None])
        self.phase_times: Dict[str, float] = defaultdict(float)

    # -- the STAT_* macros ---------------------------------------------------
    def counter(self, name: str, value: int = 1):
        self.counters[name] += int(value)

    def memory_counter(self, name: str, nbytes: int):
        self.memory[name] += int(nbytes)

    def ratio(self, name: str, num: int = 0, denom: int = 0):
        r = self.ratios[name]
        r[0] += int(num)
        r[1] += int(denom)

    def percent(self, name: str, num: int = 0, denom: int = 0):
        p = self.percents[name]
        p[0] += int(num)
        p[1] += int(denom)

    def distribution(self, name: str, value):
        d = self.distributions[name]
        d[0] += float(value)
        d[1] += 1
        d[2] = value if d[2] is None else min(d[2], value)
        d[3] = value if d[3] is None else max(d[3], value)

    @contextmanager
    def phase(self, name: str):
        """ProfilePhase: wall time per named phase."""
        t0 = time.time()
        try:
            yield
        finally:
            self.phase_times[name] += time.time() - t0

    def clear(self):
        self.__init__()

    # -- reporting (PrintStats / ReportProfilerResults) ----------------------
    def report(self, out=None) -> str:
        lines = ["Statistics:"]
        by_cat = defaultdict(list)

        def add(title, text):
            cat, t = title.split("/", 1) if "/" in title else ("", title)
            by_cat[cat].append((t, text))

        for name, v in sorted(self.counters.items()):
            add(name, f"{v:>12d}")
        for name, v in sorted(self.memory.items()):
            add(name, f"{v / (1024.0 * 1024.0):>12.2f} MiB")
        for name, (n, d) in sorted(self.ratios.items()):
            if d:
                add(name, f"{n:>12d} / {d:d} ({n / d:.2f}x)")
        for name, (n, d) in sorted(self.percents.items()):
            if d:
                add(name, f"{n:>12d} / {d:d} ({100.0 * n / d:.2f}%)")
        for name, (total, count, mn, mx) in sorted(self.distributions.items()):
            if count:
                add(name, f"{total / count:>12.3f} avg [range {mn} - {mx}]")
        for cat in sorted(by_cat):
            lines.append(f"  {cat or 'Misc'}")
            for t, text in by_cat[cat]:
                lines.append(f"    {t:<42}{text}")
        if self.phase_times:
            total = sum(self.phase_times.values())
            lines.append("  Profile (wall time)")
            for name, secs in sorted(self.phase_times.items(), key=lambda kv: -kv[1]):
                lines.append(f"    {name:<42}{secs:>10.2f}s "
                             f"({100.0 * secs / max(total, 1e-9):5.1f}%)")
        text = "\n".join(lines)
        if out is not None:
            print(text, file=out)
        return text


STATS = StatsRegistry()


@contextmanager
def profile_trace(log_dir: Optional[str] = None):
    """torch.profiler trace context (CPU and CUDA activities) that exports
    a Chrome trace (`trace.json`) into log_dir on exit: the reference's
    jax.profiler context. No-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class ProgressReporter:
    """progressreporter.cpp ProgressReporter: a +-style ETA bar, updated by
    the caller's loop."""

    def __init__(self, total_work: int, title: str, quiet: bool = False):
        from tpu_pbrt_torch.config import cfg

        self.total = max(1, int(total_work))
        self.title = title
        self.done_work = 0
        self.start = time.time()
        freq = cfg.progress_frequency
        # 0 means print on every update (pbrt's continuous mode)
        self.min_interval = float(freq) if freq is not None else 0.25
        self.quiet = quiet
        self._last_print = 0.0
        if not quiet:
            self._print()

    def update(self, amount: int = 1):
        self.done_work += amount
        if not self.quiet and time.time() - self._last_print >= self.min_interval:
            self._print()

    def _print(self):
        self._last_print = time.time()
        frac = min(1.0, self.done_work / self.total)
        elapsed = time.time() - self.start
        eta = elapsed / max(frac, 1e-9) * (1.0 - frac)
        filled = int(40 * frac)
        sys.stderr.write(f"\r{self.title}: [{'+' * filled}{' ' * (40 - filled)}] "
                         f"({elapsed:.1f}s|{eta:.1f}s)  ")
        sys.stderr.flush()

    def done(self):
        if not self.quiet:
            self.done_work = self.total
            self._print()
            sys.stderr.write("\n")
            sys.stderr.flush()
