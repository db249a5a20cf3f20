"""Profiling: named phase timers + decode throughput accounting.

A copy of `jacobiforcing_tpu/utils/profiling.py` (the reference ProfileTimer,
inference_engine/engine/model_runner.py:26-152): gated by PROFILE=1, named
start/stop timers with a device sync, per-category report, and a
TPF/TPS/efficiency summary with a theoretical-max line.  The bucket counters
are the reference's CUDA-graph hit/miss counters (model_runner.py:173-175,
376-398) again: each distinct (kind, bucket key) is one decode program, its
CUDA graph's capture is the miss and each replay a hit (eagerly, each run of
the program is a use).
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from typing import Callable, Dict, Optional


def profiling_enabled() -> bool:
    return os.environ.get("PROFILE", "0") == "1"


class ProfileTimer:
    def __init__(self, sync: Optional[Callable[[], None]] = None):
        # sync: blocks until device work completes (torch.cuda.synchronize)
        self.sync = sync
        self.times: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._open: Dict[str, float] = {}
        self.tokens = 0
        self.iterations = 0
        self.bucket_uses: Dict[tuple, int] = defaultdict(int)
        self.t0 = time.perf_counter()

    # --- timers ---
    def start(self, name: str) -> None:
        self._open[name] = time.perf_counter()

    def stop(self, name: str) -> None:
        t = self._open.pop(name, None)
        if t is None:
            return
        if self.sync is not None:
            self.sync()
        self.times[name] += time.perf_counter() - t
        self.counts[name] += 1

    # --- decode accounting ---
    def add_tokens(self, n: int) -> None:
        self.tokens += n

    def add_iteration(self, n: int = 1) -> None:
        self.iterations += n

    def record_bucket(self, kind: str, key: tuple) -> None:
        """One use of a bucket's program: the first is its graph's capture
        (the miss), every later one a replay (a hit)."""
        self.bucket_uses[(kind,) + key] += 1

    # --- report ---
    @property
    def wall(self) -> float:
        return time.perf_counter() - self.t0

    def summary(self) -> Dict[str, float]:
        tpf = self.tokens / self.iterations if self.iterations else 0.0
        tps = self.tokens / self.wall if self.wall > 0 else 0.0
        fwd = self.times.get("forward", 0.0)
        max_tps = (
            self.tokens / fwd if fwd > 0 else 0.0
        )  # tokens over pure-forward time = theoretical max
        return {
            "tokens": self.tokens,
            "iterations": self.iterations,
            "tokens_per_forward": round(tpf, 3),
            "tokens_per_second": round(tps, 2),
            "theoretical_max_tps": round(max_tps, 2),
            "efficiency": round(tps / max_tps, 3) if max_tps else 0.0,
            "wall_s": round(self.wall, 3),
        }

    def report(self) -> str:
        lines = ["=== profile report ==="]
        total = sum(self.times.values())
        for name in sorted(self.times, key=self.times.get, reverse=True):
            t = self.times[name]
            lines.append(
                f"  {name:<24} {t*1e3:9.1f} ms  ({self.counts[name]:5d} calls,"
                f" {100*t/max(total,1e-9):5.1f}%)"
            )
        hits = sum(v - 1 for v in self.bucket_uses.values() if v > 0)
        lines.append(
            f"  programs: {len(self.bucket_uses)} shape buckets (captures),"
            f" {hits} replays"
        )
        for k, v in self.summary().items():
            lines.append(f"  {k}: {v}")
        return "\n".join(lines)


_GLOBAL: Optional[ProfileTimer] = None


def get_profiler(sync: Optional[Callable[[], None]] = None) -> Optional[ProfileTimer]:
    """Global profiler when PROFILE=1 (reference _get_profiler pattern,
    jacobi_decoding.py:18-23); `sync` is set on first use by a caller that
    has one (the engine passes its device's synchronize)."""
    global _GLOBAL
    if not profiling_enabled():
        return None
    if _GLOBAL is None:
        _GLOBAL = ProfileTimer()
    if _GLOBAL.sync is None:
        _GLOBAL.sync = sync
    return _GLOBAL


def reset_profiler() -> None:
    global _GLOBAL
    _GLOBAL = None
