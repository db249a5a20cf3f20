"""The device trace of a traced window, reduced to what the metrics read.

`torch.profiler` records the host's operators and the card's kernels and
copies (CUPTI); the reduction reads the profiler's raw events
(`kineto_results.events()`), which is much faster than building its
`FunctionEvent` tree.  The traced window is the host span `bench.window`,
opened and closed right after a device synchronisation.

    busy_s       the union of the device's kernel, copy and set intervals
                 inside the window
    kernels      {name: [device seconds, launches]} inside the window
    idle gaps    the intervals of the window with nothing on the device,
                 each named by the innermost host span or operator running
                 at its start
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.window"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: Dict[str, List[float]] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def device_seconds(self, *needles: str) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name holds
        any of `needles` (lower case)."""
        s, n = 0.0, 0
        for name, (t, c) in self.kernels.items():
            low = name.lower()
            if any(k in low for k in needles):
                s += t
                n += int(c)
        return s, n

    def groups(self) -> Dict[str, float]:
        """Device seconds by kind, as `chip_smoke.py`'s profiles group them."""
        out = {"GEMM": 0.0, "paged_attention": 0.0, "copies and casts": 0.0, "other": 0.0}
        for name, (t, _) in self.kernels.items():
            low = name.lower()
            if "paged_attention" in low:
                out["paged_attention"] += t
            elif any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma")):
                out["GEMM"] += t
            elif "copy" in low or "memcpy" in low or "memset" in low:
                out["copies and casts"] += t
            else:
                out["other"] += t
        return out

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(((k, v[0]) for k, v in self.kernels.items()), key=lambda kv: -kv[1])[:n]


class Tracer:
    """Profile from `start()` to `stop()`; `read()` reduces the trace, after
    the window's drain, so that reading it delays no request."""

    def __init__(self, device):
        self.device = device
        self._prof = None
        self._span = None
        self.seconds = [0.0, 0.0]  # stopping the profiler, reading its trace

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.synchronize(self.device)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()

    def stop(self) -> None:
        import torch

        t = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.seconds[0] = time.perf_counter() - t

    def read(self) -> TraceSummary:
        t = time.perf_counter()
        summary = summarize(self._prof.profiler.kineto_results.events())
        self._prof = self._span = None
        self.seconds[1] = time.perf_counter() - t
        return summary


def summarize(events) -> TraceSummary:
    from torch.autograd import DeviceType

    win = [e for e in events if e.name() == WINDOW_SPAN and e.device_type() == DeviceType.CPU]
    if not win:
        raise RuntimeError("the trace holds no window span: the profiler recorded nothing")
    lo, hi = win[0].start_ns(), win[0].end_ns()
    dev: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    for e in events:
        a, b = e.start_ns(), e.end_ns()
        if b <= lo or a >= hi:
            continue
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation():
                continue  # a host range mirrored on the device's timeline
            dev.append((max(a, lo), min(b, hi), e.name()))
        elif e.name() != WINDOW_SPAN:
            host.append((a, b, e.name()))
    kernels: Dict[str, List[float]] = {}
    for a, b, name in dev:
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (b - a) / 1e9
        k[1] += 1
    dev.sort()
    busy = 0
    gaps: List[Tuple[int, int]] = []
    cur_a, cur_b = lo, lo
    for a, b, _ in dev:
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a = a
        cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    if hi > cur_b:
        gaps.append((cur_b, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    host.sort()
    named = []
    for a, b in gaps[:10]:
        inner = None
        for ha, hb, name in host:
            if ha > a:
                break
            if hb > a and (inner is None or ha >= inner[0]):
                inner = (ha, name)
        named.append((inner[1] if inner else "no host span", (b - a) / 1e9))
    return TraceSummary(window_s=(hi - lo) / 1e9, busy_s=busy / 1e9, kernels=kernels,
                        idle_gaps=named)


@contextlib.contextmanager
def span(name: str, on: bool):
    """A host span of the harness, recorded only while a trace runs."""
    if not on:
        yield
        return
    from torch.profiler import record_function

    with record_function(name):
        yield
