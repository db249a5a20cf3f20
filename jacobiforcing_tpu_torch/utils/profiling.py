"""The serving engine's spans and the `PROFILE=1` report.

A span times one phase of `LLMEngine` on the host clock into the engine's
`stats` dict: `stats["<name>_s"]` gets its seconds and `stats["<name>_self_s"]`
those less the seconds of the spans opened inside it, so the self times of
the spans inside `step` add up to `step_s`.  A span declared a device wait
(its name ends in `.wait`) also adds its seconds to `stats["device_wait_s"]`;
it times a read-back the engine makes anyway, and nothing here waits for the
device.  That bookkeeping is always on: two clock reads and a few dict
updates per span.

Only while a torch profiler records (`torch.autograd._profiler_enabled()`),
or with `PROFILE=1` in the environment when the engine was made, a span also
opens `torch.profiler.record_function("engine.<name>")`, so the engine's
phases land in the profiler's trace beside the device's kernels, on its
clock.  Entering `record_function` costs microseconds even with no profiler
recording, which is why it is skipped otherwise.

The spans.  They run inside `step` (`generate_stream` also flushes between
steps); an indented one is a device wait inside the span above it, and
`commit` also runs inside `flush`:

    step            all of `LLMEngine.step`
    schedule        `Scheduler.schedule`
    flush           landing every pending Jacobi chunk (`_flush_pending`)
    prefill         a prefill batch, chunked segments included
    prefill.wait      its read-back of the draft and logits
    ar              an AR step through its bucket's program
    ar.wait           its read-back of the next tokens
    dispatch        loading a Jacobi chunk and launching its first trip
    trips           the rest of the chunk's trips (`runner.ChunkRun.finish`)
    trips.wait        the flag read after each trip
    commit          committing a chunk's tokens to the host mirrors
    commit.wait       the chunk's read-back
    mr              an eager MR chunk
    onpolicy        an eager on-policy block

`report` turns a window's stats delta into the `PROFILE=1` report.
"""

from __future__ import annotations

import contextlib
import os
from time import perf_counter_ns
from typing import Dict, Optional

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

SPANS = ("step", "schedule", "flush", "prefill", "prefill.wait", "ar", "ar.wait", "dispatch",
         "trips", "trips.wait", "commit", "commit.wait", "mr", "onpolicy")
# stats keys that hold a gauge, not a sum a delta can be taken of
_GAUGES = ("wall_s",)


class Span:
    """One named phase, a context manager.  Its open frames live on the
    owner's stacks, by depth."""

    __slots__ = ("owner", "label", "total", "own", "wait")

    def __init__(self, owner: "Spans", name: str):
        self.owner = owner
        self.label = "engine." + name
        self.total = name + "_s"
        self.own = name + "_self_s"
        self.wait = name.endswith(".wait")

    def __enter__(self):
        owner = self.owner
        depth = owner.depth + 1
        owner.depth = depth
        owner.inner[depth] = 0
        if owner.requested or _profiler_enabled():
            owner.ranges[depth] = rf = record_function(self.label)
            rf.__enter__()
        owner.start[depth] = perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = perf_counter_ns()
        owner = self.owner
        depth = owner.depth
        dt = t1 - owner.start[depth]
        stats = owner.stats
        stats[self.total] += dt * 1e-9
        stats[self.own] += (dt - owner.inner[depth]) * 1e-9
        if self.wait:
            stats["device_wait_s"] += dt * 1e-9
        owner.depth = depth - 1
        owner.inner[depth - 1] += dt
        rf = owner.ranges[depth]
        if rf is not None:
            owner.ranges[depth] = None
            rf.__exit__(None, None, None)
        return False


class Spans:
    """The spans of one engine, bound to its `stats` dict (which gets a zero
    for each of their keys).  `spans["commit"]` is the span named so."""

    MAX_DEPTH = 32

    def __init__(self, stats: Dict[str, float]):
        self.stats = stats
        # PROFILE=1: open every span's range; read once, not per span
        self.requested = os.environ.get("PROFILE", "0") == "1"
        # by depth (0: outside every span): start ns, ns of the spans closed
        # inside, the profiler's range
        self.depth = 0
        self.start = [0] * self.MAX_DEPTH
        self.inner = [0] * self.MAX_DEPTH
        self.ranges = [None] * self.MAX_DEPTH
        self._spans = {name: Span(self, name) for name in SPANS}
        for name in SPANS:
            stats.setdefault(name + "_s", 0.0)
            stats.setdefault(name + "_self_s", 0.0)
        stats.setdefault("device_wait_s", 0.0)

    def __getitem__(self, name: str) -> Span:
        return self._spans[name]


class NoSpans:
    """What code given no spans times with: every name is a null context."""

    _null = contextlib.nullcontext()

    def __getitem__(self, name: str):
        return self._null


def stats_delta(before: Dict[str, float], after: Dict[str, float]) -> Dict[str, float]:
    """`after` less `before`, key by key (a key new in `after` counts from 0)."""
    return {k: v - before.get(k, 0) for k, v in after.items() if k not in _GAUGES}


def report(delta: Dict[str, float], window_s: Optional[float] = None, programs=None) -> str:
    """The `PROFILE=1` report of a window: each span that ran with its total
    and self time, the counters that moved, tokens per forward, tokens per
    second (given the window's seconds) and, given the engine's
    `DecodePrograms`, its programs and the seconds their graphs took to
    capture."""
    lines = ["=== engine profile ==="]
    step = delta.get("step_s", 0.0)
    lines.append(f"  {'span':<14} {'total ms':>10} {'self ms':>10} {'self % of step':>15}")
    for name in SPANS:
        total = delta.get(name + "_s", 0.0)
        if total <= 0:
            continue
        own = delta.get(name + "_self_s", 0.0)
        share = f"{100 * own / step:14.1f}%" if step > 0 else f"{'':>15}"
        lines.append(f"  {name:<14} {total * 1e3:10.1f} {own * 1e3:10.1f} {share}")
    span_keys = {name + suffix for name in SPANS for suffix in ("_s", "_self_s")}
    counters = {k: v for k, v in delta.items() if k not in span_keys and v}
    for k in sorted(counters):
        v = counters[k]
        lines.append(f"  {k}: {round(v, 4) if isinstance(v, float) else v}")
    gen, it = delta.get("generated_tokens", 0), delta.get("jacobi_iterations", 0)
    if it > 0:
        lines.append(f"  tokens_per_forward: {gen / it:.3f}")
    if window_s:
        lines.append(f"  tokens_per_second: {gen / window_s:.2f} over {window_s:.3f} s")
    if programs is not None:
        lines.append(f"  programs: {len(programs.programs)}, of them CUDA graphs "
                     f"{programs.num_graphs}, captured in {sum(programs.capture_s.values()):.2f} s")
    return "\n".join(lines)
