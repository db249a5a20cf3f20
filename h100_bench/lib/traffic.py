"""The one traffic generator: it reads a traffic file's parameters.

The sizes do not depend on the run's seed: `shape_seed` in the traffic file
draws a fixed pool of (prompt length, output length) pairs and, for an open
loop, a fixed schedule of gaps between arrivals.  The gaps are exponential,
scaled inside each block of the arrivals' `block` (32 if absent) so that
the block lasts exactly its count over the rate: Poisson arrivals given
their number per block, so that any window offers the rate it names, give
or take part of one block, and not whatever one draw of gaps averages.
The run's `--seed` only orders the pairs inside consecutive blocks of
`shuffle_block` requests, and draws the prompts' token ids: every block of
requests, as they are sent, holds the same sizes under every seed, so every
seed offers the same work in another order and runs spread by the system,
not by the draw.  A small `shuffle_block` keeps an open loop's bursts of
long requests where they fall under every seed.

Length distributions:
    {"dist": "uniform", "min": a, "max": b}                 integers in [a, b]
    {"dist": "lognormal", "median": m, "sigma": s, "min": a, "max": b}
        exp(ln m + s * N(0, 1)), rounded, clipped to [a, b]
Arrivals:
    {"kind": "closed", "clients": n}       each client sends its next request
                                           when its last one completes
    {"kind": "poisson", "rate": r, "block": k}
                                           requests/s, exponential gaps, each
                                           block of k arrivals lasting k / r
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class Request:
    index: int
    prompt: List[int]
    max_tokens: int


def draw_lengths(spec: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    if spec["dist"] == "uniform":
        return rng.integers(spec["min"], spec["max"] + 1, size=n)
    if spec["dist"] == "lognormal":
        x = np.exp(np.log(spec["median"]) + spec["sigma"] * rng.standard_normal(n))
        return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def normalised_gaps(gaps: np.ndarray, block: int) -> np.ndarray:
    """Scale each block of `block` gaps (the last may be shorter) so that its
    mean is exactly 1."""
    out = np.array(gaps, dtype=np.float64)
    for b in range(0, len(out), block):
        out[b:b + block] /= out[b:b + block].mean()
    return out


class Traffic:
    def __init__(self, traffic: dict, seed: int, vocab_size: int, rate: float = None):
        self.spec = traffic
        self.arrivals = dict(traffic["arrivals"])
        if rate is not None:
            self.arrivals["rate"] = rate
        pool = int(traffic["pool"])
        shape_rng = np.random.default_rng(int(traffic["shape_seed"]))
        prompt_lens = draw_lengths(traffic["prompt_len"], pool, shape_rng)
        output_lens = draw_lengths(traffic["output_len"], pool, shape_rng)
        block = int(traffic["shuffle_block"])
        self.unit_gaps = normalised_gaps(shape_rng.standard_exponential(pool),
                                         int(self.arrivals.get("block", 32)))
        rng = np.random.default_rng(seed)
        order = np.concatenate([b + rng.permutation(min(block, pool - b))
                                for b in range(0, pool, block)])
        self.prompt_lens = prompt_lens[order]
        self.output_lens = output_lens[order]
        self.vocab_size = vocab_size
        self._rng = rng
        self._next = 0

    @property
    def closed(self) -> bool:
        return self.arrivals["kind"] == "closed"

    @property
    def clients(self) -> int:
        return int(self.arrivals["clients"])

    def next_request(self) -> Request:
        """The next request of the pool (the pool repeats once used up)."""
        i = self._next
        self._next += 1
        k = i % len(self.prompt_lens)
        prompt = self._rng.integers(1, self.vocab_size, size=int(self.prompt_lens[k]))
        return Request(i, prompt.tolist(), int(self.output_lens[k]))

    def arrival_times(self, horizon_s: float) -> np.ndarray:
        """Due times (s after the window opens) of an open loop's arrivals up
        to `horizon_s`: the fixed gaps, scaled to the rate."""
        if self.arrivals["kind"] != "poisson":
            raise ValueError("arrival_times is for open loops")
        gaps = self.unit_gaps / float(self.arrivals["rate"])
        reps = int(np.ceil(horizon_s / gaps.sum())) + 1
        t = np.cumsum(np.tile(gaps, reps))
        return t[t <= horizon_s]
