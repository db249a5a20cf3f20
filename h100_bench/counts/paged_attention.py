"""Operations and bytes that kernel 1 (`csrc/paged_attention.cu`) needs.

Operations are counted over the visible (query, key) pairs only: 2 * D for
q.k and 2 * D for p.v per pair and query head.  A query at position p sees
the keys 0..p, or under a window W the keys max(0, p - W + 1)..p.  Bytes
count each K/V row the queries can see read once, each query read once and
each output written once; block tables and lengths are left out.
"""

from __future__ import annotations

import math


def pairs(first_pos, n_queries: int, window=None):
    """Visible pairs of queries at positions first_pos .. first_pos + n - 1.
    `first_pos` may be a mean over trips (a float); the count is then the
    count at that mean."""
    if window is None:
        return n_queries * first_pos + n_queries * (n_queries + 1) // 2
    # the first m queries see every key up to their own; the rest see `window`
    m = min(max(math.ceil(window - 1 - first_pos), 0), n_queries)
    return m * first_pos + m * (m + 1) // 2 + (n_queries - m) * window


def launch(first_pos, n_queries: int, NH: int, KH: int, D: int,
           kv_bytes: int = 2, q_bytes: int = 2, window=None):
    """(operations, bytes) of one sequence's queries in one launch."""
    ops = 4 * D * NH * pairs(first_pos, n_queries, window)
    keys = first_pos + n_queries
    if window is not None:
        keys -= max(0, first_pos - window + 1)
    nbytes = 2 * KH * D * kv_bytes * keys + 2 * n_queries * NH * D * q_bytes
    return ops, nbytes


def bound_s(ops: float, nbytes: float, flops_peak: float, bytes_peak: float):
    """(least seconds, which bound binds) for work of `ops` and `nbytes`."""
    t_ops, t_bytes = ops / flops_peak, nbytes / bytes_peak
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
