"""Operations and bytes that kernel 1 (`csrc/paged_attention.cu`) needs.

Operations are counted over the visible (query, key) pairs only: 2 * D for
q.k and 2 * D for p.v per pair and query head.  Bytes count each K/V row the
queries can see read once, each query read once and each output written
once; block tables and lengths are left out.
"""

from __future__ import annotations


def _pairs(first_pos: int, n_queries: int) -> int:
    """Visible pairs of queries at positions first_pos .. first_pos + n - 1,
    each seeing every key up to its own position."""
    return n_queries * first_pos + n_queries * (n_queries + 1) // 2


def launch(first_pos: int, n_queries: int, NH: int, KH: int, D: int,
           kv_bytes: int = 2, q_bytes: int = 2):
    """(operations, bytes) of one sequence's queries in one launch."""
    ops = 4 * D * NH * _pairs(first_pos, n_queries)
    keys = first_pos + n_queries
    nbytes = 2 * KH * D * kv_bytes * keys + 2 * n_queries * NH * D * q_bytes
    return ops, nbytes


def bound_s(ops: float, nbytes: float, flops_peak: float, bytes_peak: float):
    """(least seconds, which bound binds) for work of `ops` and `nbytes`."""
    t_ops, t_bytes = ops / flops_peak, nbytes / bytes_peak
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
