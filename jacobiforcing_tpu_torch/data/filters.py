"""Stages -1/0/3: dataset filtering, bucketing, downsampling.

Reference: generate_trajectory/data/-1_opencodeinstruct_data_filtering.py:6-45
(quality filter), 0_bucketing_opencodeinstruct.py (length-sorted shards),
3_postprocessing_data_length_filtering.py:1-60, 3_downsample_dataset.py:44-
(reservoir sampling).

The PyTorch port's own copy of `jacobiforcing_tpu/data/filters.py` (host code
with no array framework in it); `tests/test_torch_data.py` holds it to the
original.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, Iterable, List, Optional


def filter_by_quality(
    rows: Iterable[Dict[str, Any]],
    *,
    score_key: str = "average_test_score",
    min_score: float = 1.0,
    rank_key: Optional[str] = "llm_judgement_score",
    top_n: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Keep rows with perfect test score, optionally ranked by judge score."""
    kept = [r for r in rows if float(r.get(score_key, 0.0)) >= min_score]
    if rank_key is not None:
        kept.sort(key=lambda r: float(r.get(rank_key, 0.0)), reverse=True)
    return kept[:top_n] if top_n else kept


def bucket_by_length(
    rows: List[Dict[str, Any]],
    length_fn: Callable[[Dict[str, Any]], int],
    bucket_size: int = 5000,
) -> List[List[Dict[str, Any]]]:
    """Sort by token length and shard into fixed-size buckets so batches have
    homogeneous lengths (reference 0_bucketing_*: 5k-example shards)."""
    rows_sorted = sorted(rows, key=length_fn)
    return [rows_sorted[i : i + bucket_size] for i in range(0, len(rows_sorted), bucket_size)]


def filter_by_token_length(
    rows: Iterable[Dict[str, Any]],
    max_len: int,
    key: str = "complete_training_sequence_ids",
) -> List[Dict[str, Any]]:
    return [r for r in rows if len(r[key]) <= max_len]


def reservoir_downsample(
    rows: Iterable[Dict[str, Any]], n: int, seed: int = 0
) -> List[Dict[str, Any]]:
    """Uniform reservoir sampling (streaming-safe)."""
    rng = random.Random(seed)
    out: List[Dict[str, Any]] = []
    for i, r in enumerate(rows):
        if i < n:
            out.append(r)
        else:
            j = rng.randint(0, i)
            if j < n:
                out[j] = r
    return out
