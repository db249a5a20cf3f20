"""Baseline SFT data preparation.

Reference: generate_trajectory/data/2_prepare_baseline_training_data_sft.py —
convert teacher rows into plain next-token-CE rows for the fairness-baseline
SFT run (JacobiForcing/train/baseline_sft_train.py).

The PyTorch port's own copy of `jacobiforcing_tpu/data/sft.py` (host code
with no array framework in it); `tests/test_torch_data.py` holds it to the
original.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

import numpy as np


def make_sft_rows(
    rows: Iterable[Dict[str, Any]],
    output_path: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """{prompt_ids, teacher_output_ids|labels_ids} -> {input_ids, prompt_ids_len}."""
    out = []
    seen = set()
    for r in rows:
        full = r.get("labels_ids") or r["teacher_output_ids"]
        key = r.get("data_id", id(r))
        if key in seen:  # one SFT row per data_id (trajectory rows repeat it)
            continue
        seen.add(key)
        out.append({
            "data_id": key,
            "input_ids": list(full),
            "prompt_ids_len": len(r["prompt_ids"]),
        })
    if output_path:
        with open(output_path, "w") as f:
            for row in out:
                f.write(json.dumps(row) + "\n")
    return out


def sft_batch(
    rows: List[Dict[str, Any]],
    seq_bucket: int,
    pad_id: int = 0,
    mask_prompt: bool = True,
) -> Dict[str, np.ndarray]:
    """Collate rows to fixed shape; loss_mask covers completion tokens only
    (PAD and optionally prompt positions masked, baseline_sft_train.py:24-198)."""
    B = len(rows)
    ids = np.full((B, seq_bucket), pad_id, np.int32)
    mask = np.zeros((B, seq_bucket), np.float32)
    for i, r in enumerate(rows):
        x = r["input_ids"][:seq_bucket]
        ids[i, : len(x)] = x
        start = r.get("prompt_ids_len", 0) if mask_prompt else 0
        mask[i, start : len(x)] = 1.0
    return {"input_ids": ids, "loss_mask": mask}
