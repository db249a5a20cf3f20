"""Dataset tools: shard merging, trajectory profiling, packed-row debugging.

Reference: generate_trajectory/data/tool_merge_standalone_jsonl_data.py,
tool_merge_single_bucket_data.py, tool_profile_trajectory_dataset.py:25-,
tool_debug_complete_training_seq_data.py.  (The reference's
tool_merge_ds_ckpts.py DeepSpeed-shard merge has no analog here: training
checkpoints are already HF-layout safetensors the engine loads directly.)

The PyTorch port's own copy of `jacobiforcing_tpu/data/tools.py` (host code
with no array framework in it); `tests/test_torch_data.py` holds it to the
original.
"""

from __future__ import annotations

import json
import glob as globlib
from typing import Any, Dict, Iterable, List

import numpy as np


def iter_jsonl(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def merge_jsonl(patterns: List[str], output_path: str) -> int:
    """Concatenate bucket/shard JSONL files (tool_merge_*)."""
    n = 0
    with open(output_path, "w") as out:
        for pat in patterns:
            for path in sorted(globlib.glob(pat)):
                for row in iter_jsonl(path):
                    out.write(json.dumps(row) + "\n")
                    n += 1
    return n


def profile_trajectory_dataset(rows: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Summary statistics of stage-1 trajectory rows
    (tool_profile_trajectory_dataset.py)."""
    n_rows = 0
    traj_lens: List[int] = []
    prompt_lens: List[int] = []
    noise_first: List[float] = []
    data_ids = set()
    for r in rows:
        n_rows += 1
        data_ids.add(r.get("data_id"))
        traj = r["answer_trajectory_ids"]
        traj_lens.append(len(traj))
        prompt_lens.append(len(r["prompt_ids"]))
        N = len(traj[-1][-len(traj[0]):]) if traj else 0
        if len(traj) >= 2 and N:
            fixed = traj[-1][-N:]
            first = traj[0][-N:]
            div = next((i for i, (a, b) in enumerate(zip(first, fixed)) if a != b), N)
            noise_first.append((N - div) / N)
    def stats(xs):
        if not xs:
            return {}
        a = np.asarray(xs, float)
        return {"mean": round(float(a.mean()), 3), "p50": float(np.median(a)),
                "min": float(a.min()), "max": float(a.max())}
    return {
        "rows": n_rows,
        "unique_data_ids": len(data_ids),
        "iterations_per_block": stats(traj_lens),
        "prompt_len": stats(prompt_lens),
        "initial_noise_ratio": stats(noise_first),
    }


def debug_decode_packed_row(
    row: Dict[str, Any], N: int, tokenizer=None
) -> List[Dict[str, Any]]:
    """Split a packed training row back into (k_j, last_j) pairs for
    inspection (tool_debug_complete_training_seq_data.py)."""
    ids = row["complete_training_sequence_ids"]
    P = row["prompt_ids_len"]
    T = len(row["traj_position_indices"])
    out = []
    for j in range(T):
        ks = P + 2 * j * N
        ls = P + (2 * j + 1) * N
        k_blk, l_blk = ids[ks : ks + N], ids[ls : ls + N]
        div = next((i for i, (a, b) in enumerate(zip(k_blk, l_blk)) if a != b), N)
        rec = {"pair": j, "k": k_blk, "last": l_blk,
               "first_divergence": div, "noise_ratio": (N - div) / N}
        if tokenizer is not None:
            rec["k_text"] = tokenizer.decode(k_blk)
            rec["last_text"] = tokenizer.decode(l_blk)
        out.append(rec)
    return out
