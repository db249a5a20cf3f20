"""Stage 2: trajectory rows -> noise-scheduled packed training sequences.

Re-design of the reference packer
(generate_trajectory/data/2_prepare_efficient_cllm_training_data_progressive_noise_window.py:87-282,
cyclic variant 2_..._new_progressive_noise_cyclic.py:21-24):

  * per trajectory row (one n-token block of one data_id): each recorded
    state's noise ratio = (N - first_divergence_from_fixed_point) / N, computed
    on the LAST N tokens of each state (the reference computes it on the full
    sequence, which for masking-format rows with a long identical prefix goes
    negative — the cyclic variant clamps it; we compute the intended
    block-local ratio directly, valid for both row formats);
  * a linear progressive noise schedule over a window:
    schedule = linspace(min_ratio, max_ratio, window_size),
    noisy_index = diffusion_itr % window_size ("progressive") or uniform
    ("random");
  * pick the state k_j whose ratio is nearest the scheduled ratio; emit
    pair_seq = noisy_state + fixed_point (each N tokens);
  * merge per data_id (SQLite in the reference — in-memory dict here, with an
    optional sqlite path for very large runs), sort pairs by diffusion_itr,
    flatten to `complete_training_sequence_ids = prompt + concat(pairs)` with
    `traj_position_indices`.

The PyTorch port's own copy of `jacobiforcing_tpu/data/pack.py` (host code
with no array framework in it); `tests/test_torch_data.py` holds it to the
original.
"""

from __future__ import annotations

import itertools
import json
import random
import re
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

_ITR_RE = re.compile(r"(\d+)")


def _parse_int(s: Any) -> int:
    if isinstance(s, int):
        return s
    m = _ITR_RE.search(str(s))
    return int(m.group(1)) if m else 0


def _first_divergence(a: List[int], b: List[int]) -> int:
    arr1, arr2 = np.asarray(a), np.asarray(b)
    n = min(len(arr1), len(arr2))
    diff = arr1[-n:] != arr2[-n:]
    return int(np.argmax(diff)) if diff.any() else n


def select_noisy_state(
    answer_traj: List[List[int]],
    diffusion_itr: int,
    N: int,
    window_size: int,
    min_noisy_ratio: float,
    max_noisy_ratio: float,
    strategy: str,
    rng: Optional[random.Random] = None,
) -> int:
    """Index k_j of the trajectory state nearest the scheduled noise ratio."""
    schedule = np.linspace(min_noisy_ratio, max_noisy_ratio, window_size)
    if strategy == "random":
        noisy_index = (rng or random).randint(0, window_size - 1)
    elif strategy in ("progressive", "cyclic"):
        noisy_index = diffusion_itr % window_size
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    target = schedule[noisy_index]

    fixed = answer_traj[-1][-N:]
    ratios = []
    for state in answer_traj:
        d = _first_divergence(state[-N:], fixed)
        r = (N - d) / N
        if strategy == "cyclic":
            r = max(0.0, r)  # cyclic variant clamps negative support
        ratios.append(r)
    return int(np.argmin(np.abs(np.asarray(ratios) - target)))


def pack_trajectories(
    rows: Iterable[Dict[str, Any]],
    n_token_seq_length: int,
    window_size: int = 4,
    min_noisy_ratio: float = 0.0,
    max_noisy_ratio: float = 1.0,
    strategy: str = "progressive",
    output_path: Optional[str] = None,
    seed: int = 0,
) -> List[Dict[str, Any]]:
    """Pack trajectory rows into training rows; returns (and optionally writes)
    the packed JSONL rows."""
    N = n_token_seq_length
    rng = random.Random(seed)
    merged: Dict[str, Dict[str, Any]] = {}

    for sample in rows:
        data_id = sample["data_id"]
        itr = _parse_int(sample["diffusion_itr_id"])
        traj = sample["answer_trajectory_ids"]
        k_j = select_noisy_state(
            traj, itr, N, window_size, min_noisy_ratio, max_noisy_ratio,
            strategy, rng,
        )
        sampled_seq = list(traj[k_j][-N:])
        fixed_seq = list(traj[-1][-N:])
        pair = {
            "diffusion_itr": itr,
            "traj_position_index": k_j,
            "seq": sampled_seq + fixed_seq,
        }
        prompt_ids = sample["prompt_ids"]
        # tolerate both [ids] and [[ids]] prompt encodings (the reference
        # stores prompt_ids and indexes [0] at write-out)
        if prompt_ids and isinstance(prompt_ids[0], list):
            prompt_ids = prompt_ids[0]
        entry = merged.setdefault(
            data_id,
            {
                "data_id": data_id,
                "data_id_int": _parse_int(data_id),
                "prompt_ids": list(prompt_ids),
                "pairs": [],
            },
        )
        entry["pairs"].append(pair)

    out: List[Dict[str, Any]] = []
    for entry in sorted(merged.values(), key=lambda e: e["data_id_int"]):
        pairs_sorted = sorted(entry["pairs"], key=lambda p: p["diffusion_itr"])
        flat = list(itertools.chain.from_iterable(p["seq"] for p in pairs_sorted))
        out.append(
            {
                "data_id": entry["data_id"],
                "prompt_ids": entry["prompt_ids"],
                "complete_training_sequence_ids": entry["prompt_ids"] + flat,
                "prompt_ids_len": len(entry["prompt_ids"]),
                "traj_position_indices": [p["traj_position_index"] for p in pairs_sorted],
            }
        )

    if output_path:
        with open(output_path, "w") as f:
            for row in out:
                f.write(json.dumps(row) + "\n")
    return out
