"""Stage 1: trajectory collection — inference-based and masking-based.

Inference-based (reference:
generate_trajectory/generation/generate_trajectory_opencodeinstruct_greedy.py:73-227
+ qwen2_modeling_jacobi_forcing_greedy.py): the engine's on-policy block
decoder already records per-iteration block states; greedy mode (temperature=0)
reproduces the greedy collector, temperature>0 the non-greedy
(accept_threshold-style) variant.

Masking-based (reference:
generate_trajectory/data/1_progressive_masking_based_prepare_trajectory.py:64-160):
synthesize trajectories WITHOUT inference by progressively corrupting each
N-token chunk of a teacher completion from the right with random tokens drawn
from a lookback context window.

The PyTorch port's own copy of `jacobiforcing_tpu/data/collect.py` (host code
with no array framework in it); `tests/test_torch_data.py` holds it to the
original.  `collect_trajectories` asks the engine for the `jacobi_on_policy`
strategy, which the port's engine refuses until it is ported; the
masking-based synthesis needs no engine.
"""

from __future__ import annotations

import json
import random
from typing import Any, Dict, Iterable, List, Optional

from jacobiforcing_tpu_torch.config import SamplingParams


def collect_trajectories(
    engine,
    prompt_token_ids: List[List[int]],
    *,
    block_len: int = 32,
    max_tokens: int = 512,
    temperature: float = 0.0,
    top_k: int = -1,
    top_p: float = 1.0,
    accept_threshold: float = 0.0,
    max_blocks: int = 128,
    data_id_offset: int = 0,
    output_path: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """Run Jacobi rollouts and emit stage-1 trajectory rows.

    temperature == 0 -> greedy trajectory collection (exact-match acceptance);
    temperature > 0 -> stochastic on-policy collection (rejection sampling, or
    deterministic p(x) >= accept_threshold acceptance when threshold > 0 —
    the reference's nongreedy collector uses 0.99).

    Row contract (generate_trajectory_opencodeinstruct_greedy.py:170-196):
    {data_id, diffusion_itr_id, prompt_ids, answer_trajectory_ids,
     teacher_output_ids} — teacher max-filled with the final full sequence.
    """
    sp = SamplingParams(
        temperature=temperature,
        top_k=top_k,
        top_p=top_p,
        max_tokens=max_tokens,
        decode_strategy="jacobi_on_policy",
        jacobi_block_len=block_len,
        jacobi_max_iterations=max_blocks,
        jacobi_accept_threshold=accept_threshold,
    )
    outs = engine.generate(prompt_token_ids, sp)
    rows: List[Dict[str, Any]] = []
    for i, out in enumerate(outs):
        for rec in out.get("rollout_records", []):
            rows.append(
                {
                    "data_id": f"data_{data_id_offset + i}",
                    "diffusion_itr_id": rec["diffusion_itr_id"],
                    "prompt_ids": rec["prompt_ids"],
                    "answer_trajectory_ids": rec["answer_trajectory_ids"],
                    "teacher_output_ids": rec["teacher_output_ids"],
                }
            )
    if output_path:
        with open(output_path, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return rows


def corrupt_chunk(
    chunk: List[int],
    chunk_offset: int,
    full_ids: List[int],
    prompt_len: int,
    lookup_context_len: int,
    pad_id: int,
    rng: Optional[random.Random] = None,
) -> List[List[int]]:
    """Progressively corrupted versions of one chunk (masking-based, reference
    1_progressive_masking_based_prepare_trajectory.py:64-88): state i keeps the
    first i chunk tokens and replaces the rest with random tokens drawn from up
    to `lookup_context_len` preceding context tokens.  Each state is the FULL
    prefix + corrupted chunk (the packer takes the last N tokens)."""
    rng = rng or random
    start_idx = prompt_len + chunk_offset
    prefix = full_ids[:start_idx]
    n = len(chunk)
    states: List[List[int]] = []
    for corrupt_right in reversed(range(n + 1)):
        keep = chunk[: n - corrupt_right]
        corrupt: List[int] = []
        if corrupt_right > 0:
            pool = full_ids[max(0, start_idx - lookup_context_len) : start_idx]
            if not pool:
                pool = [pad_id]
            corrupt = [rng.choice(pool) for _ in range(corrupt_right)]
        states.append(prefix + keep + corrupt)
    return states


def synthesize_trajectories_masking(
    samples: Iterable[Dict[str, Any]],
    *,
    chunk_size: int = 32,
    lookup_context_len: int = 128,
    sequence_sampling_ratio: float = 1.0,
    pad_id: int = 0,
    seed: int = 0,
    output_path: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """Masking-based trajectory synthesis from (prompt_ids, full_ids) pairs.

    `samples`: iterable of {"prompt_ids": [...], "full_ids": [...]} (already
    tokenized; chat templating is the caller's concern).  Responses are padded
    to a chunk multiple with pad_id, each (sampled) chunk becomes one
    trajectory row keyed itr_<chunk_idx> (reference :110-155).
    """
    rng = random.Random(seed)
    rows: List[Dict[str, Any]] = []
    for row_id, s in enumerate(samples):
        prompt_ids = list(s["prompt_ids"])
        full_ids = list(s["full_ids"])
        resp = len(full_ids) - len(prompt_ids)
        if resp <= 0:
            continue
        if resp % chunk_size:
            full_ids = full_ids + [pad_id] * (chunk_size - resp % chunk_size)
        num_chunks = (len(full_ids) - len(prompt_ids)) // chunk_size
        n_keep = max(1, int(num_chunks * sequence_sampling_ratio))
        keep = set(rng.sample(range(num_chunks), n_keep))
        for ci in range(num_chunks):
            if ci not in keep:
                continue
            off = ci * chunk_size
            chunk = full_ids[len(prompt_ids) + off : len(prompt_ids) + off + chunk_size]
            traj = corrupt_chunk(
                chunk, off, full_ids, len(prompt_ids), lookup_context_len, pad_id, rng
            )
            rows.append(
                {
                    "data_id": f"data_{row_id}",
                    "diffusion_itr_id": f"itr_{ci}",
                    "prompt_ids": prompt_ids,
                    "answer_trajectory_ids": traj,
                    "teacher_output_ids": full_ids,
                    "labels_ids": full_ids,
                }
            )
    if output_path:
        with open(output_path, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return rows
