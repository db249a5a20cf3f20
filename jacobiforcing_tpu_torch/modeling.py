"""Standalone single-sequence Jacobi decoding API.

PyTorch port of `jacobiforcing_tpu/modeling.py`:
  * `jacobi_generate_greedy`: single-block greedy Jacobi for one prompt;
  * `jacobi_generate_multiblock`: multiblock + rejection recycling (MR).

Each call owns a private paged KV cache and runs the decode loops of
`engine/runner.py` and `engine/multiblock.py` directly: no engine, no
scheduler.  Both take the device ("cuda" by default), an explicit seed and
`kv_dtype` (the private cache's storage type; None = the model dtype;
`torch.float8_e4m3fn` and `torch.int8` are stored with per-row scales), and
return (token_ids, stats).  Quantized parameters (`ops/quant.py`) are served
as they come.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from jacobiforcing_tpu_torch.engine import runner
from jacobiforcing_tpu_torch.engine.multiblock import jacobi_chunk_multiblock
from jacobiforcing_tpu_torch.models.qwen import ModelConfig, rope_table
from jacobiforcing_tpu_torch.ops.kv_cache import alloc_kv_cache
from jacobiforcing_tpu_torch.utils.device import resolve_device


def _setup(cfg, prompt, max_new, L, page_size, kv_dtype, dev):
    rope = rope_table(cfg, dev)
    cap = len(prompt) + max_new + 2 * L + 1
    n_pages = (cap + page_size - 1) // page_size
    kv = alloc_kv_cache(
        cfg.num_layers, n_pages, page_size, cfg.num_kv_heads, cfg.head_dim,
        kv_dtype or cfg.dtype, dev)
    bt = torch.arange(n_pages, dtype=torch.int32, device=dev)[None, :]
    return rope, kv, bt, n_pages * page_size, cap


def _prefill_with_draft(params, cfg, rope, kv, bt, prompt_ids, L, rng, dev):
    """Prefill the prompt with a random L-token draft appended; returns the
    greedy predictions at the L positions starting at the last prompt token."""
    P = len(prompt_ids)
    ids = np.zeros((1, P + L), np.int32)
    ids[0, :P] = prompt_ids
    ids[0, P:] = rng.randint(0, cfg.vocab_size, L)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    _, _, pf = runner.prefill(
        params, cfg, rope, torch.from_numpy(ids).to(dev), i32([0]), i32([P + L]), i32([P]),
        kv, bt, n_out=L,
    )
    return pf


def _result(res, P):
    out = res["tokens"][0, P : int(res["cur_len"][0])].tolist()
    iters = int(res["iters"][0])
    return out, {
        "iterations": iters,
        "tokens_per_forward": len(out) / max(iters, 1),
        "eos": bool(res["eos"][0]),
    }


@torch.no_grad()
def jacobi_generate_greedy(
    params: Dict[str, Any],
    cfg: ModelConfig,
    prompt_ids: List[int],
    *,
    n_token_seq_len: int = 64,
    max_new_tokens: int = 512,
    eos_token_id: int = -1,
    max_iterations: int = 1024,
    page_size: int = 256,
    kv_dtype=None,
    seed: int = 0,
    device="cuda",
) -> Tuple[List[int], Dict[str, float]]:
    """Single-block greedy Jacobi generation for one prompt."""
    dev = resolve_device(device)
    L = n_token_seq_len
    rope, kv, bt, capacity, cap = _setup(
        cfg, prompt_ids, max_new_tokens, L, page_size, kv_dtype, dev)
    P = len(prompt_ids)
    pf = _prefill_with_draft(params, cfg, rope, kv, bt, prompt_ids, L,
                             np.random.RandomState(seed), dev)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    tokens = torch.zeros((1, cap), dtype=torch.int32, device=dev)
    tokens[0, :P] = i32(prompt_ids)
    generator = torch.Generator(device=dev).manual_seed(seed)
    draft = runner.make_first_draft(pf, i32([prompt_ids[-1]]), L, generator, cfg.vocab_size)
    res = runner.jacobi_chunk_greedy(
        params, cfg, rope, kv, tokens, i32([P]), draft,
        torch.zeros((1,), dtype=torch.bool, device=dev), i32([0]), bt, i32([capacity]),
        i32([P + max_new_tokens]),  # absolute len_limit
        generator, eos_token_id, i32([max_iterations]), chunk_budget=max_new_tokens,
    )
    return _result(res, P)


@torch.no_grad()
def jacobi_generate_multiblock(
    params: Dict[str, Any],
    cfg: ModelConfig,
    prompt_ids: List[int],
    *,
    n_token_seq_len: int = 64,
    K: int = 2,
    r: float = 0.85,
    lookahead_start_ratio: float = 0.0,
    n_gram_pool_size: int = 4,
    max_new_tokens: int = 512,
    eos_token_id: int = -1,
    pad_token_id: int = 0,
    max_iterations: int = 1024,
    page_size: int = 256,
    kv_dtype=None,
    seed: int = 0,
    device="cuda",
) -> Tuple[List[int], Dict[str, float]]:
    """Multiblock + rejection-recycling generation for one prompt."""
    dev = resolve_device(device)
    N = n_token_seq_len
    C = max(1, n_gram_pool_size)
    W = 2 * N
    rope, kv, bt, capacity, cap = _setup(
        cfg, prompt_ids, max_new_tokens, N * max(K, 1), page_size, kv_dtype, dev)
    P = len(prompt_ids)
    pf = _prefill_with_draft(params, cfg, rope, kv, bt, prompt_ids, N,
                             np.random.RandomState(seed), dev)[0]
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    zeros = lambda *shape: torch.zeros(shape, dtype=torch.int32, device=dev)
    tokens = zeros(1, cap)
    tokens[0, :P] = i32(prompt_ids)
    blk_draft = zeros(1, K, N)
    blk_draft[0, 0] = pf[:N]
    res = jacobi_chunk_multiblock(
        params, cfg, rope, kv, tokens, i32([P]), blk_draft,
        i32([[N] + [0] * (K - 1)]), zeros(1, K), zeros(1, K, N),
        i32([[P] + [0] * (K - 1)]),
        torch.tensor([[True] + [False] * (K - 1)], device=dev),
        zeros(1), i32([1]), zeros(1, C, W), zeros(1, C), zeros(1), pf[:1].to(torch.int32),
        torch.zeros((1,), dtype=torch.bool, device=dev), zeros(1), bt,
        i32([capacity]), i32([max_new_tokens]), eos_token_id, pad_token_id,
        i32([int(math.ceil(r * N))]), i32([int(math.ceil(lookahead_start_ratio * N))]),
        i32([max_iterations]),
        N=N, K=K, C=C, W=W, chunk_budget=max_new_tokens,
    )
    return _result(res, P)
