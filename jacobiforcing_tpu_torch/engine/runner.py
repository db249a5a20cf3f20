"""Decode programs: prefill, AR decode, and the greedy Jacobi fixed-point loop.

PyTorch port of `jacobiforcing_tpu/engine/runner.py` (the greedy slice).  The
JAX version runs a whole Jacobi chunk as one jitted `lax.while_loop`; here the
loop is a Python loop whose body runs on the device, with the per-row
`active` mask kept on the device.  The loop condition is read back once per
iteration.  The KV cache is updated in place.

Semantics kept from the JAX version (and the reference greedy decoder):
  * draft[0] is the seed = last committed token, re-forwarded each iteration
    at position S-1;
  * accept length = 1 + number of leading exact matches of draft[1:] against
    the greedy predictions;
  * EOS inside the accepted prefix caps the commit;
  * zero acceptance commits greedy[0] (>= 1 token per iteration);
  * next draft = greedy continuation from the first mismatch, padded with
    random tokens drawn from an explicit `torch.Generator`;
  * the rejected tail needs no KV trim: validity is the cache_lens counter.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from jacobiforcing_tpu_torch.models.qwen import (
    ModelConfig,
    forward,
    greedy_tokens,
    logits_at,
)
from jacobiforcing_tpu_torch.ops.kv_cache import KVCache
from jacobiforcing_tpu_torch.ops.sampling import sample


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


# ---------------------------------------------------------------------------
# Prefill (with optional Jacobi draft bootstrap)
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill(
    params: Dict[str, Any],
    cfg: ModelConfig,
    rope,
    input_ids: torch.Tensor,  # [B, T]: [uncached prompt suffix, bootstrap draft, pad]
    start_pos: torch.Tensor,  # [B] absolute position of input_ids[:, 0]
    total_lens: torch.Tensor,  # [B] absolute length incl. draft
    prompt_lens: torch.Tensor,  # [B] absolute prompt length
    kv: KVCache,
    block_tables: torch.Tensor,  # [B, P]
    *,
    n_out: int = 1,
) -> Tuple[KVCache, torch.Tensor, torch.Tensor]:
    """Forward padded prompt suffixes (plus an appended random draft) once.

    Returns (kv, last_prompt_logits [B, V], prefill_draft [B, n_out]): the
    logits at the last prompt token, and the greedy predictions at the n_out
    positions starting there (the bootstrap draft; [:, 0] is the argmax of
    the logits).  The draft's KV needs no trim: the caller records cache
    length = prompt length and the first Jacobi iteration overwrites it.
    """
    B, T = input_ids.shape
    positions = start_pos[:, None] + _arange(T, input_ids)[None, :]
    write_mask = positions < total_lens[:, None]
    positions = positions.clamp(max=cfg.max_position - 1)
    h, kv = forward(
        params, cfg, input_ids, positions, kv, block_tables,
        cache_lens=total_lens, rope=rope, write_mask=write_mask,
    )
    gather_abs = prompt_lens[:, None] - 1 + _arange(n_out, input_ids)[None, :]
    gather_rel = (gather_abs - start_pos[:, None]).clamp(0, T - 1).long()
    h_sel = torch.gather(h, 1, gather_rel[:, :, None].expand(-1, -1, h.shape[-1]))
    logits = logits_at(params, cfg, h_sel)  # [B, n_out, V]
    draft = torch.argmax(logits, dim=-1).to(torch.int32)
    return kv, logits[:, 0, :], draft


# ---------------------------------------------------------------------------
# AR decode
# ---------------------------------------------------------------------------


@torch.no_grad()
def ar_decode_step(
    params: Dict[str, Any],
    cfg: ModelConfig,
    rope,
    kv: KVCache,
    last_tokens: torch.Tensor,  # [B] the most recently committed token
    seq_lens: torch.Tensor,  # [B] committed length (last token NOT yet in KV)
    block_tables: torch.Tensor,
    active: torch.Tensor,  # [B] bool
    temperature: torch.Tensor,  # [B] float32; 0 = greedy
    generator: torch.Generator,
) -> Tuple[KVCache, torch.Tensor]:
    """One AR decode step: forward the token at position S-1, sample the next."""
    positions = (seq_lens - 1)[:, None]
    h, kv = forward(
        params, cfg, last_tokens[:, None], positions, kv, block_tables,
        cache_lens=seq_lens, rope=rope, write_mask=active[:, None],
    )
    logits = logits_at(params, cfg, h[:, 0, :])  # [B, V]
    t = temperature.clamp(min=1e-6)
    next_tokens = sample(logits / t[:, None], generator, temperature)
    return kv, next_tokens


def _commit_window(tokens_in_len, tokens, L, chunk_budget, chunk_iters):
    """The tokens a chunk committed all lie in [cur_len_at_entry,
    cur_len_at_entry + W) for a static bound W; returns (window [B, W], start)."""
    cap = tokens.shape[1]
    W = chunk_iters * (L - 1) + 1 if chunk_iters > 0 else chunk_budget + L
    W = min(W, cap)
    start = tokens_in_len.clamp(max=cap - W)
    idx = (start[:, None] + _arange(W, tokens)[None, :]).long()
    return torch.gather(tokens, 1, idx), start


# ---------------------------------------------------------------------------
# Jacobi greedy decode: one chunk
# ---------------------------------------------------------------------------


class JacobiState(NamedTuple):
    """Loop state, all fixed shape."""

    kv: KVCache
    tokens: torch.Tensor  # [B, cap_tokens] committed tokens
    cur_len: torch.Tensor  # [B] committed length
    draft: torch.Tensor  # [B, L]; draft[:, 0] = seed
    eos: torch.Tensor  # [B] bool
    generated: torch.Tensor  # [B] tokens committed during this chunk
    iters: torch.Tensor  # [B] Jacobi iterations consumed (lifetime of request)


def _jacobi_cond(chunk_budget, max_iters, state: JacobiState, len_limit, capacity):
    """Per-row activity; `len_limit` is absolute (prompt_len + max_tokens) and
    `max_iters` the per-request lifetime iteration budget.  chunk_budget None
    = iteration-budget chunking (no per-row token cap within the chunk)."""
    L = state.draft.shape[1]
    can_fit = (state.cur_len - 1 + L) <= capacity
    under_limit = state.cur_len < len_limit
    if chunk_budget is not None:
        under_limit = under_limit & (state.generated < chunk_budget)
    return (
        (~state.eos)
        & under_limit
        & (state.iters < max_iters)
        & can_fit
        & (state.cur_len + L < state.tokens.shape[1])
    )


def _jacobi_step(
    params, cfg, rope, state: JacobiState, active, block_tables, generator, eos_token_id
) -> JacobiState:
    """One Jacobi iteration over every row; inactive rows keep their state."""
    B, L = state.draft.shape
    j = _arange(L - 1, state.draft)[None, :]
    positions = (state.cur_len - 1)[:, None] + _arange(L, state.draft)[None, :]
    cache_lens = state.cur_len - 1 + L
    h, kv = forward(
        params, cfg, state.draft, positions, state.kv, block_tables,
        cache_lens=cache_lens, rope=rope, write_mask=active[:, None].expand(B, L),
    )
    greedy_full = greedy_tokens(params, cfg, h)  # [B, L]

    # ---- verify ----
    spec = state.draft[:, 1:]  # [B, L-1]
    mismatch = (spec != greedy_full[:, : L - 1]).to(torch.int32)
    acc_len = (torch.cumsum(mismatch, dim=-1) == 0).sum(-1).to(torch.int32) + 1

    # ---- EOS cap inside the accepted prefix ----
    is_eos = (spec == eos_token_id) & (eos_token_id >= 0)
    eos_in_acc = is_eos & (j < (acc_len - 1)[:, None])
    any_eos = eos_in_acc.any(-1)
    first_eos = torch.argmax(eos_in_acc.to(torch.int32), dim=-1).to(torch.int32)
    acc_len = torch.where(any_eos, first_eos + 2, acc_len)

    # ---- AR fallback ----
    fallback = acc_len == 1
    fb_tok = greedy_full[:, 0]
    fb_eos = fallback & (fb_tok == eos_token_id) & (eos_token_id >= 0)
    new_eos = state.eos | (active & (any_eos | fb_eos))

    count = torch.where(fallback, 1, acc_len - 1).to(torch.int32)
    commit = torch.where(fallback[:, None], fb_tok[:, None], spec)  # [B, L-1]

    # ---- commit into the token buffer (a trash column takes skipped writes) ----
    cap = state.tokens.shape[1]
    valid = (j < count[:, None]) & active[:, None]
    tok_idx = torch.where(valid, state.cur_len[:, None] + j, cap).long()
    tokens = torch.cat([state.tokens, state.tokens[:, :1]], dim=1)
    tokens = tokens.scatter(1, tok_idx, commit)[:, :cap]

    count = torch.where(active, count, 0)
    cur_len = state.cur_len + count
    generated = state.generated + count
    iters = state.iters + active.to(torch.int32)

    # ---- next draft ----
    rows = torch.arange(B, device=tokens.device)
    seed = tokens[rows, (cur_len - 1).clamp(min=0).long()]
    start = torch.where(fallback, 1, acc_len - 1)
    src = start[:, None] + j  # [B, L-1] indices into greedy_full
    cont = torch.gather(greedy_full, 1, src.clamp(0, L - 1).long())
    rand = torch.randint(
        0, cfg.vocab_size, (B, L - 1), generator=generator, device=tokens.device,
        dtype=torch.int32,
    )
    new_spec = torch.where(src < L, cont, rand)
    new_draft = torch.cat([seed[:, None], new_spec], dim=1)
    new_draft = torch.where(active[:, None], new_draft, state.draft)
    return JacobiState(kv, tokens, cur_len, new_draft, new_eos, generated, iters)


@torch.no_grad()
def jacobi_chunk_greedy(
    params: Dict[str, Any],
    cfg: ModelConfig,
    rope,
    kv: KVCache,
    tokens: torch.Tensor,  # [B, cap_tokens]
    cur_len: torch.Tensor,  # [B]
    draft: torch.Tensor,  # [B, L]
    eos: torch.Tensor,  # [B] bool (already finished rows are inert)
    iters: torch.Tensor,  # [B] iterations consumed so far for each request
    block_tables: torch.Tensor,  # [B, P]
    capacity: torch.Tensor,  # [B] = allocated pages * page_size
    len_limit: torch.Tensor,  # [B] absolute token-count limit (prompt + max_tokens)
    generator: torch.Generator,
    eos_token_id: int,
    max_iters: torch.Tensor,  # [B] per-request lifetime iteration budgets
    *,
    chunk_budget: int,
    chunk_iters: int = 0,
) -> Dict[str, torch.Tensor]:
    """Run greedy Jacobi iterations until every row is done or stalled.

    Bounded by `chunk_budget` committed tokens per row, or with
    chunk_iters > 0 by a fixed number of loop trips in which every
    unfinished row takes part.
    """
    B, L = draft.shape
    budget = None if chunk_iters > 0 else chunk_budget
    state = JacobiState(
        kv, tokens, cur_len, draft, eos,
        torch.zeros((B,), dtype=torch.int32, device=draft.device), iters,
    )
    while True:
        active = _jacobi_cond(budget, max_iters, state, len_limit, capacity)
        go = active.any()
        if chunk_iters > 0:
            go = go & ((state.iters - iters).max() < chunk_iters)
        if not bool(go):  # the one device-to-host read per iteration
            break
        state = _jacobi_step(
            params, cfg, rope, state, active, block_tables, generator, eos_token_id
        )
    window, win_start = _commit_window(cur_len, state.tokens, L, chunk_budget, chunk_iters)
    return {
        "kv": state.kv,
        "tokens": state.tokens,
        "cur_len": state.cur_len,
        "draft": state.draft,
        "eos": state.eos,
        "generated": state.generated,
        "iters": state.iters,
        "new_tokens": window,
        "win_start": win_start,
    }


def make_first_draft(
    prefill_draft: torch.Tensor,  # [B, >=1] greedy predictions from prefill
    last_tokens: torch.Tensor,  # [B] last committed (prompt) token
    L: int,
    generator: torch.Generator,
    vocab_size: int,
) -> torch.Tensor:
    """Build the first Jacobi draft from the prefill bootstrap."""
    B, n = prefill_draft.shape
    parts = [last_tokens[:, None].to(torch.int32), prefill_draft[:, : L - 1].to(torch.int32)]
    have = 1 + min(n, L - 1)
    if have < L:
        parts.append(torch.randint(
            0, vocab_size, (B, L - have), generator=generator,
            device=prefill_draft.device, dtype=torch.int32,
        ))
    return torch.cat(parts, dim=1)
