"""Decode programs: prefill, AR decode, and the Jacobi fixed-point loops.

PyTorch port of `jacobiforcing_tpu/engine/runner.py`.  The JAX version runs a
whole Jacobi chunk (or on-policy block) as one jitted `lax.while_loop`; here
the loop is a Python loop of trips.  A Jacobi trip (`chunk_trip`: the per-row
`active` mask, one iteration, the next trip's flag) reads nothing back and
updates the fixed-shape `ChunkBuffers` in place, so a CUDA graph can capture
it (`engine/graphs.py`); the host reads one flag per trip (`ChunkRun`).  The
KV cache is updated in place.

Greedy semantics kept from the JAX version (and the reference decoder):
  * draft[0] is the seed = last committed token, re-forwarded each iteration
    at position S-1;
  * accept length = 1 + number of leading exact matches of draft[1:] against
    the greedy predictions;
  * EOS inside the accepted prefix caps the commit;
  * zero acceptance commits greedy[0] (>= 1 token per iteration);
  * next draft = greedy continuation from the first mismatch, padded with
    random tokens drawn from an explicit `torch.Generator`;
  * the rejected tail needs no KV trim: validity is the cache_lens counter.

`jacobi_chunk_nongreedy` verifies stochastically instead (rejection sampling
under a delta proposal), and `jacobi_onpolicy_block` runs one block to
completion while recording every intermediate block state (the trajectory
collector).  Their random draws come from the caller's generator in a fixed
order per iteration, so one seed gives one stream.

Tensor parallelism: every program takes the model group (`group`, None for
one rank) and passes it to the forward and the heads.  The logits a program
samples from are gathered in vocab order and the generator is seeded alike
on every rank, so every rank draws, verifies and commits the same tokens.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from jacobiforcing_tpu_torch.models.qwen import (
    ModelConfig,
    chunked_token_logprob,
    forward,
    greedy_tokens,
    logits_at,
)
from jacobiforcing_tpu_torch.ops.kv_cache import KVCache
from jacobiforcing_tpu_torch.ops.sampling import gumbel, sample, target_probs
from jacobiforcing_tpu_torch.parallel.collectives import Group
from jacobiforcing_tpu_torch.utils.profiling import NoSpans


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=like.device)


def _scatter_drop(buf: torch.Tensor, cols: torch.Tensor, valid: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """buf [B, C] with values [B, K] written at cols [B, K] where `valid`;
    the other writes go to a trash column and are dropped (the JAX scatter's
    `mode="drop"`)."""
    C = buf.shape[1]
    idx = torch.where(valid, cols, C).long()
    return torch.cat([buf, buf[:, :1]], dim=1).scatter(1, idx, values)[:, :C]


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
    group: Group = None,
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
        cache_lens=total_lens, rope=rope, write_mask=write_mask, group=group,
    )
    gather_abs = prompt_lens[:, None] - 1 + _arange(n_out, input_ids)[None, :]
    gather_rel = (gather_abs - start_pos[:, None]).clamp(0, T - 1).long()
    h_sel = torch.gather(h, 1, gather_rel[:, :, None].expand(-1, -1, h.shape[-1]))
    logits = logits_at(params, cfg, h_sel, group)  # [B, n_out, V]
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
    group: Group = None,
) -> Tuple[KVCache, torch.Tensor]:
    """One AR decode step: forward the token at position S-1, sample the next."""
    positions = (seq_lens - 1)[:, None]
    h, kv = forward(
        params, cfg, last_tokens[:, None], positions, kv, block_tables,
        cache_lens=seq_lens, rope=rope, write_mask=active[:, None], group=group,
    )
    logits = logits_at(params, cfg, h[:, 0, :], group)  # [B, V]
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


def _forward_draft(params, cfg, rope, state: JacobiState, active, block_tables, group):
    """Forward each row's L-token draft at positions cur_len-1 ...; active
    rows write their K/V.  Returns (hidden [B, L, H], kv)."""
    B, L = state.draft.shape
    positions = (state.cur_len - 1)[:, None] + _arange(L, state.draft)[None, :]
    return forward(
        params, cfg, state.draft, positions, state.kv, block_tables,
        cache_lens=state.cur_len - 1 + L, rope=rope, write_mask=active[:, None].expand(B, L),
        group=group,
    )


def _commit_and_redraft(
    cfg, state: JacobiState, kv, active, commit, count, new_eos, greedy_full, generator
) -> JacobiState:
    """Write each active row's first `count` tokens of `commit` [B, L-1]
    after its committed prefix, and build its next draft: the new seed, the greedy continuation from the
    commit point (greedy_full[count:]) and random padding.  Inactive rows
    keep their state."""
    B, L = state.draft.shape
    j = _arange(L - 1, state.draft)[None, :]
    valid = (j < count[:, None]) & active[:, None]
    tokens = _scatter_drop(state.tokens, state.cur_len[:, None] + j, valid, commit)

    n = torch.where(active, count, 0)
    cur_len = state.cur_len + n
    generated = state.generated + n
    iters = state.iters + active.to(torch.int32)

    rows = torch.arange(B, device=tokens.device)
    seed = tokens[rows, (cur_len - 1).clamp(min=0).long()]
    src = count[:, None] + j  # [B, L-1] indices into greedy_full
    cont = torch.gather(greedy_full, 1, src.clamp(0, L - 1).long())
    rand = torch.randint(
        0, cfg.vocab_size, (B, L - 1), generator=generator, device=tokens.device,
        dtype=torch.int32,
    )
    new_spec = torch.where(src < L, cont, rand)
    new_draft = torch.cat([seed[:, None], new_spec], dim=1)
    new_draft = torch.where(active[:, None], new_draft, state.draft)
    return JacobiState(kv, tokens, cur_len, new_draft, new_eos, generated, iters)


def _jacobi_step(
    params, cfg, rope, state: JacobiState, active, block_tables, generator, eos_token_id,
    group: Group = None,
) -> JacobiState:
    """One greedy Jacobi iteration over every row; inactive rows keep their state."""
    B, L = state.draft.shape
    j = _arange(L - 1, state.draft)[None, :]
    h, kv = _forward_draft(params, cfg, rope, state, active, block_tables, group)
    greedy_full = greedy_tokens(params, cfg, h, group=group)  # [B, L]

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
    return _commit_and_redraft(cfg, state, kv, active, commit, count, new_eos, greedy_full,
                               generator)


def _nongreedy_step(
    params, cfg, rope, state: JacobiState, active, block_tables, generator, eos_token_id,
    temperature, top_p, top_k: int, use_top_p: bool, group: Group = None,
) -> JacobiState:
    """One rejection-sampling Jacobi iteration (delta proposal): accept the
    drafted x_t with probability p_t(x_t); at the first rejection draw a bonus
    token from p_t with x_t excluded; >= 1 token per iteration.  Draws, in
    order: u [B, L-1], the bonus's Gumbel noise [B, V], the padding."""
    B, L = state.draft.shape
    j = _arange(L - 1, state.draft)[None, :]
    rows = torch.arange(B, device=state.draft.device)
    h, kv = _forward_draft(params, cfg, rope, state, active, block_tables, group)
    spec = state.draft[:, 1:]  # [B, L-1] proposed tokens

    # ---- stochastic verify ----
    light = top_k <= 0 and not use_top_p
    if light:
        # acceptance needs only p(drafted token): vocab-chunked logsumexp, no
        # [B, L, V] logits
        p_x = torch.exp(chunked_token_logprob(params, cfg, h[:, : L - 1], spec,
                                              temperature[:, None], group=group))
        greedy_full = greedy_tokens(params, cfg, h, group=group)
    else:
        logits = logits_at(params, cfg, h, group)  # [B, L, V]
        greedy_full = torch.argmax(logits, dim=-1).to(torch.int32)
        probs = target_probs(logits[:, : L - 1], temperature[:, None], top_k=top_k,
                             top_p=top_p[:, None] if use_top_p else None)  # [B, L-1, V]
        p_x = torch.gather(probs, -1, spec[..., None].long())[..., 0]

    u = torch.rand((B, L - 1), generator=generator, device=h.device, dtype=torch.float32)
    accept = (u < p_x).to(torch.int32)
    n_acc = torch.cumprod(accept, dim=-1).sum(-1).to(torch.int32)
    rejected = n_acc < (L - 1)

    # bonus ~ p_t(. | != proposed) at the rejection position
    t_rej = n_acc.clamp(max=L - 2).long()
    proposed_rej = spec[rows, t_rej].long()
    if light:
        # the full distribution at ONE position per row
        logp = (logits_at(params, cfg, h[rows, t_rej], group)
                / temperature.clamp(min=1e-6)[:, None])
    else:
        logp = torch.log(probs[rows, t_rej].clamp(min=1e-30))  # [B, V]
    z = logp + gumbel(logp.shape, generator, logp.device)
    z.scatter_(1, proposed_rej[:, None], float("-inf"))  # a scalar fill: capturable
    bonus = torch.argmax(z, dim=-1).to(torch.int32)

    commit = torch.where((j == n_acc[:, None]) & rejected[:, None], bonus[:, None], spec)
    count = n_acc + rejected.to(torch.int32)  # >= 1

    # ---- EOS cap over committed tokens ----
    eos_in = (commit == eos_token_id) & (eos_token_id >= 0) & (j < count[:, None])
    any_eos = eos_in.any(-1)
    first_eos = torch.argmax(eos_in.to(torch.int32), dim=-1).to(torch.int32)
    count = torch.where(any_eos, first_eos + 1, count)
    new_eos = state.eos | (active & any_eos)
    return _commit_and_redraft(cfg, state, kv, active, commit, count, new_eos, greedy_full,
                               generator)


@dataclass
class ChunkBuffers:
    """The fixed-shape tensors of one chunk's trips: the loop state, which
    every trip updates in place, and the chunk's inputs, loaded once per
    chunk.  One set serves every chunk of a (B, L) program, so a CUDA graph
    captured over it replays with whatever a chunk loads."""

    tokens: torch.Tensor  # [B, cap] committed tokens
    cur_len: torch.Tensor  # [B] committed length
    draft: torch.Tensor  # [B, L]; draft[:, 0] = seed
    eos: torch.Tensor  # [B] bool
    generated: torch.Tensor  # [B] tokens committed during this chunk
    iters: torch.Tensor  # [B] Jacobi iterations consumed (lifetime of request)
    cur_len0: torch.Tensor  # [B] committed length at chunk entry
    iters0: torch.Tensor  # [B] iterations at chunk entry (the chunk_iters bound)
    block_tables: torch.Tensor  # [B, P]
    capacity: torch.Tensor  # [B] = allocated pages * page_size
    len_limit: torch.Tensor  # [B] absolute token-count limit
    max_iters: torch.Tensor  # [B] lifetime iteration budgets
    temperature: torch.Tensor  # [B] float32 (non-greedy only)
    top_p: torch.Tensor  # [B] float32 (non-greedy with top-p only)
    eos_id: torch.Tensor  # [] int32; -1 = no EOS
    flag: torch.Tensor  # [] bool: the next trip has an active row

    @classmethod
    def alloc(cls, B: int, L: int, cap: int, P: int, device) -> "ChunkBuffers":
        """Inert buffers: every row finished, every page -1."""
        def i32(*shape, fill=0):
            return torch.full(shape, fill, dtype=torch.int32, device=device)

        def f32():
            return torch.ones((B,), dtype=torch.float32, device=device)

        return cls(
            tokens=i32(B, cap), cur_len=i32(B, fill=1), draft=i32(B, L),
            eos=torch.ones((B,), dtype=torch.bool, device=device), generated=i32(B),
            iters=i32(B), cur_len0=i32(B, fill=1), iters0=i32(B),
            block_tables=i32(B, P, fill=-1), capacity=i32(B), len_limit=i32(B),
            max_iters=i32(B), temperature=f32(), top_p=f32(), eos_id=i32(fill=-1),
            flag=torch.zeros((), dtype=torch.bool, device=device),
        )

    def load(self, **values) -> None:
        """Copy tensors (from any device) or fill scalars into the named
        buffers; the buffers keep their addresses."""
        for name, v in values.items():
            dst = getattr(self, name)
            if isinstance(v, torch.Tensor):
                dst.copy_(v)
            else:
                dst.fill_(v)


_LOOP = ("tokens", "cur_len", "draft", "eos", "generated", "iters")


def _loop_state(buf: ChunkBuffers, kv: Optional[KVCache]) -> JacobiState:
    return JacobiState(kv, *(getattr(buf, k) for k in _LOOP))


def trip_active(buf: ChunkBuffers, chunk_budget: int, chunk_iters: int) -> torch.Tensor:
    """[B] rows that take part in the next trip: `chunk_budget` committed
    tokens per row bound a chunk, or with chunk_iters > 0 a number of trips,
    folded into the mask (a row past it is inert)."""
    budget = None if chunk_iters > 0 else chunk_budget
    active = _jacobi_cond(budget, buf.max_iters, _loop_state(buf, None), buf.len_limit,
                          buf.capacity)
    if chunk_iters > 0:
        # a row stops for good once inactive, so a row active now has taken
        # part in every trip so far: its count is the chunk's trip count
        active = active & ((buf.iters - buf.iters0) < chunk_iters)
    return active


def chunk_trip(step, kv: KVCache, buf: ChunkBuffers, chunk_budget: int,
               chunk_iters: int) -> None:
    """One trip: the active mask, one iteration of `step` over every row,
    and the next trip's flag.  Fixed shapes, in place, nothing read back."""
    active = trip_active(buf, chunk_budget, chunk_iters)
    new = step(_loop_state(buf, kv), active)
    for name in _LOOP:
        getattr(buf, name).copy_(getattr(new, name))
    buf.flag.copy_(trip_active(buf, chunk_budget, chunk_iters).any())


def greedy_step(params, cfg, rope, buf: ChunkBuffers, generator, group: Group = None):
    """The greedy iteration over `buf`'s chunk inputs, for `chunk_trip`."""
    def step(st, active):
        return _jacobi_step(params, cfg, rope, st, active, buf.block_tables, generator,
                            buf.eos_id, group)
    return step


def nongreedy_step(params, cfg, rope, buf: ChunkBuffers, generator, top_k: int,
                   use_top_p: bool, group: Group = None):
    """The rejection-sampling iteration over `buf`'s chunk inputs."""
    def step(st, active):
        return _nongreedy_step(params, cfg, rope, st, active, buf.block_tables, generator,
                               buf.eos_id, buf.temperature, buf.top_p, top_k, use_top_p, group)
    return step


class ChunkRun:
    """One chunk's trips, driven from the host with one flag read per trip.
    `start` reads whether any row is active and launches the first trip,
    then returns, so the caller can work on the host while it runs;
    `finish` runs the rest.  No trip runs with every row inactive.
    `spans` (the engine's `utils.profiling.Spans`) times `finish` as
    `trips` and each flag read as `trips.wait`."""

    def __init__(self, trip: Callable[[], None], buf: ChunkBuffers, chunk_budget: int,
                 chunk_iters: int, spans=None):
        self.trip, self.buf = trip, buf
        self.chunk_budget, self.chunk_iters = chunk_budget, chunk_iters
        self.spans = spans if spans is not None else NoSpans()
        self.go = False

    def start(self) -> "ChunkRun":
        self.go = bool(trip_active(self.buf, self.chunk_budget, self.chunk_iters).any())
        if self.go:
            self.trip()
        return self

    def finish(self) -> Dict[str, torch.Tensor]:
        """Run the remaining trips; returns the chunk's outputs, copied out
        of the buffers (which the program's next chunk reuses)."""
        with self.spans["trips"]:
            wait = self.spans["trips.wait"]
            while self.go:
                with wait:
                    self.go = bool(self.buf.flag)  # the one device-to-host read per trip
                if self.go:
                    self.trip()
            buf = self.buf
            window, win_start = _commit_window(buf.cur_len0, buf.tokens, buf.draft.shape[1],
                                               self.chunk_budget, self.chunk_iters)
            out = {k: getattr(buf, k).clone() for k in _LOOP}
            out.update(new_tokens=window, win_start=win_start)
            return out


def _chunk(step_of, kv, tokens, cur_len, draft, eos, iters, block_tables, capacity, len_limit,
           max_iters, eos_token_id, chunk_budget, chunk_iters, **extra) -> Dict[str, Any]:
    """One chunk through fresh buffers and eager trips (the functional API)."""
    B, L = draft.shape
    buf = ChunkBuffers.alloc(B, L, tokens.shape[1], block_tables.shape[1], draft.device)
    buf.load(tokens=tokens, cur_len=cur_len, draft=draft, eos=eos, iters=iters,
             cur_len0=cur_len, iters0=iters, generated=0, block_tables=block_tables,
             capacity=capacity, len_limit=len_limit, max_iters=max_iters,
             eos_id=eos_token_id, **extra)
    step = step_of(buf)
    out = ChunkRun(lambda: chunk_trip(step, kv, buf, chunk_budget, chunk_iters), buf,
                   chunk_budget, chunk_iters).start().finish()
    return {"kv": kv, **out}


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
    group: Group = None,
) -> Dict[str, torch.Tensor]:
    """Run greedy Jacobi iterations until every row is done or stalled.

    Bounded by `chunk_budget` committed tokens per row, or with
    chunk_iters > 0 by a fixed number of loop trips in which every
    unfinished row takes part.
    """
    return _chunk(lambda buf: greedy_step(params, cfg, rope, buf, generator, group), kv, tokens,
                  cur_len, draft, eos, iters, block_tables, capacity, len_limit, max_iters,
                  eos_token_id, chunk_budget, chunk_iters)


@torch.no_grad()
def jacobi_chunk_nongreedy(
    params: Dict[str, Any],
    cfg: ModelConfig,
    rope,
    kv: KVCache,
    tokens: torch.Tensor,  # [B, cap_tokens]
    cur_len: torch.Tensor,  # [B]
    draft: torch.Tensor,  # [B, L]
    eos: torch.Tensor,  # [B] bool
    iters: torch.Tensor,  # [B]
    block_tables: torch.Tensor,
    capacity: torch.Tensor,
    len_limit: torch.Tensor,  # [B] absolute token-count limit
    temperature: torch.Tensor,  # [B] float32 > 0
    top_p: torch.Tensor,  # [B] float32 (ignored unless use_top_p)
    generator: torch.Generator,
    eos_token_id: int,
    max_iters: torch.Tensor,  # [B] per-request lifetime iteration budgets
    *,
    chunk_budget: int,
    chunk_iters: int = 0,
    top_k: int = -1,
    use_top_p: bool = False,
    group: Group = None,
) -> Dict[str, torch.Tensor]:
    """Jacobi decoding with speculative-decoding-style stochastic verification
    under a delta proposal (the reference's
    JacobiDecoderNonGreedy._verify_block_rejection_sampling): accept x_t with
    probability p_t(x_t), at the first rejection commit a bonus token from
    p_t conditioned on != x_t, and draft the greedy continuation from the
    commit point, random-padded.  With top_k <= 0 and no top-p the verify
    takes the memory-light route (`chunked_token_logprob` + `greedy_tokens`,
    the full distribution at one position per row); otherwise `logits_at` +
    `target_probs` over [B, L-1, V].  Chunking as in `jacobi_chunk_greedy`.
    """
    return _chunk(
        lambda buf: nongreedy_step(params, cfg, rope, buf, generator, top_k, use_top_p, group),
        kv,
        tokens, cur_len, draft, eos, iters, block_tables, capacity, len_limit, max_iters,
        eos_token_id, chunk_budget, chunk_iters, temperature=temperature, top_p=top_p)


# ---------------------------------------------------------------------------
# On-policy rollout: one L-token block with full trajectory recording
# ---------------------------------------------------------------------------


class OnPolicyState(NamedTuple):
    kv: KVCache
    tokens: torch.Tensor  # [B, cap]
    cur_len: torch.Tensor  # [B]
    block_tokens: torch.Tensor  # [B, L] current block vector (committed + draft + pad)
    accepted: torch.Tensor  # [B] committed count within the block
    stopped: torch.Tensor  # [B] bool: stop token committed
    traj: torch.Tensor  # [B, L+1, L] snapshots (0 = init, i = after iteration i)
    it: torch.Tensor  # [B] iterations used in this block
    fwds: torch.Tensor  # [B]


def _onpolicy_active(state: OnPolicyState, gen_len, capacity):
    L = state.block_tokens.shape[1]
    return (
        (~state.stopped)
        & (state.accepted < gen_len)
        & ((state.cur_len + L) <= capacity)
        & (state.cur_len + L < state.tokens.shape[1])
    )


def _onpolicy_step(
    params, cfg, rope, state: OnPolicyState, active, gen_len, block_tables, temperature,
    top_p, generator, stop_tokens, pad_token_id, top_k, use_top_p, greedy_mode,
    accept_threshold, group: Group = None,
) -> OnPolicyState:
    B, L = state.block_tokens.shape
    dev = state.block_tokens.device
    jT = _arange(L, state.block_tokens)[None, :]
    rows = torch.arange(B, device=dev)
    remaining = (gen_len - state.accepted).clamp(1, L)  # [B]
    seed = state.tokens[rows, (state.cur_len - 1).clamp(min=0).long()]
    src = (state.accepted[:, None] + jT).clamp(0, L - 1).long()
    proposed = torch.gather(state.block_tokens, 1, src)  # [B, L]
    draft = torch.cat([seed[:, None], proposed], dim=1)  # [B, L+1]

    # L+1 rows from cur_len-1; only rows j <= remaining write, and cache_lens
    # stops at the last of them, so the tail rows sit past cache_lens
    j1 = _arange(L + 1, state.block_tokens)[None, :]
    positions = (state.cur_len - 1)[:, None] + j1
    write_mask = (j1 <= remaining[:, None]) & active[:, None]
    h, kv = forward(
        params, cfg, draft, positions, state.kv, block_tables,
        cache_lens=state.cur_len + remaining, rope=rope, write_mask=write_mask, group=group,
    )
    logits = logits_at(params, cfg, h[:, :L], group)  # [B, L, V]
    greedy_full = torch.argmax(logits, dim=-1).to(torch.int32)
    undecided = jT < remaining[:, None]

    if greedy_mode:
        # exact-match acceptance; zero acceptance commits argmax[0]
        accept = (proposed == greedy_full) & undecided
        n_acc = torch.cumprod(accept.to(torch.int32), dim=-1).sum(-1).to(torch.int32)
        fallback = n_acc == 0
        commit = torch.where((jT == 0) & fallback[:, None], greedy_full[:, :1], proposed)
        count = n_acc.clamp(min=1)
        samp = greedy_full  # tail refresh = greedy continuation
    else:
        probs = target_probs(logits, temperature[:, None], top_k=top_k,
                             top_p=top_p[:, None] if use_top_p else None)  # [B, L, V]
        p_x = torch.gather(probs, -1, proposed[..., None].long())[..., 0]
        if accept_threshold > 0.0:
            # deterministic acceptance of the prefix with p(x) >= threshold
            accept = (p_x >= accept_threshold) & undecided
        else:
            u = torch.rand((B, L), generator=generator, device=dev, dtype=torch.float32)
            accept = (u < p_x) & undecided
        n_acc = torch.cumprod(accept.to(torch.int32), dim=-1).sum(-1).to(torch.int32)
        rejected = n_acc < remaining

        t_rej = torch.minimum(n_acc, remaining - 1).long()
        logp = torch.log(probs[rows, t_rej].clamp(min=1e-30))  # [B, V]
        z = logp + gumbel(logp.shape, generator, dev)
        if accept_threshold <= 0.0:
            # the rejection-sampling residual excludes the rejected proposal
            z.scatter_(1, proposed[rows, t_rej].long()[:, None], float("-inf"))
        bonus = torch.argmax(z, dim=-1).to(torch.int32)
        if accept_threshold > 0.0:
            # zero acceptance samples ONE token from the full p; no bonus otherwise
            fallback = n_acc == 0
            commit = torch.where((jT == 0) & fallback[:, None], bonus[:, None], proposed)
            count = n_acc.clamp(min=1)
        else:
            commit = torch.where((jT == n_acc[:, None]) & rejected[:, None], bonus[:, None],
                                 proposed)
            count = n_acc + rejected.to(torch.int32)  # >= 1
        # next drafts of undecided positions are sampled from the current probs
        samp = torch.argmax(torch.log(probs.clamp(min=1e-30)) + gumbel(probs.shape, generator, dev),
                            dim=-1).to(torch.int32)

    # ---- stop-token cap (the stop set is padded with -1) ----
    is_stop = (commit[:, :, None] == stop_tokens[None, None, :]).any(-1) & (stop_tokens.max() >= 0)
    stop_in = is_stop & (jT < count[:, None])
    any_stop = stop_in.any(-1)
    first_stop = torch.argmax(stop_in.to(torch.int32), dim=-1).to(torch.int32)
    count = torch.where(any_stop, first_stop + 1, count)
    stopped = state.stopped | (active & any_stop)

    # ---- commit into the running sequence and the block vector ----
    valid = (jT < count[:, None]) & active[:, None]
    tokens = _scatter_drop(state.tokens, state.cur_len[:, None] + jT, valid, commit)
    count = torch.where(active, count, 0)
    cur_len = state.cur_len + count
    bt1 = _scatter_drop(state.block_tokens, state.accepted[:, None] + jT, valid, commit)
    accepted = torch.minimum(gen_len, state.accepted + count)

    # block position q >= accepted takes sample q - (old accepted); every such
    # q below gen_len lies inside this forward's `remaining` rows (the JAX
    # version's random fill beyond them is only ever overwritten by the pad)
    sample_idx = (count[:, None] + (jT - accepted[:, None])).clamp(0, L - 1).long()
    draft_val = torch.gather(samp, 1, sample_idx)
    pad = torch.full_like(draft_val, pad_token_id)
    new_bt = torch.where(
        jT < accepted[:, None], bt1,
        torch.where(stopped[:, None] | (jT >= gen_len[:, None]), pad, draft_val),
    )
    new_bt = torch.where(active[:, None], new_bt, state.block_tokens)

    it = state.it + active.to(torch.int32)
    fwds = state.fwds + active.to(torch.int32)
    snap = active[:, None] & (_arange(L + 1, state.block_tokens)[None, :] == it[:, None])
    traj = torch.where(snap[:, :, None], new_bt[:, None, :], state.traj)
    return OnPolicyState(kv, tokens, cur_len, new_bt, accepted, stopped, traj, it, fwds)


@torch.no_grad()
def jacobi_onpolicy_block(
    params: Dict[str, Any],
    cfg: ModelConfig,
    rope,
    kv: KVCache,
    tokens: torch.Tensor,  # [B, cap]
    cur_len: torch.Tensor,  # [B]
    block_init: torch.Tensor,  # [B, L] initial draft (prompt-sampled) + pads
    gen_len: torch.Tensor,  # [B] = min(L, remaining token budget)
    active_in: torch.Tensor,  # [B] bool: row participates
    block_tables: torch.Tensor,
    capacity: torch.Tensor,
    temperature: torch.Tensor,  # [B] float32 > 0
    top_p: torch.Tensor,  # [B] float32
    generator: torch.Generator,
    stop_tokens: torch.Tensor,  # [n_stop] int32 (padded with -1)
    pad_token_id: int,
    *,
    top_k: int = -1,
    use_top_p: bool = False,
    greedy_mode: bool = False,
    accept_threshold: float = 0.0,
    group: Group = None,
) -> Dict[str, torch.Tensor]:
    """Run ONE Jacobi block to completion, recording every intermediate block
    state: the on-policy trajectory collector (the reference's
    JacobiDecoderNonGreedyOnPolicy._run_one_block).

      * the block vector has fixed length L; only gen_len positions generate,
        the tail is pad;
      * per iteration: forward [seed + block from the commit point] (L + 1
        rows), verify, commit >= 1 token;
      * verify modes: `greedy_mode` (exact match, argmax[0] on zero
        acceptance, greedy tail refresh: the reference's greedy collector),
        rejection sampling (accept w.p. p(x), bonus from p(.|!=x) at the
        first rejection), or `accept_threshold` > 0 (the prefix with p(x) >=
        threshold, one full-p sample on zero acceptance, no exclusion);
      * outside greedy mode, next drafts of undecided positions are SAMPLED
        from the current probabilities;
      * a committed stop token caps the block and pads its tail;
      * `traj` holds the block vector after every iteration (init first).

    Random draws per iteration, in order: u (rejection sampling only), the
    bonus noise [B, V], the draft noise [B, L, V]; greedy mode draws none.
    """
    B, L = block_init.shape
    dev = block_init.device
    block_init = block_init.to(torch.int32)
    traj0 = torch.zeros((B, L + 1, L), dtype=torch.int32, device=dev)
    traj0[:, 0] = block_init
    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    state = OnPolicyState(kv, tokens, cur_len, block_init, zeros, ~active_in, traj0, zeros, zeros)
    while True:
        active = _onpolicy_active(state, gen_len, capacity)
        if not bool(active.any()):  # the one device-to-host read per iteration
            break
        state = _onpolicy_step(
            params, cfg, rope, state, active, gen_len, block_tables, temperature, top_p,
            generator, stop_tokens, pad_token_id, top_k, use_top_p, greedy_mode,
            accept_threshold, group,
        )
    return {
        "kv": state.kv,
        "tokens": state.tokens,
        "cur_len": state.cur_len,
        "block_tokens": state.block_tokens,
        "accepted": state.accepted,
        "stopped": state.stopped,
        "traj": state.traj,
        "iters": state.it,
        "fwds": state.fwds,
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
