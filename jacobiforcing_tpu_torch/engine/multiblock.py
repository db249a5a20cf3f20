"""Multiblock Jacobi decoding with rejection recycling (MR), batched.

PyTorch port of `jacobiforcing_tpu/engine/multiblock.py`: the same state
machine over the same fixed-shape state, the same arguments and the same
returned dict.

  * K block slots in a ring: slot = (draft[N], draft_len, acc, acc_toks[N],
    base_position, active).  RA = the oldest active slot; a spawn appends at
    the ring tail when the newest block's acceptance crosses ceil(r*N); on RA
    completion the next slot is promoted with its acceptance RESET and its
    draft rebuilt [last_next | packed[1:]]: promotion re-verifies, which is
    what makes conditioning on pseudo blocks safe;
  * candidates from the n-gram pool ride the SEQUENCE axis of one forward
    (tree-attention segments): each of 1+C alternative segments attends the
    committed KV + itself causally; pseudo segments attend the committed KV +
    the RA segment + earlier pseudos + themselves (`forward_spec` writes
    nothing; the winning segment's K/V is scattered into the paged cache
    afterwards);
  * the n-gram pool is a fixed [C, W] ring buffer; per rejected iteration it
    receives the global block-concat and the rejected greedy tail; a
    candidate splices a pool entry from the first position matching the next
    token, padded with the current draft, skipping the newest entry.

Where the JAX version vmaps per-sequence functions and runs the loop as one
jitted `lax.while_loop`, every tensor here carries an explicit leading batch
axis, `.at[...].set(..., mode="drop")` becomes a one-hot `where` or a scatter
into a spare trailing slot that is sliced off, and the loop is Python control
flow: per iteration one device-to-host read decides whether to go on and
which of the three forwards (full / no-candidate / RA-only) the batch takes.
The KV cache is updated in place.  Finished or stalled rows are gated inert,
not skipped, so mixed-progress batches decode together.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

from jacobiforcing_tpu_torch.models.qwen import ModelConfig, forward_spec, greedy_tokens
from jacobiforcing_tpu_torch.parallel.collectives import Group
from jacobiforcing_tpu_torch.ops.kv_cache import (
    KVCache,
    quantize_rows,
    storage_view,
    with_trash,
    write_plan,
)

# keys of the returned dict that carry the per-sequence MR state between chunks
STATE_KEYS = (
    "blk_draft", "blk_dlen", "blk_acc", "blk_acc_toks", "blk_base", "blk_active",
    "ra", "n_active", "pool", "pool_len", "pool_next", "last_next",
)


class MBState(NamedTuple):
    kv: KVCache
    tokens: torch.Tensor  # [B, cap]
    cur_len: torch.Tensor  # [B] committed length
    blk_draft: torch.Tensor  # [B, K, N]
    blk_dlen: torch.Tensor  # [B, K]
    blk_acc: torch.Tensor  # [B, K]
    blk_acc_toks: torch.Tensor  # [B, K, N]
    blk_base: torch.Tensor  # [B, K] absolute start position of each block
    blk_active: torch.Tensor  # [B, K] bool
    ra: torch.Tensor  # [B] slot index
    n_active: torch.Tensor  # [B]
    pool: torch.Tensor  # [B, C, W]
    pool_len: torch.Tensor  # [B, C]
    pool_next: torch.Tensor  # [B] ring index
    last_next: torch.Tensor  # [B] token
    eos: torch.Tensor  # [B] bool
    iters: torch.Tensor  # [B]
    generated: torch.Tensor  # [B]


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis, 0 where there is none
    (`jnp.argmax` of a bool)."""
    n = mask.shape[-1]
    ar = torch.arange(n, device=mask.device)
    first = torch.where(mask, ar, n).amin(-1)
    return torch.where(first == n, 0, first)


def _first_max(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum along the last axis (`jnp.argmax`): a tie
    goes to the lowest index on every device."""
    return _first_true(x == x.amax(-1, keepdim=True))


def _compact(tokens: torch.Tensor, valid: torch.Tensor):
    """Stable-compact the valid tokens of each row to the front; returns
    (tokens [..., n], count [...])."""
    n = tokens.shape[-1]
    ar = torch.arange(n, device=tokens.device)
    key = torch.where(valid, ar, n + ar)  # unique keys: any sort is stable
    return torch.gather(tokens, -1, torch.argsort(key, dim=-1)), valid.sum(-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for x [B, K, ...] and idx [B] or [B, M]."""
    b = torch.arange(x.shape[0], device=x.device)
    return x[b, idx] if idx.dim() == 1 else x[b[:, None], idx]


def _set_slot(x: torch.Tensor, slot: torch.Tensor, val, cond=None) -> torch.Tensor:
    """x [B, K, ...] with x[b, slot[b]] = val[b] where cond[b]."""
    hit = torch.arange(x.shape[1], device=x.device)[None, :] == slot[:, None]
    if cond is not None:
        hit = hit & cond[:, None]
    if not torch.is_tensor(val):
        val = torch.full((), val, dtype=x.dtype, device=x.device)
    if x.dim() == 3:
        hit = hit[:, :, None]
        val = val[:, None, :] if val.dim() == 2 else val
    elif val.dim() == 1:
        val = val[:, None]
    return torch.where(hit, val, x)


def _scatter_drop(row: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """row [B, n] with row[b, idx[b, j]] = vals[b, j]; an index >= n is dropped
    (it lands in a spare trailing slot that is sliced off)."""
    n = row.shape[1]
    buf = torch.cat([row, row[:, :1]], dim=1)
    return buf.scatter(1, idx.clamp(max=n), vals)[:, :n]


def _packed(blk_acc_toks, blk_draft, blk_acc, slot):
    """A block's tokens as [accepted | draft]: ([B, ..., N], acc [B, ...])."""
    N = blk_draft.shape[-1]
    jN = torch.arange(N, device=blk_draft.device)
    a = _take(blk_acc, slot)
    src = (jN - a[..., None]).clamp(0, N - 1)
    tok = torch.where(jN < a[..., None], _take(blk_acc_toks, slot),
                      torch.gather(_take(blk_draft, slot), -1, src))
    return tok, a


def tree_mask(N: int, K: int, C: int, device) -> torch.Tensor:
    """Intra-block visibility [T, T] of the segment layout [RA | C candidates
    | K-1 pseudos]: same-segment causal; a pseudo also sees the RA segment and
    the earlier pseudos in full."""
    S = 1 + C + (K - 1)
    seg_of = torch.arange(S, device=device).repeat_interleave(N)
    idx_in = torch.arange(N, device=device).repeat(S)
    qs, ks = seg_of[:, None], seg_of[None, :]
    qi, ki = idx_in[:, None], idx_in[None, :]
    return ((qs == ks) & (ki <= qi)) | ((qs > C) & ((ks == 0) | ((ks > C) & (ks < qs))))


@torch.no_grad()
def jacobi_chunk_multiblock(
    params: Dict[str, Any],
    cfg: ModelConfig,
    rope,
    kv: KVCache,
    tokens: torch.Tensor,  # [B, cap]
    cur_len: torch.Tensor,  # [B]
    blk_draft: torch.Tensor,  # [B, K, N]
    blk_dlen: torch.Tensor,
    blk_acc: torch.Tensor,
    blk_acc_toks: torch.Tensor,
    blk_base: torch.Tensor,
    blk_active: torch.Tensor,
    ra: torch.Tensor,
    n_active: torch.Tensor,
    pool: torch.Tensor,  # [B, C, W]
    pool_len: torch.Tensor,
    pool_next: torch.Tensor,
    last_next: torch.Tensor,
    eos_in: torch.Tensor,  # [B] bool
    iters: torch.Tensor,  # [B]
    block_tables: torch.Tensor,  # [B, P_pages]
    capacity: torch.Tensor,  # [B]
    max_new: torch.Tensor,  # [B]
    eos_token_id: int,
    pad_token_id: int,
    spawn_threshold: torch.Tensor,  # [B] int: ceil(r * N)
    lookahead_start: torch.Tensor,  # [B] int: ceil(lookahead_start_ratio * N)
    max_iters: torch.Tensor,  # [B] per-request lifetime iteration budgets
    *,
    N: int,
    K: int,
    C: int,  # candidate slots (= n-gram pool size)
    W: int,  # pool entry width
    chunk_budget: int,
    chunk_iters: int = 0,
    group: Group = None,  # the model group (tensor parallelism)
) -> Dict[str, torch.Tensor]:
    dev = cur_len.device
    B = cur_len.shape[0]
    S = 1 + C + (K - 1)  # segments: RA, C candidates, K-1 pseudos
    T = S * N
    cap = tokens.shape[1]
    jN = torch.arange(N, device=dev)
    jW = torch.arange(W, device=dev)
    jB = torch.arange(B, device=dev)
    eos_id, pad_id = int(eos_token_id), int(pad_token_id)
    has_eos_id = eos_id >= 0

    # state in int64 inside the loop (index arithmetic without casts); the
    # returned dict goes back to the callers' int32
    i64 = lambda t: t.to(torch.int64)
    iters0 = i64(iters)
    capacity, max_new, max_iters = i64(capacity), i64(max_new), i64(max_iters)
    spawn_threshold, lookahead_start = i64(spawn_threshold), i64(lookahead_start)
    st = MBState(
        kv=kv, tokens=i64(tokens), cur_len=i64(cur_len), blk_draft=i64(blk_draft),
        blk_dlen=i64(blk_dlen), blk_acc=i64(blk_acc), blk_acc_toks=i64(blk_acc_toks),
        blk_base=i64(blk_base), blk_active=blk_active.to(torch.bool), ra=i64(ra),
        n_active=i64(n_active), pool=i64(pool), pool_len=i64(pool_len),
        pool_next=i64(pool_next), last_next=i64(last_next), eos=eos_in.to(torch.bool),
        iters=iters0, generated=torch.zeros((B,), dtype=torch.int64, device=dev),
    )
    tiers = [0, 0, 0]  # batch trips served by the full / no-candidate / RA-only forward
    sees = tree_mask(N, K, C, dev)
    block_tables_l = i64(block_tables)

    # chunk_iters > 0: ITERATION-budget chunking, a fixed trip count with no
    # per-row token budget inside the chunk
    budget = max_new if chunk_iters > 0 else max_new.clamp(max=chunk_budget)

    def alive_fn(st: MBState) -> torch.Tensor:
        return (
            (~st.eos)
            & (st.iters < max_iters)
            & (st.generated < budget)
            & (st.cur_len + N <= capacity)
            & (st.cur_len + N < cap)
        )

    # ---------------- segment assembly ----------------
    def assemble(st: MBState):
        ra_draft = _take(st.blk_draft, st.ra)  # [B, N]
        ra_dlen = _take(st.blk_dlen, st.ra)
        ra_acc = _take(st.blk_acc, st.ra)
        nxt0 = ra_draft[:, 0]
        newest_pool = (st.pool_next - 1) % C

        # candidates [B, C, N]: splice a pool entry from its first match of nxt0
        hit = (st.pool == nxt0[:, None, None]) & (jW < st.pool_len[:, :, None])
        pos = _first_true(hit)  # [B, C]
        src = pos[:, :, None] + jN
        vals = torch.gather(st.pool, 2, src.clamp(0, W - 1))
        cands = torch.where(src < st.pool_len[:, :, None], vals, ra_draft[:, None, :])
        cand_valid = (
            hit.any(-1)
            & (torch.arange(C, device=dev)[None, :] != newest_pool[:, None])
            & (st.pool_len > 0)
            & ((ra_acc >= lookahead_start) & (ra_dlen > 1))[:, None]
        )

        # pseudos [B, K-1, N]: the blocks after RA in ring order
        o = torch.arange(1, K, device=dev)
        pb = (st.ra[:, None] + o) % K
        ps_tok, ps_acc = _packed(st.blk_acc_toks, st.blk_draft, st.blk_acc, pb)
        ps_vlen = (ps_acc + _take(st.blk_dlen, pb)).clamp(max=N)
        ps_active = _take(st.blk_active, pb) & (o < st.n_active[:, None])

        seg_tokens = torch.cat([ra_draft[:, None], cands, ps_tok], dim=1)  # [B, S, N]
        seg_vlen = torch.cat([ra_dlen[:, None].expand(B, 1 + C), ps_vlen], dim=1)
        seg_active = torch.cat(
            [torch.ones((B, 1), dtype=torch.bool, device=dev), cand_valid, ps_active], dim=1)
        ra_start = _take(st.blk_base, st.ra) + ra_acc
        seg_start = torch.cat([ra_start[:, None].expand(B, 1 + C), _take(st.blk_base, pb)], dim=1)
        seg_pos = seg_start[:, :, None] + jN
        tok_valid = (jN < seg_vlen[:, :, None]) & seg_active[:, :, None]
        return seg_tokens, seg_vlen, seg_active, seg_pos, tok_valid

    # ---------------- verify + state update ----------------
    def update(st: MBState, seg_tokens, seg_vlen, seg_active, greedy):
        blk_draft, blk_dlen, blk_acc = st.blk_draft, st.blk_dlen, st.blk_acc
        blk_acc_toks, blk_base, blk_active = st.blk_acc_toks, st.blk_base, st.blk_active
        ra_i, n_act = st.ra, st.n_active
        o = torch.arange(1, K, device=dev)
        pb = (ra_i[:, None] + o) % K  # [B, K-1] pseudo slots

        # acceptance of every segment; a pseudo verifies from its accepted prefix on
        shifts = torch.cat(
            [torch.zeros((B, 1 + C), dtype=torch.int64, device=dev), _take(blk_acc, pb)], dim=1)
        idx = (shifts[:, :, None] + jN).clamp(0, N - 1)
        t_toks = torch.gather(seg_tokens, 2, idx)  # [B, S, N]
        t_gs = torch.gather(greedy, 2, idx)
        t_lens = seg_vlen - shifts
        mis = (t_toks[:, :, 1:] != t_gs[:, :, :-1]) | (jN[1:] >= t_lens[:, :, None])
        acc_all = 1 + (torch.cumsum(mis.to(torch.int64), dim=-1) == 0).sum(-1)
        acc_all = torch.minimum(acc_all, t_lens.clamp(min=0))
        acc_all = torch.where(seg_active & (t_lens > 0), acc_all, 0)

        # RA winner among RA + candidates (a tie goes to the RA segment, index 0)
        w = _first_max(acc_all[:, : 1 + C])
        acc_w = acc_all[jB, w]
        tw, gw, tlen_w = t_toks[jB, w], t_gs[jB, w], t_lens[jB, w]

        # EOS cap inside the accepted region
        is_eos = (tw == eos_id) & has_eos_id & (jN < acc_w[:, None])
        eos_hit = is_eos.any(-1)
        acc_w = torch.where(eos_hit, _first_true(is_eos) + 1, acc_w)

        rejected = acc_w < tlen_w
        nxt = torch.where(
            rejected,
            gw[jB, (acc_w - 1).clamp(0, N - 1)],
            gw[jB, (tlen_w - 1).clamp(0, N - 1)],
        )

        # RA block update
        commit_ok = jN < acc_w[:, None]
        a_old = _take(blk_acc, ra_i)
        acc_toks_ra = _scatter_drop(
            _take(blk_acc_toks, ra_i), torch.where(commit_ok, a_old[:, None] + jN, N), tw)
        new_dlen_ra = torch.where(rejected & ~eos_hit, tlen_w - acc_w, 0)
        nd_src = (acc_w[:, None] + jN - 1).clamp(0, N - 1)
        nd = torch.where(jN == 0, nxt[:, None], torch.gather(gw, 1, nd_src))
        nd = torch.where(jN < new_dlen_ra[:, None], nd, pad_id)

        blk_draft2 = _set_slot(blk_draft, ra_i, nd)
        blk_dlen2 = _set_slot(blk_dlen, ra_i, new_dlen_ra)
        blk_acc2 = _set_slot(blk_acc, ra_i, a_old + acc_w)
        blk_acc_toks2 = _set_slot(blk_acc_toks, ra_i, acc_toks_ra)

        nxt_eos = (~eos_hit) & has_eos_id & (nxt == eos_id)
        eos_out = eos_hit | nxt_eos

        # ---- pseudo updates: slot (ra + o) % K differs per step, so a loop ----
        for oi in range(1, K):
            b = pb[:, oi - 1]
            seg = C + oi
            active = seg_active[:, seg]
            acc_p = acc_all[:, seg]
            tp, gp, tlp = t_toks[:, seg], t_gs[:, seg], t_lens[:, seg]
            a_p = _take(blk_acc, b)
            new_acc_toks = _scatter_drop(
                _take(blk_acc_toks2, b),
                torch.where((jN < acc_p[:, None]) & active[:, None], a_p[:, None] + jN, N), tp)
            rej_p = acc_p < tlp
            nxt_p = torch.where(
                rej_p, gp[jB, (acc_p - 1).clamp(0, N - 1)], gp[jB, (tlp - 1).clamp(0, N - 1)])
            ndl = torch.where(rej_p, tlp - acc_p, 0)
            nd_p = torch.where(
                jN == 0, nxt_p[:, None],
                torch.gather(gp, 1, (acc_p[:, None] + jN - 1).clamp(0, N - 1)))
            nd_p = torch.where(jN < ndl[:, None], nd_p, pad_id)
            blk_draft2 = _set_slot(blk_draft2, b, nd_p, active)
            blk_dlen2 = _set_slot(blk_dlen2, b, ndl, active)
            blk_acc2 = _set_slot(blk_acc2, b, a_p + acc_p, active)
            blk_acc_toks2 = _set_slot(blk_acc_toks2, b, new_acc_toks, active)

        # ---- n-gram pool append (rejected RA only) ----
        def pool_append(pool, pool_len, pool_next, entry, elen, do):
            slot = pool_next % C
            return (_set_slot(pool, slot, entry, do), _set_slot(pool_len, slot, elen, do),
                    pool_next + do.to(torch.int64))

        n_pieces = min(K, W // N)
        op = torch.arange(n_pieces, device=dev)
        piece_slot = (ra_i[:, None] + op) % K  # [B, n_pieces]
        pieces_tok, a = _packed(blk_acc_toks2, blk_draft2, blk_acc2, piece_slot)
        pieces_valid = (jN < (a + _take(blk_dlen2, piece_slot)).clamp(max=N)[:, :, None]) & (
            (op == 0) | (_take(blk_active, piece_slot) & (op < n_act[:, None]))
        )[:, :, None]
        flat_tok = pieces_tok.reshape(B, -1)[:, :W]
        flat_val = pieces_valid.reshape(B, -1)[:, :W]
        if flat_tok.shape[1] < W:  # K == 1: a single block is narrower than W
            padn = W - flat_tok.shape[1]
            flat_tok = torch.cat(
                [flat_tok, torch.zeros((B, padn), dtype=torch.int64, device=dev)], dim=1)
            flat_val = torch.cat(
                [flat_val, torch.zeros((B, padn), dtype=torch.bool, device=dev)], dim=1)
        concat_entry, concat_len = _compact(flat_tok, flat_val)
        do_pool = rejected & ~eos_out
        pool2, pool_len2, pool_next2 = pool_append(
            st.pool, st.pool_len, st.pool_next, concat_entry, concat_len,
            do_pool & (concat_len > 0))
        tail_len = (tlen_w - 1 - acc_w).clamp(min=0)
        tail = torch.gather(gw, 1, (acc_w[:, None] + jW).clamp(0, N - 1))
        tail = torch.where(jW < tail_len[:, None], tail, pad_id)
        pool2, pool_len2, pool_next2 = pool_append(
            pool2, pool_len2, pool_next2, tail, tail_len, do_pool & (tail_len > 0))

        # ---- spawn ----
        newest = (ra_i + n_act - 1) % K
        can_spawn = (_take(blk_acc2, newest) >= spawn_threshold) & (n_act < K) & (~eos_out)
        new_slot = (ra_i + n_act) % K
        blk_draft2 = _set_slot(blk_draft2, new_slot, nd, can_spawn)
        blk_dlen2 = _set_slot(blk_dlen2, new_slot, N, can_spawn)
        blk_acc2 = _set_slot(blk_acc2, new_slot, 0, can_spawn)
        blk_acc_toks2 = _set_slot(blk_acc_toks2, new_slot, 0, can_spawn)
        blk_base2 = _set_slot(blk_base, new_slot, _take(blk_base, newest) + N, can_spawn)
        blk_active2 = _set_slot(blk_active, new_slot, True, can_spawn)
        n_act2 = n_act + can_spawn.to(torch.int64)

        # ---- promotion on RA completion ----
        complete = (_take(blk_acc2, ra_i) >= N) & (~eos_out)
        has_pseudo = n_act2 > 1
        b2 = (ra_i + 1) % K
        packed_b2, _ = _packed(blk_acc_toks2, blk_draft2, blk_acc2, b2)
        promo_draft = torch.where(jN == 0, nxt[:, None], packed_b2)
        fresh_draft = torch.where(jN == 0, nxt[:, None], pad_id)
        prom = complete & has_pseudo
        fresh = complete & ~has_pseudo

        blk_active2 = _set_slot(blk_active2, ra_i, False, prom)
        blk_draft2 = _set_slot(blk_draft2, b2, promo_draft, prom)
        blk_dlen2 = _set_slot(blk_dlen2, b2, N, prom)
        blk_acc2 = _set_slot(blk_acc2, b2, 0, prom)
        blk_acc_toks2 = _set_slot(blk_acc_toks2, b2, 0, prom)
        blk_draft2 = _set_slot(blk_draft2, ra_i, fresh_draft, fresh)
        blk_dlen2 = _set_slot(blk_dlen2, ra_i, N, fresh)
        blk_acc2 = _set_slot(blk_acc2, ra_i, 0, fresh)
        blk_acc_toks2 = _set_slot(blk_acc_toks2, ra_i, 0, fresh)
        blk_base2 = _set_slot(blk_base2, ra_i, _take(blk_base2, ra_i) + N, fresh)
        ra2 = torch.where(prom, b2, ra_i)
        n_act2 = torch.where(prom, n_act2 - 1, n_act2)

        return dict(
            blk_draft=blk_draft2, blk_dlen=blk_dlen2, blk_acc=blk_acc2,
            blk_acc_toks=blk_acc_toks2, blk_base=blk_base2, blk_active=blk_active2,
            ra=ra2, n_active=n_act2, pool=pool2, pool_len=pool_len2, pool_next=pool_next2,
            last_next=nxt, eos_hit=eos_out, nxt_eos=nxt_eos, w=w, acc_w=acc_w, tw=tw,
        )

    def spec_forward(out_tokens, out_pos, intra, cur):
        h, k_n, v_n = forward_spec(
            params, cfg, out_tokens, out_pos, kv, block_tables, cur, intra, rope, group=group)
        return i64(greedy_tokens(params, cfg, h, group=group)), k_n, v_n

    while True:
        alive = alive_fn(st)
        seg_tokens, seg_vlen, seg_active, seg_pos, tok_valid = assemble(st)
        # Dead rows' state is frozen (gated below), but their stale candidate /
        # pseudo flags must not steer the batch-global tier choice, or a
        # draining batch stays pinned to the expensive full forward.
        seg_active = seg_active & alive[:, None]
        tok_valid = tok_valid & alive[:, None, None]

        go = alive.any()
        if chunk_iters > 0:
            go = go & ((st.iters - iters0).max() < chunk_iters)
        any_cand = seg_active[:, 1 : 1 + C].any()
        any_pseudo = seg_active[:, 1 + C :].any()
        # the one device-to-host read per iteration
        go, any_cand, any_pseudo = torch.stack([go, any_cand, any_pseudo]).tolist()
        if not go:
            break

        out_tokens = torch.where(tok_valid, seg_tokens, 0).reshape(B, T)
        out_pos = seg_pos.reshape(B, T)
        tv = tok_valid.reshape(B, T)
        intra = sees[None] & tv[:, :, None] & tv[:, None, :]

        # tier: 0 = full, 1 = no candidate live anywhere in the batch (forward
        # [RA | pseudos], K*N tokens), 2 = nothing but RA blocks live (N tokens)
        if S == 1 or any_cand:
            tier = 0
        elif any_pseudo:
            tier = 1 if C > 0 else 0
        else:
            tier = 2
        tiers[tier] += 1
        greedy = torch.zeros((B, S, N), dtype=torch.int64, device=dev)
        if tier == 0:
            g, k_new, v_new = spec_forward(out_tokens, out_pos, intra, st.cur_len)
            greedy = g.reshape(B, S, N)
        elif tier == 2:
            g, k_new, v_new = spec_forward(
                out_tokens[:, :N], out_pos[:, :N], intra[:, :N, :N], st.cur_len)
            greedy[:, 0] = g
        else:
            # the pseudo rows start at (1+C)*N in the full layout; RA stays
            # first, so slicing keeps the tree mask's meaning
            keep = torch.cat([jN, torch.arange((1 + C) * N, T, device=dev)])
            g, k_new, v_new = spec_forward(
                out_tokens[:, keep], out_pos[:, keep], intra[:, keep][:, :, keep], st.cur_len)
            g = g.reshape(B, K, N)
            greedy[:, 0] = g[:, 0]
            greedy[:, 1 + C :] = g[:, 1:]

        upd = update(st, seg_tokens, seg_vlen, seg_active, greedy)
        acc_w = torch.where(alive, upd["acc_w"], 0)  # [B]
        tw = upd["tw"]  # [B, N]

        # ---- shared commits: token buffers + paged KV ----
        commit_ok = (jN < acc_w[:, None]) & alive[:, None]
        tokens2 = _scatter_drop(
            st.tokens, torch.where(commit_ok, st.cur_len[:, None] + jN, cap), tw)

        page = kv.page_size
        pos_c = st.cur_len[:, None] + jN
        page_idx = torch.gather(
            block_tables_l, 1, (pos_c // page).clamp(0, block_tables.shape[1] - 1))
        slots = torch.where(
            commit_ok & (page_idx >= 0), page_idx * page + pos_c % page, kv.num_slots)  # [B, N]
        # the winner's N rows of the stash [Lyr, B, T', KH, D]; in the two
        # smaller tiers no candidate is live, so the winner is the RA segment
        if tier == 0:
            rows = (upd["w"][:, None] * N + jN)[None, :, :, None, None]
            kw = torch.gather(k_new, 2, rows.expand(k_new.shape[0], B, N, *k_new.shape[3:]))
            vw = torch.gather(v_new, 2, rows.expand(v_new.shape[0], B, N, *v_new.shape[3:]))
        else:
            kw, vw = k_new[:, :, :N], v_new[:, :, :N]
        # out-of-range slots (uncommitted tokens, -1 pages) go to the trash rows
        Lyr, _, _, KH, D = kw.shape
        dest = write_plan(slots, kv.num_slots, KH)  # [KH * B * N]
        kw = kw.reshape(Lyr, B * N, KH, D).transpose(1, 2).reshape(Lyr, KH * B * N, D)
        vw = vw.reshape(Lyr, B * N, KH, D).transpose(1, 2).reshape(Lyr, KH * B * N, D)
        for cache, scales, new in ((kv.k, kv.k_scale, kw), (kv.v, kv.v_scale, vw)):
            if kv.scaled:  # narrow KV: per-row quantization + scale scatter
                new, sc = quantize_rows(new, cache.dtype)
                with_trash(scales, 0).index_copy_(1, dest, sc)
            with_trash(storage_view(cache), 1).index_copy_(
                1, dest, storage_view(new.to(cache.dtype)))

        cur_len2 = st.cur_len + acc_w
        generated2 = st.generated + acc_w

        # nxt itself is EOS -> commit it and stop
        nxt_eos = upd["nxt_eos"] & alive
        tokens2 = _scatter_drop(
            tokens2, torch.where(nxt_eos, cur_len2, cap)[:, None], upd["last_next"][:, None])
        cur_len2 = cur_len2 + nxt_eos.to(torch.int64)
        generated2 = generated2 + nxt_eos.to(torch.int64)
        eos2 = st.eos | (alive & (upd["eos_hit"] | nxt_eos))

        def gate(new, old):
            return torch.where(alive.reshape((B,) + (1,) * (new.dim() - 1)), new, old)

        st = MBState(
            kv=kv, tokens=tokens2, cur_len=gate(cur_len2, st.cur_len),
            **{k: gate(upd[k], getattr(st, k)) for k in STATE_KEYS},
            eos=eos2, iters=st.iters + alive.to(torch.int64),
            generated=gate(generated2, st.generated),
        )

    i32 = lambda t: t.to(torch.int32)
    out = {"kv": st.kv, "tokens": i32(st.tokens), "cur_len": i32(st.cur_len)}
    for k in STATE_KEYS:
        v = getattr(st, k)
        out[k] = v if v.dtype == torch.bool else i32(v)
    out.update(eos=st.eos, iters=i32(st.iters), generated=i32(st.generated),
               tiers=torch.tensor(tiers, dtype=torch.int32, device=dev))
    return out
