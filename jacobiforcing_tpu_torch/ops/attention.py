"""Paged causal attention: the single attention path for every decode context.

PyTorch port of `jacobiforcing_tpu/ops/attention.py`.  Queries [B, T, NH, D]
at absolute `positions` attend to the paged cache through `block_tables`; a
key at position j counts iff `j < cache_lens[b]` and `j <= position`.  One
function serves prefill, AR decode (T=1) and Jacobi blocks (T=L), so greedy
Jacobi and greedy AR see bit-identical attention rows.

Two implementations:
  * `paged_attention_ref`: gather the pages, masked softmax.  The plain
    version; runs on any device and is what CPU tensors take.
  * `ops/paged_attention_cuda.paged_attention_cuda`: the hand-written CUDA
    kernel (csrc/paged_attention.cu).  CUDA tensors always take it, and an
    input it cannot serve raises instead of falling back.

`paged_attention_with_block` is the speculative attention of the multiblock
(MR) decoder: the committed paged keys (length mask only) plus an in-flight
block that is in no cache, under an arbitrary intra-block mask, one softmax
over both.  It has the same two implementations
(`paged_attention_with_block_ref`, `ops/spec_attention_cuda.spec_attention_cuda`
for csrc/spec_attention.cu) and the same dispatch rule.

A narrow KV cache (fp8 e4m3 / int8, `ops/kv_cache.py`) comes with per-row
dequant scales `k_scale_l` / `v_scale_l` [KH, num_slots]: every implementation
reads a stored row as `dequantize_rows` does, in the query dtype.

Left out on purpose (TPU-only): the flat-exp2 softmax, its calibration and
score guard, the `JF_ATTN_IMPL` / `JF_SPEC_ONLY_T` switches, the `D % 128`
feasibility gate and head-group tiling, and the serving-mesh shard_map
dispatch.
"""

from __future__ import annotations

from typing import Optional

import torch

from jacobiforcing_tpu_torch.ops.kv_cache import dequantize_rows, gather_pages, gather_scales

_NEG_INF = -1e30


def gather_dequant(cache_l, scale_l, block_tables, page_size, dtype):
    """Gather pages as `dtype`; apply the per-row dequant scales when present."""
    x = gather_pages(cache_l, block_tables, page_size)  # [B, S, KH, D]
    if scale_l is None:
        return x.to(dtype)
    return dequantize_rows(x, gather_scales(scale_l, block_tables, page_size), dtype)


def paged_attention_ref(
    q: torch.Tensor,  # [B, T, NH, D]
    k_cache_l: torch.Tensor,  # [KH, num_slots, D]
    v_cache_l: torch.Tensor,
    block_tables: torch.Tensor,  # [B, P]
    cache_lens: torch.Tensor,  # [B] valid KV length (incl. this call's tokens)
    positions: torch.Tensor,  # [B, T] absolute query positions
    scale: float,
    *,
    page_size: int,
    k_scale_l: Optional[torch.Tensor] = None,  # [KH, num_slots] dequant rows
    v_scale_l: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of `paged_attention_xla`: same mask, same dtypes."""
    B, T, NH, D = q.shape
    KH = k_cache_l.shape[0]
    groups = NH // KH
    k = gather_dequant(k_cache_l, k_scale_l, block_tables, page_size, q.dtype)  # [B,S,KH,D]
    v = gather_dequant(v_cache_l, v_scale_l, block_tables, page_size, q.dtype)
    S = k.shape[1]

    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.reshape(B, T, KH, groups, D).permute(0, 2, 3, 1, 4)  # [B,KH,G,T,D]
    kt = k.permute(0, 2, 1, 3)  # [B, KH, S, D]
    scores = torch.einsum("bhgtd,bhsd->bhgts", qg.to(acc), kt.to(acc)) * scale

    key_pos = torch.arange(S, device=q.device)[None, :]
    valid = key_pos < cache_lens[:, None].long()  # [B, S]
    causal = key_pos[:, None, :] <= positions[:, :, None].long()  # [B, T, S]
    mask = (valid[:, None, :] & causal)[:, None, None, :, :]
    scores = torch.where(mask, scores, torch.tensor(_NEG_INF, dtype=acc, device=q.device))

    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    vt = v.permute(0, 2, 1, 3)  # [B, KH, S, D]
    out = torch.einsum("bhgts,bhsd->bhgtd", probs, vt)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, NH, D)


def paged_attention(
    q,
    k_cache_l,
    v_cache_l,
    block_tables,
    cache_lens,
    positions,
    scale,
    *,
    page_size: int,
    k_scale_l=None,
    v_scale_l=None,
) -> torch.Tensor:
    """CUDA tensors go to the kernel (which raises on what it cannot serve);
    CPU tensors go to the plain version."""
    if q.is_cuda:
        from jacobiforcing_tpu_torch.ops.paged_attention_cuda import paged_attention_cuda

        return paged_attention_cuda(
            q, k_cache_l, v_cache_l, block_tables, cache_lens, positions, scale,
            page_size=page_size, k_scale_l=k_scale_l, v_scale_l=v_scale_l,
        )
    return paged_attention_ref(
        q, k_cache_l, v_cache_l, block_tables, cache_lens, positions, scale,
        page_size=page_size, k_scale_l=k_scale_l, v_scale_l=v_scale_l,
    )


def paged_attention_with_block_ref(
    q: torch.Tensor,  # [B, T, NH, D]
    k_cache_l: torch.Tensor,  # [KH, num_slots, D]
    v_cache_l: torch.Tensor,
    block_tables: torch.Tensor,  # [B, P]
    cache_lens: torch.Tensor,  # [B] committed KV length (all attended)
    k_new: torch.Tensor,  # [B, T, KH, D] in-flight block K (NOT in the cache)
    v_new: torch.Tensor,
    intra_mask: torch.Tensor,  # [B, T, T] bool: query attends in-flight key?
    scale: float,
    *,
    page_size: int,
    k_scale_l: Optional[torch.Tensor] = None,  # [KH, num_slots] dequant rows
    v_scale_l: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the dense path of the JAX `paged_attention_with_block`:
    committed scores masked by `key < cache_len`, in-flight scores by
    `intra_mask`, ONE softmax over their concatenation, probabilities cast to
    `q.dtype`, and the two value products summed."""
    B, T, NH, D = q.shape
    KH = k_cache_l.shape[0]
    groups = NH // KH
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    neg = torch.tensor(_NEG_INF, dtype=acc, device=q.device)

    kc = gather_dequant(k_cache_l, k_scale_l, block_tables, page_size, q.dtype)  # [B,S,KH,D]
    vc = gather_dequant(v_cache_l, v_scale_l, block_tables, page_size, q.dtype)
    S = kc.shape[1]

    qg = q.reshape(B, T, KH, groups, D).permute(0, 2, 3, 1, 4).to(acc)  # [B,KH,G,T,D]
    sc_cache = torch.einsum("bhgtd,bshd->bhgts", qg, kc.to(acc)) * scale
    key_pos = torch.arange(S, device=q.device)[None, :]
    valid_c = (key_pos < cache_lens[:, None].long())[:, None, None, None, :]
    sc_cache = torch.where(valid_c, sc_cache, neg)

    sc_blk = torch.einsum("bhgtd,bshd->bhgts", qg, k_new.to(q.dtype).to(acc)) * scale
    sc_blk = torch.where(intra_mask[:, None, None, :, :], sc_blk, neg)

    probs = torch.softmax(torch.cat([sc_cache, sc_blk], dim=-1), dim=-1).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bhgtd", probs[..., :S], vc) + torch.einsum(
        "bhgts,bshd->bhgtd", probs[..., S:], v_new.to(q.dtype)
    )
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, NH, D)


def paged_attention_with_block(
    q,
    k_cache_l,
    v_cache_l,
    block_tables,
    cache_lens,
    k_new,
    v_new,
    intra_mask,
    scale,
    *,
    page_size: int,
    k_scale_l=None,
    v_scale_l=None,
) -> torch.Tensor:
    """CUDA tensors go to the kernel (which raises on what it cannot serve);
    CPU tensors go to the plain version."""
    if q.is_cuda:
        from jacobiforcing_tpu_torch.ops.spec_attention_cuda import spec_attention_cuda

        return spec_attention_cuda(
            q, k_cache_l, v_cache_l, block_tables, cache_lens, k_new, v_new, intra_mask, scale,
            page_size=page_size, k_scale_l=k_scale_l, v_scale_l=v_scale_l,
        )
    return paged_attention_with_block_ref(
        q, k_cache_l, v_cache_l, block_tables, cache_lens, k_new, v_new, intra_mask, scale,
        page_size=page_size, k_scale_l=k_scale_l, v_scale_l=v_scale_l,
    )
