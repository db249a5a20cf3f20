"""Paged KV cache (PyTorch port of `jacobiforcing_tpu/ops/kv_cache.py`).

Storage is head-major, `[layers, kv_heads, num_pages * page_size, head_dim]`,
exactly as in the JAX package: a page of one KV head is a contiguous
`[page, head_dim]` slab, and a block table turns an absolute token position
into a flat slot.  There is no clear or trim operation: a sequence's valid
KV prefix is its `cache_lens` counter, and stale slots are masked by the
attention and overwritten later.

Unlike the JAX cache, which is immutable and returned anew by every write,
`write_kv` updates the cache tensors in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch


@dataclass
class KVCache:
    """Paged KV storage for all layers.

    k, v: [num_layers, num_kv_heads, num_pages * page_size, head_dim]
    """

    k: torch.Tensor
    v: torch.Tensor
    page_size: int = 256

    @property
    def num_slots(self) -> int:
        return self.k.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k.shape[2] // self.page_size


def alloc_kv_cache(
    num_layers: int,
    num_pages: int,
    page_size: int,
    num_kv_heads: int,
    head_dim: int,
    dtype=torch.bfloat16,
    device="cpu",
) -> KVCache:
    shape = (num_layers, num_kv_heads, num_pages * page_size, head_dim)
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        page_size,
    )


def write_plan(slots: torch.Tensor, num_slots: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Which rows of a [B, T] slot map are written, and where.

    Returns (rows, dest): indices into the flattened B*T token axis whose slot
    lies in [0, num_slots), and those slots.  Every other token is skipped,
    never clamped onto a real slot: this is the JAX scatter's `mode="drop"`
    with an explicit mask.  The plan is the same for every layer, so a
    forward computes it once (one device-to-host sync) and reuses it.
    """
    flat = slots.reshape(-1)
    rows = torch.nonzero((flat >= 0) & (flat < num_slots)).squeeze(1)
    return rows, flat[rows].long()


def write_kv(
    k_cache: torch.Tensor,  # [KH, num_slots, D] (single layer)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, T, KH, D]
    v_new: torch.Tensor,
    slots: torch.Tensor,  # [B, T] flat slots; outside [0, num_slots) = skip
    plan: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter new K/V rows into the flat paged cache of one layer, IN PLACE.

    `k_cache` and `v_cache` are modified and returned.  Tokens whose slot is
    out of range are skipped (see `write_plan`); pass `plan` to reuse one
    computed for another layer of the same forward.
    """
    rows, dest = plan if plan is not None else write_plan(slots, k_cache.shape[1])
    kh, d = k_new.shape[-2], k_new.shape[-1]
    k_rows = k_new.reshape(-1, kh, d)[rows].transpose(0, 1).to(k_cache.dtype)
    v_rows = v_new.reshape(-1, kh, d)[rows].transpose(0, 1).to(v_cache.dtype)
    k_cache[:, dest] = k_rows
    v_cache[:, dest] = v_rows
    return k_cache, v_cache


def gather_pages(
    cache_l: torch.Tensor,  # [KH, num_slots, D] (single layer)
    block_tables: torch.Tensor,  # [B, P] (-1 = unused page)
    page_size: int,
) -> torch.Tensor:
    """Gather each sequence's pages into contiguous [B, P * page_size, KH, D].

    Unused (-1) pages read page 0, as in the JAX version; the attention masks
    those keys by `cache_lens`.  Only the plain attention uses this: the CUDA
    kernel reads pages in place.
    """
    B, P = block_tables.shape
    ar = torch.arange(page_size, device=block_tables.device)
    slot_idx = (
        block_tables.clamp(min=0).long()[:, :, None] * page_size + ar[None, None, :]
    ).reshape(B, P * page_size)
    return cache_l[:, slot_idx].permute(1, 2, 0, 3)  # [B, S_max, KH, D]
