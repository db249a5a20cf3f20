"""Paged KV cache (PyTorch port of `jacobiforcing_tpu/ops/kv_cache.py`).

Storage is head-major, `[layers, kv_heads, num_pages * page_size, head_dim]`,
exactly as in the JAX package: a page of one KV head is a contiguous
`[page, head_dim]` slab, and a block table turns an absolute token position
into a flat slot.  There is no clear or trim operation: a sequence's valid
KV prefix is its `cache_lens` counter, and stale slots are masked by the
attention and overwritten later.

Narrow storage types (`torch.float8_e4m3fn`, `torch.int8`) carry PER-ROW (per
token, per KV head) float32 dequant scales in `k_scale` / `v_scale`: a written
row is normalised to the type's range (its amax maps to 448 or 127), so
magnitudes beyond the e4m3 maximum do not saturate.

Unlike the JAX cache, which is immutable and returned anew by every write,
`write_kv` and `write_kv_scaled` update the cache tensors in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


# Largest magnitude of each narrow type; rows are scaled so that amax maps here.
FP8_MAX = 448.0  # float8_e4m3fn
INT8_MAX = 127.0
# The JAX source writes `amax / FP8_MAX` inside jitted code, and XLA compiles a
# division by a constant into a multiplication by its float32 reciprocal.  The
# port multiplies by the same reciprocals, so stored bytes and scales equal the
# JAX engine's.
_INV_FP8_MAX = float(np.float32(1.0) / np.float32(FP8_MAX))
_INV_INT8_MAX = float(np.float32(1.0) / np.float32(INT8_MAX))

_FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
_SCALED_DTYPES = _FP8_DTYPES + (torch.int8,)


def needs_row_scales(dtype: torch.dtype) -> bool:
    return dtype in _SCALED_DTYPES


def storage_view(t: torch.Tensor) -> torch.Tensor:
    """A float8 tensor as its bytes, any other tensor as it is: rows are moved
    in and out of the cache by indexing, which not every build offers for
    float8 tensors."""
    return t.view(torch.uint8) if t.dtype in _FP8_DTYPES else t


@dataclass
class KVCache:
    """Paged KV storage for all layers.

    k, v: [num_layers, num_kv_heads, num_pages * page_size, head_dim]
    k_scale, v_scale: [num_layers, num_kv_heads, num_pages * page_size] float32
        per-row dequant scales (None unless the storage type is narrow).
    """

    k: torch.Tensor
    v: torch.Tensor
    page_size: int = 256
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def num_slots(self) -> int:
        return self.k.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k.shape[2] // self.page_size

    @property
    def scaled(self) -> bool:
        return self.k_scale is not None


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
    k_scale = v_scale = None
    if needs_row_scales(dtype):
        k_scale = torch.ones(shape[:3], dtype=torch.float32, device=device)
        v_scale = torch.ones(shape[:3], dtype=torch.float32, device=device)
    return KVCache(
        torch.zeros(shape, dtype=dtype, device=device),
        torch.zeros(shape, dtype=dtype, device=device),
        page_size, k_scale, v_scale,
    )


def quantize_rows(x: torch.Tensor, cache_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (last-axis) amax scaling into a narrow type (fp8 or int8).

    x [..., D] -> (q [..., D] cache_dtype, scale [...] float32) with
    dequant(q) = q.float() * scale[..., None].  An all-zero row has scale
    1e-12 and zeros."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1)
    if cache_dtype == torch.int8:
        scale = (amax * _INV_INT8_MAX).clamp(min=1e-12)
        q = torch.round(xf / scale[..., None]).clamp(-INT8_MAX, INT8_MAX)
        return q.to(cache_dtype), scale
    scale = (amax * _INV_FP8_MAX).clamp(min=1e-12)
    return (xf / scale[..., None]).to(cache_dtype), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows stored narrow, read back in `dtype`: both the stored value and its
    scale are cast to `dtype` and multiplied there.  This is what every reader
    of a scaled cache computes (the plain attention, the CUDA kernels, and
    `forward_spec` for rows that are not committed yet), bit for bit."""
    return q.to(dtype) * scale[..., None].to(dtype)


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


def write_kv_scaled(
    k_cache: torch.Tensor,  # [KH, num_slots, D] narrow type (single layer)
    v_cache: torch.Tensor,
    ks_cache: torch.Tensor,  # [KH, num_slots] float32
    vs_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, T, KH, D] compute dtype
    v_new: torch.Tensor,
    slots: torch.Tensor,  # [B, T]
    plan: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`write_kv` with per-row amax quantization and a scatter of the scales,
    IN PLACE, with the same drop semantics."""
    rows, dest = plan if plan is not None else write_plan(slots, k_cache.shape[1])
    kh, d = k_new.shape[-2], k_new.shape[-1]
    for cache, scales, new in ((k_cache, ks_cache, k_new), (v_cache, vs_cache, v_new)):
        q, s = quantize_rows(new.reshape(-1, kh, d)[rows], cache.dtype)  # [R, KH, D], [R, KH]
        storage_view(cache)[:, dest] = storage_view(q).transpose(0, 1)
        scales[:, dest] = s.T
    return k_cache, v_cache, ks_cache, vs_cache


def _slot_index(block_tables: torch.Tensor, page_size: int) -> torch.Tensor:
    """[B, P * page_size] flat slot of every position; a -1 page reads page 0."""
    B, P = block_tables.shape
    ar = torch.arange(page_size, device=block_tables.device)
    return (
        block_tables.clamp(min=0).long()[:, :, None] * page_size + ar[None, None, :]
    ).reshape(B, P * page_size)


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
    out = storage_view(cache_l)[:, _slot_index(block_tables, page_size)].view(cache_l.dtype)
    return out.permute(1, 2, 0, 3)  # [B, S_max, KH, D]


def gather_scales(
    scale_l: torch.Tensor,  # [KH, num_slots] (single layer)
    block_tables: torch.Tensor,  # [B, P]
    page_size: int,
) -> torch.Tensor:
    """Gather per-row dequant scales into [B, P * page_size, KH]."""
    return scale_l[:, _slot_index(block_tables, page_size)].permute(1, 2, 0)
