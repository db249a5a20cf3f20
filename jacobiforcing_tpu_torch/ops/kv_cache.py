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
`write_kv` and `write_kv_scaled` update the cache tensors in place, with a
scatter of fixed shape: a token that is not written (its slot out of range,
masked, or on a -1 page) goes to a trash row.  `alloc_kv_cache` lays each
layer out as its `num_kv_heads * num_slots` slot rows followed by that trash
row, so a layer's `[num_kv_heads, num_slots, head_dim]` view stays contiguous
(what the kernels take, with the pool's own `num_slots`), no block table can
name the trash row, and nothing reads it.  Under tensor parallelism a rank's
pool, its trash rows and its scale planes hold that rank's
`num_kv_heads / tp` heads; a write plan takes the pool's own head count.  A fixed-shape write needs no
device-to-host read, so a forward can be captured in a CUDA graph.
"""

from __future__ import annotations

import math
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
    """Paged KV storage for all layers, made by `alloc_kv_cache`.

    k, v: [num_layers, num_kv_heads, num_pages * page_size, head_dim]
    k_scale, v_scale: [num_layers, num_kv_heads, num_pages * page_size] float32
        per-row dequant scales (None unless the storage type is narrow).
    Each layer's rows are followed in memory by its trash row (`with_trash`).
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


def _pool(num_layers, num_kv_heads, num_slots, row, fill, dtype, device) -> torch.Tensor:
    """[num_layers, num_kv_heads, num_slots, *row] over a [num_layers,
    num_kv_heads * num_slots + 1, *row] buffer: each layer's trash row sits
    right after its slots."""
    buf = torch.full((num_layers, num_kv_heads * num_slots + 1) + row, fill, dtype=dtype,
                     device=device)
    return buf[:, : num_kv_heads * num_slots].unflatten(1, (num_kv_heads, num_slots))


def alloc_kv_cache(
    num_layers: int,
    num_pages: int,
    page_size: int,
    num_kv_heads: int,
    head_dim: int,
    dtype=torch.bfloat16,
    device="cpu",
) -> KVCache:
    dims = (num_layers, num_kv_heads, num_pages * page_size)
    k_scale = v_scale = None
    if needs_row_scales(dtype):
        k_scale = _pool(*dims, (), 1.0, torch.float32, device)
        v_scale = _pool(*dims, (), 1.0, torch.float32, device)
    return KVCache(
        _pool(*dims, (head_dim,), 0, dtype, device),
        _pool(*dims, (head_dim,), 0, dtype, device),
        page_size, k_scale, v_scale,
    )


def with_trash(t: torch.Tensor, row_dims: int) -> torch.Tensor:
    """The rows of a cache tensor laid out by `alloc_kv_cache` together with
    each layer's trash row.

    `t` is one layer, [num_kv_heads, num_slots, *row], or the pool, [layers,
    num_kv_heads, num_slots, *row], with `row_dims` = len(row) (1 for K/V
    rows, 0 for scales).  Returns [num_kv_heads * num_slots + 1, *row] (or
    [layers, ...]): slot s of head h is row h * num_slots + s, the trash row
    is the last.  Raises ValueError for a tensor without trash rows."""
    lead = t.dim() - 2 - row_dims
    kh, slots = t.shape[lead], t.shape[lead + 1]
    row = math.prod(t.shape[lead + 2:])
    per_layer = (kh * slots + 1) * row
    strides = t.stride()
    rows_ok = strides[lead:] == tuple(math.prod(t.shape[i + 1:]) for i in range(lead, t.dim()))
    layers_ok = lead == 0 or t.shape[0] == 1 or strides[0] == per_layer
    if not (lead in (0, 1) and rows_ok and layers_ok and t.storage_offset() % per_layer == 0
            and (t.untyped_storage().nbytes() // t.element_size()) % per_layer == 0):
        raise ValueError("the cache has no trash rows: allocate it with alloc_kv_cache")
    shape = t.shape[:lead] + (kh * slots + 1,) + t.shape[lead + 2:]
    return t.as_strided(shape, (per_layer,) * lead + strides[lead + 1:])


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


def write_plan(slots: torch.Tensor, num_slots: int, num_kv_heads: int) -> torch.Tensor:
    """Where each (KV head, token) of a [B, T] slot map is written: [KH * B * T]
    row indices into `with_trash` rows, head-major.  A token whose slot lies
    outside [0, num_slots) goes to the trash row, never to a real slot: the
    JAX scatter's `mode="drop"` in a shape that does not depend on the data.
    The plan is the same for every layer, so a forward computes it once."""
    flat = slots.reshape(-1).long()
    heads = torch.arange(num_kv_heads, device=flat.device)[:, None] * num_slots
    dest = torch.where((flat >= 0) & (flat < num_slots), heads + flat[None, :],
                       num_kv_heads * num_slots)
    return dest.reshape(-1)


def _head_major(x: torch.Tensor, kh: int) -> torch.Tensor:
    """[B, T, KH, *row] -> [KH * B * T, *row], the order of `write_plan`."""
    row = tuple(x.shape[3:])
    return x.reshape((-1, kh) + row).transpose(0, 1).reshape((-1,) + row)


def write_kv(
    k_cache: torch.Tensor,  # [KH, num_slots, D] (single layer, from alloc_kv_cache)
    v_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, T, KH, D]
    v_new: torch.Tensor,
    slots: torch.Tensor,  # [B, T] flat slots; outside [0, num_slots) = skip
    plan: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter new K/V rows into the flat paged cache of one layer, IN PLACE.

    `k_cache` and `v_cache` are modified and returned.  Tokens whose slot is
    out of range are skipped (see `write_plan`); pass `plan` to reuse one
    computed for another layer of the same forward.
    """
    kh = k_cache.shape[0]
    dest = plan if plan is not None else write_plan(slots, k_cache.shape[1], kh)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        with_trash(cache, 1).index_copy_(0, dest, _head_major(new, kh).to(cache.dtype))
    return k_cache, v_cache


def write_kv_scaled(
    k_cache: torch.Tensor,  # [KH, num_slots, D] narrow type (single layer)
    v_cache: torch.Tensor,
    ks_cache: torch.Tensor,  # [KH, num_slots] float32
    vs_cache: torch.Tensor,
    k_new: torch.Tensor,  # [B, T, KH, D] compute dtype
    v_new: torch.Tensor,
    slots: torch.Tensor,  # [B, T]
    plan: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`write_kv` with per-row amax quantization and a scatter of the scales,
    IN PLACE, with the same drop semantics."""
    kh = k_cache.shape[0]
    dest = plan if plan is not None else write_plan(slots, k_cache.shape[1], kh)
    for cache, scales, new in ((k_cache, ks_cache, k_new), (v_cache, vs_cache, v_new)):
        q, s = quantize_rows(_head_major(new, kh), cache.dtype)  # [KH*B*T, D], [KH*B*T]
        with_trash(storage_view(cache), 1).index_copy_(0, dest, storage_view(q))
        with_trash(scales, 0).index_copy_(0, dest, s)
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
