"""Wrapper of the hand-written CUDA speculative-attention kernel (csrc/spec_attention.cu).

Port of the TPU kernel `jacobiforcing_tpu/ops/pallas/spec_attention.py::
spec_attention_pallas`; same arguments as
`ops/attention.paged_attention_with_block_ref`, which is its plain version.
The wrapper checks device, dtype, shape and contiguity and raises on anything
the kernel does not take; it launches on PyTorch's current stream, does not
synchronise, and raises if the launch is refused.
`spec_attention_cuda.launches` counts its launches.

The committed cache may be stored narrower than the queries, with the pairs
and the scale planes of `ops/paged_attention_cuda`; the in-flight block always
comes in the query dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from jacobiforcing_tpu_torch.ops import _build
from jacobiforcing_tpu_torch.ops.paged_attention_cuda import (
    _CACHE_CODES,
    _DTYPE_CODES,
    SUPPORTED_HEAD_DIMS,
    check_cache_dtype,
    kernel_variants,
)

_FN = None


def variants():
    """`kernel_variants` of csrc/spec_attention.cu."""
    return kernel_variants(_build.load("spec_attention"), "jf_spec_attention_attrs")


def _kernel():
    global _FN
    if _FN is None:
        lib = _build.load("spec_attention")
        fn = lib.jf_spec_attention
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.jf_error_string.argtypes = [ctypes.c_int]
        lib.jf_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.jf_error_string)
    return _FN


def check_inputs(q, k_cache_l, v_cache_l, block_tables, cache_lens, k_new, v_new, intra_mask,
                 page_size, k_scale_l=None, v_scale_l=None):
    """Raise ValueError for anything the kernel does not take."""
    if q.dim() != 4 or k_cache_l.dim() != 3 or v_cache_l.dim() != 3:
        raise ValueError("expected q [B, T, NH, D] and k/v caches [KH, num_slots, D]")
    B, T, NH, D = q.shape
    KH, num_slots, Dk = k_cache_l.shape
    check_cache_dtype(q, k_cache_l, v_cache_l, k_scale_l, v_scale_l)
    if k_new.dtype != q.dtype or v_new.dtype != q.dtype:
        raise ValueError("the in-flight K/V dtype must equal the query dtype")
    if D not in SUPPORTED_HEAD_DIMS or Dk != D or tuple(v_cache_l.shape) != (KH, num_slots, D):
        raise ValueError(f"head_dim must be one of {SUPPORTED_HEAD_DIMS} for q, k and v")
    if KH == 0 or NH % KH != 0:
        raise ValueError(f"query heads {NH} must be a multiple of KV heads {KH}")
    if page_size % 16 != 0 or num_slots % page_size != 0:
        raise ValueError(f"page_size {page_size} must be a multiple of 16 dividing the slots")
    if tuple(k_new.shape) != (B, T, KH, D) or tuple(v_new.shape) != (B, T, KH, D):
        raise ValueError("k_new and v_new must be [B, T, KH, D]")
    if tuple(intra_mask.shape) != (B, T, T) or intra_mask.dtype != torch.bool:
        raise ValueError("intra_mask must be a bool tensor [B, T, T]")
    if block_tables.dim() != 2 or block_tables.shape[0] != B or tuple(cache_lens.shape) != (B,):
        raise ValueError("block_tables must be [B, P] and cache_lens [B]")
    for name, t in (("block_tables", block_tables), ("cache_lens", cache_lens)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    tensors = (q, k_cache_l, v_cache_l, block_tables, cache_lens, k_new, v_new, intra_mask)
    if k_scale_l is not None:
        tensors += (k_scale_l, v_scale_l)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("all inputs must be CUDA tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache_l, v_cache_l, k_new, v_new)):
        raise ValueError("q, k and v must start on a 16-byte boundary (the kernel loads 16 B)")


def spec_attention_cuda(
    q: torch.Tensor,  # [B, T, NH, D]
    k_cache_l: torch.Tensor,  # [KH, num_slots, D]
    v_cache_l: torch.Tensor,
    block_tables: torch.Tensor,  # [B, P] int32 (-1 = unused)
    cache_lens: torch.Tensor,  # [B] int32 committed KV length
    k_new: torch.Tensor,  # [B, T, KH, D] in-flight block K (in no cache)
    v_new: torch.Tensor,
    intra_mask: torch.Tensor,  # [B, T, T] bool
    scale: float,
    *,
    page_size: int,
    k_scale_l: Optional[torch.Tensor] = None,  # [KH, num_slots] float32 dequant rows
    v_scale_l: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    check_inputs(q, k_cache_l, v_cache_l, block_tables, cache_lens, k_new, v_new, intra_mask,
                 page_size, k_scale_l, v_scale_l)
    fn, err_str = _kernel()
    B, T, NH, D = q.shape
    KH, num_slots, _ = k_cache_l.shape
    out = torch.empty_like(q)
    rc = fn(
        q.data_ptr(), k_cache_l.data_ptr(), v_cache_l.data_ptr(),
        None if k_scale_l is None else k_scale_l.data_ptr(),
        None if v_scale_l is None else v_scale_l.data_ptr(), block_tables.data_ptr(),
        cache_lens.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), intra_mask.data_ptr(),
        out.data_ptr(), B, T, NH, KH, D, block_tables.shape[1], num_slots, page_size,
        float(scale), _DTYPE_CODES[q.dtype], _CACHE_CODES[k_cache_l.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        msg = "unsupported shape or dtype" if rc < 0 else err_str(rc).decode()
        raise RuntimeError(f"spec_attention kernel launch failed ({rc}): {msg}")
    spec_attention_cuda.launches += 1
    return out


spec_attention_cuda.launches = 0
