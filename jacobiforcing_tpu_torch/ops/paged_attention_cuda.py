"""Wrapper of the hand-written CUDA paged-attention kernel (csrc/paged_attention.cu).

Port of the TPU kernel `jacobiforcing_tpu/ops/pallas/paged_attention.py::
paged_attention_pallas`; same arguments as `ops/attention.paged_attention_ref`,
which is its plain version.  The wrapper checks device, dtype, shape and
contiguity and raises on anything the kernel does not take; it launches on
PyTorch's current stream, does not synchronise, and raises if the launch is
refused.  `paged_attention_cuda.launches` counts its launches.

The cache may be stored narrower than the queries.  Served (query, cache)
pairs: the cache in the query's type; a bfloat16 cache under float32 queries;
`torch.float8_e4m3fn`, `torch.float8_e5m2` or `torch.int8` under either, and
then (and only then)
with both per-row dequant scale planes `k_scale_l` / `v_scale_l`
[KH, num_slots], float32, contiguous.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from jacobiforcing_tpu_torch.ops import _build

SUPPORTED_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_CACHE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2, torch.int8: 3,
                torch.float8_e5m2: 4}
SCALED_CACHE_DTYPES = (torch.float8_e4m3fn, torch.int8, torch.float8_e5m2)
# (query dtype, cache dtype) pairs the kernels are built for
SUPPORTED_PAIRS = frozenset(
    [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
     (torch.float32, torch.bfloat16)]
    + [(qd, cd) for qd in _DTYPE_CODES for cd in SCALED_CACHE_DTYPES])
_FN = None
# what the `jf_*_attrs` C functions report for one variant, in order
_ATTR_FIELDS = ("tensor_cores", "registers", "local_bytes", "static_smem", "dynamic_smem",
                "threads", "key_tile", "stages")


def kernel_variants(lib, fn_name):
    """One dict per built (query, cache, D) variant of a kernel library: which
    tile it runs (tensor cores or the fp32 CUDA-core tile), its registers and
    local (stack or spilled) bytes per thread, static and dynamic shared
    memory and threads per CTA, keys per tile and K/V stages.  Needs the
    card."""
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows = []
    for qd, cd in sorted(SUPPORTED_PAIRS, key=str):
        for D in SUPPORTED_HEAD_DIMS:
            buf = (ctypes.c_int * len(_ATTR_FIELDS))()
            rc = fn(_DTYPE_CODES[qd], _CACHE_CODES[cd], D, buf)
            if rc != 0:
                raise RuntimeError(f"{fn_name}({qd}, {cd}, {D}) failed ({rc})")
            rows.append(dict(query=str(qd).replace("torch.", ""),
                             cache=str(cd).replace("torch.", ""), D=D,
                             **dict(zip(_ATTR_FIELDS, buf))))
    return rows


def variants():
    """`kernel_variants` of csrc/paged_attention.cu."""
    return kernel_variants(_build.load("paged_attention"), "jf_paged_attention_attrs")


def _kernel():
    global _FN
    if _FN is None:
        lib = _build.load("paged_attention")
        fn = lib.jf_paged_attention
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        lib.jf_error_string.argtypes = [ctypes.c_int]
        lib.jf_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.jf_error_string)
    return _FN


def check_cache_dtype(q, k_cache_l, v_cache_l, k_scale_l, v_scale_l):
    """Raise ValueError unless (query dtype, cache dtype) is a served pair and
    the scale planes are there exactly when the cache type needs them.  Shared
    with the speculative kernel's wrapper."""
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype} not supported (float32 or bfloat16)")
    if v_cache_l.dtype != k_cache_l.dtype or (q.dtype, k_cache_l.dtype) not in SUPPORTED_PAIRS:
        raise ValueError(
            f"K/V cache dtype {k_cache_l.dtype}/{v_cache_l.dtype} under {q.dtype} queries is not "
            f"supported: the cache must be stored in the query dtype, as bfloat16 under float32 "
            f"queries, or as float8_e4m3fn / float8_e5m2 / int8 with per-row scales")
    scaled = k_cache_l.dtype in SCALED_CACHE_DTYPES
    if (k_scale_l is None) != (v_scale_l is None):
        raise ValueError("k_scale_l and v_scale_l must be given together")
    if scaled != (k_scale_l is not None):
        raise ValueError(f"a {k_cache_l.dtype} cache "
                         + ("needs" if scaled else "takes no") + " k_scale_l / v_scale_l")
    if scaled:
        want = tuple(k_cache_l.shape[:2])
        for name, t in (("k_scale_l", k_scale_l), ("v_scale_l", v_scale_l)):
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"{name} must be float32 [KH, num_slots] = {want}")


def check_inputs(q, k_cache_l, v_cache_l, block_tables, cache_lens, positions, page_size,
                 k_scale_l=None, v_scale_l=None):
    """Raise ValueError for anything the kernel does not take."""
    if q.dim() != 4 or k_cache_l.dim() != 3 or v_cache_l.dim() != 3:
        raise ValueError("expected q [B, L, NH, D] and k/v caches [KH, num_slots, D]")
    B, L, NH, D = q.shape
    KH, num_slots, Dk = k_cache_l.shape
    check_cache_dtype(q, k_cache_l, v_cache_l, k_scale_l, v_scale_l)
    if D not in SUPPORTED_HEAD_DIMS or Dk != D or tuple(v_cache_l.shape) != (KH, num_slots, D):
        raise ValueError(f"head_dim must be one of {SUPPORTED_HEAD_DIMS} for q, k and v")
    if KH == 0 or NH % KH != 0:
        raise ValueError(f"query heads {NH} must be a multiple of KV heads {KH}")
    if page_size % 16 != 0 or num_slots % page_size != 0:
        raise ValueError(f"page_size {page_size} must be a multiple of 16 dividing the slots")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError("block_tables must be [B, P]")
    if tuple(cache_lens.shape) != (B,) or tuple(positions.shape) != (B, L):
        raise ValueError("cache_lens must be [B] and positions [B, L]")
    for name, t in (("block_tables", block_tables), ("cache_lens", cache_lens),
                    ("positions", positions)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    tensors = (q, k_cache_l, v_cache_l, block_tables, cache_lens, positions)
    if k_scale_l is not None:
        tensors += (k_scale_l, v_scale_l)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("all inputs must be CUDA tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k_cache_l, v_cache_l)):
        raise ValueError("q, k and v must start on a 16-byte boundary (the kernel loads 16 B)")


def paged_attention_cuda(
    q: torch.Tensor,  # [B, L, NH, D]
    k_cache_l: torch.Tensor,  # [KH, num_slots, D]
    v_cache_l: torch.Tensor,
    block_tables: torch.Tensor,  # [B, P] int32 (-1 = unused)
    cache_lens: torch.Tensor,  # [B] int32
    positions: torch.Tensor,  # [B, L] int32
    scale: float,
    *,
    page_size: int,
    k_scale_l: Optional[torch.Tensor] = None,  # [KH, num_slots] float32 dequant rows
    v_scale_l: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    check_inputs(q, k_cache_l, v_cache_l, block_tables, cache_lens, positions, page_size,
                 k_scale_l, v_scale_l)
    fn, err_str = _kernel()
    B, L, NH, D = q.shape
    KH, num_slots, _ = k_cache_l.shape
    out = torch.empty_like(q)
    rc = fn(
        q.data_ptr(), k_cache_l.data_ptr(), v_cache_l.data_ptr(),
        None if k_scale_l is None else k_scale_l.data_ptr(),
        None if v_scale_l is None else v_scale_l.data_ptr(), block_tables.data_ptr(),
        cache_lens.data_ptr(), positions.data_ptr(), out.data_ptr(),
        B, L, NH, KH, D, block_tables.shape[1], num_slots, page_size, float(scale),
        _DTYPE_CODES[q.dtype], _CACHE_CODES[k_cache_l.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if rc != 0:
        msg = "unsupported shape or dtype" if rc < 0 else err_str(rc).decode()
        raise RuntimeError(f"paged_attention kernel launch failed ({rc}): {msg}")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
