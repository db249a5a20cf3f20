"""Wrappers of the hand-written CUDA training-attention kernels
(csrc/train_attention.cu): forward, dQ (with the delta pre-pass) and dK/dV.

Port of the TPU kernel `jacobiforcing_tpu/ops/pallas/train_attention.py::
splash_train_attention`, forward and backward; the plain version is
`ops/train_attention.train_attention_ref` under autograd.  `layout` is
`(prompt_len, T_pairs, seq_len, N, variant, window_size)`.  Each wrapper
checks device, dtype, shape and contiguity and raises on anything the kernels
do not take; it launches on PyTorch's current stream, does not synchronise,
and raises if the launch is refused.  Each counts its launches in
`.launches`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from jacobiforcing_tpu_torch.ops import _build
from jacobiforcing_tpu_torch.ops.paged_attention_cuda import _DTYPE_CODES, SUPPORTED_HEAD_DIMS
from jacobiforcing_tpu_torch.ops.train_attention import VARIANTS, TileMap, classify_tiles

_FNS = None


def _kernels():
    global _FNS
    if _FNS is None:
        lib = _build.load("train_attention")
        tail = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
        fns = {}
        for name, n_ptr in (("fwd", 7), ("dq", 10), ("dkdv", 10)):
            fn = getattr(lib, f"jf_train_attention_{name}")
            fn.argtypes = [ctypes.c_void_p] * n_ptr + tail
            fn.restype = ctypes.c_int
            fns[name] = fn
        lib.jf_error_string.argtypes = [ctypes.c_int]
        lib.jf_error_string.restype = ctypes.c_char_p
        fns["error_string"] = lib.jf_error_string
        _FNS = fns
    return _FNS


def check_inputs(q, k, v, layout, others=()) -> None:
    """Raise ValueError for anything the kernels do not take.  `others` are
    (name, tensor, shape, dtype) of the further tensors of a backward call."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("expected q [L, NH, D] and k, v [L, KH, D]")
    L, NH, D = q.shape
    KH = k.shape[1]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"q dtype {q.dtype} not supported (float32 or bfloat16)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("the k and v dtype must equal the query dtype")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim must be one of {SUPPORTED_HEAD_DIMS}, got {D}")
    if tuple(k.shape) != (L, KH, D) or tuple(v.shape) != (L, KH, D):
        raise ValueError("k and v must be [L, KH, D] with q's L and D")
    if KH == 0 or NH % KH != 0:
        raise ValueError(f"query heads {NH} must be a multiple of KV heads {KH}")
    prompt_len, T, seq_len, N, variant, window = layout
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    if min(prompt_len, T, seq_len) < 0 or seq_len > L or N <= 0 or window <= 0:
        raise ValueError(f"layout {layout} does not fit a row of {L} tokens")
    tensors = [("q", q, q.shape, q.dtype), ("k", k, k.shape, q.dtype), ("v", v, v.shape, q.dtype),
               *others]
    for name, t, shape, dtype in tensors:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise ValueError(f"{name} must be {tuple(shape)} {dtype}, got {tuple(t.shape)} "
                             f"{t.dtype}")
        if not (t.is_cuda and t.device == q.device):
            raise ValueError("all inputs must be CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the kernels load 16 B)")


def _tiles(q, k, layout) -> TileMap:
    prompt_len, T, seq_len, N, variant, window = layout
    return classify_tiles(q.shape[0], prompt_len, T, seq_len, N, variant, window,
                          groups=q.shape[1] // k.shape[1])


def _call(name: str, pointers, q, k, layout) -> None:
    fns = _kernels()
    prompt_len, T, seq_len, N, variant, window = layout
    L, NH, D = q.shape
    lay = (ctypes.c_int * 6)(prompt_len, T, seq_len, N, VARIANTS.index(variant), window)
    rc = fns[name](*pointers, L, NH, k.shape[1], D, lay, 1.0 / math.sqrt(D),
                   _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = "unsupported shape, dtype or layout" if rc < 0 else fns["error_string"](rc).decode()
        raise RuntimeError(f"train_attention {name} kernel launch failed ({rc}): {msg}")


def train_attention_fwd_cuda(q, k, v, layout) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [L, NH, D], lse [L, NH] float32: the row log-sum-exp of the scaled
    scores, 0 for a row that sees nothing)."""
    check_inputs(q, k, v, layout)
    q_ptr, q_ent, _, _ = _tiles(q, k, layout).device_lists(q.device)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _call("fwd", [t.data_ptr() for t in (q, k, v, q_ptr, q_ent, out, lse)], q, k, layout)
    train_attention_fwd_cuda.launches += 1
    return out, lse


def train_attention_dq_cuda(q, k, v, out, lse, dout, layout) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dq [L, NH, D], delta [L, NH] float32 = rowsum(dout * out), taken by a
    small kernel that this call launches first and the dK/dV call reads)."""
    check_inputs(q, k, v, layout, [("out", out, q.shape, q.dtype),
                                   ("dout", dout, q.shape, q.dtype),
                                   ("lse", lse, q.shape[:2], torch.float32)])
    q_ptr, q_ent, _, _ = _tiles(q, k, layout).device_lists(q.device)
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    _call("dq", [t.data_ptr() for t in (q, k, v, out, dout, lse, q_ptr, q_ent, dq, delta)],
          q, k, layout)
    train_attention_dq_cuda.launches += 1
    return dq, delta


def train_attention_dkdv_cuda(q, k, v, lse, delta, dout, layout
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [L, KH, D], summed over the query heads of each KV head."""
    check_inputs(q, k, v, layout, [("dout", dout, q.shape, q.dtype),
                                   ("lse", lse, q.shape[:2], torch.float32),
                                   ("delta", delta, q.shape[:2], torch.float32)])
    _, _, k_ptr, k_ent = _tiles(q, k, layout).device_lists(q.device)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _call("dkdv", [t.data_ptr() for t in (q, k, v, dout, lse, delta, k_ptr, k_ent, dk, dv)],
          q, k, layout)
    train_attention_dkdv_cuda.launches += 1
    return dk, dv


train_attention_fwd_cuda.launches = 0
train_attention_dq_cuda.launches = 0
train_attention_dkdv_cuda.launches = 0
