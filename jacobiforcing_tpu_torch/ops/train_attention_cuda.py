"""Wrappers of the hand-written CUDA training-attention kernels
(csrc/train_attention.cu): forward, dQ (with delta) and dK/dV.

Port of the TPU kernel `jacobiforcing_tpu/ops/pallas/train_attention.py::
splash_train_attention`, forward and backward; the plain version is
`ops/train_attention.train_attention_ref` under autograd.  float32 inputs take
the fp32 CUDA-core kernels (32-key tiles; dQ takes sigma = sum_j P and delta
= sum_j (P / sigma) dP in a first sweep over the keys, and both backward
kernels use P / sigma); bfloat16
inputs take the tensor-core kernels (64-key tiles, `train_fwd_tc_kernel`,
`train_dq_tc_kernel` with delta folded in, `train_dkdv_tc_kernel` +
`train_dkdv_reduce_kernel`); the bf16 forward also writes `out_lo`, the
residual of `out`'s rounding to bf16, from which dQ takes delta =
rowsum(dO * O) at float32 precision.  `layout` is
`(prompt_len, T_pairs, seq_len, N, variant, window_size)`.  Each wrapper
checks device, dtype, shape and contiguity and raises on anything the kernels
do not take; it launches on PyTorch's current stream, does not synchronise,
and raises if the launch is refused.  Each counts its launches in
`.launches`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from jacobiforcing_tpu_torch.ops import _build
from jacobiforcing_tpu_torch.ops.paged_attention_cuda import (
    _ATTR_FIELDS, _DTYPE_CODES, SUPPORTED_HEAD_DIMS)
from jacobiforcing_tpu_torch.ops.train_attention import (
    KEY_TILE, TC_KEY_TILE, VARIANTS, TileMap, classify_tiles)

_FNS = None
# which kernel of the C interface: forward, dQ (with delta), dK/dV and the
# bf16 dK/dV's partial-sum kernel
_WHICH = ("fwd", "dq", "dkdv", "dkdv_reduce")


def _kernels():
    global _FNS
    if _FNS is None:
        lib = _build.load("train_attention")
        tail = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
        fns = {}
        # dkdv: 13 pointers, then the chunk and reduce counts
        for name, head in (("fwd", [ctypes.c_void_p] * 9), ("dq", [ctypes.c_void_p] * 12),
                           ("dkdv", [ctypes.c_void_p] * 13 + [ctypes.c_int] * 2)):
            fn = getattr(lib, f"jf_train_attention_{name}")
            fn.argtypes = head + tail
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


def variants():
    """One dict per built (kernel, dtype, D) variant of csrc/train_attention.cu:
    which tile it runs (tensor cores or the fp32 CUDA-core tile), its
    registers, local (stack or spilled) bytes per thread, static and dynamic
    shared memory, threads per CTA, keys per tile and stages.  Needs the
    card."""
    lib = _build.load("train_attention")
    fn = lib.jf_train_attention_attrs
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rows = []
    for which, name in enumerate(_WHICH):
        for dtype, code in _DTYPE_CODES.items():
            for D in SUPPORTED_HEAD_DIMS:
                buf = (ctypes.c_int * len(_ATTR_FIELDS))()
                rc = fn(which, code, D, buf)
                if rc == -1:  # not a kernel of this dtype (the f32 reduce)
                    continue
                if rc != 0:
                    raise RuntimeError(f"jf_train_attention_attrs({name}, {dtype}, {D}) failed "
                                       f"({rc})")
                rows.append(dict(kernel=name, dtype=str(dtype).replace("torch.", ""), D=D,
                                 **dict(zip(_ATTR_FIELDS, buf))))
    return rows


def _tiles(q, k, layout, key_tile=KEY_TILE) -> TileMap:
    prompt_len, T, seq_len, N, variant, window = layout
    return classify_tiles(q.shape[0], prompt_len, T, seq_len, N, variant, window,
                          groups=q.shape[1] // k.shape[1], key_tile=key_tile)


def _tc(q) -> bool:
    """bf16 inputs run the tensor-core kernels on 64-key tiles."""
    return q.dtype == torch.bfloat16


def _delta_shape(q):
    """What dQ hands dK/dV: bf16 delta [L, NH]; f32 delta and sigma [2, L, NH]."""
    return tuple(q.shape[:2]) if _tc(q) else (2,) + tuple(q.shape[:2])


def _query_lists(q, k, layout):
    """The forward's and dQ's list pointers: bf16, one CTA per pair of query
    tiles over 64-key tiles, launched longest list first (pair_ptr, pair_ent,
    pair_order); f32, one CTA per query tile over 32-key tiles (q_ptr, q_ent,
    no order)."""
    if _tc(q):
        lists = _tiles(q, k, layout, TC_KEY_TILE).device_lists(q.device)
        return [lists[n].data_ptr() for n in ("pair_ptr", "pair_ent", "pair_order")]
    lists = _tiles(q, k, layout).device_lists(q.device)
    return [lists["q_ptr"].data_ptr(), lists["q_ent"].data_ptr(), None]


def _call(name: str, args, q, k, layout) -> None:
    fns = _kernels()
    prompt_len, T, seq_len, N, variant, window = layout
    L, NH, D = q.shape
    lay = (ctypes.c_int * 6)(prompt_len, T, seq_len, N, VARIANTS.index(variant), window)
    rc = fns[name](*args, L, NH, k.shape[1], D, lay, 1.0 / math.sqrt(D),
                   _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        msg = "unsupported shape, dtype or layout" if rc < 0 else fns["error_string"](rc).decode()
        raise RuntimeError(f"train_attention {name} kernel launch failed ({rc}): {msg}")


def train_attention_fwd_cuda(q, k, v, layout
                             ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(out [L, NH, D], lse [L, NH] float32: the row log-sum-exp of the scaled
    scores, 0 for a row that sees nothing, out_lo): bf16, out_lo [L, NH, D] =
    bf16(O - out), the rounding residual of the float32 O, which dQ reads;
    f32, None."""
    check_inputs(q, k, v, layout)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    out_lo = torch.empty_like(q) if _tc(q) else None
    _call("fwd", [t.data_ptr() for t in (q, k, v)] + _query_lists(q, k, layout)
          + [out.data_ptr(), lse.data_ptr(), None if out_lo is None else out_lo.data_ptr()],
          q, k, layout)
    train_attention_fwd_cuda.launches += 1
    return out, lse, out_lo


def train_attention_dq_cuda(q, k, v, out, lse, dout, layout, out_lo=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dq [L, NH, D], delta float32, which the dK/dV call reads).  bf16:
    delta [L, NH], taken by the one kernel over the forward's pair lists as
    rowsum(dout * (out + out_lo)) (out_lo is the forward's third output,
    which it needs); f32: delta [2, L, NH], the fp32 dQ kernel's first sweep
    over the keys: sigma = sum_j P of the recomputed P and delta = sum_j (P /
    sigma) dP, then sigma (both backward kernels use P / sigma, so that
    sum_j dS is zero to rounding, as in autograd's softmax backward; out is
    checked but not read, out_lo None)."""
    others = [("out", out, q.shape, q.dtype), ("dout", dout, q.shape, q.dtype),
              ("lse", lse, q.shape[:2], torch.float32)]
    if _tc(q):
        if out_lo is None:
            raise ValueError("the bf16 dQ needs out_lo, the forward's residual of out")
        others.append(("out_lo", out_lo, q.shape, q.dtype))
    elif out_lo is not None:
        raise ValueError("out_lo is the bf16 forward's; the f32 dQ takes none")
    check_inputs(q, k, v, layout, others)
    dq = torch.empty_like(q)
    delta = torch.empty(_delta_shape(q), dtype=torch.float32, device=q.device)
    _call("dq", [t.data_ptr() for t in (q, k, v, out)]
          + [None if out_lo is None else out_lo.data_ptr()]
          + [t.data_ptr() for t in (dout, lse)] + _query_lists(q, k, layout)
          + [dq.data_ptr(), delta.data_ptr()], q, k, layout)
    train_attention_dq_cuda.launches += 1
    return dq, delta


def train_attention_dkdv_cuda(q, k, v, lse, delta, dout, layout
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [L, KH, D], summed over the query heads of each KV head.  bf16:
    one CTA per (chunk of a 64-key tile's query tiles, KV head); a key tile
    cut into several chunks sums their float32 partials, kept in a scratch
    buffer of this call, in chunk order."""
    check_inputs(q, k, v, layout, [("dout", dout, q.shape, q.dtype),
                                   ("lse", lse, q.shape[:2], torch.float32),
                                   ("delta", delta, _delta_shape(q), torch.float32)])
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    ptrs = [t.data_ptr() for t in (q, k, v, dout, lse, delta)]
    if _tc(q):
        tm = _tiles(q, k, layout, TC_KEY_TILE)
        lists = tm.device_lists(q.device)
        # [slot][dK, dV][KH][64 keys][D] float32, every element written by its chunk
        partial = torch.empty((max(tm.n_slots, 1), 2, k.shape[1], TC_KEY_TILE, q.shape[2]),
                              dtype=torch.float32, device=q.device)
        ptrs += [None] + [t.data_ptr() for t in (lists["k_ent"], lists["chunks"], lists["reduce"],
                                                 partial)]
        counts = [len(tm.chunks), len(tm.reduce)]
    else:
        lists = _tiles(q, k, layout).device_lists(q.device)
        ptrs += [lists["k_ptr"].data_ptr(), lists["k_ent"].data_ptr(), None, None, None]
        counts = [0, 0]
    _call("dkdv", ptrs + [dk.data_ptr(), dv.data_ptr()] + counts, q, k, layout)
    train_attention_dkdv_cuda.launches += 1
    return dk, dv


train_attention_fwd_cuda.launches = 0
train_attention_dq_cuda.launches = 0
train_attention_dkdv_cuda.launches = 0
