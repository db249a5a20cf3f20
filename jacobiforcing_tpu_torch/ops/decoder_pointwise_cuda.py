"""Wrappers of the decoder layer's fused pointwise kernels (csrc/decoder_pointwise.cu).

No TPU kernel is ported here: XLA fused these chains on the TPU.  Each
wrapper computes one chain of `models/qwen.py` in one pass over bfloat16
tensors on the card:

  * `add_rms_norm_cuda(x, w, eps, delta)`: (x + delta, rms_norm(x + delta, w,
    eps)); without `delta`, (x, rms_norm(x, w, eps));
  * `qkv_rope_cuda(q, k, v, cos, sin, ...)`: the q/k/v bias (Qwen2), the
    per-head q/k RMSNorm (Qwen3) and `apply_rope` on q and k;
  * `silu_mul_cuda(g, u)`: `F.silu(g.float()).to(bf16) * u`.

The plain versions are the functions of `models/qwen.py`, which choose
between the two (`models.qwen.add_rms_norm`, `_bias_norm_rope`, `silu_mul`)
by device, dtype and autograd alone.  Each wrapper checks device,
dtype, shape, contiguity and 16-byte alignment and raises ValueError on
what its kernel does not take; it allocates its outputs with `torch.empty`, launches
on PyTorch's current stream, does not synchronise, raises if the launch is
refused, and counts its launches in `.launches`, so a launch can be
captured into a CUDA graph.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from jacobiforcing_tpu_torch.ops import _build

SUPPORTED_HEAD_DIMS = (64, 128)
MAX_HIDDEN = 16384  # 512 threads x 4 vectors of 8 per row
_FN = None


def _lib():
    global _FN
    if _FN is None:
        lib = _build.load("decoder_pointwise")
        lib.jf_add_rms_norm.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.jf_qkv_rope.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        lib.jf_silu_mul.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]
        for fn in (lib.jf_add_rms_norm, lib.jf_qkv_rope, lib.jf_silu_mul):
            fn.restype = ctypes.c_int
        lib.jf_error_string.argtypes = [ctypes.c_int]
        lib.jf_error_string.restype = ctypes.c_char_p
        _FN = lib
    return _FN


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        msg = "unsupported shape" if rc < 0 else _lib().jf_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed ({rc}): {msg}")


def _tensor_refusal(*tensors: torch.Tensor, dtype=torch.bfloat16) -> Optional[str]:
    """Why the kernels cannot take these tensors, or None."""
    first = tensors[0]
    if not all(t.is_cuda and t.device == first.device for t in tensors):
        return "all inputs must be CUDA tensors on one device"
    if not all(t.dtype == dtype for t in tensors):
        return f"all inputs must be {dtype}"
    if not all(t.is_contiguous() for t in tensors):
        return "all inputs must be contiguous"
    if any(t.data_ptr() % 16 for t in tensors):
        return "all inputs must start on a 16-byte boundary (the kernels load 16 B)"
    return None


def _add_rms_norm_refusal(x, w, delta=None) -> Optional[str]:
    """Why `add_rms_norm_cuda` cannot take these inputs, or None."""
    if x.dim() < 1 or x.numel() == 0 or tuple(w.shape) != (x.shape[-1],):
        return "expected x [..., H] with rows and w [H]"
    H = x.shape[-1]
    if delta is not None and delta.shape != x.shape:
        return "delta must have x's shape"
    if H % 8 or H > MAX_HIDDEN:
        return f"H = {H} must be a multiple of 8 and at most {MAX_HIDDEN}"
    return _tensor_refusal(x, w, *(() if delta is None else (delta,)))


def add_rms_norm_cuda(x: torch.Tensor, w: torch.Tensor, eps: float,
                      delta: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(s, rms_norm(s, w, eps)) with s = x + delta rounded to bf16 (s = x
    without `delta`): the residual add folded into the norm that reads it."""
    why = _add_rms_norm_refusal(x, w, delta)
    if why is not None:
        raise ValueError(why)
    H = x.shape[-1]
    s = x if delta is None else torch.empty_like(x)
    out = torch.empty_like(x)
    rc = _lib().jf_add_rms_norm(x.data_ptr(), _ptr(delta), w.data_ptr(),
                                None if delta is None else s.data_ptr(), out.data_ptr(),
                                x.numel() // H, H, float(eps), _stream(x))
    _raise_on(rc, "add_rms_norm")
    add_rms_norm_cuda.launches += 1
    return s, out


def _qkv_rope_refusal(q, k, v, cos, sin, bq=None, bk=None, bv=None, q_norm=None,
                     k_norm=None) -> Optional[str]:
    """Why `qkv_rope_cuda` cannot take these inputs, or None."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        return "expected q [B, T, NH, D] and k / v [B, T, KH, D]"
    B, T, NH, D = q.shape
    if D not in SUPPORTED_HEAD_DIMS or k.shape[:2] != (B, T) or k.shape[3] != D:
        return f"head_dim must be one of {SUPPORTED_HEAD_DIMS} for q, k and v"
    if B * T == 0 or cos.shape != (B, T, D // 2) or sin.shape != cos.shape:
        return "cos / sin must be [B, T, D / 2] for a non-empty q"
    biases = (bq, bk, bv)
    if any(b is None for b in biases) != all(b is None for b in biases):
        return "bq, bk and bv come together"
    if (q_norm is None) != (k_norm is None):
        return "q_norm and k_norm come together"
    KH = k.shape[2]
    if bq is not None and (bq.shape != (NH * D,) or bk.shape != (KH * D,) or bv.shape != bk.shape):
        return "bq must be [NH * D] and bk / bv [KH * D]"
    if q_norm is not None and (q_norm.shape != (D,) or k_norm.shape != (D,)):
        return "q_norm / k_norm must be [D]"
    extra = tuple(t for t in (*biases, q_norm, k_norm) if t is not None)
    return (_tensor_refusal(q, k, v, *extra)
            or _tensor_refusal(cos, sin, dtype=torch.float32))


def qkv_rope_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cos: torch.Tensor,
                  sin: torch.Tensor, eps: float, *, bq=None, bk=None, bv=None, q_norm=None,
                  k_norm=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(q, k, v) after the bias (q/k/v, optional), the per-head q/k RMSNorm
    (optional) and rotate-half RoPE of q and k at cos / sin [B, T, D / 2];
    q [B, T, NH, D], k / v [B, T, KH, D].  Without a bias `v` is returned
    as it is."""
    why = _qkv_rope_refusal(q, k, v, cos, sin, bq, bk, bv, q_norm, k_norm)
    if why is not None:
        raise ValueError(why)
    B, T, NH, D = q.shape
    qo, ko = torch.empty_like(q), torch.empty_like(k)
    vo = v if bv is None else torch.empty_like(v)
    rc = _lib().jf_qkv_rope(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bq), _ptr(bk), _ptr(bv), _ptr(q_norm),
        _ptr(k_norm), cos.data_ptr(), sin.data_ptr(), qo.data_ptr(), ko.data_ptr(),
        None if bv is None else vo.data_ptr(), B * T, NH, k.shape[2], D, float(eps),
        _stream(q))
    _raise_on(rc, "qkv_rope")
    qkv_rope_cuda.launches += 1
    return qo, ko, vo


def _silu_mul_refusal(g, u) -> Optional[str]:
    """Why `silu_mul_cuda` cannot take these inputs, or None."""
    if g.shape != u.shape or g.numel() == 0 or g.shape[-1] % 8:
        return "g and u must have one non-empty shape whose last width is a multiple of 8"
    return _tensor_refusal(g, u)


def silu_mul_cuda(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """bf16(bf16(silu(float(g))) * u), the MLP's gate times its up projection."""
    why = _silu_mul_refusal(g, u)
    if why is not None:
        raise ValueError(why)
    out = torch.empty_like(g)
    rc = _lib().jf_silu_mul(g.data_ptr(), u.data_ptr(), out.data_ptr(), g.numel(), _stream(g))
    _raise_on(rc, "silu_mul")
    silu_mul_cuda.launches += 1
    return out


add_rms_norm_cuda.launches = 0
qkv_rope_cuda.launches = 0
silu_mul_cuda.launches = 0
