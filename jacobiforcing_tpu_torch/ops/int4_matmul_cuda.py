"""Wrapper of the hand-written CUDA int4 dequant-matmul kernel (csrc/int4_matmul.cu).

Port of the TPU kernel `jacobiforcing_tpu/ops/pallas/int4_matmul.py::
int4_matmul`; same arguments as `ops/int4_matmul.int4_matmul_ref`, which is
its plain version.  The wrapper checks device, dtype, shape and contiguity and
raises on anything the kernel does not take; it launches on PyTorch's current
stream, does not synchronise, and raises if the launch is refused.
`int4_matmul_cuda.launches` counts its launches.

The kernel needs N/2 (the packed width) to be a multiple of 16: it loads the
packed weight 16 bytes at a time.  M and K are free.
"""

from __future__ import annotations

import ctypes

import torch

from jacobiforcing_tpu_torch.ops import _build

PACKED_ALIGN = 16  # bytes per weight load: N/2 must be a multiple
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


def _kernel():
    global _FN
    if _FN is None:
        lib = _build.load("int4_matmul")
        fn = lib.jf_int4_matmul
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.jf_error_string.argtypes = [ctypes.c_int]
        lib.jf_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.jf_error_string)
    return _FN


def check_inputs(x, w_packed, scale):
    """Raise ValueError for anything the kernel does not take."""
    if x.dim() != 2 or w_packed.dim() != 2 or scale.dim() != 1:
        raise ValueError("expected x [M, K], w_packed [K, N/2] and scale [N]")
    M, K = x.shape
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x dtype {x.dtype} not supported (float32 or bfloat16)")
    if w_packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError("w_packed must be int8 and scale float32")
    if w_packed.shape[0] != K or scale.shape[0] != 2 * w_packed.shape[1]:
        raise ValueError("w_packed must be [K, N/2] and scale [N] for x [M, K]")
    if M == 0 or K == 0 or w_packed.shape[1] % PACKED_ALIGN:
        raise ValueError(f"M and K must be positive and N/2 = {w_packed.shape[1]} a multiple "
                         f"of {PACKED_ALIGN} (the kernel loads the packed weight 16 B at a time)")
    tensors = (x, w_packed, scale)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("all inputs must be CUDA tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if w_packed.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("w_packed and scale must start on a 16-byte boundary (the kernel "
                         "loads 16 B)")


def int4_matmul_cuda(
    x: torch.Tensor,  # [M, K] float32 or bfloat16
    w_packed: torch.Tensor,  # [K, N/2] int8 (pack_int4 layout)
    scale: torch.Tensor,  # [N] float32 per-output-channel scale
) -> torch.Tensor:
    check_inputs(x, w_packed, scale)
    fn, err_str = _kernel()
    M, K = x.shape
    N = scale.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    rc = fn(x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), out.data_ptr(), M, K, N,
            _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = "unsupported shape or dtype" if rc < 0 else err_str(rc).decode()
        raise RuntimeError(f"int4_matmul kernel launch failed ({rc}): {msg}")
    int4_matmul_cuda.launches += 1
    return out


int4_matmul_cuda.launches = 0
