"""Int4 weight-only dequant-matmul (a tested building block, not wired into serving).

PyTorch port of `jacobiforcing_tpu/ops/pallas/int4_matmul.py`, which the JAX
package keeps as an experiment beside its int8 serving path.  It computes

    y[M, N] = (x[M, K] @ unpack(w_packed[K, N/2])) * scale[N]

with float32 accumulation and the output in `x.dtype`.  Packing: two int4
values per byte along the OUTPUT axis in a split-half layout: packed column j
holds output column j in the low nibble and column j + N/2 in the high nibble,
each stored as value + 8.

Two implementations:
  * `int4_matmul_ref`: unpack, then a plain product.  The plain version; runs
    on any device and is what CPU tensors take.
  * `ops/int4_matmul_cuda.int4_matmul_cuda`: the hand-written CUDA kernel
    (csrc/int4_matmul.cu).  CUDA tensors always take it, and an input it
    cannot serve raises instead of falling back.
"""

from __future__ import annotations

import torch


def pack_int4(w_q: torch.Tensor) -> torch.Tensor:
    """[..., K, N] int8 in [-8, 7] -> [..., K, N // 2] int8 (split-half nibbles)."""
    n = w_q.shape[-1]
    assert n % 2 == 0
    lo = (w_q[..., : n // 2].to(torch.int32) + 8) & 0xF
    hi = (w_q[..., n // 2 :].to(torch.int32) + 8) & 0xF
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4(w_packed: torch.Tensor) -> torch.Tensor:
    """[..., K, N // 2] int8 -> [..., K, N] int8 in [-8, 7]; inverse of `pack_int4`."""
    b = w_packed.view(torch.uint8).to(torch.int32)
    return torch.cat([(b & 0xF) - 8, ((b >> 4) & 0xF) - 8], dim=-1).to(torch.int8)


def int4_matmul_ref(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version: the weight is unpacked and cast to `x.dtype` (exact), the
    product accumulates in float32 (float64 for float64 inputs), the scale is
    applied there, and the result is cast to `x.dtype`."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    w = unpack_int4(w_packed).to(x.dtype)
    return ((x.to(acc) @ w.to(acc)) * scale.to(acc)[None, :]).to(x.dtype)


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [M, K], w_packed [K, N/2] int8 (`pack_int4` layout), scale [N] ->
    [M, N] in `x.dtype`.  CUDA tensors go to the kernel (which raises on what
    it cannot serve); CPU tensors go to the plain version."""
    if x.is_cuda:
        from jacobiforcing_tpu_torch.ops.int4_matmul_cuda import int4_matmul_cuda

        return int4_matmul_cuda(x, w_packed, scale)
    return int4_matmul_ref(x, w_packed, scale)
