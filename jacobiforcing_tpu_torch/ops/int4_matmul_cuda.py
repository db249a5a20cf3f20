"""Wrapper of the hand-written CUDA int4 dequant-matmul kernels (csrc/int4_matmul.cu).

Port of the TPU kernel `jacobiforcing_tpu/ops/pallas/int4_matmul.py::
int4_matmul`; same arguments as `ops/int4_matmul.int4_matmul_ref`, which is
its plain version.  bfloat16 x takes the tensor-core kernel (the weights
dequantized into wgmma's register operand, K cut into chunks by `chunk_plan`,
spread over CTAs at small M as `plan` says); float32 x the exact fp32 kernel.
The wrapper checks device, dtype, shape and contiguity and raises on anything
the kernels do not take; it launches on PyTorch's current stream, does not
synchronise, and raises if the launch is refused.  `int4_matmul_cuda.launches`
counts its calls (one per call, the bf16 split route's reduce kernel
included).

The kernels need N/2 (the packed width) to be a multiple of 16: they copy the
packed weight 16 bytes at a time.  M and K are free.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from jacobiforcing_tpu_torch.ops import _build

PACKED_ALIGN = 16  # bytes per weight copy: N/2 must be a multiple
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FN = None

# The bf16 tensor-core kernel's tiling (csrc/int4_matmul.cu): K in stages of
# 64; per CTA, by the x rows per wgmma, 32 packed columns (32 low channels and
# their 32 high partners) at n8 and 128 at n128.  The chunk plan counts
# channel tiles of TILE_P packed columns whatever the route.
TILE_P = 32
STAGE_K = 64
CTA_COLUMNS = {8: 32, 128: 128}
# K chunks: about SPREAD_CTAS CTAs over the channel tiles (four per SM of the
# H100's 132), at least MIN_CHUNK_STAGES stages per chunk.
SPREAD_CTAS = 528
MIN_CHUNK_STAGES = 2
# The split route (one CTA per chunk, fp32 partials, a reduce kernel) is taken
# while the unsplit grid holds fewer than SPREAD_CTAS CTAs and the partials
# (written and read once) fit in SPLIT_SCRATCH_BYTES: an unsplit grid of a
# few dozen CTAs walking all of K costs more than that traffic.
SPLIT_SCRATCH_BYTES = 64 << 20


def chunk_plan(K: int, N: int) -> Tuple[int, int]:
    """(chunk, n_chunks): K cut into n_chunks chunks [i * chunk, min((i + 1) *
    chunk, K)), chunk a multiple of STAGE_K.  It depends on (K, N) only, so a
    row's sum (each chunk from zero, the chunks added in ascending order) does
    not depend on M."""
    stages = -(-K // STAGE_K)
    c_tiles = -(-(N // 2) // TILE_P)
    per = max(MIN_CHUNK_STAGES, -(-stages // -(-SPREAD_CTAS // c_tiles)))
    per = min(per, stages)
    return per * STAGE_K, -(-stages // per)


def plan(M: int, K: int, N: int) -> Tuple[int, int, int, bool]:
    """(bn, chunk, n_chunks, split) of a bf16 call: bn x rows per wgmma (8 at
    M <= 8, else 128); split: one CTA per chunk, its fp32 partial to a scratch
    buffer, summed in chunk order by a second kernel (small M), else one CTA
    walks all chunks and adds them in registers.  Either way the same
    additions in the same order."""
    bn = 8 if M <= 8 else 128
    chunk, n_chunks = chunk_plan(K, N)
    ctas = -(-M // bn) * -(-(N // 2) // CTA_COLUMNS[bn])
    split = n_chunks > 1 and ctas < SPREAD_CTAS and n_chunks * M * N * 4 <= SPLIT_SCRATCH_BYTES
    return bn, chunk, n_chunks, split


def _lib():
    global _FN
    if _FN is None:
        lib = _build.load("int4_matmul")
        fn = lib.jf_int4_matmul
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.jf_error_string.argtypes = [ctypes.c_int]
        lib.jf_error_string.restype = ctypes.c_char_p
        lib.jf_int4_matmul_attrs.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.jf_int4_matmul_attrs.restype = ctypes.c_int
        _FN = (fn, lib.jf_error_string, lib.jf_int4_matmul_attrs)
    return _FN


_VARIANTS = (("fp32", "float32"), ("tc_n8", "bfloat16"), ("tc_n128", "bfloat16"),
             ("reduce", "bfloat16"))
_ATTR_FIELDS = ("tensor_cores", "registers", "local_bytes", "static_smem", "dynamic_smem",
                "threads", "rows_n", "stages")


def variants():
    """One dict per kernel of csrc/int4_matmul.cu (the fp32 kernel, the
    tensor-core kernel at 8 and 128 x rows per instruction, the split route's
    reduce kernel): tensor cores or not, registers, local (stack or spilled)
    bytes per thread, static and dynamic shared memory, threads per CTA, x
    rows per instruction and stages.  Needs the card."""
    fn = _lib()[2]
    rows = []
    for which, (name, dtype) in enumerate(_VARIANTS):
        buf = (ctypes.c_int * len(_ATTR_FIELDS))()
        rc = fn(which, buf)
        if rc != 0:
            raise RuntimeError(f"jf_int4_matmul_attrs({name}) failed ({rc})")
        rows.append(dict(kernel=name, dtype=dtype, **dict(zip(_ATTR_FIELDS, buf))))
    return rows


def check_inputs(x, w_packed, scale):
    """Raise ValueError for anything the kernels do not take."""
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
                         f"of {PACKED_ALIGN} (the kernels copy the packed weight 16 B at a time)")
    tensors = (x, w_packed, scale)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("all inputs must be CUDA tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")
    if w_packed.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("w_packed and scale must start on a 16-byte boundary (the kernels "
                         "copy 16 B)")


def int4_matmul_cuda(
    x: torch.Tensor,  # [M, K] float32 or bfloat16
    w_packed: torch.Tensor,  # [K, N/2] int8 (pack_int4 layout)
    scale: torch.Tensor,  # [N] float32 per-output-channel scale
) -> torch.Tensor:
    check_inputs(x, w_packed, scale)
    fn, err_str, _ = _lib()
    M, K = x.shape
    N = scale.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    bn, chunk, n_chunks, split = plan(M, K, N)
    partial = (torch.empty((n_chunks, M, N), dtype=torch.float32, device=x.device)
               if x.dtype == torch.bfloat16 and split else None)
    rc = fn(x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(), M, K, N, _DTYPE_CODES[x.dtype],
            bn, chunk, int(split), torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        msg = "unsupported shape or dtype" if rc < 0 else err_str(rc).decode()
        raise RuntimeError(f"int4_matmul kernel launch failed ({rc}): {msg}")
    int4_matmul_cuda.launches += 1
    return out


int4_matmul_cuda.launches = 0
