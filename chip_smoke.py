#!/usr/bin/env python3
"""Drive the PyTorch port (`jacobiforcing_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

    python3 chip_smoke.py kernel,train_kernel   # the kernels against their plain versions only
    python3 chip_smoke.py int4                  # the int4 kernels and their path alone
    python3 chip_smoke.py paged_cells:build/parent  # kernel 1 at the cells' shapes, bitwise
                                                    # and timed against that tree's build
    python3 chip_smoke.py pointwise             # the decoder's fused pointwise kernels alone
    python3 chip_smoke.py apps                  # the chat / grid / demo-trainer / legacy apps
    python3 chip_smoke.py train_mesh            # DP / fsdp and TP training, two ranks

    # the same phases from a parent tree (P) and this one (C) in turns, P C C P,
    # on one card: training kernel times, steps/s and step profiles side by side
    python3 chip_smoke.py compare build/parent train_kernel,train
    # kernel 3's f32 times alone (`train_f32_time` uses only the wrappers, so
    # this script copied into a parent tree times that tree's kernels)
    python3 chip_smoke.py compare build/parent train_f32_time

Phases (each prints its lines; any failure exits non-zero and prints no
result line):
  1. the card's name and power limit; build the CUDA kernels (one nvcc per
     source, started together).
  2. `kernel`: a `[kernel-design]` line per serving kernel (which variants
     run the tensor-core tile, which the fp32 tile; registers, local bytes
     and shared memory of each).  Each serving kernel against its plain
     PyTorch version, f32 and
     bf16, at the demo (D=64, KH=2, G=2) and Qwen2.5-7B (D=128, KH=4, G=7) head
     shapes, with shuffled page tables, ragged lengths and -1 padding rows
     (tolerances in `check`).  The paged-attention kernel: the bitwise
     AR-row == Jacobi-row check over every cache kind (bf16 runs the
     warp-specialised design, fp8 / int8 the cp.async tile); times at the
     Jacobi-block (B=4, L=64), AR-decode (B=4, L=1) and prefill shapes; at
     the benchmark cells' shapes (`PAGED_CELL_SHAPES`: cell 1's trip, cell
     2's trip and prefill, and those three) against the plain version and
     timed in a CUDA graph with the inputs rotating past the L2, beside the
     bound (`[kernel-cells]`; `paged_cells:TREE` also builds TREE's kernel 1,
     compares every output bit for bit and times both P C C P).  The
     speculative-attention kernel of the multiblock (MR) decoder: T in
     {N, 2N, 6N} in-flight tokens, committed lengths from 0 up, the decoder's
     tree mask with holes and a random mask; bitwise, the RA rows of a T=6N
     call == the rows of a T=N call and a row of a B=8 call == the same row
     at B=1; times at T = 64 / 128 / 384.  Every timed shape prints kernel,
     plain-version and SDPA times beside the bound and is held to `check`.
     Both kernels again on a narrow cache (fp8 e4m3, fp8 e5m2 and int8 with
     per-row scales, K/V magnitudes ~600): cases against the plain version,
     the same bitwise checks, bitwise equality of an in-flight
     fake-quantized block with its committed copy, and times with an e4m3
     and an e5m2 cache.  The int4
     dequant-matmul kernel against its plain version in f32 and bf16 at the
     JAX test's shape, ragged M and K and the four Qwen2.5-7B linear shapes
     at M = 4 / 256 / 1536 (tolerances in `check_int4`), its times beside the
     bound and a bf16 GEMM on the pre-dequantized weight, and its path: one
     decoder layer's seven linear layers through the dispatcher.  Kernels 1
     and 2 at the local heads of tensor parallelism (Qwen2.5-7B heads, KH 2
     at TP 2 and KH 1 at TP 4), f32 and bf16, against their plain versions,
     and their times at B 4 (`[tp-kernel-time]`).
  2b. `pointwise` (also part of `kernel`): the decoder layer's fused
     pointwise kernels (residual add + RMSNorm, bias / q/k norm + RoPE,
     SiLU times up) against their plain chains at the benchmark cells'
     shapes (silu_mul and bias + RoPE bit for bit, the norms within one
     bf16 ulp; a fault fails the phase), timed beside them and beside their
     least time by bytes (`[pointwise-time]`), the kernels one eager prefill
     layer launches, fused and plain (`[pointwise-launches]`), and one eager
     Jacobi forward's device time by kernel, fused and plain
     (`[pointwise-attribution]`).  `full` fails if a path of its bf16
     engines (and `full_quant`'s) launches none of them.
  3. `train_kernel`: a `[kernel-design]` line of the training kernels (bf16
     forward, dQ and dK/dV on tensor cores, every f32 kernel on the fp32
     tile; registers, local bytes, shared memory; it fails on local memory in
     a bf16 variant or a variant on the wrong tile).  The training-attention kernels
     (forward, dQ, dK/dV) against the plain version under autograd in float32: f32 and bf16, both
     head shapes, the three mask variants, rows shorter than their bucket, T
     below the pairs the row holds, prompt lengths off every tile edge, N
     16/32/64 (tolerances in `check` and `check_grad`); gradients bitwise equal
     across two runs; rows that see nothing zero.  Times at L 4096 and
     L 16384 (Qwen2.5-7B heads, bf16), each kernel beside its bound, the plain
     version and SDPA under a dense boolean mask, forward and backward; the
     f32 kernels' times at the demo's heads, L 1024 and 4096.
     `compare PARENT PHASES` runs the phases from a parent tree and this one
     in turns and prints their times, steps/s and step profiles side by side.
  4. `demo`: the trained demo checkpoint `assets/tpf_demo_n32_v7` in f32
     through `LLM` and the port's `bench_generate.run`: `ar`, `jacobi` and
     `mr` (auto-policy off, then on) on all 64 held-out prompts.  All token
     streams must be identical, 2033 tokens, 64/64 EOS, and with the policy
     off every MR tier (full / no-candidate / RA-only) must have run.  Then
     the same checkpoint served quantized (int8 weights, W8A8, an fp8 e4m3,
     an int8 and an fp8 e5m2 KV cache): inside each engine `jacobi` == `ar`
     == `mr`, counts printed beside the JAX package's CPU runs (e5m2's must
     equal its anchor, 2002 tokens, 64/64 EOS).
  5. `sampling`: the rejection-sampling and on-policy decoders on the demo
     checkpoint in f32: non-greedy top_k=1 == `ar` on the 64 prompts (2033
     tokens, 64/64 EOS); greedy on-policy collection of the 64 prompts
     (final sequences == `ar`, snapshots 32 long, rows == the JAX CPU
     anchor); non-greedy at temperature 0.7 through `bench_generate.run`
     beside the JAX CPU seed spread, >= 1 token per iteration, one seed one
     stream; the first-token TV of non-greedy against AR sampling at
     temperature 1.0; the W8A8 engine's non-greedy top_k=1 == its greedy
     stream; `apps/validate_learning` at its defaults.  Every run zeroes the
     kernel counts first and fails unless the paged kernel ran and no plain
     attention ran on CUDA.
  5b. `apps`: `chat_web.serve` on the demo with a byte-level tokenizer, 4
     POSTs to /generate over HTTP whose streamed tokens == blocking
     generation; `jacobi_stream_chat` streamed == blocking; `run_grid` over
     n {16, 32} x K {1, 2} x r {0.8} x pool {1, 4} (MR points launch kernel
     2) and `analyze_grid` on its CSV; `train_tpf_demo` at its default
     geometry cut to 2000 SFT steps and one round of two epochs, into a
     temporary directory: aggregate TPF >= 2 on its held-out prompts; the
     legacy CLLM step, 3 steps at the demo widths on the card == the host
     (f32 within 1e-5, f64 within 1e-9) and one step at Qwen2.5-7B widths,
     4 layers, bf16, with its peak memory.
  6. `full`: Qwen2.5-7B widths with random bf16 weights, 4 requests of
     256-1024 random prompt tokens through `LLM.generate`: prefill, AR,
     Jacobi, MR (policy off), non-greedy at temperature 0.7 (the
     memory-light verify, then top_k=50) and on-policy rollouts at 0.7.
     Each kernel's launch count is zeroed before each path and must grow in
     the paths that run it; the JSON line reports the Jacobi run's count for
     the paged kernel and the MR run's for the speculative one.
  7. `engine`: the serving host path.  The demo checkpoint in f32 on the
     default engine (one-chunk-lag pipeline, CUDA graphs): `ar`, `jacobi`
     and `mr` (policy on), 2033 tokens, 64/64 EOS, Jacobi TPF in [4.55,
     4.85], beside the eager synchronous engine's `jacobi`.  Qwen2.5-7B
     widths, bf16, 4 requests, block 64, 128 new tokens on three engines
     (eager-sync, graph-sync, graph-async): `ar` and `jacobi` token match
     against the eager engine (must be 1.0) with equal loop trips,
     iterations/s in turns, the device's busy share (profiler records; CUDA
     events around each graph replay), graphs captured, pool memory and
     capture time per bucket.  `apps/bench_engine.run_engine_bench` at 7B
     widths (Jacobi, B 8, prompt 512, 128 new tokens, chunk_iters 8, 16
     requests) on the three engines with random bf16 weights, and on
     graph-async with the app's W8A8 model and an fp8 KV cache; each
     result a JSON line.  Every earlier phase also serves through the
     default engine.  The Python and the native block manager in turns (P N
     N P) on the demo's 64 prompts in one `generate`: tokens and every
     allocate / grow / free call's page table equal, iterations/s, wall and
     block-manager ms per engine step.
  8. `full_quant`: Qwen2.5-7B widths, the `full` phase's bf16 weights with
     an fp8 e5m2 KV cache under `jacobi` and `mr`; then random int8 weights
     (`init_quantized_params`), the same 4 requests: W8A8 with an fp8 KV cache
     under `ar`, `jacobi` and `mr`, then weight-only int8 with an int8 KV
     cache under `jacobi`; launch counts as in `full`, tok/s, iterations/s,
     peak memory, and the device-time split of a profiled run.
  9. `tp`: tensor-parallel serving at TP 2 on this one card: two ranks
     spawned as processes of this script (`tp-rank`), joined over gloo and
     run eagerly (NCCL takes one rank per card, and a gloo group cannot be
     captured in a CUDA graph).  The demo checkpoint in f32 (1 KV head per
     rank): `ar` == `jacobi` == `mr` (policy off) on the 64 prompts, tokens
     and EOS beside 2033 / 64 and against TP 1 served here, MR tiers beside
     TP 1's; W8A8: `ar` == `jacobi`, tokens beside 2029.  Qwen2.5-7B widths,
     random bf16 weights drawn whole on each rank and handed to `LLM`, which
     cuts the rank's share (2 KV heads, 14 query heads per rank); the
     shares' dense forward within `TP_SHARD_TOL` of the full weights'; 4
     requests of 256-1024 prompt tokens, 32 new tokens: `ar`, `jacobi`
     (block 64), `mr` (N 64, K 2, policy off), tokens against TP 1 and AR
     against Jacobi as counts, iterations/s over gloo.
     Every path launches kernel 1 (and `mr` kernel 2) on every rank and no
     plain attention; the ranks' streams are identical.  With two cards or
     more the demo's `ar` and `jacobi` also run over NCCL with CUDA graphs.
 10. `train`: the consistency trainer through `train(TrainerArgs(...))` with
     `attn_impl="splash"`.  (a) the demo checkpoint's widths in f32 from random
     weights: rows from `synthesize_trajectories_masking` ->
     `pack_trajectories` -> `JacobianDataset`; the first step's losses and
     every gradient leaf against the same step through the dense-mask
     attention; the loss descends; `checkpoint-*` resume; the saved checkpoint
     served by `LLM` with `ar` == `jacobi`.  (b) Qwen2.5-7B widths, bf16, the
     `full` phase's weights, one packed row of 4096 tokens, `remat=True`,
     three optimizer steps, then two more under torch.profiler: steps/s,
     tokens/s, peak memory, launches of each kernel per step, device idle
     share of one step, finite losses and gradient norm.
 11. `train_mesh`: training over a (data, model) mesh, two ranks spawned as
     processes of this script (`train-rank`) sharing the card over gloo.
     (c) kernel 3 at the local heads of TP 2 (Qwen2.5-7B's 14 query, 2 KV
     heads, D 128, and the demo model's 2 query heads of 1 KV head, D 64),
     f32 and bf16 against the plain version, and its times at L 4096 beside
     the bound, the plain version and SDPA.  (a) the demo checkpoint's
     weights in f32 on the `train` phase's copy-task rows, 3 steps through
     `train()` at (dp, tp) = (2, 1) fsdp dense with global batch 2 and at
     (1, 2) splash + remat, each against one process on a (1, 1) mesh:
     losses, the AdamW moments and the weights' change of the checkpoints
     (written by rank (0, 0) from the gathered blocks), within the stated
     tolerances; kernel 3's launches per rank at (1, 2), no plain attention
     on CUDA; beside them the same runs in float64 on the host.  The same
     runs with a fault planted in the two ranks (the update not written
     back; one leaf's gradient not summed over the data ranks) must fail
     those gates.  `[train-exact]`: the (1, 2) configuration in one process
     with kernel 3 and with the plain attention, against float64, and kernel
     3's step-3 loss error and sign-flip shares against the plain
     attention's (aim: within 10x and 2x).  (b)
     Qwen2.5-7B widths, all 28 layers, bf16, remat: (2, 1) fsdp dense, one
     packed row of 2048 tokens per rank, and (1, 2) splash (kernel 3 on 2 KV
     heads per rank), one row of 4096 tokens: 3 steps each with finite
     losses and gradient norm, the step times (gloo-bound), each rank's peak
     memory and kernel 3's launches; with two cards or more again over NCCL,
     one rank per card.

The line before the last is a JSON object with the kernels' numbers; the last
line is {"ok": true, "device": {...}}.  Without a CUDA device, or outside the
repository, it exits non-zero.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense tensor-core bf16; fp32 FMA
# narrow KV storage with row scales
KV_KINDS = {"fp8": torch.float8_e4m3fn, "int8": torch.int8, "e5m2": torch.float8_e5m2}
REPO = os.path.dirname(os.path.abspath(__file__))
DEMO = os.path.join(REPO, "assets", "tpf_demo_n32_v7")
# csrc/<name>.cu
SOURCES = ("paged_attention", "spec_attention", "train_attention", "int4_matmul",
           "decoder_pointwise")
_TRAIN = dict(source="jacobiforcing_tpu_torch/csrc/train_attention.cu",
              replaces="jacobiforcing_tpu/ops/pallas/train_attention.py:112")
_PAGED = dict(source="jacobiforcing_tpu_torch/csrc/paged_attention.cu",
              replaces="jacobiforcing_tpu/ops/pallas/paged_attention.py:736")
_SPEC = dict(source="jacobiforcing_tpu_torch/csrc/spec_attention.cu",
             replaces="jacobiforcing_tpu/ops/pallas/spec_attention.py:245")
KERNELS = {
    "paged_attention": _PAGED,
    "spec_attention": _SPEC,
    # the same kernels on an fp8 e4m3 / e5m2 cache with per-row scales
    "paged_attention_fp8": _PAGED,
    "spec_attention_fp8": _SPEC,
    "paged_attention_e5m2": _PAGED,
    "spec_attention_e5m2": _SPEC,
    "int4_matmul": dict(source="jacobiforcing_tpu_torch/csrc/int4_matmul.cu",
                        replaces="jacobiforcing_tpu/ops/pallas/int4_matmul.py:53"),
    "train_attention_fwd": _TRAIN,
    "train_attention_dkdv": _TRAIN,
    "train_attention_dq": _TRAIN,
    # tensor parallelism at TP 2: the same kernels on each rank's 2 KV heads
    "paged_attention_kh2": _PAGED,
    "spec_attention_kh2": _SPEC,
    # tensor-parallel training at TP 2: kernel 3 on each rank's KV heads
    "train_attention_fwd_kh2": _TRAIN,
    "train_attention_dkdv_kh2": _TRAIN,
    "train_attention_dq_kh2": _TRAIN,
    # the decoder layer's pointwise chains, which XLA fused on the TPU
    **{name: dict(source="jacobiforcing_tpu_torch/csrc/decoder_pointwise.cu",
                  replaces="no TPU kernel: XLA fused these chains")
       for name in ("add_rms_norm", "qkv_rope", "silu_mul")},
}
MR = "jacobi_multiblock_rejection_recycling"
# the JAX package's demo run in f32 on the CPU (2023 on a TPU, whose default
# matmul precision is below f32)
DEMO_TOKENS = 2033


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# Phase 2 helpers
# ---------------------------------------------------------------------------


def narrow_cache(x, kv):
    """(stored rows, scales): x [KH, slots, D] at magnitudes ~600 (beyond the
    e4m3 maximum, so the row scales matter) quantized row by row into the
    storage type `kv` names, or (x, None) for kv=None."""
    from jacobiforcing_tpu_torch.ops.kv_cache import quantize_rows

    if kv is None:
        return x, None
    return quantize_rows(x.float() * 600.0, KV_KINDS[kv])


def make_case(B, L, KH, G, D, page, ctx_max, dtype, seed, n_pad=0, full=False, kv=None,
              ctx_min=None):
    """Random paged inputs: shuffled pages, ragged lengths in [max(ctx_min,
    L), ctx_max] (all `ctx_max` when `full`), -1 table tails and `n_pad`
    batch-bucket padding rows (all -1 table, as the engine pads).  With `kv`
    ("fp8" / "int8") the cache is
    stored narrow with per-row scales, K/V magnitudes ~600, and the queries are
    scaled down by 600 so that the scores stay O(1)."""
    r = np.random.RandomState(seed)
    P = -(-(ctx_max + L) // page) + 1
    n_real = B - n_pad
    lens = r.randint(max(L, ctx_min or 1), ctx_max + 1, size=n_real)
    if full:
        lens[:] = ctx_max
    need = [-(-int(c) // page) for c in lens]
    num_pages = sum(need) + 8
    perm = r.permutation(num_pages)
    bt = np.full((B, P), -1, np.int32)
    o = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[o : o + n]
        o += n
    clen = np.ones((B,), np.int32)
    pos = np.zeros((B, L), np.int32)
    for b in range(B):
        if b < n_real:
            clen[b] = lens[b]
            pos[b] = lens[b] - L + np.arange(L)
        else:  # engine padding row: jacobi/prefill rows sit at 0..L-1
            clen[b] = L
            pos[b] = np.arange(L)
    dev = "cuda"
    q = torch.from_numpy(r.randn(B, L, KH * G, D).astype(np.float32)).to(dev, dtype)
    k = torch.from_numpy(r.randn(KH, num_pages * page, D).astype(np.float32)).to(dev, dtype)
    v = torch.from_numpy(r.randn(KH, num_pages * page, D).astype(np.float32)).to(dev, dtype)
    t = lambda a: torch.from_numpy(a).to(dev)
    if kv is not None:
        q = (q.float() / 600.0).to(dtype)
    k, ks = narrow_cache(k, kv)
    v, vs = narrow_cache(v, kv)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, bt=t(bt), clen=t(clen), pos=t(pos), page=page,
                scale=1.0 / math.sqrt(D), n_real=n_real)


def run_kernel(c):
    from jacobiforcing_tpu_torch.ops.paged_attention_cuda import paged_attention_cuda

    return paged_attention_cuda(c["q"], c["k"], c["v"], c["bt"], c["clen"], c["pos"],
                                c["scale"], page_size=c["page"], k_scale_l=c["ks"],
                                v_scale_l=c["vs"])


def run_plain(c):
    from jacobiforcing_tpu_torch.ops.attention import paged_attention_ref

    return paged_attention_ref(c["q"], c["k"], c["v"], c["bt"], c["clen"], c["pos"],
                               c["scale"], page_size=c["page"], k_scale_l=c["ks"],
                               v_scale_l=c["vs"])


def check(out, ref, n_real=None):
    """(max_abs_err, worst err/tol, ok) over the real rows (the first `n_real`
    sequences, or every row given).  f32: |err| <=
    1e-5 * max|ref|.  bf16 (the plain version rounds the probabilities and
    the output to bf16): per element |err| <= 2^-5 * |ref| + 2^-7 * max|ref|
    of its row, i.e. a few bf16 ulps of the element and of its row, so a
    long-context row whose outputs are ~0.03 is held to ~1e-3, not to 2e-2.
    The same rules hold on a narrow cache: kernel and plain version both
    dequantize a stored row in the query dtype, to the same bits."""
    bf16 = out.dtype == torch.bfloat16
    out, ref = out[:n_real].float(), ref[:n_real].float()
    err = (out - ref).abs()
    if bf16:
        tol = ref.abs() * 2.0**-5 + ref.abs().amax(-1, keepdim=True) * 2.0**-7
    else:
        tol = torch.full_like(ref, 1e-5 * ref.abs().max().item())
    finite = bool(torch.isfinite(out).all())
    worst = (err / tol).max().item()
    return err.max().item(), worst, finite and worst <= 1.0


def time_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters=20):
    """Device time per call: `iters` calls captured in one CUDA graph and
    replayed, so the host's work per call (Python, checks, allocations, the
    launch itself) is not in it.  `time_ms` keeps it, as a caller that
    launches call after call would."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def bound(c):
    """(bound_ms, bound_by): each input read once (only the keys below each
    row's cache length), the output written once; 4*D ops per visible key per
    query head."""
    q, dtype = c["q"], c["q"].dtype
    B, L, NH, D = q.shape
    KH = c["k"].shape[0]
    it = q.element_size()
    clen = c["clen"][: c["n_real"]].long().cpu()
    pos = c["pos"][: c["n_real"]].long().cpu()
    # a narrow cache: one byte per element and a float32 scale per row and head
    kv_bytes = 2 * int(clen.sum()) * KH * (D * c["k"].element_size()
                                           + (4 if c["ks"] is not None else 0))
    nbytes = (2 * q.numel() * it + kv_bytes + c["bt"].numel() * 4 + c["clen"].numel() * 4
              + c["pos"].numel() * 4)
    visible = torch.minimum(pos + 1, clen[:, None]).clamp(min=0).sum()
    ops = 4 * D * NH * int(visible)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dense_kv(c, name):
    """The case's pages of K or V gathered (and a narrow cache dequantized) to
    dense [B, S, KH, D] in the query dtype."""
    from jacobiforcing_tpu_torch.ops.attention import gather_dequant

    return gather_dequant(c[name], c[name + "s"], c["bt"], c["page"], c["q"].dtype)


def sdpa_ms(c):
    """One `scaled_dot_product_attention` call on the same function, with the
    pages gathered to dense K/V (a narrow cache dequantized) beforehand;
    neither is timed."""
    q, page = c["q"], c["page"]
    B, L, NH, D = q.shape
    k = dense_kv(c, "k").permute(0, 2, 1, 3).contiguous()  # [B,KH,S,D]
    v = dense_kv(c, "v").permute(0, 2, 1, 3).contiguous()
    S = k.shape[2]
    key = torch.arange(S, device=q.device)
    mask = (key[None, None, :] <= c["pos"][:, :, None]) & (key[None, None, :] < c["clen"][:, None, None])
    mask = mask[:, None]
    qt = q.transpose(1, 2).contiguous()
    f = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask, scale=c["scale"], enable_gqa=True)
    return time_ms(f)


def kernel_design():
    """One `[kernel-design]` line per serving kernel: which (query, cache, D)
    variants run the warp-specialised tensor-core design, the cp.async
    tensor-core tile and the fp32 tile, with the
    registers, local bytes and shared memory of each (cudaFuncGetAttributes).
    Fails if a tensor-core variant uses local memory (spills or a stack)."""
    from jacobiforcing_tpu_torch.ops import paged_attention_cuda as pac
    from jacobiforcing_tpu_torch.ops import spec_attention_cuda as sac

    short = {"float32": "f32", "bfloat16": "bf16", "float8_e4m3fn": "fp8", "int8": "int8",
             "float8_e5m2": "e5m2"}
    for name, variants in (("paged_attention", pac.variants()), ("spec_attention", sac.variants())):
        parts = []
        for design in (2, 1, 0):
            vs = [v for v in variants if v["tensor_cores"] == design]
            if not vs:
                continue
            v0 = vs[0]
            what = {
                2: f"warp-specialised tensor-core design (the same wgmma tile; "
                   f"{v0['key_tile']}-key tiles; {v0['stages']} TMA K/V stages filled by one "
                   f"producer warp; {v0['threads'] // 128 - 1} consumer warpgroups of 64 rows "
                   f"per CTA)",
                1: f"tensor-core tile (wgmma m64n64k16 Q.K^T and m64n<D>k16 P.V, bf16 in, fp32 "
                   f"accumulate; {v0['key_tile']}-key tiles; {v0['stages']} cp.async K/V stages; "
                   f"{v0['threads'] // 128} warpgroups of 64 rows per CTA)",
                0: f"fp32 CUDA-core tile ({v0['key_tile']}-key tiles, {v0['threads']} threads, "
                   f"64 rows per CTA)"}[design]
            cells = [f"{short[v['query']]}/{short[v['cache']]} D{v['D']} {v['registers']} regs "
                     f"{v['local_bytes']} B local {v['static_smem'] + v['dynamic_smem']} B smem"
                     for v in vs]
            parts.append(f"{what}: " + ", ".join(cells))
        log(f"[kernel-design] {name}: " + "; ".join(parts))
        spilled = [v for v in variants if v["tensor_cores"] and v["local_bytes"]]
        if spilled or any(bool(v["tensor_cores"]) != (v["query"] == "bfloat16")
                          for v in variants):
            raise AssertionError(f"{name}: a tensor-core variant uses local memory, or a variant "
                                 f"runs the wrong tile: {spilled}")


def phase_kernel(timing):
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    shapes = [("demo", 2, 2, 64, 16), ("qwen7b", 4, 7, 128, 256)]
    n = 0
    for dname, dtype in dtypes.items():
        for sname, KH, G, D, page in shapes:
            cases = [(B, L, 4096 if B <= 4 else 2048, False) for L in (1, 32, 64) for B in (1, 4, 8)]
            cases.append((1, 1024, 1024, True))
            for B, L, ctx, prefill in cases:
                c = make_case(B, L, KH, G, D, page, ctx, dtype, seed=n,
                              n_pad=(1 if B >= 4 else 0), full=prefill)
                n += 1
                out = run_kernel(c)
                torch.cuda.synchronize()
                # padding rows only have to be finite (the kernel reads no -1 page)
                finite = bool(torch.isfinite(out).all())
                err, worst, ok = check(out, run_plain(c), c["n_real"])
                ok = ok and finite
                tag = f"{dname} {sname} B={B} L={L} ctx<={ctx}{' prefill' if prefill else ''}"
                log(f"[kernel] {tag}: max_abs_err={err:.3e} max err/tol={worst:.3f} "
                    f"finite={finite} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(f"kernel disagrees with the plain version: {tag}")

    # the same on a narrow cache with per-row scales (fp8 e4m3 and e5m2, int8)
    for kv in KV_KINDS:
        for dname, dtype in dtypes.items():
            for sname, KH, G, D, page in shapes:
                for B, L, ctx, prefill in [(1, 1, 4096, False), (4, 1, 4096, False),
                                           (4, 64, 4096, False), (8, 32, 2048, False),
                                           (1, 1024, 1024, True)]:
                    c = make_case(B, L, KH, G, D, page, ctx, dtype, seed=n,
                                  n_pad=(1 if B >= 4 else 0), full=prefill, kv=kv)
                    n += 1
                    out = run_kernel(c)
                    torch.cuda.synchronize()
                    finite = bool(torch.isfinite(out).all())
                    err, worst, ok = check(out, run_plain(c), c["n_real"])
                    ok = ok and finite
                    tag = (f"{kv} KV {dname} {sname} B={B} L={L} ctx<={ctx}"
                           f"{' prefill' if prefill else ''}")
                    log(f"[kernel] {tag}: max_abs_err={err:.3e} max err/tol={worst:.3f} "
                        f"finite={finite} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(f"kernel disagrees with the plain version: {tag}")

    # bitwise: a row from an L=1, B=1 call == the same row inside a B=8, L=64 block
    for kv, (dname, dtype) in [(kv, d) for kv in (None, *KV_KINDS) for d in dtypes.items()]:
        for sname, KH, G, D, page in shapes:
            c = make_case(8, 64, KH, G, D, page, 2048, dtype, seed=1000, n_pad=1, kv=kv)
            block = run_kernel(c)
            diffs = 0
            for b in (0, 3, 6):
                for t in (0, 17, 63):
                    p = int(c["pos"][b, t])
                    one = dict(c, q=c["q"][b : b + 1, t : t + 1].contiguous(),
                               bt=c["bt"][b : b + 1].contiguous(),
                               clen=torch.tensor([p + 1], dtype=torch.int32, device="cuda"),
                               pos=torch.tensor([[p]], dtype=torch.int32, device="cuda"), n_real=1)
                    row = run_kernel(one)[0, 0]
                    same = torch.equal(row.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                                       block[b, t].view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
                    diffs += 0 if same else 1
            log(f"[kernel] bitwise AR-row == Jacobi-row {dname} {sname} {kv or 'same-type'} KV: "
                f"9 rows, {diffs} differ {'ok' if diffs == 0 else 'FAIL'}")
            if diffs:
                raise AssertionError("AR row and Jacobi row differ bitwise")

    # times at the main path's shapes (Qwen2.5-7B heads, bf16, page 256), with
    # a bf16 cache and with an fp8 e4m3 / e5m2 cache: a Jacobi block, AR
    # decode, prefill
    times = {f"{name}{'_' + kv if kv else ''}": (B, L, ctx, kv) for kv in (None, "fp8", "e5m2")
             for name, (B, L, ctx) in {"decode": (4, 64, 1024), "ar_decode": (4, 1, 1024),
                                       "prefill": (1, 1024, 1024)}.items()}
    for name, (B, L, ctx, kv) in times.items():
        c = make_case(B, L, 4, 7, 128, 256, ctx, torch.bfloat16, seed=2000, full=True, kv=kv)
        ms = time_ms(lambda: run_kernel(c))
        plain = time_ms(lambda: run_plain(c), iters=5)
        lib = sdpa_ms(c)
        bms, by = bound(c)
        err, worst, ok = check(run_kernel(c), run_plain(c), c["n_real"])
        log(f"[kernel-time] {name} B={B} L={L} ctx={ctx} bf16 queries, {kv or 'bf16'} KV, D=128 "
            f"KH=4 G=7: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.5f} ms ({by}), "
            f"{bms / ms * 100:.2f}% of bound, max_abs_err {err:.3e} max err/tol {worst:.3f} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with the plain version at the {name} shape")
        timing[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                            max_abs_err=err)


# Kernel 1 at the benchmark cells' shapes and row 1's of PERF.md's table: bf16
# queries over a bf16 cache, D 128, page 256.  (name, B, L, KH, G, ctx_min,
# ctx_max, every sequence at ctx_max)
PAGED_CELL_SHAPES = (
    ("cell1_trip", 32, 64, 4, 7, 256, 1536, False),     # coder7b-jacobi-closed32's trip
    ("cell2_trip", 16, 64, 8, 4, 128, 2304, False),     # qwen3-8b-jacobi-poisson's trip
    ("cell2_prefill", 1, 2048, 8, 4, 2048, 2048, True),  # and its prefill
    ("decode", 4, 64, 4, 7, 1024, 1024, True),
    ("ar_decode", 4, 1, 4, 7, 1024, 1024, True),
    ("prefill", 1, 1024, 4, 7, 1024, 1024, True),
)


def reference_paged(tree):
    """Another tree's build of csrc/paged_attention.cu (the parent commit's,
    say), in the form of the wrapper's `_FN`."""
    import ctypes

    from jacobiforcing_tpu_torch.ops import _build
    from jacobiforcing_tpu_torch.ops import paged_attention_cuda as pac

    src = os.path.join(os.path.abspath(tree), "jacobiforcing_tpu_torch", "csrc",
                       "paged_attention.cu")
    out = os.path.join(REPO, "build", "kernels", "reference_paged_attention.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {src} failed:\n{proc.stdout}{proc.stderr}")
    return pac.bind(ctypes.CDLL(out))


def run_with(fn, c):
    """run_kernel(c) through the library `fn` (`reference_paged`'s form)."""
    from jacobiforcing_tpu_torch.ops import paged_attention_cuda as pac

    saved, pac._FN = pac._FN, fn
    try:
        return run_kernel(c)
    finally:
        pac._FN = saved


def phase_paged_cells(timing, ref_tree=None):
    """Kernel 1 at PAGED_CELL_SHAPES: against the plain version, then its
    device time (a CUDA graph of 20 calls, the inputs rotating through sets
    whose K/V pass 256 MB, so the L2 does not hold them) beside the bound.
    With `ref_tree`, the same seeded inputs through that tree's build as
    well: every output bitwise against it, and both timed in turns (P C C
    P)."""
    from jacobiforcing_tpu_torch.ops import paged_attention_cuda as pac

    ref = reference_paged(ref_tree) if ref_tree else None
    differ = []
    for name, B, L, KH, G, lo, hi, full in PAGED_CELL_SHAPES:
        make = lambda seed: make_case(B, L, KH, G, 128, 256, hi, torch.bfloat16, seed=seed,
                                      full=full, ctx_min=lo)
        sets = [make(3000)]
        kv_bytes = 2 * sets[0]["k"].numel() * sets[0]["k"].element_size()
        sets += [make(3000 + i) for i in range(1, math.ceil(SPILL_L2_BYTES / kv_bytes))]
        ws0 = pac.paged_attention_cuda.ws_launches
        out = run_kernel(sets[0])
        torch.cuda.synchronize()
        ws = pac.paged_attention_cuda.ws_launches - ws0
        err, worst, ok = check(out, run_plain(sets[0]), sets[0]["n_real"])
        bounds = [bound(c) for c in sets]
        bms = sum(b[0] for b in bounds) / len(bounds)
        by = "/".join(sorted({b[1] for b in bounds}))
        line = (f"[kernel-cells] {name} B={B} L={L} KH={KH} G={G} ctx {lo}-{hi}: "
                f"{'warp-specialised' if ws else 'cp.async tile'}; max_abs_err={err:.3e} "
                f"max err/tol={worst:.3f} {'ok' if ok else 'FAIL'}; bound {bms:.5f} ms ({by}); "
                f"{len(sets)} input sets, K/V {kv_bytes / 1e6:.1f} MB each")
        if not ok:
            log(line)
            raise AssertionError(f"kernel 1 disagrees with the plain version at {name}")
        if ref is None:
            ms = graph_ms(rotating(run_kernel, sets))
            log(line + f"; kernel {ms:.4f} ms ({bms / ms * 100:.2f}% of bound)")
            timing[f"cells_{name}"] = dict(ms=ms, bound_ms=bms, bound_by=by, max_abs_err=err)
            continue
        n_diff = sum(not torch.equal(bits(run_kernel(c)), bits(run_with(ref, c))) for c in sets)
        if n_diff:
            differ.append(name)
        t = {"P": [], "C": []}
        for tag in "PCCP":
            fn = (lambda c: run_with(ref, c)) if tag == "P" else run_kernel
            t[tag].append(graph_ms(rotating(fn, sets)))
        p_ms, c_ms = min(t["P"]), min(t["C"])
        log(line + f"; bitwise against the reference build: {n_diff} of {len(sets)} outputs "
            f"differ {'ok' if n_diff == 0 else 'FAIL'}; reference "
            f"{' / '.join(f'{x:.4f}' for x in t['P'])} ms ({bms / p_ms * 100:.2f}% of bound), "
            f"this tree {' / '.join(f'{x:.4f}' for x in t['C'])} ms ({bms / c_ms * 100:.2f}%), "
            f"{p_ms / c_ms:.2f}x")
        timing[f"cells_{name}"] = dict(ms=c_ms, ref_ms=p_ms, bound_ms=bms, bound_by=by,
                                       max_abs_err=err)
    if differ:
        raise AssertionError(f"kernel 1 differs bitwise from the reference build at {differ}")


# ---------------------------------------------------------------------------
# Phase 2, the speculative-attention kernel
# ---------------------------------------------------------------------------


def make_spec_case(B, N, K, C, KH, G, D, page, ctx_max, dtype, seed, n_pad=0, mask="tree",
                   full=False, kv=None):
    """Random inputs of the MR decoder's attention: T = (1+C+K-1)*N in-flight
    tokens per sequence over shuffled pages with ragged committed lengths from
    0 up to `ctx_max` (all `ctx_max` when `full`) and `n_pad` batch-bucket
    padding rows (all -1 table, length 1, all-false mask).  `mask`: "tree" is
    the decoder's mask (same-segment causal, pseudos see RA and earlier
    pseudos) with holes where segments are inactive or drafts short (none when
    `full`); "random" lets each key through with probability 0.3.  With `kv`
    ("fp8" / "int8") the committed cache is stored narrow with per-row scales
    at magnitudes ~600 (queries scaled down by 600), and the in-flight block
    is fake-quantized as `forward_spec` does it."""
    from jacobiforcing_tpu_torch.engine.multiblock import tree_mask
    from jacobiforcing_tpu_torch.ops.kv_cache import dequantize_rows, quantize_rows

    r = np.random.RandomState(seed)
    S = 1 + C + (K - 1)
    T = S * N
    n_real = B - n_pad
    lens = r.randint(0, ctx_max + 1, size=n_real)
    if n_real > 1:
        lens[0] = 0  # a sequence with nothing committed
    if full:
        lens[:] = ctx_max
    P = -(-ctx_max // page) + 1
    need = [-(-int(c) // page) for c in lens]
    num_pages = sum(need) + 8
    perm = r.permutation(num_pages)
    bt = np.full((B, P), -1, np.int32)
    o = 0
    for b, n in enumerate(need):
        bt[b, :n] = perm[o : o + n]
        o += n
    clen = np.ones((B,), np.int32)
    clen[:n_real] = lens
    if mask == "tree":
        active = r.rand(B, S) < 0.7
        vlen = r.randint(1, N + 1, size=(B, S))
        if full:
            active[:], vlen[:] = True, N
        active[:, 0] = True
        tv = (active[:, :, None] & (np.arange(N)[None, None, :] < vlen[:, :, None])).reshape(B, T)
        m = tree_mask(N, K, C, "cpu").numpy()[None] & tv[:, :, None] & tv[:, None, :]
    else:
        m = r.rand(B, T, T) < 0.3
    m[n_real:] = False
    dev = "cuda"
    f = lambda *shape: torch.from_numpy(r.randn(*shape).astype(np.float32)).to(dev, dtype)
    t = lambda a: torch.from_numpy(a).to(dev)
    q, k, v = f(B, T, KH * G, D), f(KH, num_pages * page, D), f(KH, num_pages * page, D)
    k_new, v_new = f(B, T, KH, D), f(B, T, KH, D)
    if kv is not None:
        q = (q.float() / 600.0).to(dtype)
        k_new = dequantize_rows(*quantize_rows(k_new.float() * 600.0, KV_KINDS[kv]), dtype)
        v_new = dequantize_rows(*quantize_rows(v_new.float() * 600.0, KV_KINDS[kv]), dtype)
    k, ks = narrow_cache(k, kv)
    v, vs = narrow_cache(v, kv)
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, bt=t(bt), clen=t(clen), k_new=k_new, v_new=v_new,
                mask=t(m), page=page, scale=1.0 / math.sqrt(D), n_real=n_real, N=N)


def spec_args(c):
    return (c["q"], c["k"], c["v"], c["bt"], c["clen"], c["k_new"], c["v_new"], c["mask"],
            c["scale"])


def run_spec_kernel(c):
    from jacobiforcing_tpu_torch.ops.spec_attention_cuda import spec_attention_cuda

    return spec_attention_cuda(*spec_args(c), page_size=c["page"], k_scale_l=c["ks"],
                               v_scale_l=c["vs"])


def run_spec_plain(c):
    from jacobiforcing_tpu_torch.ops.attention import paged_attention_with_block_ref

    return paged_attention_with_block_ref(*spec_args(c), page_size=c["page"], k_scale_l=c["ks"],
                                          v_scale_l=c["vs"])


def spec_rows_to_check(c):
    """[B, T] bool: the rows of real sequences that see at least one key.  A
    row with no visible key gives zeros in the kernel and a uniform average
    in the plain version; the decoder discards such rows."""
    seen = (c["clen"][:, None] > 0) | c["mask"].any(-1)
    seen[c["n_real"]:] = False
    return seen


def spec_slice(c, b=None, T=None):
    """The same inputs cut to sequence `b` alone and/or to the first T tokens."""
    out = dict(c)
    for key in ("q", "k_new", "v_new", "mask", "bt", "clen"):
        x = c[key]
        if b is not None:
            x = x[b : b + 1]
        if T is not None and key in ("q", "k_new", "v_new"):
            x = x[:, :T]
        if T is not None and key == "mask":
            x = x[:, :T, :T]
        out[key] = x.contiguous()
    if b is not None:
        out["n_real"] = 1
    return out


def spec_bound(c):
    """(bound_ms, bound_by): each input read once (only the committed keys
    below each cache length), the output written once; 4*D operations per
    visible key (committed, or in-flight and let through by the mask) and
    query head."""
    q = c["q"]
    B, T, NH, D = q.shape
    KH = c["k"].shape[0]
    it = q.element_size()
    n = c["n_real"]
    clen = c["clen"][:n].long()
    # a narrow cache: one byte per element and a float32 scale per row and head
    row_bytes = D * c["k"].element_size() + (4 if c["ks"] is not None else 0)
    nbytes = (2 * q.numel() * it + 2 * int(clen.sum()) * KH * row_bytes
              + 2 * c["k_new"].numel() * it + c["mask"].numel() + c["bt"].numel() * 4
              + c["clen"].numel() * 4)
    visible = int(clen.sum()) * T + int(c["mask"][:n].sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * D * NH * visible / PEAK_OPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spec_sdpa_ms(c):
    """One `scaled_dot_product_attention` call on the same function: dense
    K/V, committed pages gathered (a narrow cache dequantized) beforehand and
    the in-flight block appended, under one boolean mask (none of that is
    timed)."""
    q = c["q"]
    kc = dense_kv(c, "k")  # [B, S, KH, D]
    vc = dense_kv(c, "v")
    S = kc.shape[1]
    k = torch.cat([kc, c["k_new"]], dim=1).permute(0, 2, 1, 3).contiguous()  # [B,KH,S+T,D]
    v = torch.cat([vc, c["v_new"]], dim=1).permute(0, 2, 1, 3).contiguous()
    committed = torch.arange(S, device=q.device)[None, None, :] < c["clen"][:, None, None]
    mask = torch.cat([committed.expand(-1, q.shape[1], -1), c["mask"]], dim=-1)[:, None]
    qt = q.transpose(1, 2).contiguous()
    f = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask, scale=c["scale"], enable_gqa=True)
    return time_ms(f)


def bits(x):
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


def two_sources_check():
    """The MR decoder sees a key twice: in flight, fake-quantized by
    `forward_spec`, and later committed, dequantized inside the kernels.  Both
    must be the same bits.  With the committed length a multiple of the key
    tile (32 keys in the fp32 tile, 64 in the tensor-core tile: the committed
    length 256 is a multiple of both) the two kernels walk the same keys in the
    same tiles, so the rows of a speculative call over [committed | causal
    block] must equal, bit for bit, the rows of a paged call after the block's
    rows were committed."""
    from jacobiforcing_tpu_torch.ops.kv_cache import (
        alloc_kv_cache, dequantize_rows, quantize_rows, write_kv_scaled)

    N, clen, page, KH, G, D = 32, 256, 16, 2, 2, 64
    for kv, store in KV_KINDS.items():
        for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            c = make_spec_case(2, N, 1, 0, KH, G, D, page, clen, dtype, seed=6500, full=True, kv=kv)
            # the committed cache in a pool with trash rows, which the write needs
            pool = alloc_kv_cache(1, c["k"].shape[1] // page, page, KH, D, store, "cuda")
            for name, t in (("k", pool.k), ("v", pool.v), ("ks", pool.k_scale),
                            ("vs", pool.v_scale)):
                t[0].copy_(c[name])
                c[name] = t[0]
            r = np.random.RandomState(6501)
            raw_k = torch.from_numpy(r.randn(2, N, KH, D).astype(np.float32) * 600).to("cuda", dtype)
            raw_v = torch.from_numpy(r.randn(2, N, KH, D).astype(np.float32) * 600).to("cuda", dtype)
            c["k_new"] = dequantize_rows(*quantize_rows(raw_k, store), dtype)
            c["v_new"] = dequantize_rows(*quantize_rows(raw_v, store), dtype)
            c["mask"] = torch.tril(torch.ones(N, N, dtype=torch.bool, device="cuda"))[None] \
                .expand(2, N, N).contiguous()
            spec = run_spec_kernel(c)
            # commit the block's rows behind the committed keys, onto fresh pages
            free = [p for p in range(c["k"].shape[1] // page) if p not in set(c["bt"].flatten().tolist())]
            bt = torch.cat([c["bt"][:, : clen // page],
                            torch.tensor([free[:2], free[2:4]], dtype=torch.int32, device="cuda")], 1)
            pos = clen + torch.arange(N, dtype=torch.int32, device="cuda")[None].expand(2, N)
            slots = torch.gather(bt.long(), 1, (pos // page).long()) * page + pos % page
            write_kv_scaled(c["k"], c["v"], c["ks"], c["vs"], raw_k, raw_v, slots)
            paged = run_kernel(dict(c, bt=bt.contiguous(), pos=pos.contiguous(),
                                    clen=torch.full((2,), clen + N, dtype=torch.int32,
                                                    device="cuda")))
            diffs = int((bits(spec) != bits(paged)).any(-1).any(-1).sum())
            log(f"[spec-kernel] bitwise {kv} KV {dname}: rows over [committed | in-flight "
                f"fake-quantized block] == rows after the block is committed, {2 * N} rows, "
                f"{diffs} differ {'ok' if diffs == 0 else 'FAIL'}")
            if diffs:
                raise AssertionError("an in-flight fake-quantized key and its committed copy differ")


def phase_spec_kernel(timing):
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    shapes = [("demo", 2, 2, 64, 16), ("qwen7b", 4, 7, 128, 256)]
    tiers = [("N", 1, 0), ("2N", 2, 0), ("6N", 2, 4)]  # RA-only, no-candidate, full (K=2, C=4)
    n = 0
    for dname, dtype in dtypes.items():
        for sname, KH, G, D, page in shapes:
            for N in (32, 64):
                for B in (1, 4, 8):
                    for tname, K, C in tiers:
                        for mask in ("tree", "random"):
                            ctx = 4096 if B <= 4 else 2048
                            c = make_spec_case(B, N, K, C, KH, G, D, page, ctx, dtype, seed=3000 + n,
                                               n_pad=(1 if B >= 4 else 0), mask=mask)
                            n += 1
                            out = run_spec_kernel(c)
                            torch.cuda.synchronize()
                            # padding and unseen rows only have to be finite
                            finite = bool(torch.isfinite(out).all())
                            keep = spec_rows_to_check(c)
                            err, worst, ok = check(out[keep], run_spec_plain(c)[keep])
                            ok = ok and finite
                            tag = (f"{dname} {sname} B={B} N={N} T={tname} {mask} mask "
                                   f"ctx<={ctx} ({int(keep.sum())} rows)")
                            log(f"[spec-kernel] {tag}: max_abs_err={err:.3e} max err/tol={worst:.3f} "
                                f"finite={finite} {'ok' if ok else 'FAIL'}")
                            if not ok:
                                raise AssertionError(
                                    f"spec kernel disagrees with the plain version: {tag}")

    # the same on a narrow committed cache with per-row scales (fp8 e4m3 and
    # e5m2, int8)
    for kv in KV_KINDS:
        for dname, dtype in dtypes.items():
            for sname, KH, G, D, page in shapes:
                for B, N in ((1, 64), (8, 32)):
                    for tname, K, C in tiers:
                        ctx = 4096 if B <= 4 else 2048
                        c = make_spec_case(B, N, K, C, KH, G, D, page, ctx, dtype, seed=3000 + n,
                                           n_pad=(1 if B >= 4 else 0), kv=kv)
                        n += 1
                        out = run_spec_kernel(c)
                        torch.cuda.synchronize()
                        finite = bool(torch.isfinite(out).all())
                        keep = spec_rows_to_check(c)
                        err, worst, ok = check(out[keep], run_spec_plain(c)[keep])
                        ok = ok and finite
                        tag = (f"{kv} KV {dname} {sname} B={B} N={N} T={tname} tree mask "
                               f"ctx<={ctx} ({int(keep.sum())} rows)")
                        log(f"[spec-kernel] {tag}: max_abs_err={err:.3e} max err/tol={worst:.3f} "
                            f"finite={finite} {'ok' if ok else 'FAIL'}")
                        if not ok:
                            raise AssertionError(
                                f"spec kernel disagrees with the plain version: {tag}")

    # bitwise: RA rows of a T=6N call == the rows of a T=N call on the same
    # sequence (the batch-global tier choice must not change a row's bits), and
    # a row of a B=8 call == the same row at B=1
    for kv, (dname, dtype) in [(kv, d) for kv in (None, *KV_KINDS) for d in dtypes.items()]:
        for sname, KH, G, D, page in shapes:
            for N in (32, 64):
                c = make_spec_case(8, N, 2, 4, KH, G, D, page, 2048, dtype, seed=5000 + N, n_pad=1,
                                   kv=kv)
                big = run_spec_kernel(c)
                ra = run_spec_kernel(spec_slice(c, T=N))
                tier_diffs = int((bits(big[:, :N]) != bits(ra)).any(-1).any(-1).sum())
                batch_diffs = 0
                for b in (0, 3, 6):
                    solo = run_spec_kernel(spec_slice(c, b=b))
                    batch_diffs += int((bits(solo[0]) != bits(big[b])).any(-1).any(-1).sum())
                ok = tier_diffs == 0 and batch_diffs == 0
                log(f"[spec-kernel] bitwise {dname} {sname} {kv or 'same-type'} KV N={N}: RA rows "
                    f"of T=6N vs T=N, "
                    f"{8 * N} rows, {tier_diffs} differ; rows of B=8 vs B=1, {3 * 6 * N} rows, "
                    f"{batch_diffs} differ {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("spec kernel rows depend on the tier or the batch")

    two_sources_check()

    # times at the MR path's shapes (Qwen2.5-7B heads, bf16, page 256, B=4, ctx 1024, N=64),
    # with a bf16 cache and with an fp8 e4m3 / e5m2 cache
    times = {f"{name}{'_' + kv if kv else ''}": (K, C, kv) for kv in (None, "fp8", "e5m2")
             for name, (K, C) in {"T64": (1, 0), "T128": (2, 0), "T384": (2, 4)}.items()}
    for name, (K, C, kv) in times.items():
        c = make_spec_case(4, 64, K, C, 4, 7, 128, 256, 1024, torch.bfloat16, seed=6000, full=True,
                           kv=kv)
        T = c["q"].shape[1]
        ms = time_ms(lambda: run_spec_kernel(c))
        plain = time_ms(lambda: run_spec_plain(c), iters=5)
        lib = spec_sdpa_ms(c)
        bms, by = spec_bound(c)
        err, worst, ok = check(run_spec_kernel(c), run_spec_plain(c))
        log(f"[spec-kernel-time] T={T} B=4 ctx=1024 bf16 queries, {kv or 'bf16'} KV, D=128 KH=4 "
            f"G=7: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.5f} ms ({by}), "
            f"{bms / ms * 100:.2f}% of bound, max_abs_err {err:.3e} max err/tol {worst:.3f} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"spec kernel disagrees with the plain version at T={T}")
        timing[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                            max_abs_err=err)


def phase_tp_kernel(timing):
    """Kernels 1 and 2 at the launch shapes of tensor parallelism: Qwen2.5-7B
    heads (D 128, G 7) with the KV heads of one rank at TP 2 (KH 2) and TP 4
    (KH 1), f32 and bf16, against their plain versions under `check`; then
    their times at B 4 (the paged kernel at L 64, the speculative one at T
    64 / 128 / 384) beside the bound and SDPA."""
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    tiers = {"T64": (1, 0), "T128": (2, 0), "T384": (2, 4)}
    n = 0
    for KH in (2, 1):
        for dname, dtype in dtypes.items():
            for B, L, ctx, prefill in [(1, 1, 4096, False), (4, 64, 4096, False),
                                       (8, 32, 2048, False), (1, 1024, 1024, True)]:
                c = make_case(B, L, KH, 7, 128, 256, ctx, dtype, seed=7000 + n,
                              n_pad=(1 if B >= 4 else 0), full=prefill)
                n += 1
                out = run_kernel(c)
                finite = bool(torch.isfinite(out).all())
                err, worst, ok = check(out, run_plain(c), c["n_real"])
                tag = f"KH={KH} {dname} B={B} L={L} ctx<={ctx}{' prefill' if prefill else ''}"
                log(f"[tp-kernel] paged {tag}: max_abs_err={err:.3e} max err/tol={worst:.3f} "
                    f"finite={finite} {'ok' if ok and finite else 'FAIL'}")
                if not (ok and finite):
                    raise AssertionError(f"kernel disagrees with the plain version: {tag}")
            for B in (1, 4):
                for tname, (K, C) in tiers.items():
                    c = make_spec_case(B, 64, K, C, KH, 7, 128, 256, 2048, dtype, seed=7000 + n,
                                       n_pad=(1 if B >= 4 else 0))
                    n += 1
                    out = run_spec_kernel(c)
                    finite = bool(torch.isfinite(out).all())
                    keep = spec_rows_to_check(c)
                    err, worst, ok = check(out[keep], run_spec_plain(c)[keep])
                    tag = f"KH={KH} {dname} B={B} N=64 T={tname} tree mask ctx<=2048"
                    log(f"[tp-kernel] speculative {tag}: max_abs_err={err:.3e} "
                        f"max err/tol={worst:.3f} finite={finite} "
                        f"{'ok' if ok and finite else 'FAIL'}")
                    if not (ok and finite):
                        raise AssertionError(f"spec kernel disagrees with the plain version: {tag}")
    for KH in (2, 1):
        c = make_case(4, 64, KH, 7, 128, 256, 1024, torch.bfloat16, seed=7500, full=True)
        cases = {f"decode_kh{KH}": (c, run_kernel, run_plain, sdpa_ms, bound, None)}
        for tname, (K, C) in tiers.items():
            cs = make_spec_case(4, 64, K, C, KH, 7, 128, 256, 1024, torch.bfloat16, seed=7600,
                                full=True)
            cases[f"{tname}_kh{KH}"] = (cs, run_spec_kernel, run_spec_plain, spec_sdpa_ms,
                                        spec_bound, spec_rows_to_check(cs))
        for name, (c, kern, plain_fn, lib_fn, bound_fn, keep) in cases.items():
            ms = time_ms(lambda: kern(c))
            plain = time_ms(lambda: plain_fn(c), iters=5)
            lib = lib_fn(c)
            bms, by = bound_fn(c)
            out, ref = kern(c), plain_fn(c)
            err, worst, ok = check(out, ref, c["n_real"]) if keep is None else \
                check(out[keep], ref[keep])
            log(f"[tp-kernel-time] {name} B=4 {'L=64 ' if keep is None else ''}ctx=1024 bf16, "
                f"D=128 KH={KH} G=7: kernel {ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
                f"bound {bms:.5f} ms ({by}), {bms / ms * 100:.2f}% of bound, max_abs_err "
                f"{err:.3e} max err/tol {worst:.3f} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"kernel disagrees with the plain version at {name}")
            timing[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                                bound_by=by, max_abs_err=err)


# ---------------------------------------------------------------------------
# Phase `kernel`, the int4 dequant-matmul kernel
# ---------------------------------------------------------------------------

# the linear layers of Qwen2.5-7B as (K, N): wq/wo, wk/wv, gate/up, down
INT4_SHAPES = {"qo": (3584, 3584), "kv": (3584, 512), "gateup": (3584, 18944),
               "down": (18944, 3584)}
INT4_ROWS = (4, 256, 1536)  # AR decode (B=4), a Jacobi block (B*L), the MR full tier (B*T)


def make_int4_case(M, K, N, dtype, seed):
    from jacobiforcing_tpu_torch.ops.int4_matmul import pack_int4

    g = torch.Generator(device="cuda").manual_seed(seed)
    wq = torch.randint(-8, 8, (K, N), generator=g, device="cuda", dtype=torch.int8)
    scale = torch.randn(N, generator=g, device="cuda").abs() * 0.01
    x = torch.randn(M, K, generator=g, device="cuda").to(dtype)
    return dict(x=x, wq=wq, wp=pack_int4(wq), scale=scale)


def check_int4(out, ref):
    """(max_abs_err, worst err/tol, ok) against the plain version run in
    float32 on the same (rounded) inputs.  f32: |err| <= 1e-5 * max|ref| (the
    sums are taken in another order).  bf16: per element |err| <= 2^-7 * |ref|
    + 1e-5 * max|ref|: the output is rounded to bf16 once, and a sum that lies
    near a rounding boundary may land on the neighbouring value (one ulp)."""
    bf16 = out.dtype == torch.bfloat16
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    tol = torch.full_like(ref, 1e-5 * ref.abs().max().item())
    if bf16:
        tol = tol + ref.abs() * 2.0**-7
    worst = (err / tol).max().item()
    return err.max().item(), worst, bool(torch.isfinite(out).all()) and worst <= 1.0


def int4_bound(M, K, N, dtype):
    """(bound_ms, bound_by): the packed weight, x and the scales read once, y
    written once; 2*M*K*N operations at the tensor cores' rate for x's type."""
    e = torch.empty((), dtype=dtype).element_size()
    t_bytes = (K * N // 2 + M * K * e + M * N * e + N * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * K * N / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int4_kernel_design():
    """The `[kernel-design]` line of the int4 kernels: tile, registers, local
    bytes and shared memory of the fp32 kernel (f32 x) and of the tensor-core
    kernel at 8 and 128 x rows per instruction with its reduce kernel (bf16 x).
    Fails unless bf16 runs on tensor cores without local memory."""
    from jacobiforcing_tpu_torch.ops import int4_matmul_cuda as i4c

    variants = i4c.variants()
    what = {"fp32": "fp32 CUDA-core tile (64 rows x 256 channels, K stages of 32)",
            "tc_n8": f"tensor cores (wgmma m64n8k16, weights dequantized into the register A "
                     f"operand; {i4c.TILE_P} packed columns per CTA, K stages of {i4c.STAGE_K})",
            "tc_n128": "tensor cores (wgmma m64n128k16, as n8)",
            "reduce": "chunk-ordered sum of the split route's fp32 partials"}
    cells = [f"{v['kernel']} {'f32' if v['dtype'] == 'float32' else 'bf16'}: {what[v['kernel']]}, "
             f"{v['threads']} threads {v['stages']} stages {v['registers']} regs "
             f"{v['local_bytes']} B local {v['static_smem'] + v['dynamic_smem']} B smem"
             for v in variants]
    log("[kernel-design] int4_matmul: " + "; ".join(cells))
    bad = [v for v in variants if v["dtype"] == "bfloat16" and (
        v["local_bytes"] or v["tensor_cores"] != v["kernel"].startswith("tc_"))]
    if bad or sum(v["tensor_cores"] for v in variants) != 2:
        raise AssertionError(f"int4_matmul: a bf16 kernel is not on tensor cores or uses local "
                             f"memory: {bad}")


def phase_int4_kernel(timing):
    from jacobiforcing_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_ref

    int4_kernel_design()

    # against the plain version: the JAX test's shape, ragged M and K, the 7B shapes
    shapes = [(16, 256, 1024), (3, 100, 96), (70, 37, 160)]
    shapes += [(M, K, N) for K, N in INT4_SHAPES.values() for M in INT4_ROWS]
    for n, (M, K, N) in enumerate(shapes):
        for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            c = make_int4_case(M, K, N, dtype, seed=9000 + n)
            out = int4_matmul(c["x"], c["wp"], c["scale"])
            torch.cuda.synchronize()
            err, worst, ok = check_int4(out, int4_matmul_ref(c["x"].float(), c["wp"], c["scale"]))
            log(f"[int4-kernel] {dname} M={M} K={K} N={N}: max_abs_err={err:.3e} "
                f"max err/tol={worst:.3f} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"int4 kernel disagrees with the plain version: M={M} K={K} N={N}")
    # a row's bits do not depend on how many rows come with it: M 4 takes the
    # split route (n8, partials summed by the reduce kernel), M 1536 the
    # unsplit one (n128, the chunks summed in registers)
    from jacobiforcing_tpu_torch.ops.int4_matmul_cuda import plan

    if plan(4, 3584, 512)[3] == plan(1536, 3584, 512)[3]:
        raise AssertionError("the bitwise-rows shape no longer takes both routes")
    c = make_int4_case(1536, 3584, 512, torch.bfloat16, seed=9100)
    full = int4_matmul(c["x"], c["wp"], c["scale"])
    few = int4_matmul(c["x"][700:704].contiguous(), c["wp"], c["scale"])
    same = torch.equal(bits(full[700:704]), bits(few))
    log(f"[int4-kernel] bitwise rows 700..703 of M=1536 == the same rows at M=4: {same} "
        f"{'ok' if same else 'FAIL'}")
    if not same:
        raise AssertionError("int4 kernel rows depend on M")

    # times (bf16) beside the bound, the plain version and, for orientation, one
    # GEMM on the pre-dequantized bf16 weight (which reads 4x the weight bytes;
    # no single PyTorch call computes this function from the packed layout)
    for sname, (K, N) in INT4_SHAPES.items():
        for M in INT4_ROWS:
            c = make_int4_case(M, K, N, torch.bfloat16, seed=9200)
            x, wp, scale = c["x"], c["wp"], c["scale"]
            ms = time_ms(lambda: int4_matmul(x, wp, scale), iters=10)
            plain = time_ms(lambda: int4_matmul_ref(x, wp, scale), iters=3)
            w_bf16 = c["wq"].to(torch.bfloat16)
            dense = time_ms(lambda: x @ w_bf16, iters=10)
            g_ms = graph_ms(lambda: int4_matmul(x, wp, scale))
            g_dense = graph_ms(lambda: x @ w_bf16)
            bms, by = int4_bound(M, K, N, torch.bfloat16)
            err, worst, ok = check_int4(int4_matmul(x, wp, scale),
                                        int4_matmul_ref(x.float(), wp, scale))
            log(f"[int4-kernel-time] {sname} M={M} K={K} N={N} bf16: kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, x @ W_bf16 on the pre-dequantized weight (4x the weight bytes) "
                f"{dense:.4f} ms, bound {bms:.5f} ms ({by}), {bms / ms * 100:.2f}% of bound, "
                f"{2 * M * K * N / ms / 1e9:.1f} TFLOP/s, max err/tol {worst:.3f} "
                f"{'ok' if ok else 'FAIL'}; in a CUDA graph (device time, no host work per "
                f"call): kernel {g_ms:.4f} ms ({bms / g_ms * 100:.2f}% of bound), x @ W_bf16 "
                f"{g_dense:.4f} ms")
            if not ok:
                raise AssertionError(f"int4 kernel disagrees at the timed shape {sname} M={M}")
            timing[f"int4_{sname}_M{M}"] = dict(ms=ms, plain_ms=plain, library_ms=None,
                                                bound_ms=bms, bound_by=by, max_abs_err=err)


# (name, rows, hidden, intermediate, query heads, KV heads, head_dim, qkv bias, q/k norm):
# coder7b-jacobi-closed32's trip (B 32 x L 64) and a prefill of 1024 rows;
# qwen3-8b-jacobi-poisson's widths at a trip of 2048 rows
POINTWISE_SHAPES = (("coder7b_trip", 2048, 3584, 18944, 28, 4, 128, True, False),
                    ("coder7b_prefill", 1024, 3584, 18944, 28, 4, 128, True, False),
                    ("qwen3_8b_trip", 2048, 4096, 12288, 32, 8, 128, False, True))
POINTWISE = ("add_rms_norm", "qkv_rope", "silu_mul")
# the inputs a timed call reads rotate through copies holding at least this
# many bytes, so that no call finds its inputs in the 50 MB L2
SPILL_L2_BYTES = 256e6


def ulps(a, b) -> int:
    """The most bf16 steps between a and b, element by element (-1 where a
    sign differs and neither is zero)."""
    ai, bi = (t.view(torch.int16).int() for t in (a, b))
    zero = (a == 0) | (b == 0)
    if not bool((((ai < 0) == (bi < 0)) | zero).all()):
        return -1
    return int(torch.where(zero, 0, (ai - bi).abs()).max())


def pointwise_inputs(R, H, I, NH, KH, D, bias, norm):
    """One set of random bf16 inputs of the three chains at one shape."""
    from jacobiforcing_tpu_torch.models import qwen as tq

    def bf16(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device="cuda")).to(torch.bfloat16)

    B, T = R // 64, 64
    cfg = tq.ModelConfig(hidden_size=H, num_heads=NH, num_kv_heads=KH, head_dim=D,
                         max_position=4096)
    cos_t, sin_t = tq.rope_table(cfg, device="cuda")
    pos = torch.randint(0, 4096, (B, T), device="cuda")
    x = dict(h=bf16(R, H), d=bf16(R, H), w=(1 + 0.1 * torch.randn(H, device="cuda")).bfloat16(),
             g=bf16(R, I, scale=3.0), u=bf16(R, I), q=bf16(B, T, NH, D, scale=4.0),
             k=bf16(B, T, KH, D, scale=4.0), v=bf16(B, T, KH, D, scale=4.0), cos=cos_t[pos],
             sin=sin_t[pos], qkv={})
    if bias:
        x["qkv"].update(bq=bf16(NH * D), bk=bf16(KH * D), bv=bf16(KH * D))
    if norm:
        x["qkv"].update(q_norm=(1 + 0.1 * torch.randn(D, device="cuda")).bfloat16(),
                        k_norm=(1 + 0.1 * torch.randn(D, device="cuda")).bfloat16())
    return x


def pointwise_chains(R, H, I, NH, KH, D, bias, norm):
    """{chain: (fused(x), plain(x), bytes the chain needs)} for inputs `x` of
    `pointwise_inputs`: each input read once, each output written once.  The
    plain calls are the plain functions of `models/qwen.py`."""
    from jacobiforcing_tpu_torch.models import qwen as tq
    from jacobiforcing_tpu_torch.ops import decoder_pointwise_cuda as dpc

    def plain_qkv(x):
        q, k, v, w = x["q"], x["k"], x["v"], x["qkv"]
        if bias:
            q, k, v = (t + w[n].reshape(-1, D) for t, n in ((q, "bq"), (k, "bk"), (v, "bv")))
        if norm:
            q, k = tq.rms_norm(q, w["q_norm"], 1e-6), tq.rms_norm(k, w["k_norm"], 1e-6)
        return tq.apply_rope(q, x["cos"], x["sin"]), tq.apply_rope(k, x["cos"], x["sin"]), v

    def plain_norm(x):
        s_ = x["h"] + x["d"]
        return s_, tq.rms_norm(s_, x["w"], 1e-6)

    qkv_bytes = 2 * R * (NH + KH) * D * 2 + (2 * R * KH * D * 2 if bias else 0) + 2 * R * D // 2 * 4
    return {
        "add_rms_norm": (lambda x: dpc.add_rms_norm_cuda(x["h"], x["w"], 1e-6, x["d"]),
                         plain_norm, 4 * R * H * 2 + H * 2),
        "qkv_rope": (lambda x: dpc.qkv_rope_cuda(x["q"], x["k"], x["v"], x["cos"], x["sin"], 1e-6,
                                                 **x["qkv"]), plain_qkv, qkv_bytes),
        "silu_mul": (lambda x: dpc.silu_mul_cuda(x["g"], x["u"]),
                     lambda x: torch.nn.functional.silu(x["g"].float()).to(torch.bfloat16) * x["u"],
                     3 * R * I * 2),
    }


def check_pointwise(chain, fused, plain, x, norm):
    """(max |fused - plain|, fault or None) of one chain on inputs `x`:
    silu_mul, the residual sum and bias + RoPE bit for bit; the norms within
    one bf16 ulp; with the q/k norm, the norm alone (RoPE at angle 0) within
    one ulp and the rotated values within 2^-6 of each pair's magnitude."""
    out, ref = fused(x), plain(x)
    out, ref = (out, ref) if isinstance(out, tuple) else ((out,), (ref,))
    err = max((o.float() - r.float()).abs().max().item() for o, r in zip(out, ref))
    if chain == "silu_mul" or (chain == "qkv_rope" and not norm):
        exact = all(torch.equal(o, r) for o, r in zip(out, ref))
        return err, None if exact else "not bit for bit"
    if chain == "add_rms_norm":
        if not torch.equal(out[0], ref[0]):
            return err, "the residual sum is not bit for bit"
        n = ulps(out[1], ref[1])
        return err, None if 0 <= n <= 1 else f"the norm is {n} ulps off"
    if not torch.equal(out[2], ref[2]):
        return err, "v is not bit for bit"
    flat = dict(x, cos=torch.ones_like(x["cos"]), sin=torch.zeros_like(x["sin"]))
    normed, ref_normed = fused(flat), plain(flat)
    n = max(ulps(a, b) for a, b in zip(normed[:2], ref_normed[:2]))
    if not 0 <= n <= 1:
        return err, f"the q/k norm is {n} ulps off"
    for o, r, y in zip(out[:2], ref[:2], ref_normed[:2]):
        half = y.shape[-1] // 2
        pair = (y[..., :half].float().abs() + y[..., half:].float().abs()).repeat(1, 1, 1, 2)
        if not bool(((o.float() - r.float()).abs() <= 2.0 ** -6 * pair).all()):
            return err, "rotated q/k beyond 2^-6 of the pair's magnitude"
    return err, None


def rotating(fn, sets):
    """`fn` on the next of `sets` at each call."""
    import itertools

    turn = itertools.count()
    return lambda: fn(sets[next(turn) % len(sets)])


def plain_forward(params, cfg, ids, positions, kv, tables, lens, rope):
    """`models.qwen.forward` with the plain functions only and every residual
    added at the end of its sub-layer, as before the fused kernels, each
    region in a `record_function` range named after it (the device time of
    the aten kernels launched in a range is the range's)."""
    from torch.profiler import record_function

    from jacobiforcing_tpu_torch.models import qwen as tq
    from jacobiforcing_tpu_torch.ops.attention import paged_attention
    from jacobiforcing_tpu_torch.ops.kv_cache import write_kv, write_plan

    B, T = ids.shape
    page, num_slots = kv.page_size, kv.num_slots
    pos_l = positions.long()
    eps = cfg.rms_norm_eps
    with record_function("embedding"):
        cos, sin = rope[0][pos_l], rope[1][pos_l]
        idx = torch.gather(tables, 1, (pos_l // page).clamp(0, tables.shape[1] - 1)).long()
        slots = torch.where(idx < 0, num_slots, idx * page + pos_l % page)
        plan = write_plan(slots, num_slots, kv.k.shape[1])
        h = tq.embed(params, cfg, ids)
    for i in range(cfg.num_layers):
        w = tq._layer_weights(params["layers"], i)
        with record_function(PLAIN_REGIONS["add_rms_norm"]):
            hn = tq.rms_norm(h, w["ln1"], eps)
        with record_function("linear layers (GEMMs)"):
            q, kk, vv = hn @ w["wq"], hn @ w["wk"], hn @ w["wv"]
        with record_function(PLAIN_REGIONS["qkv_rope"]):
            if cfg.qkv_bias:
                q, kk, vv = q + w["bq"], kk + w["bk"], vv + w["bv"]
            q, kk, vv = (t.reshape(B, T, -1, cfg.head_dim) for t in (q, kk, vv))
            if cfg.qk_norm:
                q, kk = tq.rms_norm(q, w["q_norm"], eps), tq.rms_norm(kk, w["k_norm"], eps)
            q, kk = tq.apply_rope(q, cos, sin), tq.apply_rope(kk, cos, sin)
        with record_function("KV writes"):
            write_kv(kv.k[i], kv.v[i], kk, vv, slots, plan)
        o = paged_attention(q, kv.k[i], kv.v[i], tables, lens, positions,
                            1.0 / math.sqrt(cfg.head_dim), page_size=page)
        with record_function("linear layers (GEMMs)"):
            a = o.reshape(B, T, -1) @ w["wo"]
        with record_function(PLAIN_REGIONS["add_rms_norm"]):
            h = h + a
            hn = tq.rms_norm(h, w["ln2"], eps)
        with record_function("linear layers (GEMMs)"):
            g, u = hn @ w["w_gate"], hn @ w["w_up"]
        with record_function(PLAIN_REGIONS["silu_mul"]):
            m = torch.nn.functional.silu(g.to(tq.acc_dtype(g.dtype))).to(u.dtype) * u
        with record_function("linear layers (GEMMs)"):
            m = m @ w["w_down"]
        with record_function(PLAIN_REGIONS["add_rms_norm"]):
            h = h + m
    with record_function(PLAIN_REGIONS["add_rms_norm"]):
        return tq.rms_norm(h, params["final_norm"], eps), kv


PLAIN_REGIONS = {"add_rms_norm": "norms (residual add + RMSNorm)",
                 "qkv_rope": "q/k/v bias, q/k norm, RoPE", "silu_mul": "SiLU * up"}
RANGES = {*PLAIN_REGIONS.values(), "linear layers (GEMMs)", "KV writes", "embedding",
          "greedy head"}
# device kernels by name: (class, substrings of the kernel's name)
KERNEL_CLASSES = (("GEMMs", ("gemm", "nvjet", "cutlass", "xmma")),
                  ("kernel 1", ("paged_attention",)),
                  *((c, (c + "_kernel",)) for c in POINTWISE),
                  ("aten elementwise", ("elementwise_kernel",)),
                  ("aten reduce", ("reduce_kernel",)))


def kernel_class(name):
    return next((c for c, keys in KERNEL_CLASSES if any(k in name for k in keys)), "other")


def profile_forward(forward, B=32, L=64, ctx=640, cfg=None):
    """One eager Jacobi forward of `forward` (`models.qwen.forward` or
    `plain_forward`) and its greedy head at Qwen2.5-7B widths (B 32 x L 64
    rows over `ctx` cached tokens), profiled after a warm call: (device ms
    by kernel class, device ms by `record_function` range, kernels)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from jacobiforcing_tpu_torch.models import qwen as tq
    from jacobiforcing_tpu_torch.ops.kv_cache import alloc_kv_cache

    cfg = cfg or tq.ModelConfig()
    params = full_width_params(cfg)
    rope = tq.rope_table(cfg, device="cuda")
    page = 256
    pages = -(-(ctx + L) // page)
    kv = alloc_kv_cache(cfg.num_layers, B * pages, page, cfg.num_kv_heads, cfg.head_dim,
                        device="cuda")
    tables = torch.arange(B * pages, dtype=torch.int32, device="cuda").reshape(B, pages)
    ids = torch.randint(0, cfg.vocab_size, (B, L), device="cuda")
    pos = (ctx - 1 + torch.arange(L, device="cuda", dtype=torch.int32))[None].expand(B, L)
    pos = pos.contiguous()
    lens = torch.full((B,), ctx - 1 + L, dtype=torch.int32, device="cuda")

    def trip():
        h, _ = forward(params, cfg, ids, pos, kv, tables, lens, rope)
        with record_function("greedy head"):
            tq.greedy_tokens(params, cfg, h)

    with torch.no_grad():
        trip()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trip()
            torch.cuda.synchronize()
    ev = prof.key_averages()
    # a range also appears as a device-side annotation spanning its kernels
    kernels = [e for e in ev if e.device_type == DeviceType.CUDA and e.key not in RANGES]
    by_class = {}
    for e in kernels:
        c = kernel_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + e.self_device_time_total / 1e3
    by_range = {e.key: e.device_time_total / 1e3 for e in ev
                if e.device_type == DeviceType.CPU and e.key in RANGES}
    del params, kv
    gc.collect()
    torch.cuda.empty_cache()
    return by_class, by_range, sum(e.count for e in kernels)


def launches_per_layer(cfg):
    """Kernels one eager prefill forward of one layer (B 1, T 512) launches
    through `models.qwen.forward` and through `plain_forward`, counted from
    the profiler's device records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jacobiforcing_tpu_torch.models import qwen as tq
    from jacobiforcing_tpu_torch.ops.kv_cache import alloc_kv_cache

    cfg = dataclasses.replace(cfg, num_layers=1, vocab_size=4096, max_position=4096)
    params = tq.init_params(cfg, 0, device="cuda")
    rope = tq.rope_table(cfg, device="cuda")
    kv = alloc_kv_cache(1, 4, 256, cfg.num_kv_heads, cfg.head_dim, device="cuda")
    ids = torch.randint(0, 4096, (1, 512), device="cuda")
    pos = torch.arange(512, device="cuda", dtype=torch.int32)[None]
    tables = torch.arange(4, dtype=torch.int32, device="cuda")[None]
    lens = torch.full((1,), 512, dtype=torch.int32, device="cuda")
    out = {}
    for name, forward in (("fused", tq.forward), ("plain", plain_forward)):
        with torch.no_grad():
            forward(params, cfg, ids, pos, kv, tables, lens, rope)  # warm
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                forward(params, cfg, ids, pos, kv, tables, lens, rope)
                torch.cuda.synchronize()
        out[name] = sum(e.count for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and e.key not in RANGES)
    return out


def phase_pointwise(timing):
    """The decoder layer's fused pointwise kernels against their plain chains
    at the benchmark cells' shapes (`check_pointwise`; a fault fails the
    phase), then timed beside them: event times (host work per call
    included) and device times from a CUDA graph of 20 calls, the inputs
    rotating through copies past the L2, each beside its least time (bytes /
    3.35 TB/s); the kernels one eager prefill layer launches, fused and
    plain; and one eager Jacobi forward's device time by kernel class, fused
    and plain, and by code region, plain."""
    from jacobiforcing_tpu_torch.models import qwen as tq

    torch.manual_seed(0)
    faults = []
    for sname, R, H, I, NH, KH, D, bias, norm in POINTWISE_SHAPES:
        shape = (R, H, I, NH, KH, D, bias, norm)
        chains = pointwise_chains(*shape)
        sets = [pointwise_inputs(*shape)
                for _ in range(math.ceil(SPILL_L2_BYTES / min(c[2] for c in chains.values())))]
        for chain, (fused, plain, nbytes) in chains.items():
            err, fault = check_pointwise(chain, fused, plain, sets[0], norm)
            if fault:
                faults.append(f"{chain} {sname}: {fault}")
            used = sets[:math.ceil(SPILL_L2_BYTES / nbytes)]
            ms, plain_ms = time_ms(rotating(fused, used)), time_ms(rotating(plain, used))
            g_ms, g_plain = graph_ms(rotating(fused, used)), graph_ms(rotating(plain, used))
            bms = nbytes / HBM_BYTES_PER_S * 1e3
            log(f"[pointwise-time] {chain} {sname} rows={R}: max |fused - plain| {err:.3g}"
                f"{' FAULT: ' + fault if fault else ''}; fused {ms:.4f} ms, plain chain "
                f"{plain_ms:.4f} ms; in a CUDA graph (device time, {len(used)} input sets): "
                f"fused {g_ms:.4f} ms ({bms / g_ms * 100:.1f}% of bound), plain chain "
                f"{g_plain:.4f} ms; bound {bms:.5f} ms (bytes, {nbytes / 1e6:.1f} MB)")
            timing[f"pointwise_{chain}_{sname}"] = dict(
                ms=ms, plain_ms=plain_ms, graph_ms=g_ms, graph_plain_ms=g_plain, bound_ms=bms,
                bound_by="bytes", max_abs_err=err, library_ms=None)
        del sets
        gc.collect()
        torch.cuda.empty_cache()
    if faults:
        raise AssertionError(f"pointwise kernels against their plain chains: {faults}")
    for name, cfg in (("coder7b", tq.ModelConfig()),
                      ("qwen3_8b", tq.ModelConfig(hidden_size=4096, intermediate_size=12288,
                                                  num_heads=32, num_kv_heads=8, qkv_bias=False,
                                                  qk_norm=True))):
        n = launches_per_layer(cfg)
        log(f"[pointwise-launches] {name}: a one-layer eager prefill forward (T 512) "
            f"launches {n['fused']} kernels fused, {n['plain']} plain")
    for name, forward in (("plain", plain_forward), ("fused", tq.forward), ("fused", tq.forward),
                          ("plain", plain_forward)):
        by_class, by_range, count = profile_forward(forward)
        total = sum(by_class.values())
        line = (f"[pointwise-attribution] {name}: one eager Jacobi forward + greedy head, "
                f"Qwen2.5-7B, B 32 x L 64, ctx 640: device {total:.2f} ms in {count} kernels; "
                f"by kernel: " + "; ".join(f"{k} {v:.2f} ms ({v / total * 100:.1f}%)"
                                          for k, v in sorted(by_class.items(),
                                                             key=lambda kv: -kv[1])))
        if name == "plain":
            line += "; by code region (aten kernels): " + "; ".join(
                f"{k} {v:.2f} ms" for k, v in by_range.items())
        log(line)


def phase_int8_gemm():
    """Orientation for `ops/quant.mm` (library products, no kernel of this
    repository): the int8 x int8 product `torch._int_mm` on a row-major and on
    a column-major weight (the engine re-lays W8A8 weights column-major,
    `ops/quant.int_mm_layout`), the bf16 GEMM, and the int8 -> bf16 cast that
    the weight-only path pays per call, at the gate/up shape."""
    K, N = INT4_SHAPES["gateup"]
    g = torch.Generator(device="cuda").manual_seed(9400)
    w_row = torch.randint(-127, 128, (K, N), generator=g, device="cuda", dtype=torch.int8)
    w_col = w_row.t().contiguous().t()
    w_bf16 = w_row.to(torch.bfloat16)
    cast = time_ms(lambda: w_row.to(torch.bfloat16), iters=10)
    for M in (32, 256, 1536):
        a = torch.randint(-127, 128, (M, K), generator=g, device="cuda", dtype=torch.int8)
        same = torch.equal(torch._int_mm(a, w_row), torch._int_mm(a, w_col))
        exact = torch.equal(torch._int_mm(a[:8].repeat(4, 1), w_col)[:8].double(),
                            a[:8].double() @ w_row.double())
        row = time_ms(lambda: torch._int_mm(a, w_row), iters=10)
        col = time_ms(lambda: torch._int_mm(a, w_col), iters=10)
        x = a.to(torch.bfloat16)
        dense = time_ms(lambda: x @ w_bf16, iters=10)
        log(f"[int8-gemm] M={M} K={K} N={N}: torch._int_mm row-major weight {row:.4f} ms, "
            f"column-major {col:.4f} ms, bf16 GEMM {dense:.4f} ms, int8 -> bf16 cast of the "
            f"weight {cast:.4f} ms; layouts agree: {same}, sums exact: {exact}")
        if not (same and exact):
            raise AssertionError("torch._int_mm is not exact on this card")


def phase_int4_path(launches_out):
    """The int4 building block is wired into no server (as in the JAX
    package), so its path is this: the seven linear layers of one Qwen2.5-7B
    decoder layer for a Jacobi block (M = 4 * 64 rows, bf16) through the
    dispatcher `int4_matmul`, launches counted from zero, each output finite
    and equal to the plain version's."""
    from jacobiforcing_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_ref
    from jacobiforcing_tpu_torch.ops.int4_matmul_cuda import int4_matmul_cuda

    layers = ["qo", "kv", "kv", "qo", "gateup", "gateup", "down"]  # wq wk wv wo gate up down
    int4_matmul_cuda.launches = 0
    worst_all = 0.0
    for i, sname in enumerate(layers):
        K, N = INT4_SHAPES[sname]
        c = make_int4_case(256, K, N, torch.bfloat16, seed=9300 + i)
        out = int4_matmul(c["x"], c["wp"], c["scale"])
        _, worst, ok = check_int4(out, int4_matmul_ref(c["x"].float(), c["wp"], c["scale"]))
        worst_all = max(worst_all, worst)
        if not ok or tuple(out.shape) != (256, N):
            raise AssertionError(f"int4 path: layer {i} ({sname}) is wrong")
    launches_out["int4_path"] = {"int4_matmul": int4_matmul_cuda.launches}
    log(f"[int4-path] one decoder layer's 7 linear layers at M=256, bf16: "
        f"{int4_matmul_cuda.launches} launches, worst err/tol {worst_all:.3f} ok")
    if int4_matmul_cuda.launches != len(layers):
        raise AssertionError("the int4 path did not launch the kernel once per layer")


# ---------------------------------------------------------------------------
# Phase `train_kernel`: the training-attention kernels (forward, dQ, dK/dV)
# ---------------------------------------------------------------------------


def make_train_case(L, P, T, seq_len, N, KH, G, D, dtype, variant, window, seed):
    """One packed row: random q [L,NH,D], k/v [L,KH,D] and an upstream
    gradient that is zero on the rows that take no part (at or past `seq_len`
    or past pair T), as the trainer's is: it gathers no such row."""
    r = np.random.RandomState(seed)
    f = lambda *shape: torch.from_numpy(r.randn(*shape).astype(np.float32)).to("cuda", dtype)
    tok = np.arange(L)
    live = (tok < seq_len) & ((tok < P) | ((tok - P) // N < 2 * T))
    dout = f(L, KH * G, D) * torch.from_numpy(live).to("cuda", dtype)[:, None, None]
    return dict(q=f(L, KH * G, D), k=f(L, KH, D), v=f(L, KH, D), dout=dout,
                live=torch.from_numpy(live).cuda(),
                layout=dict(prompt_len=P, T_pairs=T, seq_len=seq_len, N=N, variant=variant,
                            window_size=window))


def train_grads(fn, c, dtype=None):
    """(out, dq, dk, dv) of `fn` (the dispatcher or the plain version) on the
    case's inputs, cast to `dtype` first when given."""
    q, k, v = (c[n].to(dtype or c[n].dtype).detach().requires_grad_() for n in ("q", "k", "v"))
    out = fn(q, k, v, **c["layout"])
    dq, dk, dv = torch.autograd.grad(out, (q, k, v), c["dout"].to(out.dtype))
    return out.detach(), dq, dk, dv


def check_grad(out, ref):
    """(max_abs_err, worst err/tol, ok) of a gradient.  f32: |err| <= 2e-5 *
    max|ref| (sums of up to G*L products taken in another order than the
    plain version's GEMMs).  bf16: per element 2^-5 * |ref| + 2^-7 * max|ref|
    of its row, as `check`, + 2^-9 * max|ref| of the tensor: the kernels round
    dS to bf16 before dS.K and dS^T.Q, which shows where the reference cancels
    exactly (a row that sees a single key has P = 1 and dS = dP - delta = 0).
    delta = rowsum(dO * O) is taken from the bf16 O and its residual O_lo,
    so at float32 precision."""
    bf16 = out.dtype == torch.bfloat16
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    top = ref.abs().max().item()
    if bf16:
        tol = ref.abs() * 2.0**-5 + ref.abs().amax(-1, keepdim=True) * 2.0**-7 + top * 2.0**-9
    else:
        tol = torch.full_like(ref, 2e-5 * top)
    worst = (err / tol).max().item() if top > 0 else float(err.max().item() > 0)
    return err.max().item(), worst, bool(torch.isfinite(out).all()) and worst <= 1.0


def train_pairs(c, NH):
    """Visible (query token, key) pairs of the case's layout."""
    from jacobiforcing_tpu_torch.ops.train_attention import classify_tiles

    lay = c["layout"]
    return classify_tiles(c["q"].shape[0], lay["prompt_len"], lay["T_pairs"], lay["seq_len"],
                          lay["N"], lay["variant"], lay["window_size"],
                          NH // c["k"].shape[1]).visible_pairs


def train_bounds(c):
    """{kernel: (bound_ms, bound_by)}: each input read once, each output
    written once; 2*D operations per product, visible pair and query head:
    forward QK^T and PV; dQ recomputes S, takes dP and dQ; dK/dV recomputes
    S, takes dP, dV and dK.  bf16 adds out_lo: written by the forward, read
    by dQ, which also reads out (f32's dQ takes delta from P and dP, reads no
    out, and hands dK/dV sigma beside delta)."""
    q = c["q"]
    L, NH, D = q.shape
    KH = c["k"].shape[1]
    it = q.element_size()
    qb, kb, rowb = L * NH * D * it, L * KH * D * it, L * NH * 4
    lo = qb if q.dtype == torch.bfloat16 else 0
    sig = rowb if q.dtype == torch.float32 else 0  # f32: sigma beside delta
    pairs = train_pairs(c, NH)
    work = {"train_attention_fwd": (2 * qb + lo + 2 * kb + rowb, 2),  # q,k,v -> out,lse(,lo)
            # q,k,v(,out,lo),dO,lse -> dq,delta(,sigma)
            "train_attention_dq": (3 * qb + 2 * lo + 2 * kb + 2 * rowb + sig, 3),
            # q,k,v,dO,lse,delta(,sigma) -> dk,dv
            "train_attention_dkdv": (2 * qb + 4 * kb + 2 * rowb + sig, 4)}
    out = {}
    for name, (nbytes, products) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = products * 2 * D * pairs * NH / PEAK_OPS[q.dtype] * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def train_kernel_design():
    """The `[kernel-design]` line of the training kernels: which tile each
    (kernel, dtype, D) variant runs, with its registers, local bytes and
    shared memory.  Fails unless bf16 runs the tensor-core forward, dQ and
    dK/dV, float32 the fp32 forward, dQ and dK/dV (both dQ kernels take delta
    themselves: there is no delta kernel), and unless every bf16 variant (the
    reduce kernel included) uses no local memory."""
    from jacobiforcing_tpu_torch.ops import train_attention_cuda as tac

    variants = tac.variants()
    short = {"float32": "f32", "bfloat16": "bf16"}
    cells = [f"{v['kernel']} {short[v['dtype']]} D{v['D']} "
             f"{'tensor cores' if v['tensor_cores'] else 'fp32 tile'} {v['key_tile']}-key tiles "
             f"{v['threads']} threads {v['stages']} stages {v['registers']} regs "
             f"{v['local_bytes']} B local {v['static_smem'] + v['dynamic_smem']} B smem"
             for v in variants]
    log("[kernel-design] train_attention: " + "; ".join(cells))
    wrong = [v for v in variants
             if v["tensor_cores"] != (v["dtype"] == "bfloat16" and v["kernel"] in ("fwd", "dq", "dkdv"))
             or v["kernel"] == "delta" or (v["dtype"] == "bfloat16" and v["local_bytes"])]
    have = {(v["kernel"], v["dtype"]) for v in variants}
    want = {(n, "float32") for n in ("fwd", "dq", "dkdv")}
    want |= {(n, "bfloat16") for n in ("fwd", "dq", "dkdv", "dkdv_reduce")}
    if wrong or not want <= have:
        raise AssertionError(f"train_attention: a variant runs the wrong tile, a bf16 variant "
                             f"uses local memory, or a kernel is missing: {wrong}, "
                             f"missing {sorted(want - have)}")


LAYOUTS = [(1024, 100, 14, 996, 32, 2), (1024, 37, 6, 805, 64, 3), (768, 250, 16, 762, 16, 4),
           (1024, 128, 10, 896, 32, 2)]


def check_train_case(dname, dtype, sname, KH, G, D, variant, lay, seed, tag="train-kernel"):
    """Kernel 3 (forward, dQ, dK/dV through the dispatcher) against the plain
    version in float32 on one packed row: `check` / `check_grad`, bitwise
    repeat, zeros on rows that see nothing."""
    from jacobiforcing_tpu_torch.ops.train_attention import train_attention, train_attention_ref

    L, P, T, S, N, W = lay
    c = make_train_case(L, P, T, S, N, KH, G, D, dtype, variant, W, seed=seed)
    got = train_grads(train_attention, c)
    again = train_grads(train_attention, c)
    torch.cuda.synchronize()
    # the plain version in float32 on the same (rounded) inputs
    ref = train_grads(train_attention_ref, c, torch.float32)
    live = c["live"]
    res = [check(got[0][live], ref[0][live])]
    res += [check_grad(g, r) for g, r in zip(got[1:], ref[1:])]
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    same = all(torch.equal(bits(a), bits(b)) for a, b in zip(got, again))
    dead = got[0][~live]  # rows that see nothing: zeros, not NaN
    ok = all(r[2] for r in res) and finite and same and not bool(dead.any())
    desc = (f"{dname} {sname} {variant} L={L} P={P} T={T} seq_len={S} N={N}"
            + (f" W={W}" if variant == "window" else ""))
    log(f"[{tag}] {desc}: err/tol out {res[0][1]:.3f} dq {res[1][1]:.3f} "
        f"dk {res[2][1]:.3f} dv {res[3][1]:.3f} max_abs_err out {res[0][0]:.3e} "
        f"finite={finite} bitwise-repeat={same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"train kernel disagrees with the plain version: {desc}")


def phase_train_kernel(timing):
    train_kernel_design()

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    shapes = [("demo", 2, 2, 64), ("qwen7b", 4, 7, 128)]
    # LAYOUTS (L, prompt_len, T, seq_len, N, window): seq_len < L everywhere,
    # prompt lengths off every tile edge, N 16/32/64, and in the last T below
    # the pairs that seq_len holds (rows past pair T take no part)
    n = 0
    for dname, dtype in dtypes.items():
        for sname, KH, G, D in shapes:
            for variant in ("single", "multiblock", "window"):
                for lay in LAYOUTS:
                    check_train_case(dname, dtype, sname, KH, G, D, variant, lay, seed=7000 + n)
                    n += 1

    # times at the trainer's shapes: Qwen2.5-7B heads, bf16, `single`, N=32;
    # the f32 kernels at the demo's heads
    for name, (L, P, T) in {"L4096": (4096, 512, 56), "L16384": (16384, 1024, 240)}.items():
        train_kernel_times(timing, name, L, P, T, KH=4)
    train_kernel_f32_times(timing)


def train_kernel_f32_times(timing):
    """Kernel 3's float32 kernels (forward, dQ, dK/dV) timed at the demo
    model's heads (KH 2, G 2, D 64; the f32 training path) on packed rows of
    1024 and 4096 tokens (`single`, N 32) beside their bounds.  Uses only the
    wrappers' interface, so a parent tree's kernels time the same way
    (`compare PARENT train_f32_time`).  Records timing[f"{kernel}_f32_L{L}"]."""
    from jacobiforcing_tpu_torch.ops import train_attention_cuda as tac

    for L, P, T in ((1024, 128, 14), (4096, 512, 56)):
        c = make_train_case(L, P, T, L, 32, 2, 2, 64, torch.float32, "single", 4, seed=8100)
        q, k, v, dout = c["q"], c["k"], c["v"], c["dout"]
        layout = tuple(c["layout"].values())
        out, lse, out_lo = tac.train_attention_fwd_cuda(q, k, v, layout)
        dq, delta = tac.train_attention_dq_cuda(q, k, v, out, lse, dout, layout, out_lo)
        ms = {
            "train_attention_fwd": time_ms(lambda: tac.train_attention_fwd_cuda(q, k, v, layout)),
            "train_attention_dq": time_ms(
                lambda: tac.train_attention_dq_cuda(q, k, v, out, lse, dout, layout, out_lo)),
            "train_attention_dkdv": time_ms(
                lambda: tac.train_attention_dkdv_cuda(q, k, v, lse, delta, dout, layout)),
        }
        bounds = train_bounds(c)
        for kname, t in ms.items():
            bms, by = bounds[kname]
            log(f"[train-kernel-time f32] {kname} L={L}: {t:.4f} ms, bound {bms:.5f} ms ({by}); "
                f"P={P} T={T} N=32 single f32 D=64 KH=2 G=2")
            timing[f"{kname}_f32_L{L}"] = dict(ms=t, bound_ms=bms, bound_by=by)


def phase_train_tp_kernel(timing):
    """Kernel 3 at the launch shapes of tensor-parallel training, one rank's
    heads at TP 2: Qwen2.5-7B's (14 query, 2 KV heads, D 128) and the demo
    model's (2 query heads of 1 KV head, D 64), f32 and bf16, the three
    variants, against the plain version; then its times at Qwen2.5-7B's on L
    4096 (`single`, N 32) beside the bound, the plain version and SDPA."""
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    for seed0, (sname, KH, G, D) in ((7700, ("qwen7b KH=2", 2, 7, 128)),
                                     (7720, ("demo KH=1", 1, 2, 64))):
        n = 0
        for dname, dtype in dtypes.items():
            for variant in ("single", "multiblock", "window"):
                for lay in LAYOUTS[:2]:
                    check_train_case(dname, dtype, sname, KH, G, D, variant, lay,
                                     seed=seed0 + n, tag="train-tp-kernel")
                    n += 1
    train_kernel_times(timing, "kh2_L4096", 4096, 512, 56, KH=2, tag=" KH2")


def train_kernel_times(timing, name, L, P, T, KH, G=7, tag=""):
    """Kernel 3 (forward, dQ, dK/dV) timed on one packed row of L tokens
    (`single`, N 32, bf16, D 128, KH KV heads of G query heads each) beside
    its bound, the plain version and SDPA under a dense boolean mask; the
    outputs held to the float32 plain version (L <= 4096) or to SDPA.
    Records timing[f"{kernel}_{name}"]."""
    from jacobiforcing_tpu_torch.ops import train_attention_cuda as tac
    from jacobiforcing_tpu_torch.ops.train_attention import (
        train_attention, train_attention_ref, train_mask)

    sdpa = torch.nn.functional.scaled_dot_product_attention
    NH = KH * G
    c = make_train_case(L, P, T, L, 32, KH, G, 128, torch.bfloat16, "single", 4, seed=8000)
    q, k, v, dout = c["q"], c["k"], c["v"], c["dout"]
    layout = tuple(c["layout"].values())
    iters = 10 if L <= 4096 else 3
    out, lse, out_lo = tac.train_attention_fwd_cuda(q, k, v, layout)
    dq, delta = tac.train_attention_dq_cuda(q, k, v, out, lse, dout, layout, out_lo)
    ms = {
        "train_attention_fwd": time_ms(
            lambda: tac.train_attention_fwd_cuda(q, k, v, layout), iters),
        "train_attention_dq": time_ms(
            lambda: tac.train_attention_dq_cuda(q, k, v, out, lse, dout, layout, out_lo),
            iters),
        "train_attention_dkdv": time_ms(
            lambda: tac.train_attention_dkdv_cuda(q, k, v, lse, delta, dout, layout), iters),
    }
    # the plain version materialises [heads, L, L] scores: all heads at once
    # at L=4096, one query head at a time (times summed) at L=16384
    step = NH if L <= 4096 else 1
    plain_f = plain_fb = 0.0
    errs = {}
    got = train_grads(train_attention, c)
    ref_parts = []
    for h0 in range(0, NH, step):
        kv = slice(h0 // G, max(h0 // G + 1, (h0 + step) // G))
        part = dict(c, q=q[:, h0:h0 + step], k=k[:, kv], v=v[:, kv],
                    dout=dout[:, h0:h0 + step])
        pq, pk, pv = part["q"], part["k"], part["v"]
        plain_f += time_ms(lambda: train_attention_ref(pq, pk, pv, **c["layout"]), 2)
        plain_fb += time_ms(lambda: train_grads(train_attention_ref, part), 2)
        if L <= 4096:
            ref_parts = train_grads(train_attention_ref, part, torch.float32)
    if L <= 4096:  # the float32 reference fits only here; L=16384 is held to SDPA below
        res = [check(got[0], ref_parts[0])] + [check_grad(g, r)
                                                for g, r in zip(got[1:], ref_parts[1:])]
        errs = dict(zip(("out", "dq", "dk", "dv"), res))
    # one SDPA call on the same function: dense boolean mask, K/V repeated
    # to the query heads beforehand (neither is timed)
    idx = torch.arange(L, device="cuda", dtype=torch.int32)
    mask = train_mask(idx[:, None], idx[None, :], P, T, L, 32, "single", 4)[None, None]
    qt = q.transpose(0, 1)[None].contiguous().requires_grad_()
    kt = k.repeat_interleave(G, dim=1).transpose(0, 1)[None].contiguous().requires_grad_()
    vt = v.repeat_interleave(G, dim=1).transpose(0, 1)[None].contiguous().requires_grad_()
    dt = dout.transpose(0, 1)[None].contiguous()
    with torch.no_grad():
        lib_f = time_ms(lambda: sdpa(qt, kt, vt, attn_mask=mask), iters)
    lib_fb = time_ms(
        lambda: torch.autograd.grad(sdpa(qt, kt, vt, attn_mask=mask), (qt, kt, vt), dt), iters)
    with torch.no_grad():
        lib_out = sdpa(qt, kt, vt, attn_mask=mask)[0].transpose(0, 1)
    e_lib, w_lib, ok = check(got[0], lib_out)
    ok = ok and all(r[2] for r in errs.values())
    bounds = train_bounds(c)
    pairs = train_pairs(c, NH)
    log(f"[train-kernel-time{tag}] L={L} P={P} T={T} N=32 single bf16 D=128 KH={KH} G={G}: "
        f"{pairs} visible pairs of {L * L} ({pairs / L / L * 100:.1f}%); plain forward "
        f"{plain_f:.3f} ms, forward+backward {plain_fb:.3f} ms; sdpa forward {lib_f:.3f} ms, "
        f"forward+backward {lib_fb:.3f} ms; kernel out vs sdpa err/tol {w_lib:.3f}"
        + "".join(f", {k_} vs f32 plain err/tol {r[1]:.3f}" for k_, r in errs.items())
        + f" {'ok' if ok else 'FAIL'}")
    beside = {"train_attention_fwd": f"sdpa forward {lib_f:.3f} ms",
              "train_attention_dkdv": f"sdpa forward+backward {lib_fb:.3f} ms",
              "train_attention_dq": f"sdpa forward+backward {lib_fb:.3f} ms"}
    for kname, t in ms.items():
        bms, by = bounds[kname]
        log(f"[train-kernel-time{tag}]   {kname}: {t:.3f} ms, bound {bms:.4f} ms ({by}), "
            f"{bms / t * 100:.2f}% of bound; {beside[kname]}")
    log(f"[train-kernel-time{tag}]   backward (delta + dQ + dK/dV) "
        f"{ms['train_attention_dq'] + ms['train_attention_dkdv']:.3f} ms, "
        f"forward+backward {sum(ms.values()):.3f} ms")
    if not ok:
        raise AssertionError(f"train kernel disagrees at the timed shape L={L} KH={KH}")
    lib = {"train_attention_fwd": lib_f}
    plain = {"train_attention_fwd": plain_f, "train_attention_dq": plain_fb - plain_f,
             "train_attention_dkdv": plain_fb - plain_f}
    err_of = {"train_attention_fwd": "out", "train_attention_dq": "dq",
              "train_attention_dkdv": "dk"}
    for kname, t in ms.items():
        e = errs[err_of[kname]][0] if errs else e_lib
        timing[f"{kname}_{name}"] = dict(
            ms=t, plain_ms=plain[kname], library_ms=lib.get(kname), bound_ms=bounds[kname][0],
            bound_by=bounds[kname][1], max_abs_err=e)
    timing[f"train_sdpa_{name}"] = dict(forward=lib_f, forward_backward=lib_fb)


# ---------------------------------------------------------------------------
# Phases 3 and 4
# ---------------------------------------------------------------------------


class PlainOnCudaCounter:
    """Counts calls of the plain attentions (paged, speculative and the
    trainer's block-sparse one) on CUDA tensors from inside the port; there
    must be none.  Installed after the kernel phases, which call the plain
    versions on purpose."""

    def __init__(self):
        from jacobiforcing_tpu_torch.ops import attention, train_attention

        self.n = 0
        for name in ("paged_attention_ref", "paged_attention_with_block_ref"):
            setattr(attention, name, self._counting(getattr(attention, name)))
        train_attention.train_attention_ref = self._counting(train_attention.train_attention_ref)

    def _counting(self, orig):
        def wrapped(q, *a, **kw):
            self.n += int(q.is_cuda)
            return orig(q, *a, **kw)

        return wrapped


def _wrappers():
    from jacobiforcing_tpu_torch.ops import decoder_pointwise_cuda as dpc
    from jacobiforcing_tpu_torch.ops import train_attention_cuda as tac
    from jacobiforcing_tpu_torch.ops.int4_matmul_cuda import int4_matmul_cuda
    from jacobiforcing_tpu_torch.ops.paged_attention_cuda import paged_attention_cuda
    from jacobiforcing_tpu_torch.ops.spec_attention_cuda import spec_attention_cuda

    return {"paged_attention": paged_attention_cuda, "spec_attention": spec_attention_cuda,
            "int4_matmul": int4_matmul_cuda,
            "train_attention_fwd": tac.train_attention_fwd_cuda,
            "train_attention_dkdv": tac.train_attention_dkdv_cuda,
            "train_attention_dq": tac.train_attention_dq_cuda,
            "add_rms_norm": dpc.add_rms_norm_cuda, "qkv_rope": dpc.qkv_rope_cuda,
            "silu_mul": dpc.silu_mul_cuda}


def zero_counts(counter):
    for fn in _wrappers().values():
        fn.launches = 0
    counter.n = 0


def read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


MR_STATS = ("mr_full", "mr_nocand", "mr_ra_only", "mr_single")


def demo_llm(meta, **kw):
    from jacobiforcing_tpu_torch.engine.llm import LLM

    kw = dict(dict(kvcache_page_size=16, max_model_len=512, jacobi_chunk_tokens=64,
                   eos=int(meta["eos"]), prefill_token_buckets=(32, 64, 128, 256, 512),
                   num_kv_pages=1024), **kw)
    return LLM(model=DEMO, device=DEV, dtype=torch.float32, **kw)


def phase_demo(counter, launches_out):
    from jacobiforcing_tpu_torch.apps import bench_generate

    with open(os.path.join(DEMO, "tpf_demo.json")) as f:
        meta = json.load(f)

    def make_llm(**kw):
        return demo_llm(meta, **kw)

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_demo_", dir=os.path.join(REPO, "build"))
    streams, faults = {}, []
    llm = make_llm()  # the MR auto-policy is on by default
    # (run name, app strategy, engine): `mr` is N=32, K=2, pool 4 and the app's
    # default spawn ratio, once with the requested MR program forced and once
    # under the auto-policy
    runs = [("ar", "ar", llm), ("jacobi", "jacobi", llm), ("mr_policy_on", "mr", llm),
            ("mr_policy_off", "mr", None)]
    for name, strategy, run_llm in runs:
        if run_llm is None:
            run_llm = make_llm(jacobi_mr_auto_policy=False)
        engine = run_llm.engine
        args = bench_generate.make_parser().parse_args([])
        args.strategy = strategy
        args.n_token_seq_len = int(meta["block_len"])
        args.max_blocks = 2 if strategy == "mr" else 1
        args.n_gram_pool_size = 4
        args.max_new_tokens = int(meta["max_tokens"])
        args.max_iterations = 1 << 20
        args.dataset = os.path.join(DEMO, "heldout_prompts.jsonl")
        args.output_dir = os.path.join(out_dir, name)
        stats0 = dict(engine.stats)
        zero_counts(counter)
        t0 = time.perf_counter()
        agg, _ = bench_generate.run(args, engine=engine)
        dt = time.perf_counter() - t0
        launches = launches_out[f"demo_{name}"] = read_counts()
        with open(os.path.join(args.output_dir, f"generations_{strategy}.jsonl")) as f:
            streams[name] = [json.loads(line)["token_ids"] for line in f]
        line = (f"[demo] {name}: total_tokens={agg['total_tokens']} "
                f"eos={agg['n_eos_terminated']}/{agg['n_examples']} "
                f"aggregate_tpf={agg['aggregate_tokens_per_forward']} wall={dt:.2f}s; "
                f"kernel launches {launches}; plain attention calls on CUDA: {counter.n}")
        if strategy == "mr":
            delta = {k: engine.stats.get(k, 0) - stats0.get(k, 0)
                     for k in ("jacobi_iterations",) + MR_STATS}
            line += f"; {delta}; policy {engine.mr_policy_snapshot()}"
        log(line)
        if (agg["total_tokens"], agg["n_eos_terminated"], agg["n_examples"]) != (DEMO_TOKENS, 64, 64):
            faults.append(f"{name}: {agg['total_tokens']} tokens (want {DEMO_TOKENS}), "
                          f"{agg['n_eos_terminated']}/{agg['n_examples']} EOS (want 64/64)")
        if launches["paged_attention"] <= 0 or counter.n:
            faults.append(f"{name} did not go through the kernels alone")
        if strategy != "mr" and launches["spec_attention"]:
            faults.append(f"{name} launched the speculative kernel")
        if name == "mr_policy_off":
            # each T the speculative kernel serves is launched on a real path
            idle = [k for k in ("mr_full", "mr_nocand", "mr_ra_only") if delta[k] <= 0]
            if idle or launches["spec_attention"] <= 0:
                faults.append(f"{name}: MR tiers {idle} never ran "
                              f"({launches['spec_attention']} speculative launches)")
            run_llm.exit()
    for name in ("jacobi", "mr_policy_on", "mr_policy_off"):
        diff = [i for i, (a, b) in enumerate(zip(streams["ar"], streams[name])) if a != b]
        log(f"[demo] ar == {name} on {len(streams['ar'])} prompts: {not diff} "
            f"(rows differing: {diff})")
        if diff:
            faults.append(f"ar and {name} streams differ in rows {diff}")
    llm.exit()
    if faults:
        raise AssertionError("demo checkpoint: " + "; ".join(faults))


# The JAX package's runs of the quantized demo engines in f32 on the CPU
# (`python -m tests.torch_quant_demo_anchors`): greedy Jacobi, N=32, all 64
# held-out prompts -> (tokens, EOS); and tokens per prompt of the first 16.
_LENS16 = [18, 43, 23, 21, 25, 51, 39, 19, 28, 53, 22, 17, 25, 17, 20, 31]
DEMO_QUANT_ANCHORS = {
    "int8": dict(kw=dict(quantization="int8"), tokens=2015, eos=64, first16=_LENS16),
    "w8a8": dict(kw=dict(quantization="w8a8"), tokens=2029, eos=64, first16=_LENS16),
    "fp8": dict(kw=dict(kv_cache_dtype="fp8"), tokens=2026, eos=64,
                first16=[18, 43, 23, 21, 25, 51, 39, 19, 28, 53, 20, 17, 19, 17, 20, 31]),
    "int8kv": dict(kw=dict(kv_cache_dtype="int8"), tokens=2033, eos=64, first16=_LENS16),
    # reached through kv_dtype= alone, as in the JAX engine; its count is a gate
    "e5m2": dict(kw=dict(kv_dtype=torch.float8_e5m2), tokens=2002, eos=64,
                 first16=[18, 43, 23, 21, 25, 51, 39, 19, 28, 47, 22, 17, 22, 17, 20, 31],
                 gate=True),
}


def phase_demo_quant(counter, launches_out):
    """The demo checkpoint in f32 served quantized: int8 and W8A8 weights, an
    fp8 e4m3, an int8 and an fp8 e5m2 KV cache (five engines).  Inside each:
    greedy Jacobi on all 64 held-out prompts, `ar` and `mr` (K=2, pool 4,
    policy off) on the first 16; the three streams must be identical token
    for token (gate).  Tokens, EOS count and TPF are printed beside the JAX
    package's CPU run of the same configuration; a count that differs is
    reported with the first prompt whose length differs, and fails the phase
    where the anchor is a gate (e5m2)."""
    from jacobiforcing_tpu_torch.config import SamplingParams

    with open(os.path.join(DEMO, "tpf_demo.json")) as f:
        meta = json.load(f)
    with open(os.path.join(DEMO, "heldout_prompts.jsonl")) as f:
        prompts = [json.loads(line)["prompt_ids"] for line in f]
    n, block, eos_id = int(meta["max_tokens"]), int(meta["block_len"]), int(meta["eos"])

    def sp(strategy, blocks=1):
        return SamplingParams(temperature=0.0, max_tokens=n, decode_strategy=strategy,
                              jacobi_block_len=block, jacobi_max_blocks=blocks,
                              jacobi_n_gram_pool_size=4, jacobi_max_iterations=1 << 20)

    faults = []
    for name, anchor in DEMO_QUANT_ANCHORS.items():
        llm = demo_llm(meta, jacobi_mr_auto_policy=False, **anchor["kw"])
        eng = llm.engine
        runs = {}
        for run, strategy, blocks, k in (("jacobi", "jacobi", 1, 64), ("ar", "autoregressive", 1, 16),
                                         ("mr", MR, 2, 16)):
            stats0 = dict(eng.stats)
            zero_counts(counter)
            t0 = time.perf_counter()
            # one request at a time, as bench_generate serves them
            outs = [eng.generate([p], sp(strategy, blocks))[0]["token_ids"] for p in prompts[:k]]
            dt = time.perf_counter() - t0
            launches = launches_out[f"demo_{name}_{run}"] = read_counts()
            iters = eng.stats["jacobi_iterations"] - stats0["jacobi_iterations"]
            runs[run] = outs
            toks = sum(len(o) for o in outs)
            n_eos = sum(bool(o) and o[-1] == eos_id for o in outs)
            line = (f"[demo-quant] {name} {run}: {k} prompts, total_tokens={toks} eos={n_eos}/{k} "
                    f"wall={dt:.2f}s; kernel launches "
                    f"{ {key: v for key, v in launches.items() if v} }; plain attention calls on "
                    f"CUDA: {counter.n}")
            if run != "ar":
                line += f"; {iters} iterations, aggregate_tpf={toks / max(iters, 1):.4f}"
            if run == "mr":
                line += f"; tiers { {t: eng.stats.get(t, 0) - stats0.get(t, 0) for t in MR_STATS[:3]} }"
            if run == "jacobi":
                same = (toks, n_eos) == (anchor["tokens"], anchor["eos"])
                line += (f"; the JAX package on the CPU: {anchor['tokens']} tokens, "
                         f"{anchor['eos']}/64 EOS: {'equal' if same else 'DIFFERS'}")
                if not same:
                    lens = [len(o) for o in outs[:16]]
                    first = next((i for i, (a, b) in enumerate(zip(lens, anchor["first16"]))
                                  if a != b), None)
                    line += (f" (first prompt of the first 16 whose length differs: {first}; "
                             f"lengths {lens} against {anchor['first16']})")
                    if anchor.get("gate"):
                        faults.append(f"{name}: {toks} tokens, {n_eos}/64 EOS against the JAX "
                                      f"anchor {anchor['tokens']}, {anchor['eos']}/64")
            log(line)
            if launches["paged_attention"] <= 0 or counter.n:
                faults.append(f"{name} {run} did not go through the kernels alone")
            if (run == "mr") != (launches["spec_attention"] > 0):
                faults.append(f"{name} {run}: {launches['spec_attention']} speculative launches")
        for other in ("ar", "mr"):
            diff = [i for i, (a, b) in enumerate(zip(runs["jacobi"], runs[other])) if a != b]
            log(f"[demo-quant] {name}: jacobi == {other} on {len(runs[other])} prompts: {not diff} "
                f"(rows differing: {diff})")
            if diff:
                faults.append(f"{name}: jacobi and {other} streams differ in rows {diff}")
        assert eng.kv.scaled == (name in ("fp8", "int8kv", "e5m2"))
        llm.exit()
    if faults:
        raise AssertionError("quantized demo engines: " + "; ".join(faults))


# The JAX package's runs in f32 on the CPU (`python -m
# tests.torch_sampling_demo_anchors`): the demo checkpoint's non-greedy Jacobi
# at temperature 0.7 (N=32, max_tokens 96, 64 held-out prompts one at a time)
# for engine seeds 0 / 1 / 2 -> (tokens, EOS, TPF); greedy on-policy collection
# of the 64 prompts in one call -> rows, tokens, iterations; validate_learning
# at its defaults with the tiny model at head_dim 64 (the port app's) -> TPF
# before and after.
NONGREEDY_ANCHORS = {0: (2057, 64, 4.6225), 1: (2044, 64, 4.4435), 2: (2022, 64, 4.4735)}
COLLECT_ANCHOR = dict(rows=87, tokens=2033, iterations=550)
LEARNING_ANCHOR = dict(tpf_before=1.0753, tpf_after=1.1982)


def onpolicy_kernel_check():
    """Kernel 1 at the on-policy forward's shape against its plain version:
    L + 1 query rows from position cur_len - 1, cache_lens = cur_len +
    remaining with `remaining` ragged in [1, L], so the tail rows sit past
    cache_lens.  Every row, the tail's too, must agree (rules of `check`);
    f32 and bf16, the demo's heads (D 64, KH 2, G 2, L 32) and Qwen2.5-7B's
    (D 128, KH 4, G 7, L 64)."""
    for (KH, G, D, L, page), dtype in [(h, d) for h in ((2, 2, 64, 32, 16), (4, 7, 128, 64, 256))
                                       for d in (torch.float32, torch.bfloat16)]:
        c = make_case(4, L + 1, KH, G, D, page, 700, dtype, seed=D + L)
        r = np.random.RandomState(L)
        cur = c["clen"] - L  # >= 1: make_case draws lengths >= L + 1
        c["pos"] = (cur - 1)[:, None] + torch.arange(L + 1, device="cuda", dtype=torch.int32)
        c["clen"] = cur + torch.from_numpy(r.randint(1, L + 1, size=4).astype(np.int32)).cuda()
        err, worst, ok = check(run_kernel(c), run_plain(c))
        log(f"[sampling] on-policy shape, kernel 1 vs plain: D={D} KH={KH} G={G} rows {L + 1} "
            f"{str(dtype)[6:]}: cache_lens {c['clen'].tolist()}, last positions "
            f"{c['pos'][:, -1].tolist()}; max_abs_err {err:.3g}, err/tol {worst:.3f}: "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel 1 at the on-policy shape D={D} {dtype}: err/tol {worst}")


def phase_sampling(counter, launches_out):
    """Kernel 1 at the on-policy forward's shape (`onpolicy_kernel_check`),
    then the rejection-sampling and on-policy decoders on the demo checkpoint
    in f32, each run with every kernel count zeroed before it and read after
    it (it fails unless the paged kernel ran and no plain attention ran on
    CUDA):
      * non-greedy top_k=1 on all 64 held-out prompts == the `ar` stream
        (2033 tokens, 64/64 EOS);
      * greedy on-policy collection (`collect_trajectories`, N 32, max_tokens
        96) of the 64 prompts in one call: final sequences == the `ar`
        streams, every snapshot 32 long, rows == the JAX CPU anchor;
      * non-greedy at temperature 0.7 through `bench_generate.run`: tokens,
        EOS and TPF beside the JAX CPU seed spread, >= 1 token per iteration
        per request, and the same seed twice gives the same stream;
      * 512 first tokens of non-greedy against AR sampling at temperature 1.0:
        TV < max(2 x AR-vs-AR noise, noise + 0.08);
      * the demo checkpoint served W8A8: non-greedy top_k=1 == that engine's
        greedy stream on 16 prompts;
      * `apps/validate_learning` at its defaults on the card: TPF before and
        after, improvement > 1 where the JAX CPU run shows one."""
    from jacobiforcing_tpu_torch.apps import bench_generate, validate_learning
    from jacobiforcing_tpu_torch.config import SamplingParams
    from jacobiforcing_tpu_torch.data import collect_trajectories

    with open(os.path.join(DEMO, "tpf_demo.json")) as f:
        meta = json.load(f)
    with open(os.path.join(DEMO, "heldout_prompts.jsonl")) as f:
        prompts = [json.loads(line)["prompt_ids"] for line in f]
    n, L, eos_id = int(meta["max_tokens"]), int(meta["block_len"]), int(meta["eos"])
    faults = []
    onpolicy_kernel_check()

    def counted(name, fn):
        """Run `fn` with the kernel counts zeroed; print and check its launches."""
        zero_counts(counter)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launches_out[f"sampling_{name}"] = read_counts()
        log(f"[sampling] {name}: wall {dt:.2f}s; kernel launches "
            f"{ {k: v for k, v in launches.items() if v} }; plain attention calls on CUDA: "
            f"{counter.n}")
        if launches["paged_attention"] <= 0 or counter.n or launches["spec_attention"]:
            faults.append(f"{name} did not go through the paged kernel alone")
        return out

    def sp(**kw):
        base = dict(temperature=0.7, max_tokens=n, decode_strategy="jacobi_nongreedy",
                    jacobi_block_len=L, jacobi_max_blocks=1, jacobi_max_iterations=1 << 20)
        base.update(kw)
        return SamplingParams(**base)

    def one_by_one(llm, params):
        return [llm.engine.generate([p], params)[0]["token_ids"] for p in prompts]

    def streams_equal(name, got, want):
        diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        toks = sum(len(o) for o in got)
        n_eos = sum(bool(o) and o[-1] == eos_id for o in got)
        log(f"[sampling] {name}: {len(got)} prompts, total_tokens={toks} eos={n_eos}/{len(got)}; "
            f"== the greedy stream: {not diff} (rows differing: {diff})")
        if diff or len(got) != len(want):
            faults.append(f"{name}: streams differ from the greedy stream in rows {diff}")
        return toks, n_eos

    llm = demo_llm(meta)
    ar = counted("demo ar", lambda: one_by_one(llm, sp(temperature=0.0,
                                                        decode_strategy="autoregressive")))
    ng1 = counted("demo nongreedy top_k=1",
                  lambda: one_by_one(llm, sp(temperature=0.7, top_k=1)))
    if streams_equal("demo nongreedy top_k=1", ng1, ar) != (DEMO_TOKENS, 64):
        faults.append(f"demo nongreedy top_k=1: want {DEMO_TOKENS} tokens, 64/64 EOS")

    rows = counted("demo greedy on-policy collection",
                   lambda: collect_trajectories(llm.engine, prompts, block_len=L, max_tokens=n))
    final = {r["data_id"]: r["teacher_output_ids"] for r in rows}
    got = [final[f"data_{i}"][len(p):] for i, p in enumerate(prompts)]
    streams_equal("demo greedy on-policy collection (final sequences)", got, ar)
    iters = sum(len(r["answer_trajectory_ids"]) - 1 for r in rows)
    toks = sum(len(g) for g in got)
    lens_ok = all(len(s) == L for r in rows for s in r["answer_trajectory_ids"])
    log(f"[sampling] demo greedy on-policy collection: {len(rows)} rows, {toks} tokens, {iters} "
        f"iterations (TPF {toks / max(iters, 1):.4f}); every snapshot {L} long: {lens_ok}; the "
        f"JAX package on the CPU: {COLLECT_ANCHOR['rows']} rows, {COLLECT_ANCHOR['tokens']} "
        f"tokens, {COLLECT_ANCHOR['iterations']} iterations")
    if not lens_ok or len(rows) != COLLECT_ANCHOR["rows"]:
        faults.append(f"greedy collection: {len(rows)} rows (want {COLLECT_ANCHOR['rows']}), "
                      f"snapshots of length {L}: {lens_ok}")
    llm.exit()

    # non-greedy at temperature 0.7 through the app, seed 0 twice
    spread = sorted(a[2] for a in NONGREEDY_ANCHORS.values())
    runs = []
    for rep in range(2):
        llm = demo_llm(meta, seed=0)
        args = bench_generate.make_parser().parse_args([])
        args.strategy, args.temperature = "nongreedy", 0.7
        args.n_token_seq_len, args.max_blocks = L, 1
        args.max_new_tokens, args.max_iterations = n, 1 << 20
        args.dataset = os.path.join(DEMO, "heldout_prompts.jsonl")
        args.output_dir = tempfile.mkdtemp(prefix="chip_smoke_ng_", dir=os.path.join(REPO, "build"))
        agg, profiles = counted(f"demo nongreedy T=0.7 seed 0, run {rep + 1}",
                                lambda: bench_generate.run(args, engine=llm.engine))
        with open(os.path.join(args.output_dir, "generations_nongreedy.jsonl")) as f:
            runs.append([json.loads(line)["token_ids"] for line in f])
        shutil.rmtree(args.output_dir, ignore_errors=True)
        slow = [p["index"] for p in profiles if p["new_tokens"] < p["total_iterations"]]
        log(f"[sampling] demo nongreedy T=0.7 seed 0, run {rep + 1}: total_tokens="
            f"{agg['total_tokens']} eos={agg['n_eos_terminated']}/{agg['n_examples']} "
            f"aggregate_tpf={agg['aggregate_tokens_per_forward']}; the JAX package on the CPU, "
            f"seeds 0 / 1 / 2: {list(NONGREEDY_ANCHORS.values())} (tokens, EOS, TPF; TPF "
            f"{spread[0]}-{spread[-1]}); requests with fewer tokens than iterations: {slow}")
        if slow:
            faults.append(f"nongreedy T=0.7: requests {slow} committed < 1 token per iteration")
        llm.exit()
    log(f"[sampling] demo nongreedy T=0.7: the same seed gave the same stream: "
        f"{runs[0] == runs[1]}")
    if runs[0] != runs[1]:
        faults.append("nongreedy T=0.7: one seed gave two streams")

    # the first-token marginal against AR sampling at temperature 1.0
    def first_tokens(seed, params, k=512, batch=64):
        llm = demo_llm(meta, seed=seed)
        out = []
        for _ in range(k // batch):
            out += [o["token_ids"][0] for o in llm.generate([prompts[0]] * batch, params)]
        llm.exit()
        return out

    def tv(a, b):
        ha = np.bincount(a, minlength=256) / len(a)
        hb = np.bincount(b, minlength=256) / len(b)
        return 0.5 * float(np.abs(ha - hb).sum())

    sp_ar = sp(temperature=1.0, max_tokens=3, decode_strategy="autoregressive")
    ar1 = counted("demo TV: ar T=1.0 seed 0", lambda: first_tokens(0, sp_ar))
    ar2 = counted("demo TV: ar T=1.0 seed 1", lambda: first_tokens(1, sp_ar))
    rs = counted("demo TV: nongreedy T=1.0 seed 2",
                 lambda: first_tokens(2, sp(temperature=1.0, max_tokens=3)))
    noise, dist = tv(ar1, ar2), tv(ar1, rs)
    ok = dist < max(2.0 * noise, noise + 0.08)
    log(f"[sampling] demo first-token TV, 512 samples each: nongreedy vs ar {dist:.4f}, ar vs ar "
        f"(noise) {noise:.4f}; {len(set(ar1))} distinct first tokens; within max(2 x noise, "
        f"noise + 0.08): {ok}")
    if not ok:
        faults.append(f"TV {dist:.4f} against noise {noise:.4f}")

    # the demo checkpoint served W8A8
    llm = demo_llm(meta, quantization="w8a8")
    greedy = counted("demo w8a8 jacobi", lambda: [
        llm.engine.generate([p], sp(temperature=0.0, decode_strategy="jacobi"))[0]["token_ids"]
        for p in prompts[:16]])
    ng = counted("demo w8a8 nongreedy top_k=1", lambda: [
        llm.engine.generate([p], sp(top_k=1))[0]["token_ids"] for p in prompts[:16]])
    streams_equal("demo w8a8 nongreedy top_k=1", ng, greedy)
    llm.exit()

    # the whole JacobiForcing loop at the app's defaults
    res = counted("validate_learning", lambda: validate_learning.run(
        validate_learning.make_parser().parse_args(["--device", DEV])))
    want_gain = LEARNING_ANCHOR["tpf_after"] > LEARNING_ANCHOR["tpf_before"]
    log(f"[sampling] validate_learning at its defaults: tpf_before {res['tpf_before']}, "
        f"tpf_after {res['tpf_after']}, improvement {res['improvement']}, history "
        f"{res['history']}; the JAX package on the CPU: {LEARNING_ANCHOR}")
    if want_gain and not res["improvement"] > 1:
        faults.append(f"validate_learning: no TPF gain ({res})")
    if faults:
        raise AssertionError("sampling: " + "; ".join(faults))


def full_width_sps():
    from jacobiforcing_tpu_torch.config import SamplingParams

    return {
        "autoregressive": SamplingParams(temperature=0.0, max_tokens=128),
        "jacobi": SamplingParams(temperature=0.0, max_tokens=128, decode_strategy="jacobi",
                                 jacobi_block_len=64, jacobi_max_iterations=1 << 20),
        "mr": SamplingParams(temperature=0.0, max_tokens=128, decode_strategy=MR,
                             jacobi_block_len=64, jacobi_max_blocks=2,
                             jacobi_n_gram_pool_size=4, jacobi_max_iterations=1 << 20),
        # rejection-sampling Jacobi: the memory-light verify (V = 152,064 runs
        # chunked_token_logprob over 5 vocab chunks) and the top-k route over
        # [B, L-1, V]; on-policy rollouts (2 blocks of 64)
        "nongreedy": SamplingParams(temperature=0.7, max_tokens=128,
                                    decode_strategy="jacobi_nongreedy", jacobi_block_len=64,
                                    jacobi_max_iterations=1 << 20),
        "nongreedy_top_k50": SamplingParams(temperature=0.7, top_k=50, max_tokens=128,
                                            decode_strategy="jacobi_nongreedy",
                                            jacobi_block_len=64, jacobi_max_iterations=1 << 20),
        "on_policy": SamplingParams(temperature=0.7, max_tokens=128,
                                    decode_strategy="jacobi_on_policy", jacobi_block_len=64,
                                    jacobi_max_iterations=1 << 20),
    }


GREEDY_PATHS = ("autoregressive", "jacobi", "mr")


def serve_paths(tag, llm, prompts, sps, counter, shape_out):
    """Drive one full-width engine: prefill alone (one token each, timed apart
    from decode; the prefix cache then holds the prompts' full pages for every
    strategy), then each strategy of `sps`.  Every kernel's launch count is
    zeroed before each path and read after it.  Returns (streams, launches,
    plain attention calls on CUDA) by path and fails if a path did not run
    through the kernels alone (a bfloat16 model's path also through each
    fused pointwise kernel) or a request came up short."""
    from jacobiforcing_tpu_torch.config import SamplingParams

    streams, launches, plain_on_cuda = {}, {}, {}
    zero_counts(counter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    llm.generate(prompts, SamplingParams(temperature=0.0, max_tokens=1))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches["prefill"], plain_on_cuda["prefill"] = read_counts(), counter.n
    log(f"[{tag}] prefill of 4 prompts (2560 tokens, cold) {prefill_ms:.1f} ms; kernel launches "
        f"{launches['prefill']}; plain attention calls on CUDA: {counter.n}")
    peak = torch.cuda.max_memory_allocated()
    for strategy, sp in sps.items():
        stats0 = dict(llm.stats)
        zero_counts(counter)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs = llm.generate(prompts, sp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        path_peak = torch.cuda.max_memory_allocated()
        peak = max(peak, path_peak)
        launches[strategy], plain_on_cuda[strategy] = read_counts(), counter.n
        streams[strategy] = [o["token_ids"] for o in outs]
        toks = sum(len(s) for s in streams[strategy])
        delta = {k: llm.stats.get(k, 0) - stats0.get(k, 0) for k in llm.stats}
        iters, fwds, steps = delta["jacobi_iterations"], delta["chunk_forwards"], delta["ar_steps"]
        line = (f"[{tag}] {strategy}: {toks} tokens in {wall:.3f}s = {toks / wall:.2f} tok/s "
                f"(prompts' full pages prefix-cached; the rest prefilled in the wall)")
        if strategy == "autoregressive":
            line += f"; {steps} AR steps = {steps / wall:.2f} steps/s"
        else:
            line += (f"; {iters} row-iterations, {fwds} batched forwards = "
                     f"{fwds / wall:.2f} iterations/s, TPF {toks / max(iters, 1):.3f}")
        if strategy == "mr":
            # a random model's n-gram pool seldom hits, so mr_full may be 0
            # here; the kernel phase and the demo checkpoint cover that shape
            tiers = {k: delta.get(k, 0) for k in MR_STATS[:3]}
            line += f"; tiers {tiers}"
            # the timed shape that stands for this path: its most frequent tier
            shape_out["mr_main_shape"] = {
                "mr_ra_only": "T64", "mr_nocand": "T128", "mr_full": "T384",
            }[max(tiers, key=tiers.get)]
        log(line + f"; peak memory {path_peak / 2**30:.2f} GiB; kernel launches "
            f"{launches[strategy]}; plain attention calls on CUDA: {counter.n}")
    for other in [name for name in ("jacobi", "mr") if name in sps and "autoregressive" in sps]:
        pairs = list(zip(streams["autoregressive"], streams[other]))
        match = [sum(x == y for x, y in zip(a[:128], b[:128])) / max(min(len(a), len(b), 128), 1)
                 for a, b in pairs]
        first_diff = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
                      for a, b in pairs]
        log(f"[{tag}] AR vs {other} first-128-token match rate per request: "
            f"{[round(m, 4) for m in match]} (first differing index {first_diff}); bf16 "
            f"near-ties on a random model make this a reported number, not a gate")
    log(f"[{tag}] peak torch.cuda.max_memory_allocated = {peak / 2**30:.2f} GiB")
    lens_ok = all(len(s) == 128 for v in streams.values() for s in v)
    missed = [p for p in launches if launches[p]["paged_attention"] <= 0 or plain_on_cuda[p]]
    if "mr" in sps and launches["mr"]["spec_attention"] <= 0:
        missed.append("mr (speculative kernel)")
    if any(launches[p]["spec_attention"] for p in launches if p != "mr"):
        missed.append("a non-MR path launched the speculative kernel")
    if llm.engine.model_cfg.dtype == torch.bfloat16:
        missed += [f"{p} (no {name} launch)" for p in launches for name in POINTWISE
                   if launches[p][name] <= 0]
    if missed or not lens_ok:
        raise AssertionError(f"{tag}: paths {missed} did not run through the kernels alone, "
                             f"or a request came up short of 128 tokens ({lens_ok=})")
    return streams, launches, plain_on_cuda


def alternating_rates(llm, prompts, sps, names):
    """Host-bound paths jump between runs, so compare them in turns: each of
    `names` once forward and once backward (J N K O O K N J for four), with
    iterations/s, TPF and peak memory of every run on a line."""
    rates = {name: [] for name in names}
    for name in list(names) + list(names)[::-1]:
        stats0 = dict(llm.stats)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs = llm.generate(prompts, sps[name])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fwds = llm.stats["chunk_forwards"] - stats0["chunk_forwards"]
        iters = llm.stats["jacobi_iterations"] - stats0["jacobi_iterations"]
        toks = sum(len(o["token_ids"]) for o in outs)
        rates[name].append(fwds / wall)
        log(f"[sampling] full width in turns, {name}: {fwds / wall:.2f} iterations/s, "
            f"{toks / wall:.2f} tok/s, TPF {toks / max(iters, 1):.3f}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    base = sum(rates[names[0]]) / len(rates[names[0]])
    log("[sampling] full width in turns, mean iterations/s against " + names[0] + ": " + ", ".join(
        f"{n} {sum(r) / len(r):.2f} ({sum(r) / len(r) / base:.3f}x)" for n, r in rates.items()))


def full_width_prompts(cfg):
    r = np.random.RandomState(0)
    return [r.randint(0, cfg.vocab_size, size=n).tolist() for n in (256, 512, 768, 1024)]


def phase_full_width(counter, launches_out):
    from jacobiforcing_tpu_torch.engine.llm import LLM
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig

    torch.cuda.reset_peak_memory_stats()
    cfg = ModelConfig()
    t0 = time.perf_counter()
    params = full_width_params(cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for v in params.values()
                   for t in (v.values() if isinstance(v, dict) else [v]))
    log(f"[full] Qwen2.5-7B widths: {n_params / 1e9:.3f}B random bf16 params in "
        f"{time.perf_counter() - t0:.1f}s")
    # MR runs the requested program (auto-policy off), so every MR iteration
    # goes through the speculative kernel; the option touches no other strategy
    llm = LLM(device="cuda", model_cfg=cfg, params=params, num_kv_pages=512,
              kvcache_page_size=256, eos=-1, jacobi_mr_auto_policy=False)
    prompts = full_width_prompts(cfg)
    sps = full_width_sps()
    _, launches, _ = serve_paths("full", llm, prompts, sps, counter, launches_out)
    for name in ("nongreedy", "nongreedy_top_k50", "on_policy"):
        log(f"[sampling] full width {name}: paged-kernel launches "
            f"{launches[name]['paged_attention']}, speculative {launches[name]['spec_attention']}")
    alternating_rates(llm, prompts, sps, ("jacobi", "nongreedy", "nongreedy_top_k50", "on_policy"))
    for name in ("jacobi", "mr", "nongreedy"):
        profile_decode(llm, prompts, name, sps[name])
    llm.exit()
    del llm  # the KV pool goes; the weights stay for the `train` phase
    launches_out.update(launches)
    return params


def full_width_params(cfg):
    """Random bf16 weights of `cfg` on the card, from seed 0."""
    from jacobiforcing_tpu_torch.models.qwen import init_params

    return init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")


def phase_full_quant(counter, launches_out, params=None):
    """Qwen2.5-7B widths with narrow storage.  First the bf16 weights of the
    `full` phase (`params`, or the same draw) with an fp8 e5m2 KV cache under
    `jacobi` and `mr`; then int8 weights from `init_quantized_params` (seed
    0): W8A8 with an fp8 e4m3 KV cache under `ar`, `jacobi` and `mr`, then
    weight-only int8 with an int8 KV cache under `jacobi`.  The launches of
    each path are kept under `bf16_e5m2_<path>`, `w8a8_fp8_<path>` and
    `int8_int8_<path>`.  Everything this phase made is freed at the end."""
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig
    from jacobiforcing_tpu_torch.ops.quant import init_quantized_params

    cfg = ModelConfig()
    prompts = full_width_prompts(cfg)
    sps = {k: v for k, v in full_width_sps().items() if k in GREEDY_PATHS}
    bf16 = params if params is not None else full_width_params(cfg)
    full_quant_engine(counter, launches_out, "bf16_e5m2", cfg, bf16, prompts,
                      dict(kv_dtype=torch.float8_e5m2), {k: sps[k] for k in ("jacobi", "mr")},
                      profile=False)
    del bf16
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    params = init_quantized_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                                   device="cuda")
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for _, t in param_items(params))
    log(f"[full-quant] Qwen2.5-7B widths: random int8 weights with bf16 scales, "
        f"{nbytes / 2**30:.2f} GiB, in {time.perf_counter() - t0:.1f}s ({held:.2f} GiB held by "
        f"earlier phases)")
    engines = [("w8a8_fp8", dict(quantization="w8a8", kv_cache_dtype="fp8"), sps),
               ("int8_int8", dict(quantization="int8", kv_cache_dtype="int8"),
                {"jacobi": sps["jacobi"]})]
    for tag, kw, paths in engines:
        full_quant_engine(counter, launches_out, tag, cfg, params, prompts, kw, paths)
    del params
    gc.collect()
    torch.cuda.empty_cache()


def full_quant_engine(counter, launches_out, tag, cfg, params, prompts, kw, paths, profile=True):
    """One engine of `phase_full_quant`: its KV pool, `serve_paths` over
    `paths` (launches kept under `<tag>_<path>`) and, with `profile`, a
    profiled decode of each non-AR path."""
    from jacobiforcing_tpu_torch.engine.llm import LLM

    llm = LLM(device=DEV, model_cfg=cfg, params=params, num_kv_pages=512,
              kvcache_page_size=256, eos=-1, jacobi_mr_auto_policy=False, **kw)
    kvc = llm.engine.kv
    pool = sum(t.numel() * t.element_size() for t in (kvc.k, kvc.v, kvc.k_scale, kvc.v_scale))
    log(f"[full-quant] {tag}: KV pool of 512 pages x 256 slots stored as {kvc.k.dtype} with "
        f"float32 row scales, {pool / 2**30:.2f} GiB; act_quant={llm.engine.model_cfg.act_quant}")
    shapes = {}
    _, launches, _ = serve_paths(f"full-quant {tag}", llm, prompts, paths, counter, shapes)
    for path, counts in launches.items():
        launches_out[f"{tag}_{path}"] = counts
    launches_out.update({f"{tag}_{k}": v for k, v in shapes.items()})
    if profile:
        for name in paths:
            if name != "autoregressive":
                profile_decode(llm, prompts, name, paths[name], tag=f"{tag} ")
    llm.exit()
    del llm, kvc
    gc.collect()
    torch.cuda.empty_cache()


def profile_decode(llm, prompts, name, sp, tag=""):
    """Where the device time of serving one strategy goes: torch.profiler over
    4 requests (prefill + 12 new tokens each, block 64; the trace of a longer
    run takes the profiler minutes to digest), device kernel time
    summed by kernel name (the attention kernels, int8 GEMMs, other GEMMs,
    copies and dtype casts, the rest), and the device's busy share of the
    wall."""
    from dataclasses import replace

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sp = replace(sp, max_tokens=12)
    # prompts that are not prefix-cached and share no first page between the
    # strategies (the reversed prompt rotated by k: its pages hash apart)
    k = ("jacobi", "mr", "nongreedy").index(name)
    prompts = [p[::-1][k:] + p[::-1][:k] for p in prompts]
    fwd0 = llm.stats["chunk_forwards"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        llm.generate(prompts, sp)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    fwds = llm.stats["chunk_forwards"] - fwd0
    kernels = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # CPU ops also carry their kernels' time
            continue
        t = e.self_device_time_total / 1e3  # us -> ms
        if t > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + t
    busy = sum(kernels.values())
    groups = {"paged_attention (this repo's kernel)": 0.0,
              "spec_attention (this repo's kernel)": 0.0, "int8 GEMM (cuBLASLt)": 0.0,
              "GEMM (cuBLAS)": 0.0, "copies and dtype casts": 0.0, "other": 0.0}
    for kname, t in kernels.items():
        low = kname.lower()
        if "paged_attention" in low:
            groups["paged_attention (this repo's kernel)"] += t
        elif "spec_attention" in low:
            groups["spec_attention (this repo's kernel)"] += t
        elif any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma")):
            int8 = any(w in low for w in ("i8", "s8", "int8", "imma", "igemm"))
            groups["int8 GEMM (cuBLASLt)" if int8 else "GEMM (cuBLAS)"] += t
        elif "copy" in low or "memcpy" in low:
            groups["copies and dtype casts"] += t
        else:
            groups["other"] += t
    log(f"[profile] {tag}{name}, 4 requests x 12 new tokens, {fwds} batched forwards: wall "
        f"{wall_ms:.1f} ms under the profiler, device busy {busy:.1f} ms "
        f"({busy / wall_ms * 100:.1f}% of wall, idle {100 - busy / wall_ms * 100:.1f}%)")
    for g, t in groups.items():
        log(f"[profile]   {g}: {t:.2f} ms ({t / max(busy, 1e-9) * 100:.1f}% of device time)")
    for kname, t in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   top kernel {t:8.2f} ms  {kname[:110]}")


# ---------------------------------------------------------------------------
# Phase `engine`: the serving host path (pipeline, CUDA graphs, bench_engine)
# ---------------------------------------------------------------------------

# name: (Config.enforce_eager, Config.jacobi_async_host)
ENGINE_MODES = {"eager-sync": (True, False), "graph-sync": (False, False),
                "graph-async": (False, True)}


def _sync():
    if DEV == "cuda":
        torch.cuda.synchronize()


def graph_summary(tag, engine):
    """One line: the engine's captured graphs, each bucket's capture time and
    graph-pool growth, and the kernel launches inside each graph."""
    progs = engine.programs
    per = ", ".join(f"{'/'.join(map(str, k))} {progs.capture_s[k]:.2f}s "
                    f"{progs.pool_bytes[k] / 2**20:.1f} MiB {progs.launches[k][0]} paged"
                    for k in progs.capture_s)
    log(f"[{tag}] {progs.num_graphs} CUDA graphs captured, pool "
        f"{sum(progs.pool_bytes.values()) / 2**20:.1f} MiB in all (memory_reserved growth "
        f"across each capture): {per or 'none'}")


def engine_demo(counter, launches_out):
    """The demo checkpoint in f32 on the default engine (graphs, async):
    `ar`, `jacobi` and `mr` (policy on) through `bench_generate.run`, 2033
    tokens, 64/64 EOS, Jacobi TPF in [4.55, 4.85]; `jacobi` again on the
    eager synchronous engine, whose chunk_forwards is printed beside."""
    from jacobiforcing_tpu_torch.apps import bench_generate

    with open(os.path.join(DEMO, "tpf_demo.json")) as f:
        meta = json.load(f)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_engine_", dir=os.path.join(REPO, "build"))
    faults, fwds = [], {}
    for mode, strategies in (("graph-async", ("jacobi", "ar", "mr")), ("eager-sync", ("jacobi",))):
        eager, async_on = ENGINE_MODES[mode]
        llm = demo_llm(meta, enforce_eager=eager, jacobi_async_host=async_on)
        for strategy in strategies:
            engine = llm.engine
            args = bench_generate.make_parser().parse_args([])
            args.strategy = strategy
            args.n_token_seq_len = int(meta["block_len"])
            args.max_blocks = 2 if strategy == "mr" else 1
            args.n_gram_pool_size = 4
            args.max_new_tokens = int(meta["max_tokens"])
            args.max_iterations = 1 << 20
            args.dataset = os.path.join(DEMO, "heldout_prompts.jsonl")
            args.output_dir = os.path.join(out_dir, f"{mode}-{strategy}")
            fw0 = engine.stats["chunk_forwards"]
            zero_counts(counter)
            t0 = time.perf_counter()
            agg, _ = bench_generate.run(args, engine=engine)
            dt = time.perf_counter() - t0
            launches = launches_out[f"engine_demo_{mode}_{strategy}"] = read_counts()
            fwds[(mode, strategy)] = engine.stats["chunk_forwards"] - fw0
            tpf = agg["aggregate_tokens_per_forward"]
            log(f"[engine-demo] {mode} {strategy}: total_tokens={agg['total_tokens']} "
                f"eos={agg['n_eos_terminated']}/{agg['n_examples']} aggregate_tpf={tpf} "
                f"chunk_forwards={fwds[(mode, strategy)]} wall={dt:.2f}s; graphs "
                f"{engine.programs.num_graphs}; kernel launches {launches}; plain attention "
                f"calls on CUDA: {counter.n}")
            if (agg["total_tokens"], agg["n_eos_terminated"]) != (DEMO_TOKENS, 64):
                faults.append(f"{mode} {strategy}: {agg['total_tokens']} tokens, "
                              f"{agg['n_eos_terminated']}/64 EOS")
            if strategy == "jacobi" and not 4.55 <= tpf <= 4.85:
                faults.append(f"{mode} jacobi TPF {tpf} outside [4.55, 4.85]")
            if launches["paged_attention"] <= 0 or counter.n:
                faults.append(f"{mode} {strategy} did not go through the kernels alone")
        if not eager:
            graph_summary("engine-demo", llm.engine)
        llm.exit()
    # both engines start `jacobi` from the same generator state
    log(f"[engine-demo] jacobi chunk_forwards: graph-async {fwds[('graph-async', 'jacobi')]}, "
        f"eager-sync {fwds[('eager-sync', 'jacobi')]} (the random draft tails' draws may "
        f"differ, the tokens may not)")
    shutil.rmtree(out_dir, ignore_errors=True)
    if faults:
        raise AssertionError("engine demo: " + "; ".join(faults))


def trip_device_ms(engine):
    """Wrap every program of `engine` so that each trip (graph replay or
    eager trip) is bracketed by CUDA events; returns a function giving the
    summed device milliseconds between the brackets so far.  For a graph
    replay that is the graph's execution; for an eager trip it includes the
    gaps the host leaves between launches."""
    pairs = []

    def bracket(fn):
        def call():
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            pairs.append((a, b))
            return out
        return call

    for prog in engine.programs.programs.values():
        if hasattr(prog, "trip"):
            prog.trip = bracket(prog.trip)
        else:
            prog.step = bracket(prog.step)

    def total():
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs)

    return total


def profile_busy(llm, prompts, sp):
    """(wall ms, device busy ms summed over the profiler's kernel records,
    paged-kernel ms, paged-kernel records) of one run under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        llm.generate(prompts, sp)
        _sync()
        wall = (time.perf_counter() - t0) * 1e3
    busy = paged = 0.0
    n_paged = 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = e.self_device_time_total / 1e3
        busy += t
        if "paged_attention" in e.key.lower():
            paged += t
            n_paged += e.count
    return wall, busy, paged, n_paged


def engine_full_width(counter, launches_out, cfg, params):
    """Qwen2.5-7B widths, bf16, 4 requests, block 64, 128 new tokens, `ar`
    and `jacobi` on three engines (eager-sync, graph-sync, graph-async):
    token match against the eager engine (must be 1.0), equal loop trips,
    iterations/s in turns, the device's busy share, graphs and memory."""
    from dataclasses import replace

    from jacobiforcing_tpu_torch.engine.llm import LLM

    prompts = full_width_prompts(cfg)
    sps = {k: v for k, v in full_width_sps().items() if k in ("autoregressive", "jacobi")}
    zero_counts(counter)
    llms = {}
    for mode, (eager, async_on) in ENGINE_MODES.items():
        if DEV == "cuda":
            torch.cuda.reset_peak_memory_stats()
        llms[mode] = LLM(device=DEV, model_cfg=cfg, params=params, num_kv_pages=64,
                         kvcache_page_size=256, eos=-1, enforce_eager=eager,
                         jacobi_async_host=async_on)
        t0 = time.perf_counter()
        tags = llms[mode].warmup(strategies=("ar", "jacobi"), block_lens=(64,),
                                 batch_buckets=(4,), prefill_token_buckets=(1024,))
        _sync()
        peak = torch.cuda.max_memory_allocated() / 2**30 if DEV == "cuda" else float("nan")
        log(f"[engine-full] {mode}: warmup {time.perf_counter() - t0:.1f}s {tags}; peak memory "
            f"{peak:.2f} GiB")
        if not eager:
            graph_summary("engine-full", llms[mode].engine)
    streams, trips, faults = {}, {}, []
    for strategy, sp in sps.items():
        for mode, llm in llms.items():
            stats0 = dict(llm.stats)
            zero_counts(counter)
            _sync()
            t0 = time.perf_counter()
            outs = llm.generate(prompts, sp)
            _sync()
            wall = time.perf_counter() - t0
            launches = launches_out[f"engine_{mode}_{strategy}"] = read_counts()
            streams[(mode, strategy)] = [o["token_ids"] for o in outs]
            key = "ar_steps" if strategy == "autoregressive" else "chunk_forwards"
            trips[(mode, strategy)] = llm.stats[key] - stats0[key]
            log(f"[engine-full] {mode} {strategy}: {trips[(mode, strategy)]} {key} in "
                f"{wall:.3f}s; kernel launches {launches}; plain attention calls on CUDA: "
                f"{counter.n}")
            if launches["paged_attention"] <= 0 or counter.n:
                faults.append(f"{mode} {strategy} did not go through the kernels alone")
        for mode in ("graph-sync", "graph-async"):
            ref, got = streams[("eager-sync", strategy)], streams[(mode, strategy)]
            rate = [sum(x == y for x, y in zip(a, b)) / max(len(a), 1) for a, b in zip(ref, got)]
            same_trips = trips[(mode, strategy)] == trips[("eager-sync", strategy)]
            log(f"[engine-full] {strategy} {mode} against eager-sync: token match rate per request "
                f"{[round(r, 4) for r in rate]}; loop trips {trips[(mode, strategy)]} vs "
                f"{trips[('eager-sync', strategy)]} ({'equal' if same_trips else 'DIFFER'})")
            if min(rate) < 1.0 or not same_trips:
                faults.append(f"{strategy} {mode}: match {min(rate)}, trips equal {same_trips}")
    # iterations/s (AR steps/s) in turns: E GS GA GA GS E
    order = list(ENGINE_MODES) + list(ENGINE_MODES)[::-1]
    for strategy, sp in sps.items():
        key = "ar_steps" if strategy == "autoregressive" else "chunk_forwards"
        rates = {m: [] for m in ENGINE_MODES}
        for mode in order:
            llm = llms[mode]
            n0 = llm.stats[key]
            _sync()
            t0 = time.perf_counter()
            llm.generate(prompts, sp)
            _sync()
            rates[mode].append((llm.stats[key] - n0) / (time.perf_counter() - t0))
        base = sum(rates["eager-sync"]) / 2
        log(f"[engine-rate] {strategy} in turns (E GS GA GA GS E), iterations/s: " + "; ".join(
            f"{m} {', '.join(f'{r:.2f}' for r in rs)} (mean {sum(rs) / 2:.2f}, "
            f"{sum(rs) / 2 / base:.3f}x eager-sync)" for m, rs in rates.items()))
    # the device's busy share: torch.profiler's kernel records over a
    # 12-token Jacobi run; for the graph engines also CUDA events around
    # each replay (the profiler may not see kernels inside a graph)
    sp12 = replace(sps["jacobi"], max_tokens=12)
    for mode, llm in llms.items():
        if DEV != "cuda":
            continue
        wall, busy, paged, n_paged = profile_busy(llm, prompts, sp12)
        line = (f"[engine-busy] {mode} jacobi 4 x 12 tokens: wall {wall:.1f} ms under the "
                f"profiler, kernel records {busy:.1f} ms = {busy / wall * 100:.1f}% busy; "
                f"paged_attention {paged:.2f} ms in {n_paged} records")
        measure = trip_device_ms(llm.engine)
        _sync()
        t0 = time.perf_counter()
        llm.generate(prompts, sp12)
        _sync()
        wall2 = (time.perf_counter() - t0) * 1e3
        trip_ms = measure()
        what = "graph replays" if mode != "eager-sync" else "eager trip spans (host gaps included)"
        log(line + f"; without the profiler: wall {wall2:.1f} ms, {what} {trip_ms:.1f} ms = "
            f"{trip_ms / wall2 * 100:.1f}% of wall")
    for llm in llms.values():
        llm.exit()
    if DEV == "cuda":
        log(f"[engine-full] peak torch.cuda.max_memory_allocated since the last engine: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if faults:
        raise AssertionError("engine full width: " + "; ".join(faults))


def engine_bench(cfg, params):
    """`apps/bench_engine.run_engine_bench` at Qwen2.5-7B widths: Jacobi, B 8,
    prompt 512, 128 new tokens, L 64, chunk_iters 8, 16 requests; random bf16
    weights on eager-sync, graph-sync and graph-async, then the app's default
    W8A8 model with an fp8 KV cache on graph-async.  Each result is a JSON
    line of its own."""
    from jacobiforcing_tpu_torch.apps.bench_engine import run_engine_bench

    kw = dict(B=8, prompt_len=512, max_tokens=128, L=64, chunk_iters=8, requests=16,
              device=DEV)
    runs = [(mode, dict(model_cfg=cfg, params=params)) for mode in ENGINE_MODES]
    runs.append(("graph-async", dict(kv_cache_dtype="fp8")))
    for mode, extra in runs:
        eager, async_on = ENGINE_MODES[mode]
        os.environ["JF_ENFORCE_EAGER"] = "1" if eager else "0"
        os.environ["JF_ASYNC_HOST"] = "1" if async_on else "0"
        t0 = time.perf_counter()
        try:
            out = run_engine_bench(**{**kw, **extra})
        finally:
            os.environ.pop("JF_ENFORCE_EAGER")
            os.environ.pop("JF_ASYNC_HOST")
        gc.collect()
        log(f"[engine-bench] {mode} {'bf16' if 'params' in extra else 'W8A8 + fp8 KV'}: "
            f"{time.perf_counter() - t0:.1f}s with its warmup")
        log(json.dumps({"mode": mode, **out}))


class RecordingBlockManager:
    """Delegates to an engine's block manager and records every call that
    allocates, grows or frees: (call, sequence by order of first appearance,
    arguments, result, the sequence's page table after it), and the host
    seconds spent inside the manager."""

    def __init__(self, bm):
        self.bm, self.events, self.seconds, self._ids = bm, [], 0.0, {}

    def __getattr__(self, name):  # page_size, num_free_pages, ...
        return getattr(self.bm, name)

    def _call(self, name, seq, *args, record=True):
        t0 = time.perf_counter()
        out = getattr(self.bm, name)(seq, *args)
        self.seconds += time.perf_counter() - t0
        if record:
            sid = self._ids.setdefault(seq.seq_id, len(self._ids))
            self.events.append((name, sid, args, out, tuple(seq.block_table)))
        return out

    def can_allocate(self, seq, margin_tokens=0):
        return self._call("can_allocate", seq, margin_tokens)

    def allocate_prompt(self, seq, margin_tokens=0):
        return self._call("allocate_prompt", seq, margin_tokens)

    def ensure_capacity(self, seq, upto_tokens):
        return self._call("ensure_capacity", seq, upto_tokens)

    def deallocate(self, seq):
        return self._call("deallocate", seq)

    def capacity_tokens(self, seq):
        return self._call("capacity_tokens", seq, record=False)


def engine_block_managers(counter, launches_out):
    """The Python and the native (C++) block manager in turns (P N N P) on
    the same requests: the demo checkpoint in f32 on the default engine, the
    64 held-out prompts in one `generate` (greedy Jacobi, N 32).  Every run's
    tokens and every allocate / grow / free call's page table must equal the
    first run's; iterations/s, wall ms per engine step and the manager's own
    host ms per step are printed for each."""
    from jacobiforcing_tpu_torch.engine.block_manager import BlockManager
    from jacobiforcing_tpu_torch.engine.native_block_manager import NativeBlockManager

    with open(os.path.join(DEMO, "tpf_demo.json")) as f:
        meta = json.load(f)
    prompts = demo_prompts()
    sp = demo_sps(meta, ("jacobi",))["jacobi"]
    runs, faults = [], []
    for kind in ("python", "native", "native", "python"):
        os.environ["JF_NATIVE_BM"] = "1" if kind == "native" else "0"
        try:
            llm = demo_llm(meta)
        finally:
            os.environ.pop("JF_NATIVE_BM")
        eng = llm.engine
        want = NativeBlockManager if kind == "native" else BlockManager
        if type(eng.block_manager) is not want:
            faults.append(f"{kind}: the engine took {type(eng.block_manager).__name__}")
        rec = RecordingBlockManager(eng.block_manager)
        eng.block_manager = eng.scheduler.block_manager = rec
        steps = [0]
        step = eng.step

        def counted_step():
            steps[0] += 1
            return step()

        eng.step = counted_step
        fw0 = eng.stats["chunk_forwards"]
        zero_counts(counter)
        _sync()
        t0 = time.perf_counter()
        outs = llm.generate(prompts, sp)
        _sync()
        wall = time.perf_counter() - t0
        launches = read_counts()
        fwds = eng.stats["chunk_forwards"] - fw0
        streams = [o["token_ids"] for o in outs]
        runs.append((kind, streams, rec.events))
        log(f"[engine-bm] {kind} block manager: {sum(len(t) for t in streams)} tokens, "
            f"{fwds} batched forwards in {wall:.3f}s = {fwds / wall:.2f} iterations/s; "
            f"{steps[0]} engine steps, {wall / steps[0] * 1e3:.3f} ms wall per step, "
            f"{rec.seconds / steps[0] * 1e3:.4f} ms per step inside the block manager "
            f"({len(rec.events)} allocate / grow / free calls); kernel launches "
            f"{launches['paged_attention']} paged; plain attention calls on CUDA: {counter.n}")
        if launches["paged_attention"] <= 0 or counter.n:
            faults.append(f"{kind} did not go through the kernels alone")
        llm.exit()
    first = runs[0]
    for i, (kind, streams, events) in enumerate(runs[1:], 1):
        same_tokens = streams == first[1]
        same_tables = events == first[2]
        log(f"[engine-bm] run {i} ({kind}) against run 0 (python): tokens equal {same_tokens}, "
            f"page tables equal over {len(events)} calls {same_tables}")
        if not (same_tokens and same_tables):
            faults.append(f"run {i} ({kind}): tokens equal {same_tokens}, tables equal "
                          f"{same_tables}")
    if faults:
        raise AssertionError("block managers: " + "; ".join(faults))


def phase_engine(counter, launches_out, params=None):
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params

    engine_demo(counter, launches_out)
    engine_block_managers(counter, launches_out)
    cfg = ModelConfig()
    if params is None:
        params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    engine_full_width(counter, launches_out, cfg, params)
    engine_bench(cfg, params)
    return params


# ---------------------------------------------------------------------------
# Phase `apps`: the chat apps, the grid sweep, the TPF demo trainer, legacy CLLM
# ---------------------------------------------------------------------------


class ByteTokenizer:
    """Byte-level tokenizer of the demo's 256-token vocabulary: a string's
    latin-1 bytes are its ids, and ids decode back to the same string (the
    held-out prompts, decoded, encode to themselves)."""

    eos_token_id = 2

    def encode(self, text):
        return list(text.encode("latin-1"))

    def decode(self, ids):
        return bytes(ids).decode("latin-1")


def post_generate(port, prompt, max_tokens):
    """The ndjson events of one POST /generate to the chat server."""
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"prompt": prompt, "max_tokens": max_tokens}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return [json.loads(line) for line in resp if line.strip()]


def apps_chat(counter, launches_out, meta):
    """`chat_web.serve` on the demo checkpoint with `ByteTokenizer`: the page,
    then 4 held-out prompts POSTed to /generate over HTTP, whose streamed
    text must equal blocking generation on the same engine; then
    `jacobi_stream_chat`, streamed == blocking on 4 more prompts."""
    import threading
    import urllib.request

    from jacobiforcing_tpu_torch.apps import chat_web
    from jacobiforcing_tpu_torch.apps.chat_stream import jacobi_stream_chat
    from jacobiforcing_tpu_torch.config import SamplingParams

    tok = ByteTokenizer()
    n, block = int(meta["max_tokens"]), int(meta["block_len"])
    prompts = demo_prompts()
    llm = demo_llm(meta, jacobi_chunk_tokens=block)  # a chunk per iteration: several per answer
    sp = SamplingParams(temperature=0.0, max_tokens=n, decode_strategy="jacobi",
                        jacobi_block_len=block, jacobi_max_blocks=1, jacobi_max_iterations=4096)
    server = chat_web.serve(llm.engine, tok, port=0, default_params={
        "jacobi_block_len": block, "jacobi_max_blocks": 1, "max_tokens": n})
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    faults = []
    try:
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=60).read().decode()
        zero_counts(counter)
        t0 = time.perf_counter()
        answers = [post_generate(port, tok.decode(p), n) for p in prompts[:4]]
        dt = time.perf_counter() - t0
        launches = launches_out["apps_chat_web"] = read_counts()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    for p, events in zip(prompts[:4], answers):
        text = "".join(e.get("text", "") for e in events if e["pane"] == "jacobi")
        want = llm.engine.generate([p], sp)[0]["token_ids"]
        if tok.encode(text) != want or not any("stats" in e for e in events):
            faults.append(f"chat_web prompt {p[:4]}...: streamed {tok.encode(text)[:8]}... "
                          f"against blocking {want[:8]}...")
    log(f"[apps] chat_web: page {len(page)} B; 4 POST /generate over HTTP in {dt:.2f}s, "
        f"{sum(len(e) for e in answers)} ndjson events, streamed tokens == blocking: "
        f"{not faults}; kernel launches {launches}; plain attention calls on CUDA: {counter.n}")
    if launches["paged_attention"] <= 0 or counter.n or "JacobiForcing-TPU chat" not in page:
        faults.append("chat_web did not serve its page or go through the kernels alone")
    for p in prompts[4:8]:
        chunks = []
        out = jacobi_stream_chat(llm.engine, None, [{"role": "user", "content": p}],
                                 max_new_tokens=n, n_token_seq_len=block,
                                 on_chunk=lambda _t, toks: chunks.append(list(toks)))
        want = llm.engine.generate([p], sp)[0]["token_ids"]
        ok = out["token_ids"] == want and sum(chunks, []) == want
        log(f"[apps] jacobi_stream_chat: {len(want)} tokens in {len(chunks)} chunks at "
            f"{out['tokens_per_s']:.1f} tok/s, streamed == blocking: {ok}")
        if not ok:
            faults.append(f"jacobi_stream_chat prompt {p[:4]}...: streamed != blocking")
    llm.exit()
    if faults:
        raise AssertionError("chat apps: " + "; ".join(faults))


def apps_grid(counter, launches_out, meta, workdir):
    """`grid_search.run_grid` on the demo checkpoint over n {16, 32} x K {1, 2}
    x r {0.8} x pool {1, 4} (8 held-out prompts, 96 new tokens; the MR points
    run the MR program, auto-policy off), then `analyze_grid.analyze` on its
    CSV.  Every point must succeed; the MR points launch kernel 2."""
    from jacobiforcing_tpu_torch.apps import analyze_grid, grid_search

    args = grid_search.make_parser().parse_args([])
    args.output_dir = os.path.join(workdir, "grid")
    args.block_sizes, args.Ks, args.rs, args.pools = [16, 32], [1, 2], [0.8], [1, 4]
    args.max_new_tokens = int(meta["max_tokens"])
    args.limit = 8
    args.dataset = os.path.join(DEMO, "heldout_prompts.jsonl")
    zero_counts(counter)
    t0 = time.perf_counter()
    rows = grid_search.run_grid(args, lambda: (demo_llm(meta, jacobi_mr_auto_policy=False).engine,
                                               None))
    dt = time.perf_counter() - t0
    launches = launches_out["apps_grid"] = read_counts()
    for r in rows:
        log(f"[apps] grid point n={r['n']} K={r['K']} r={r['r']} pool={r['pool']}: "
            f"{'error ' + r['error'] if 'error' in r else ''}"
            f"tokens per forward {r.get('tokens_per_forward')}, tok/s {r.get('tokens_per_s')}")
    result = analyze_grid.analyze(os.path.join(args.output_dir, "grid_results.csv"),
                                  args.output_dir)
    log(f"[apps] grid: {len(rows)} points in {dt:.1f}s; kernel launches {launches}; plain "
        f"attention calls on CUDA: {counter.n}; analyze_grid: {json.dumps(result)}")
    bad = [r for r in rows if "error" in r]
    if (bad or len(rows) != 8 or launches["paged_attention"] <= 0
            or launches["spec_attention"] <= 0 or counter.n or "best_measured" not in result):
        raise AssertionError(f"grid sweep: {len(bad)} failed points, launches {launches}, "
                             f"{counter.n} plain attention calls on CUDA, analysis {result}")


def apps_tpf_demo(counter, launches_out, workdir):
    """`train_tpf_demo` at its default geometry (hidden 256, 8 layers, N 32),
    cut to 2000 SFT steps (of 6000: the whole script's time limit) and one
    consistency round of two epochs, into a temporary directory: it must
    reach its target, a measured TPF >= 2 on its held-out prompts
    (aggregate, the throughput multiplier)."""
    from jacobiforcing_tpu_torch.apps import train_tpf_demo

    args = train_tpf_demo.make_parser().parse_args(
        ["--out", os.path.join(workdir, "tpf_demo"), "--rounds", "1", "--epochs", "2",
         "--sft-steps", "2000"])
    zero_counts(counter)
    t0 = time.perf_counter()
    result = train_tpf_demo.run(args)
    dt = time.perf_counter() - t0
    launches = launches_out["apps_tpf_demo"] = read_counts()
    stages = [(h["round"], h["tpf"], h["tpf_aggregate"]) for h in result["tpf_history"]]
    log(f"[apps] train_tpf_demo hidden {args.hidden}, {args.layers} layers, N {args.block_len}, "
        f"--rounds 1 --epochs 2 --sft-steps 2000: {dt:.1f}s; SFT {result['sft_steps']} steps in "
        f"{result['sft_seconds']:.1f}s = {result['sft_steps'] / result['sft_seconds']:.2f} "
        f"steps/s; TPF (round, mean, aggregate) per stage {stages}; second held-out set "
        f"{result['tpf_set2']} (aggregate {result['tpf_set2_aggregate']}, "
        f"{result['set2_n_eos_terminated']}/{result['n_heldout']} EOS); kernel 1 launches "
        f"{launches['paged_attention']}; plain attention calls on CUDA: {counter.n}")
    if (result["tpf_final_aggregate"] < 2.0 or launches["paged_attention"] <= 0 or counter.n):
        raise AssertionError(f"train_tpf_demo: aggregate TPF {result['tpf_final_aggregate']} "
                             f"(target >= 2), launches {launches}, {counter.n} plain calls")


def legacy_row(rng, vocab, prompt_len, answer_len, n_blk, states):
    """A stage-1 trajectory row of random tokens: the teacher output is the
    prompt and its answer; the trajectory walks a block of `n_blk` tokens
    from noise to the answer's first block."""
    prompt = rng.randint(3, vocab, prompt_len).tolist()
    answer = rng.randint(3, vocab, answer_len).tolist()
    fixed = answer[:n_blk]
    traj = []
    for i in range(states - 1):
        keep = rng.rand(n_blk) < i / states
        traj.append([f if k else int(rng.randint(3, vocab)) for f, k in zip(fixed, keep)])
    return {"prompt_ids": prompt, "answer_trajectory_ids": traj + [fixed],
            "teacher_output_ids": prompt + answer}


def legacy_run(cfg, params, sample, device, steps):
    """`steps` legacy CLLM updates (AdamW 1e-4, optax's defaults) on one
    prepared sample; returns the losses.  The RoPE table is computed on the
    host and moved: the card's float32 cos / sin differ from the host's in
    the last bit, which step 1 would carry into every later one."""
    from jacobiforcing_tpu_torch.models.qwen import rope_table
    from jacobiforcing_tpu_torch.train.legacy_cllm import make_legacy_train_step
    from jacobiforcing_tpu_torch.train.optim import AdamW

    opt = AdamW(1e-4)
    step = make_legacy_train_step(cfg, opt)
    state = opt.init(params)
    rope = tuple(t.to(device) for t in rope_table(cfg, "cpu"))
    losses = []
    for _ in range(steps):
        params, state, m = step(params, state, rope, sample)
        losses.append(float(m["loss"]))
    return losses


def apps_legacy(counter, big_cfg=None):
    """The legacy CLLM step: 3 steps from the demo checkpoint's weights on the
    card against the same 3 steps on the host CPU, in float32 (losses within
    1e-5 relative and decreasing; beside them the host's own spread between
    thread counts, which reorders f32 sums as the card does) and in float64
    (within 1e-9: the same arithmetic); then one step at Qwen2.5-7B widths in bf16 with the depth cut to 4 layers
    (28 layers' AdamW state does not fit beside the phase's other models),
    its time and peak memory.  `big_cfg` replaces that configuration (a
    rehearsal on the CPU)."""
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params
    from jacobiforcing_tpu_torch.train.legacy_cllm import prepare_legacy_sample
    from jacobiforcing_tpu_torch.utils.loader import load_checkpoint

    row = legacy_row(np.random.RandomState(0), 256, 12, 80, 32, 4)
    sample = prepare_legacy_sample(row, np.random.RandomState(0), seq_bucket=128)
    losses = {}
    threads = torch.get_num_threads()
    runs = [("cpu", torch.float64, threads), (DEV, torch.float64, threads),
            ("cpu", torch.float32, threads), (DEV, torch.float32, 0), ("cpu", torch.float32, 1)]
    for device, dtype, nt in runs:
        if nt:
            torch.set_num_threads(nt)
        cfg, params = load_checkpoint(DEMO, dtype=dtype, device=device)
        zero_counts(counter)
        t0 = time.perf_counter()
        losses[device, dtype, nt] = legacy_run(cfg, params, sample, device, 3)
        dt = time.perf_counter() - t0
        log(f"[apps] legacy CLLM demo widths {str(dtype)[6:]} on {device}"
            f"{f' ({nt} threads)' if device == 'cpu' else ''}: losses "
            f"{[f'{x:.9g}' for x in losses[device, dtype, nt]]} in {dt:.2f}s")
    torch.set_num_threads(threads)

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(losses[a], losses[b]))

    host64, card64 = ("cpu", torch.float64, threads), (DEV, torch.float64, threads)
    host32, card32 = ("cpu", torch.float32, threads), (DEV, torch.float32, 0)
    r64, r32 = rel(card64, host64), rel(card32, host32)
    spread = rel(("cpu", torch.float32, 1), host32)
    l32 = losses[card32]
    ok = r64 <= 1e-9 and r32 <= 1e-5 and l32[0] > l32[1] > l32[2]
    log(f"[apps] legacy CLLM, card against host, worst relative loss difference over 3 steps: "
        f"float32 {r32:.2e} (<= 1e-5; the host's own, {threads} threads against 1: "
        f"{spread:.2e}), float64 {r64:.2e} (<= 1e-9); float32 losses decreasing "
        f"{l32[0] > l32[1] > l32[2]} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"legacy CLLM: {losses}")
    cfg = big_cfg or dataclasses.replace(ModelConfig(), num_layers=4)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    row = legacy_row(np.random.RandomState(1), cfg.vocab_size, 64, 192, 32, 4)
    sample = prepare_legacy_sample(row, np.random.RandomState(0), seq_bucket=256)
    _sync()
    t0 = time.perf_counter()
    loss = legacy_run(cfg, params, sample, DEV, 1)
    _sync()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[apps] legacy CLLM Qwen2.5-7B widths, 4 layers, bf16, one step on rows of 256 "
        f"tokens: loss {loss[0]:.4f} in {dt:.2f}s (the first step, allocation included); peak "
        f"torch.cuda.max_memory_allocated {peak:.2f} GiB")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    if not math.isfinite(loss[0]):
        raise AssertionError(f"legacy CLLM at 7B widths: loss {loss[0]}")


def phase_apps(counter, launches_out):
    with open(os.path.join(DEMO, "tpf_demo.json")) as f:
        meta = json.load(f)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_apps_", dir=os.path.join(REPO, "build"))
    try:
        apps_chat(counter, launches_out, meta)
        apps_grid(counter, launches_out, meta, workdir)
        apps_tpf_demo(counter, launches_out, workdir)
        apps_legacy(counter)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase `train`: the consistency trainer end to end
# ---------------------------------------------------------------------------

DEV = "cuda"  # a rehearsal of the control flow on the CPU sets this to "cpu"
TRAIN_KERNEL_NAMES = ("train_attention_fwd", "train_attention_dkdv", "train_attention_dq")


def copy_task_samples(n, seed, vocab=256, eos=2):
    """Teacher rows of a task a small model learns: the response repeats the
    prompt's tokens in order, then EOS (ids 0-2 are kept for PAD and EOS)."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        prompt = r.randint(3, vocab, size=r.randint(5, 11)).tolist()
        resp = (prompt * 20)[: r.randint(40, 90)] + [eos]
        out.append({"prompt_ids": prompt, "full_ids": prompt + resp})
    return out


def param_items(params, prefix=""):
    """(dotted name, tensor) of every leaf of a parameter dict of any depth
    (a quantized weight is a dict {"q", "s"} of its own)."""
    for k, v in params.items():
        if isinstance(v, dict):
            yield from param_items(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def first_step_through(cfg, params, rope, batch, layout, impl):
    """(loss_ar, loss_consistency, {leaf: gradient}) of one sample through
    `consistency_losses` with the given attention implementation."""
    from jacobiforcing_tpu_torch.train.consistency import TrainConfig, consistency_losses

    tc = TrainConfig(N=32, seq_bucket=batch["input_ids"].shape[0], attn_impl=impl)
    leaves = {k: ({kk: vv.detach().requires_grad_() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.detach().requires_grad_())
              for k, v in params.items()}
    total, m = consistency_losses(leaves, cfg, tc, rope, batch, layout)
    names, tensors = zip(*param_items(leaves))
    grads = torch.autograd.grad(total, tensors)
    return (float(m["loss_ar"].detach()), float(m["loss_consistency"].detach()),
            dict(zip(names, grads)))


def phase_train_demo(counter, out_root, steps=40):
    """(a) demo widths, f32, random init: data path, first step vs the dense
    attention, descent, resume, and the trained checkpoint served."""
    from jacobiforcing_tpu_torch.config import SamplingParams
    from jacobiforcing_tpu_torch.data import pack_trajectories, synthesize_trajectories_masking
    from jacobiforcing_tpu_torch.engine.llm import LLM
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params, rope_table
    from jacobiforcing_tpu_torch.train.consistency import TrainConfig, prepare_sample
    from jacobiforcing_tpu_torch.train.trainer import JacobianDataset, TrainerArgs, train

    with open(os.path.join(DEMO, "config.json")) as f:
        cfg = ModelConfig.from_hf_config(json.load(f))
    cfg = ModelConfig(**{**cfg.__dict__, "dtype": torch.float32})
    samples = copy_task_samples(16, seed=0)
    traj = synthesize_trajectories_masking(samples, chunk_size=32, pad_id=0, seed=0)
    data_path = os.path.join(out_root, "rows.jsonl")
    pack_trajectories(traj, 32, output_path=data_path)
    ds = JacobianDataset(data_path)
    bucket = 256
    longest = max(len(ds[i]["input_ids"]) for i in range(len(ds)))
    log(f"[train-demo] {len(samples)} teacher rows -> {len(traj)} trajectory rows -> {len(ds)} "
        f"packed rows, longest {longest} tokens, bucket {bucket}")
    assert longest <= bucket

    # ---- the first step through the kernels and through the dense-mask attention ----
    params = init_params(cfg, 0, device=DEV)
    rope = rope_table(cfg, device=DEV)
    row = ds[0]
    tc = TrainConfig(N=32, seq_bucket=bucket)
    b_np = prepare_sample(row["input_ids"], row["prompt_len"], row["T"], tc, eos_id=2, pad_id=0)
    batch = {k: torch.as_tensor(v, device=DEV) for k, v in b_np.items()}
    layout = (int(b_np["prompt_len"]), int(b_np["T"]), int(b_np["seq_len"]))
    zero_counts(counter)
    ar_k, cons_k, g_k = first_step_through(cfg, params, rope, batch, layout, "splash")
    launches, plain_calls = read_counts(), counter.n
    ar_d, cons_d, g_d = first_step_through(cfg, params, rope, batch, None, "dense")
    # f32 through 8 layers, sums in another order: losses to 1e-5 relative,
    # each gradient leaf to 2e-4 of its largest entry
    worst = max(((g_k[n] - g_d[n]).abs().max() / g_d[n].abs().max()).item() for n in g_d)
    ok = (abs(ar_k - ar_d) <= 1e-5 * abs(ar_d) and abs(cons_k - cons_d) <= 1e-5 * abs(cons_d)
          and worst <= 2e-4 and plain_calls == 0
          and all(launches[n] == cfg.num_layers for n in TRAIN_KERNEL_NAMES))
    log(f"[train-demo] first step, kernels vs dense-mask attention: loss_ar {ar_k:.6f} vs "
        f"{ar_d:.6f}, loss_consistency {cons_k:.6f} vs {cons_d:.6f}, worst gradient leaf "
        f"max|err|/max|ref| {worst:.3e} over {len(g_d)} leaves; launches "
        f"{ {n: launches[n] for n in TRAIN_KERNEL_NAMES} }; plain attention calls on "
        f"{DEV.upper()}: {plain_calls} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the first training step through the kernels disagrees with the "
                             "dense-mask path")
    del g_k, g_d

    # ---- train, stop, resume ----
    out_dir = os.path.join(out_root, "run")
    common = dict(data_path=data_path, output_dir=out_dir, max_new_tokens=32, seq_bucket=bucket,
                  attn_impl="splash", learning_rate=1e-3, warmup_steps=4, log_steps=1,
                  save_steps=steps // 2, seed=0)
    logs = []
    zero_counts(counter)
    t0 = time.perf_counter()
    first = train(TrainerArgs(max_steps=steps // 2, **common), model_cfg=cfg, params=params,
                  eos_id=2, pad_id=0, device=DEV, log_fn=logs.append)
    res = train(TrainerArgs(max_steps=steps, **common), model_cfg=cfg, eos_id=2, pad_id=0,
                device=DEV, log_fn=logs.append)
    wall = time.perf_counter() - t0
    launches, plain_calls = read_counts(), counter.n
    losses = [h["loss"] for h in first["history"] + res["history"]]
    resumed = any(f"checkpoint-{steps // 2} at step {steps // 2}" in m for m in logs)
    head, tail = losses[1], min(losses[-5:])  # step 1 runs at learning rate 0
    ok = (res["step"] == steps and first["step"] == steps // 2 and resumed
          and len(losses) == steps and bool(np.isfinite(losses).all()) and tail < 0.5 * head
          and plain_calls == 0
          and all(launches[n] == steps * cfg.num_layers for n in TRAIN_KERNEL_NAMES))
    log(f"[train-demo] {steps} steps in {wall:.2f}s (two train() calls, the second resumed from "
        f"checkpoint-{steps // 2}: {resumed}); loss {losses[0]:.3f} -> {head:.3f} (step 2) -> "
        f"{losses[steps // 2 - 1]:.3f} -> {losses[-1]:.3f}, min of last 5 {tail:.3f}; launches "
        f"{ {n: launches[n] for n in TRAIN_KERNEL_NAMES} }; plain attention calls on "
        f"{DEV.upper()}: {plain_calls} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the demo-size training run failed (descent, resume or launch counts)")

    # ---- the trainer feeds the server ----
    llm = LLM(model=out_dir, device=DEV, dtype=torch.float32, kvcache_page_size=16,
              max_model_len=512, jacobi_chunk_tokens=64, eos=2,
              prefill_token_buckets=(32, 64, 128, 256, 512), num_kv_pages=256)
    prompts = [s_["prompt_ids"] for s_ in copy_task_samples(8, seed=1)]
    ar = llm.generate(prompts, SamplingParams(temperature=0.0, max_tokens=64))
    jac = llm.generate(prompts, SamplingParams(temperature=0.0, max_tokens=64,
                                               decode_strategy="jacobi", jacobi_block_len=32,
                                               jacobi_max_iterations=1 << 20))
    llm.exit()
    same = [a["token_ids"] == j["token_ids"] for a, j in zip(ar, jac)]
    copied = sum(a["token_ids"][: len(p)] == p for a, p in zip(ar, prompts))
    n_tok = sum(len(a["token_ids"]) for a in ar)
    log(f"[train-demo] checkpoint-{steps} served by LLM: ar == jacobi on {sum(same)}/{len(same)} "
        f"prompts ({n_tok} tokens); {copied}/{len(prompts)} answers begin with a copy of the "
        f"prompt (reported, not gated)")
    if not all(same) or n_tok == 0:
        raise AssertionError("the trained checkpoint's ar and jacobi streams differ")


def packed_row(vocab, P, T, N, seed):
    """One synthetic packed row: k_j is last_j with its last N/2 tokens redrawn."""
    r = np.random.RandomState(seed)
    seq = r.randint(3, vocab, size=P).tolist()
    for _ in range(T):
        last = r.randint(3, vocab, size=N)
        k = last.copy()
        k[N // 2:] = r.randint(3, vocab, size=N - N // 2)
        seq += k.tolist() + last.tolist()
    return {"input_ids": seq, "prompt_len": P, "T": T}


def step_profile(prof, wall_ms):
    """Device time by group inside the `profiled_step` range of a trace;
    returns the number of delta-kernel launches in the step (there should be
    none: both dQ kernels take delta themselves)."""
    from torch.autograd import DeviceType

    events = prof.events()
    span = next(e for e in events if e.name == "profiled_step"
                and e.device_type == DeviceType.CPU)
    lo, hi = span.time_range.start, span.time_range.end
    groups = {"train_attention forward (this repo's kernel)": 0.0,
              "train_attention dQ + delta (this repo's kernels)": 0.0,
              "train_attention dK/dV (this repo's kernel)": 0.0,
              "GEMM (cuBLAS)": 0.0, "AdamW (fused)": 0.0, "other": 0.0}
    named = {}
    n_delta = 0
    for e in events:
        # kernels and copies only: a record_function range also shows on the
        # device's timeline, as an annotation that spans what it launched
        if (e.device_type != DeviceType.CUDA or e.is_user_annotation
                or not (lo <= e.time_range.start <= hi)):
            continue
        t = (e.time_range.end - e.time_range.start) / 1e3  # us -> ms
        named[e.name] = named.get(e.name, 0.0) + t
        low = e.name.lower()
        n_delta += "train_delta" in low
        if "train_fwd" in low:
            groups["train_attention forward (this repo's kernel)"] += t
        elif "train_dq" in low or "train_delta" in low:
            groups["train_attention dQ + delta (this repo's kernels)"] += t
        elif "train_dkdv" in low:
            groups["train_attention dK/dV (this repo's kernel)"] += t
        elif any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma")):
            groups["GEMM (cuBLAS)"] += t
        elif "adam" in low:
            groups["AdamW (fused)"] += t
        else:
            groups["other"] += t
    busy = sum(groups.values())
    span_ms = (hi - lo) / 1e3
    log(f"[train-profile] one step under the profiler: {span_ms:.1f} ms ({wall_ms:.1f} ms on the "
        f"host clock), device busy {busy:.1f} ms ({busy / span_ms * 100:.1f}% of the step, idle "
        f"{100 - busy / span_ms * 100:.1f}%)")
    for g, t in groups.items():
        log(f"[train-profile]   {g}: {t:.2f} ms ({t / max(busy, 1e-9) * 100:.1f}% of device time)")
    for kname, t in sorted(named.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[train-profile]   top kernel {t:8.2f} ms  {kname[:110]}")
    log(f"[train-profile]   train_delta_kernel launches in the step: {n_delta}")
    return n_delta


def phase_train_full(counter, launches_out, params=None, cfg=None, row_shape=(512, 56, 32)):
    """(b) full width: three optimizer steps through `train`, then two more
    under the profiler; one packed row, remat, bf16, fused AdamW in place."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params
    from jacobiforcing_tpu_torch.train.optim import param_leaves
    from jacobiforcing_tpu_torch.train.trainer import TrainerArgs, train

    cfg = cfg or ModelConfig()
    if params is None:
        params = init_params(cfg, 0, device=DEV)
    P, T, N = row_shape
    L = P + 2 * T * N
    ds = [packed_row(cfg.vocab_size, P, T, N, seed=0)]
    args = dict(output_dir="", max_new_tokens=N, seq_bucket=L, attn_impl="splash", remat=True,
                learning_rate=1e-5, log_steps=1, save_steps=0, resume=False)
    cuda = DEV == "cuda"
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
    stamps, logs = [], []

    def on_log(msg):
        if cuda:
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        logs.append(msg)

    zero_counts(counter)
    t0 = time.perf_counter()
    res = train(TrainerArgs(max_steps=3, **args), model_cfg=cfg, params=params, dataset=ds,
                device=DEV, log_fn=on_log)
    launches, plain_calls = read_counts(), counter.n
    hist = res["history"]
    step_s = [b - a for a, b in zip([t0] + stamps[:-1], stamps)]
    steady = sum(step_s[1:]) / len(step_s[1:])
    gnorm = math.sqrt(sum(float(torch.linalg.vector_norm(g.float())) ** 2
                          for p in param_leaves(params)
                          for g in (p.grad if p.grad.dim() < 3 else p.grad.unbind(0))))
    per_step = {n: launches[n] / 3 for n in TRAIN_KERNEL_NAMES}
    want = {"train_attention_fwd": 2 * cfg.num_layers, "train_attention_dkdv": cfg.num_layers,
            "train_attention_dq": cfg.num_layers}  # remat runs the forward kernel twice
    finite = all(math.isfinite(h[k]) for h in hist for k in ("loss", "loss_ar", "loss_consistency"))
    ok = (res["step"] == 3 and finite and math.isfinite(gnorm) and gnorm > 0 and plain_calls == 0
          and per_step == want)
    mem = f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({held:.2f} GiB held before)" \
        if cuda else "not measured"
    log(f"[train-full] {cfg.num_layers} layers, hidden {cfg.hidden_size}, one packed row of {L} "
        f"tokens (P={P}, T={T}, N={N}), remat, {str(cfg.dtype).split('.')[-1]}: 3 steps "
        f"{[round(x, 3) for x in step_s]} s (the first holds the optimizer's set-up), steady "
        f"{1 / steady:.3f} steps/s = {L / steady:.1f} tokens/s; losses "
        f"{[round(h['loss'], 4) for h in hist]} (loss_ar {[round(h['loss_ar'], 4) for h in hist]}, "
        f"loss_consistency {[round(h['loss_consistency'], 4) for h in hist]}); last gradient "
        f"norm {gnorm:.4f}; peak torch.cuda.max_memory_allocated {mem}; launches per step "
        f"{per_step} (predicted {want}); plain attention calls on {DEV.upper()}: {plain_calls} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the full-width training run failed")
    launches_out["train"] = launches

    # ---- two more steps under the profiler; the second is the profiled step ----
    open_range = []

    def on_log_profiled(msg):
        on_log(msg)
        if open_range:
            open_range.pop().__exit__(None, None, None)
        else:
            rf = record_function("profiled_step")
            rf.__enter__()
            open_range.append(rf)

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        train(TrainerArgs(max_steps=2, **args), model_cfg=cfg, params=params, dataset=ds,
              device=DEV, log_fn=on_log_profiled)
    if cuda:
        n_delta = step_profile(prof, (stamps[-1] - stamps[-2]) * 1e3)
        if n_delta:
            raise AssertionError("the step launched a delta kernel: dQ takes delta itself")


def phase_train(counter, launches_out, params=None):
    out_root = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=os.path.join(REPO, "build"))
    try:
        phase_train_demo(counter, out_root)
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    phase_train_full(counter, launches_out, params)


# ---------------------------------------------------------------------------
# Phase `tp`: tensor-parallel serving, two ranks on one card
# ---------------------------------------------------------------------------

# the JAX package's W8A8 demo run in f32 on the CPU (DEMO_QUANT_ANCHORS)
TP_W8A8_TOKENS = 2029


def demo_prompts():
    with open(os.path.join(DEMO, "heldout_prompts.jsonl")) as f:
        return [json.loads(line)["prompt_ids"] for line in f]


def demo_sps(meta, names):
    """The demo's greedy requests (N 32, 96 new tokens; MR K 2, pool 4)."""
    from jacobiforcing_tpu_torch.config import SamplingParams

    kw = dict(temperature=0.0, max_tokens=int(meta["max_tokens"]),
              jacobi_block_len=int(meta["block_len"]), jacobi_n_gram_pool_size=4,
              jacobi_max_iterations=1 << 20)
    sps = {"ar": SamplingParams(**kw),
           "jacobi": SamplingParams(decode_strategy="jacobi", **kw),
           "mr": SamplingParams(decode_strategy=MR, jacobi_max_blocks=2, **kw)}
    return {n: sps[n] for n in names}


def tp_full_sps():
    """Qwen2.5-7B widths: 32 new tokens; Jacobi block 64; MR N 64, K 2."""
    from jacobiforcing_tpu_torch.config import SamplingParams

    kw = dict(temperature=0.0, max_tokens=32, jacobi_max_iterations=1 << 20)
    return {"ar": SamplingParams(**kw),
            "jacobi": SamplingParams(decode_strategy="jacobi", jacobi_block_len=64, **kw),
            "mr": SamplingParams(decode_strategy=MR, jacobi_block_len=64, jacobi_max_blocks=2,
                                 jacobi_n_gram_pool_size=4, **kw)}


def tp_serve(llm, prompts, sps, counter):
    """Each request set of `sps` once, all prompts in one call, the kernel
    counts zeroed just before and read just after: streams, launches, plain
    attention calls on CUDA, wall seconds, batched forwards (AR steps) and MR
    tier counts by path."""
    out = {}
    for name, sp in sps.items():
        stats0 = dict(llm.stats)
        zero_counts(counter)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streams = [o["token_ids"] for o in llm.generate(prompts, sp)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = {k: llm.stats.get(k, 0) - stats0.get(k, 0) for k in llm.stats}
        out[name] = dict(streams=streams, launches=read_counts(), plain=counter.n, wall=wall,
                         forwards=delta["ar_steps"] if name == "ar" else delta["chunk_forwards"],
                         tiers={k: delta.get(k, 0) for k in MR_STATS[:3]})
    return out


# the TP 2 dense forward on the engine's shards against one rank's on the
# full weights (Qwen2.5-7B widths, bf16, one 64-token prompt): relative L2
# error of the last hidden states and of the last row's logits.  The two add
# the row-parallel partial products in another order, in bf16, over 28
# layers: a few percent; a weight cut wrong leaves the two uncorrelated
# (about 1.4)
TP_SHARD_TOL = 0.25


def tp_shard_check(full, engine, cfg):
    """(hidden, logits) relative errors of `engine`'s TP forward on its
    shards against one rank's on the `full` weights."""
    from jacobiforcing_tpu_torch.models import qwen

    ids = torch.tensor([full_width_prompts(cfg)[0][:64]], device=engine.device)
    pos = torch.arange(64, device=engine.device)[None]
    with torch.no_grad():
        h1 = qwen.forward_dense(full, cfg, ids, pos, engine.rope)
        h2 = qwen.forward_dense(engine.params, cfg, ids, pos, engine.rope, group=engine.group)
        l1 = qwen.logits_at(full, cfg, h1[:, -1])
        l2 = qwen.logits_at(engine.params, cfg, h2[:, -1], engine.group)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    return rel(h2, h1), rel(l2, l1)


def tp_rank(rank, port, out_path, backend):
    """One rank of the `tp` phase's 2-process world.  gloo: both ranks on
    card 0, eagerly (NCCL takes one rank per card, and gloo refuses CUDA
    graphs); nccl: card `rank`, with CUDA graphs.  The demo checkpoint in f32
    (`ar`, `jacobi`, `mr` with the policy off; W8A8 `ar`, `jacobi`), then
    Qwen2.5-7B widths in bf16 with random weights: every rank draws the same
    full weights on its card and hands them to `LLM`, which cuts its share
    (`parallel/sharding.shard_params`); the share's TP forward is held to
    the full weights' (`tp_shard_check`) before the full copy is freed.
    Writes what it served to `out_path`."""
    import torch.distributed as dist

    from jacobiforcing_tpu_torch.engine.llm import LLM
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params
    from jacobiforcing_tpu_torch.parallel.mesh import make_mesh
    from jacobiforcing_tpu_torch.parallel.multihost import initialize_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nccl = backend == "nccl"
    initialize_multihost(f"localhost:{port}", 2, rank, backend=backend,
                         local_rank=rank if nccl else 0)
    mesh = make_mesh(tensor_parallel_size=2)
    counter = PlainOnCudaCounter()
    with open(os.path.join(DEMO, "tpf_demo.json")) as f:
        meta = json.load(f)
    res = {"device": torch.cuda.current_device()}
    tp = dict(tensor_parallel_size=2, enforce_eager=not nccl, mesh=mesh)
    llm = demo_llm(meta, jacobi_mr_auto_policy=False, **tp)
    res["demo_kv_heads"] = int(llm.engine.kv.k.shape[1])
    res["demo"] = tp_serve(llm, demo_prompts(), demo_sps(meta, ("ar", "jacobi", "mr")), counter)
    res["graphs"] = llm.engine.programs.num_graphs
    llm.exit()
    llm = demo_llm(meta, quantization="w8a8", **tp)
    res["w8a8"] = tp_serve(llm, demo_prompts(), demo_sps(meta, ("ar", "jacobi")), counter)
    llm.exit()
    cfg = ModelConfig()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    llm = LLM(device="cuda", model_cfg=cfg, params=full, num_kv_pages=64,
              kvcache_page_size=256, eos=-1, jacobi_mr_auto_policy=False, **tp)
    torch.cuda.synchronize()
    res["init_s"] = time.perf_counter() - t0
    params = llm.engine.params
    res["shard_rel_err"] = tp_shard_check(full, llm.engine, cfg)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    res["weights_gib"] = sum(t.numel() * t.element_size() for v in params.values()
                             for t in (v.values() if isinstance(v, dict) else [v])) / 2**30
    res["full_kv_heads"] = int(llm.engine.kv.k.shape[1])
    res["full_q_heads"] = int(params["layers"]["wq"].shape[-1] // cfg.head_dim)
    torch.cuda.reset_peak_memory_stats()
    res["full"] = tp_serve(llm, full_width_prompts(cfg), tp_full_sps(), counter)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    llm.exit()
    with open(out_path, "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def spawn_tp_ranks(backend, out_dir, timeout=600):
    """Run `tp_rank` in two processes; a rank that fails fails the phase."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    paths = [os.path.join(out_dir, f"tp-{backend}-rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "tp-rank", str(r),
                               str(port), paths[r], backend], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            log(f"[tp] {backend} rank {r} failed (rc {p.returncode}):\n{text[-4000:]}")
            raise AssertionError(f"a {backend} rank failed")
    ranks = []
    for path in paths:
        with open(path) as f:
            ranks.append(json.load(f))
    return ranks


def attn(run):
    """A run's launches of kernels 1 and 2."""
    return {k: run["launches"][k] for k in ("paged_attention", "spec_attention")}


def match_rate(a, b):
    """Tokens equal position by position over the shorter of two streams."""
    same = sum(x == y for s, t in zip(a, b) for x, y in zip(s, t))
    return same, sum(min(len(s), len(t)) for s, t in zip(a, b))


def report_tp(tag, ranks, demo1, full1, eos, faults, rate_note):
    """The `tp` phase's lines and gates for one world of two ranks against
    TP 1's runs (`demo1`, `full1`); `rate_note` labels its iterations/s."""
    r0 = ranks[0]
    for part in ("demo", "w8a8", "full"):
        for name in r0[part]:
            if ranks[1][part][name]["streams"] != r0[part][name]["streams"]:
                faults.append(f"{tag} {part} {name}: the ranks' streams differ")
    for part, names in (("demo", ("jacobi", "mr")), ("w8a8", ("jacobi",))):
        for name in names:
            diff = [i for i, (a, b) in enumerate(zip(r0[part]["ar"]["streams"],
                                                     r0[part][name]["streams"])) if a != b]
            log(f"[tp] {tag} demo{' W8A8' if part == 'w8a8' else ''} TP 2: ar == {name} on 64 "
                f"prompts: {not diff} (rows differing: {diff})")
            if diff:
                faults.append(f"{tag} {part}: ar and {name} differ in rows {diff}")
    for part, anchor in (("demo", DEMO_TOKENS), ("w8a8", TP_W8A8_TOKENS)):
        for name, run in r0[part].items():
            toks = sum(len(s) for s in run["streams"])
            n_eos = sum(bool(s) and s[-1] == eos for s in run["streams"])
            line = (f"[tp] {tag} demo{' W8A8' if part == 'w8a8' else ''} TP 2 {name}: {toks} "
                    f"tokens, {n_eos}/64 EOS (anchor {anchor} / 64: "
                    f"{'equal' if (toks, n_eos) == (anchor, 64) else 'DIFFERS'}); "
                    f"{run['forwards']} forwards in {run['wall']:.2f}s; launches per rank "
                    f"{[attn(r[part][name]) for r in ranks]}; plain attention calls on CUDA "
                    f"{[r[part][name]['plain'] for r in ranks]}")
            if part == "demo":
                same, n = match_rate(run["streams"], demo1[name]["streams"])
                line += f"; tokens equal to TP 1's: {same}/{n}"
            if name == "mr":
                line += f"; MR tiers {run['tiers']} (TP 1: {demo1['mr']['tiers']})"
            log(line)
    full = r0["full"]
    for name, run in full.items():
        toks = sum(len(s) for s in run["streams"])
        same, n = match_rate(run["streams"], full1[name]["streams"])
        line = (f"[tp] {tag} Qwen2.5-7B widths TP 2 {name}: {toks} tokens, {run['forwards']} "
                f"batched forwards in {run['wall']:.3f}s = {run['forwards'] / run['wall']:.2f} "
                f"iterations/s ({rate_note}; TP 1 eager here: "
                f"{full1[name]['forwards'] / full1[name]['wall']:.2f}); tokens equal to TP "
                f"1's: {same}/{n}; launches per rank {[attn(r['full'][name]) for r in ranks]}; "
                f"plain attention calls on CUDA {[r['full'][name]['plain'] for r in ranks]}")
        if name == "mr":
            line += f"; MR tiers {run['tiers']} (TP 1: {full1['mr']['tiers']})"
        log(line)
    same, n = match_rate(full["ar"]["streams"], full["jacobi"]["streams"])
    log(f"[tp] {tag} Qwen2.5-7B widths TP 2: AR vs Jacobi {same}/{n} tokens equal (bf16 "
        f"near-ties on a random model make this a reported number); per rank "
        f"{r0['full_q_heads']} query heads, {r0['full_kv_heads']} KV heads, "
        f"{r0['weights_gib']:.2f} GiB of weights, drawn whole and cut in {r0['init_s']:.1f}s, peak "
        f"{[round(r['peak_gib'], 2) for r in ranks]} GiB; CUDA graphs of the demo engine per "
        f"rank {[r['graphs'] for r in ranks]}")
    errs = [r["shard_rel_err"] for r in ranks]
    log(f"[tp] {tag} Qwen2.5-7B widths TP 2 dense forward on the engine's shards against the "
        f"full weights, 64 tokens: relative error (hidden, logits) per rank "
        f"{[tuple(f'{e:.4f}' for e in x) for x in errs]} (bound {TP_SHARD_TOL})")
    if any(e > TP_SHARD_TOL or e != e for x in errs for e in x):
        faults.append(f"{tag}: the shards' forward is not the full weights' ({errs})")
    heads = [(r["demo_kv_heads"], r["full_kv_heads"], r["full_q_heads"]) for r in ranks]
    if any(h != (1, 2, 14) for h in heads):
        faults.append(f"{tag}: per-rank (demo KV, 7B KV, 7B query) heads {heads}, want "
                      "(1, 2, 14)")
    for r in ranks:
        for part in ("demo", "w8a8", "full"):
            for name, run in r[part].items():
                spec = run["launches"]["spec_attention"]
                if run["launches"]["paged_attention"] <= 0 or run["plain"] or \
                        (name == "mr") != (spec > 0):
                    faults.append(f"{tag} {part} {name} did not run through the kernels alone "
                                  f"({attn(run)}, {run['plain']} plain calls)")


def phase_tp(counter, launches_out, params=None):
    """Tensor-parallel serving at TP 2: two ranks sharing the card over gloo,
    eagerly, against TP 1 in this process (and, with two cards or more, two
    ranks on two cards over NCCL with CUDA graphs).  Gates: every rank exits
    0, the ranks serve identical streams, `ar` == `jacobi` == `mr` on the demo
    checkpoint in f32 and `ar` == `jacobi` under W8A8, each rank holds 1
    (demo) / 2 (Qwen2.5-7B) KV heads and 14 query heads, the paged kernel
    runs in every path and the speculative one in `mr` alone, no plain
    attention runs on CUDA; NCCL's demo streams == gloo's.  Reported: tokens
    and EOS beside the anchors, matches against TP 1, MR tier counts beside
    TP 1's, and iterations/s (over gloo bound by its host round trips; not a
    TP speed)."""
    from jacobiforcing_tpu_torch.engine.llm import LLM
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params

    # card 0's name and power limit (the ranks' cards are alike)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    with open(os.path.join(DEMO, "tpf_demo.json")) as f:
        meta = json.load(f)
    faults = []
    # ---- TP 1 in this process ----
    llm = demo_llm(meta, jacobi_mr_auto_policy=False)
    demo1 = tp_serve(llm, demo_prompts(), demo_sps(meta, ("ar", "jacobi", "mr")), counter)
    llm.exit()
    cfg = ModelConfig()
    if params is None:
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    llm = LLM(device="cuda", model_cfg=cfg, params=params, num_kv_pages=64,
              kvcache_page_size=256, eos=-1, jacobi_mr_auto_policy=False, enforce_eager=True)
    full1 = tp_serve(llm, full_width_prompts(cfg), tp_full_sps(), counter)
    llm.exit()
    del llm
    gc.collect()
    torch.cuda.empty_cache()

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_tp_", dir=os.path.join(REPO, "build"))
    worlds = ["gloo"] + (["nccl"] if torch.cuda.device_count() >= 2 else [])
    for backend in worlds:
        t0 = time.perf_counter()
        ranks = spawn_tp_ranks(backend, out_dir)
        tag = ("gloo eager, both ranks on card 0" if backend == "gloo"
               else "NCCL + CUDA graphs, cards 0 and 1")
        log(f"[tp] {tag}: ranks on cards {[r['device'] for r in ranks]}, {smi}; "
            f"{time.perf_counter() - t0:.1f}s")
        note = (f"gloo-bound, not a TP speed, {smi}" if backend == "gloo"
                else f"NCCL, CUDA graphs, {smi}")
        report_tp(tag, ranks, demo1, full1, int(meta["eos"]), faults, note)
        if backend == "gloo":
            gloo0 = ranks[0]
            full = gloo0["full"]
            launches_out["tp2_jacobi"] = full["jacobi"]["launches"]
            launches_out["tp2_mr"] = full["mr"]["launches"]
            tiers = full["mr"]["tiers"]
            launches_out["tp2_mr_main_shape"] = {"mr_ra_only": "T64", "mr_nocand": "T128",
                                                 "mr_full": "T384"}[max(tiers, key=tiers.get)]
        else:
            same = all(ranks[0][part][n]["streams"] == gloo0[part][n]["streams"]
                       for part in ("demo", "w8a8") for n in gloo0[part])
            log(f"[tp] NCCL demo streams == gloo's: {same}")
            if not same or not all(r["graphs"] > 0 for r in ranks):
                faults.append("NCCL: demo streams differ from gloo's or no graph was captured")
    if worlds == ["gloo"]:
        log(f"[tp] NCCL + CUDA graphs at TP 2: not run ({torch.cuda.device_count()} card; NCCL "
            "takes one rank per card)")
    shutil.rmtree(out_dir, ignore_errors=True)
    if faults:
        raise AssertionError("tp: " + "; ".join(faults))


# ---------------------------------------------------------------------------
# Phase `train_mesh`: data-parallel / fsdp and TP training, two ranks
# ---------------------------------------------------------------------------

MESH_STEPS = 3
MESH_LR = 1e-5  # the reference's (and TrainerArgs') learning rate
# the demo-width runs: (dp, tp), global batch, attention, remat
MESH_DEMO_RUNS = {"dp2": ((2, 1), 2, "dense", False), "tp2": ((1, 2), 1, "splash", True)}
# Gates of the demo-width runs: f32, TF32 off, two ranks against one process
# on a (1, 1) mesh, leaf by leaf as RMS error over RMS (the key bias's
# moments over the query bias's RMS: its gradient nearly cancels, since
# softmax ignores a shift common to a query's scores).  Step 1 runs at
# learning rate 0, so steps 1 and 2 see the same weights and checkpoint-1's
# AdamW moments hold the first gradient itself: MESH_LOSS_TOL and MESH_TOL
# are rounding bounds (readings up to 4.8e-7 and 3.0e-5), and a gradient
# left unreduced over an axis reads O(1) there (0.95 for `ln1`).
# Checkpoint-3 holds two updates.  Adam's first updates are sign-like, so
# rounding in a gradient entry near zero decides which way it moves: the
# change of the weights from the start, over all leaves at once, read up to
# 8.9e-2 between the (1, 2) runs, each about 7e-2 from the same run in
# float64 on the host (printed beside), and 1.0 when a step never writes its
# update back; MESH_DELTA_TOL lies between.  Step 3's loss (4.4e-4; 8.7e-4
# and 1.1e-3 with the update skipped) and checkpoint-3's moments (1.7e-2)
# take loose bounds.  Readings: NVIDIA H100 80GB HBM3, 700 W; the planted
# faults (`plant_fault`) run in every `train_mesh` phase (PERF.md §6).
MESH_LOSS_TOL = 1e-5  # steps 1 and 2
MESH_TOL = 1e-3  # checkpoint-1
MESH_LOSS3_TOL = 2e-3  # step 3
MESH_TOL3 = 5e-2  # checkpoint-3's moments
MESH_DELTA_TOL = 0.3  # checkpoint-3's change of the weights, all leaves at once
# planted faults (`plant_fault`): which demo runs each spoils
MESH_FAULTS = {"skip": ("dp2", "tp2"), "ln1": ("dp2",)}
# Qwen2.5-7B widths, one packed row per rank: (2, 1) fsdp dense and (1, 2)
# splash (kernel 3 on 2 of the 4 KV heads per rank)
MESH_FULL_ROW = (512, 24, 32)  # P, T, N: 2048 tokens
MESH_FULL_TP_ROW = (512, 56, 32)  # 4096 tokens, the `train` phase's row


def mesh_args(out_dir, gb, impl, remat, **kw):
    from jacobiforcing_tpu_torch.train.trainer import TrainerArgs

    kw = dict(dict(save_steps=0), **kw)
    return TrainerArgs(output_dir=out_dir, max_new_tokens=32, attn_impl=impl, remat=remat,
                       global_batch=gb, learning_rate=MESH_LR, warmup_steps=1,
                       max_steps=MESH_STEPS, log_steps=1, resume=False, **kw)


def mesh_demo_runs(counter, workdir, mesh_of, suffix, dtype=torch.float32, device=None,
                   tags=tuple(MESH_DEMO_RUNS)):
    """The demo-width runs `tags` of `MESH_DEMO_RUNS` through `train()`, each
    from the demo checkpoint's weights in `dtype` on `device` (default: the
    card) on the rows in `workdir/rows.jsonl`, each writing
    `workdir/<tag>-<suffix>/checkpoint-{1,2,3}`; `mesh_of(dp, tp)` is the
    mesh to run on.  Returns {tag: history, launches, plain calls}."""
    from jacobiforcing_tpu_torch.train.trainer import train
    from jacobiforcing_tpu_torch.utils.loader import load_checkpoint

    device = device or DEV
    out = {}
    for tag in tags:
        (dp, tp), gb, impl, remat = MESH_DEMO_RUNS[tag]
        cfg, full = load_checkpoint(DEMO, dtype=dtype, device=device)
        mesh = mesh_of(dp, tp)
        zero_counts(counter)
        res = train(mesh_args(os.path.join(workdir, f"{tag}-{suffix}"), gb, impl, remat,
                              data_path=os.path.join(workdir, "rows.jsonl"), seq_bucket=256,
                              save_steps=1),
                    model_cfg=cfg, params=full, mesh=mesh, eos_id=2, pad_id=0, device=device,
                    log_fn=lambda *_: None)
        out[tag] = dict(history=res["history"], launches=read_counts(), plain=counter.n,
                        coords=list(mesh.coords), layers=cfg.num_layers)
    return out


def plant_fault(name):
    """Spoil this rank's training step, as a negative control of the demo
    gates: "skip" puts the weights back after every AdamW update (the
    moments still move); "ln1" leaves the `ln1` gradient this rank's own,
    not summed over the data ranks.  Returns the function that undoes it."""
    from jacobiforcing_tpu_torch.train import consistency
    from jacobiforcing_tpu_torch.train.optim import AdamW

    if name == "skip":
        apply = AdamW.apply

        def skipping(self, state):
            keep = [p.detach().clone() for p in state.leaves]
            lr = apply(self, state)
            with torch.no_grad():
                for p, k in zip(state.leaves, keep):
                    p.copy_(k)
            return lr

        AdamW.apply = skipping
        return lambda: setattr(AdamW, "apply", apply)
    if name == "ln1":
        reduce_grads = consistency.reduce_grads

        def unreduced_ln1(params, *a, **kw):
            own = params["layers"]["ln1"].grad.clone()
            reduce_grads(params, *a, **kw)
            params["layers"]["ln1"].grad.copy_(own)

        consistency.reduce_grads = unreduced_ln1
        return lambda: setattr(consistency, "reduce_grads", reduce_grads)
    raise ValueError(f"unknown fault {name!r}")


def leaf_norms(params, cfg, mesh):
    """The global gradient norm of a mesh rank's blocks: each leaf's squared
    norm summed over the axes it is split along."""
    from jacobiforcing_tpu_torch.parallel.collectives import reduce_sum
    from jacobiforcing_tpu_torch.parallel.sharding import param_specs

    specs = param_specs(cfg, fsdp=True)
    sums = {}
    for name, v in params.items():
        for key, t in (v.items() if isinstance(v, dict) else [(name, v)]):
            spec = specs[name][key] if isinstance(v, dict) else specs[name]
            axes = tuple(a for a in ("data", "model") if a in spec)
            sq = torch.linalg.vector_norm(t.grad.double()) ** 2
            sums[axes] = sums.get(axes, 0) + sq
    total = 0.0
    for axes, s in sums.items():
        for a in axes:
            reduce_sum(s, mesh.data_group if a == "data" else mesh.model_group)
        total += float(s)
    return math.sqrt(total)


def mesh_full_rank(mesh, gb, impl, row, counter):
    """Qwen2.5-7B widths (all 28 layers, bf16, random weights drawn whole on
    the card and cut to the rank's blocks), one packed row of shape `row`
    (P, T, N) per data rank, `impl` attention, remat, MESH_STEPS steps
    through `train()`: losses, the step times, the global gradient norm, peak
    memory, the kernels' launches and the plain attention calls on CUDA."""
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params
    from jacobiforcing_tpu_torch.parallel.sharding import shard_params
    from jacobiforcing_tpu_torch.train.trainer import train

    cfg = ModelConfig()
    cuda = DEV == "cuda"
    full = init_params(cfg, torch.Generator(device=DEV).manual_seed(0), device=DEV)
    params = shard_params(full, cfg, mesh, fsdp=True)
    del full
    gc.collect()
    P, T, N = row
    ds = [packed_row(cfg.vocab_size, P, T, N, seed=s) for s in range(2)]
    stamps = []

    def on_log(msg):
        if cuda:
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2**30
    zero_counts(counter)
    t0 = time.perf_counter()
    res = train(mesh_args("", gb, impl, True, seq_bucket=P + 2 * T * N), model_cfg=cfg,
                params=params, dataset=ds, mesh=mesh, device=DEV, log_fn=on_log)
    launches, plain = read_counts(), counter.n
    out = dict(history=res["history"], step_s=[b - a for a, b in zip([t0] + stamps, stamps)],
               gnorm=leaf_norms(params, cfg, mesh), launches=launches, plain=plain,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None,
               held_gib=held if cuda else None, coords=list(mesh.coords),
               shape=[mesh.shape["data"], mesh.shape["model"]], impl=impl, row=list(row),
               layers=cfg.num_layers,
               block_gib=sum(t.numel() * t.element_size() for _, t in param_items(params))
               / 2**30)
    del params, res
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def train_rank(part, rank, port, out_path, backend, workdir):
    """One rank of the `train_mesh` phase's 2-process world.  gloo: both
    ranks on card 0; nccl: card `rank`.  `part` "demo" runs the demo-width
    runs on (2, 1) and (1, 2) meshes, then those of `MESH_FAULTS` again with
    each planted fault; "full" Qwen2.5-7B widths on (2, 1) and (1, 2).
    Writes what it ran to `out_path`."""
    import torch.distributed as dist

    from jacobiforcing_tpu_torch.parallel.mesh import make_mesh
    from jacobiforcing_tpu_torch.parallel.multihost import initialize_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nccl = backend == "nccl"
    initialize_multihost(f"localhost:{port}", 2, rank, backend=backend,
                         local_rank=rank if nccl else 0)
    res = {"device": torch.cuda.current_device() if DEV == "cuda" else None}
    counter = PlainOnCudaCounter()
    if part == "demo":
        res.update(mesh_demo_runs(counter, workdir, lambda dp, tp: make_mesh(tp, dp), "mesh"))
        res["faults"] = {}
        for name, tags in MESH_FAULTS.items():
            undo = plant_fault(name)
            res["faults"][name] = mesh_demo_runs(counter, workdir,
                                                 lambda dp, tp: make_mesh(tp, dp),
                                                 f"fault-{name}", tags=tags)
            undo()
    else:
        res["full"] = mesh_full_rank(make_mesh(1, 2), 2, "dense", MESH_FULL_ROW, counter)
        dist.barrier()  # both ranks' memory is back before the next run
        res["full_tp"] = mesh_full_rank(make_mesh(2, 1), 1, "splash", MESH_FULL_TP_ROW, counter)
    with open(out_path, "w") as f:
        json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def spawn_train_ranks(part, backend, workdir, timeout):
    """Run `train_rank` in two processes; a rank that fails fails the phase."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    paths = [os.path.join(workdir, f"{part}-{backend}-rank{r}.json") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "train-rank", part,
                               str(r), str(port), paths[r], backend, workdir], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            log(f"[train-mesh] {part} {backend} rank {r} failed (rc {p.returncode}):\n"
                f"{text[-4000:]}")
            raise AssertionError(f"a {backend} rank failed")
    ranks = []
    for path in paths:
        with open(path) as f:
            ranks.append(json.load(f))
    return ranks


def checkpoint_leaves(path):
    """{"<kind> <leaf>": float64 tensor} of a checkpoint's weights and AdamW
    moments (kinds: weights, exp_avg, exp_avg_sq), named as the parameter
    dict's leaves (the optimizer state follows `param_leaves`' order); the
    demo checkpoint, which holds no optimizer state, gives its weights."""
    from jacobiforcing_tpu_torch.train.optim import param_leaves
    from jacobiforcing_tpu_torch.utils.loader import load_checkpoint

    _, params = load_checkpoint(path, dtype=torch.float64, device="cpu")
    names = [n for n, _ in sorted(param_items(params))]
    if len(names) != len(param_leaves(params)):
        raise AssertionError("leaf names do not follow param_leaves")
    out = {f"weights {n}": t for n, t in param_items(params)}
    if os.path.exists(os.path.join(path, "opt_state.pt")):
        sd = torch.load(os.path.join(path, "opt_state.pt"), map_location="cpu",
                        weights_only=True)
        for i, s_ in sd["opt"]["state"].items():
            for m in ("exp_avg", "exp_avg_sq"):
                out[f"{m} {names[i]}"] = s_[m].double()
    return out


def rms(t):
    return float(t.pow(2).mean().sqrt())


def mesh_checkpoint_errors(got_dir, want_dir, start):
    """(per leaf, delta) for two checkpoints of runs that began from the
    weights `start` (`checkpoint_leaves`): per leaf RMS error / RMS of the
    reference over the AdamW moments (the key bias's over the query bias's
    RMS) and over the weights' change from `start`; delta = |change of got
    - change of want| / |change of want| over all weights at once."""
    got, want = checkpoint_leaves(got_dir), checkpoint_leaves(want_dir)
    if sorted(got) != sorted(want):
        raise AssertionError(f"the checkpoints hold other leaves: {sorted(set(got) ^ set(want))}")
    errs, num, den = {}, 0.0, 0.0
    for k, v in want.items():
        g = got[k]
        if k in start:
            g, v = g - start[k], v - start[k]
            num += float((g - v).pow(2).sum())
            den += float(v.pow(2).sum())
            errs[k] = rms(g - v) / max(rms(v), 1e-30)
        else:
            errs[k] = rms(g - v) / max(rms(v), rms(want[k.replace(".bk", ".bq")]), 1e-30)
    return errs, math.sqrt(num / max(den, 1e-300)) if num else 0.0


def mesh_demo_readings(workdir, tag, got, want, start, got_hist, want_hist):
    """Readings of the run `<tag>-<got>` against `<tag>-<want>`: relative
    loss error per step, checkpoint-1's worst leaves, checkpoint-3's worst
    moments and the change of the weights (`mesh_checkpoint_errors`)."""
    step_err = [max(abs(h[i]["loss"] - w["loss"]) / abs(w["loss"]) for h in got_hist)
                for i, w in enumerate(want_hist)]
    ck = {c: mesh_checkpoint_errors(*(os.path.join(workdir, f"{tag}-{side}", f"checkpoint-{c}")
                                      for side in (got, want)), start)
          for c in (1, MESH_STEPS)}
    worst1 = sorted(ck[1][0].items(), key=lambda kv: -kv[1])[:3]
    moments3 = sorted(((k, e) for k, e in ck[MESH_STEPS][0].items() if not k.startswith("weights")),
                      key=lambda kv: -kv[1])[:3]
    return dict(step_err=step_err, worst1=worst1, moments3=moments3, delta1=ck[1][1],
                delta3=ck[MESH_STEPS][1])


def report_mesh_demo(ranks, one, exact, smi, suffix="mesh", label="", tags=tuple(MESH_DEMO_RUNS)):
    """The demo-width lines and gates: each rank's losses against the (1, 1)
    run's, checkpoints 1 and 3 (written by rank (0, 0)) against its, kernel
    3's launches per rank (TP 2) and no plain attention on CUDA; beside them
    how far the f32 runs sit from the float64 runs `exact` (None: not run).
    Returns {tag: ok}."""
    workdir = one["workdir"]
    start = checkpoint_leaves(DEMO)
    verdict = {}
    for tag in tags:
        (dp, tp), gb, impl, remat = MESH_DEMO_RUNS[tag]
        L = one[tag]["layers"]
        per_step = ({"train_attention_fwd": 2 * L, "train_attention_dq": L,
                     "train_attention_dkdv": L} if impl == "splash"
                    else {n: 0 for n in TRAIN_KERNEL_NAMES})
        want = {n: per_step[n] * MESH_STEPS for n in TRAIN_KERNEL_NAMES}
        r = mesh_demo_readings(workdir, tag, suffix, "one", start,
                               [x[tag]["history"] for x in ranks], one[tag]["history"])
        launches = [{k: x[tag]["launches"][k] for k in TRAIN_KERNEL_NAMES} for x in ranks]
        plain = [x[tag]["plain"] for x in ranks]
        ok = (max(r["step_err"][:2]) <= MESH_LOSS_TOL and r["step_err"][2] <= MESH_LOSS3_TOL
              and r["worst1"][0][1] <= MESH_TOL and r["delta3"] <= MESH_DELTA_TOL
              and r["moments3"][0][1] <= MESH_TOL3
              and all(x == want for x in launches) and plain == [0, 0]
              and all(len(x[tag]["history"]) == MESH_STEPS for x in ranks))
        fmt = lambda kv: [(k, f"{e:.2e}") for k, e in kv]
        line = (f"[train-mesh] demo f32 {label}(dp, tp) = ({dp}, {tp}) {impl}"
                f"{' remat' if remat else ''}, global batch {gb}, {MESH_STEPS} steps on 2 ranks "
                f"(coords {[x[tag]['coords'] for x in ranks]}) vs one process (1, 1): losses "
                f"{[round(h['loss'], 6) for h in one[tag]['history']]}, relative error per step "
                f"{[f'{e:.2e}' for e in r['step_err']]} (bounds {MESH_LOSS_TOL}, {MESH_LOSS_TOL}, "
                f"{MESH_LOSS3_TOL}); RMS error / RMS, worst three leaves: checkpoint-1 "
                f"{fmt(r['worst1'])} (bound {MESH_TOL}); checkpoint-{MESH_STEPS} moments "
                f"{fmt(r['moments3'])} (bound {MESH_TOL3}), change of the weights over all "
                f"leaves {r['delta3']:.3e} (bound {MESH_DELTA_TOL}); kernel 3 launches per rank "
                f"{launches} (want {want}); plain attention calls on CUDA {plain}")
        if exact is not None:
            # each f32 run against the same run in float64 on the host
            e_one = mesh_demo_readings(workdir, tag, "one", "f64", start,
                                       [one[tag]["history"]], exact[tag]["history"])
            e_mesh = mesh_demo_readings(workdir, tag, suffix, "f64", start,
                                        [x[tag]["history"] for x in ranks],
                                        exact[tag]["history"])
            line += "; against float64 on the host: " + "; ".join(
                f"{who} step 3 loss {e['step_err'][2]:.2e}, checkpoint-1 {fmt(e['worst1'][:1])}, "
                f"change of the weights {e['delta3']:.3e}"
                for who, e in (("one process", e_one), ("2 ranks", e_mesh)))
        log(f"{line}; {smi} {'ok' if ok else 'FAIL'}")
        verdict[tag] = ok
    return verdict


def report_mesh_full(tag, ranks, smi):
    """The full-width lines and gates: finite losses and gradient norm; at
    (1, 2) kernel 3's launches per rank and no plain attention on CUDA."""
    faults = []
    for run in ("full", "full_tp"):
        for r in ranks:
            f = r[run]
            hist = f["history"]
            P, T, N = f["row"]
            L = f["layers"]
            finite = all(math.isfinite(h[k]) for h in hist for k in ("loss", "loss_ar",
                                                                       "loss_consistency"))
            want = ({"train_attention_fwd": 2 * L * MESH_STEPS, "train_attention_dq": L * MESH_STEPS,
                     "train_attention_dkdv": L * MESH_STEPS} if f["impl"] == "splash"
                    else {n: 0 for n in TRAIN_KERNEL_NAMES})
            launches = {k: f["launches"][k] for k in TRAIN_KERNEL_NAMES}
            ok = (finite and len(hist) == MESH_STEPS and f["gnorm"] > 0
                  and math.isfinite(f["gnorm"]) and launches == want and f["plain"] == 0)
            peak = (f"peak torch.cuda.max_memory_allocated {f['peak_gib']:.2f} GiB "
                    f"({f['held_gib']:.2f} GiB held before)" if f["peak_gib"] is not None
                    else "peak not measured")
            dp, tp = f["shape"]
            log(f"[train-mesh] {tag} Qwen2.5-7B widths, {L} layers, bf16, remat, {f['impl']}, "
                f"(dp, tp) = ({dp}, {tp}){' fsdp' if dp > 1 else ''}, coords {f['coords']}: one "
                f"packed row of {P + 2 * T * N} tokens (P {P}, T {T}, N {N}) per data rank, "
                f"global batch {dp}: {MESH_STEPS} steps {[round(x, 3) for x in f['step_s']]} s "
                f"({tag}-bound, not a speed); losses {[round(h['loss'], 4) for h in hist]}; "
                f"gradient norm {f['gnorm']:.4f}; weights block {f['block_gib']:.2f} GiB; {peak} "
                f"(one process, a 4096-token row: 61.79 GiB on this card type); kernel 3 "
                f"launches {launches} (want {want}); plain attention calls on CUDA {f['plain']}; "
                f"{smi} {'ok' if ok else 'FAIL'}")
            if not ok:
                faults.append(f"{tag} full width ({dp}, {tp}) rank {f['coords']}")
    return faults


def report_exactness(counter, workdir, one, exact, smi):
    """Where the card's f32 training leaves exact arithmetic: the (1, 2)
    demo configuration in one process with kernel 3 (`one`) and once more
    with the plain attention on the card, each against the same run in
    float64 on the host (`exact`): relative loss error per step, the change
    of the weights and, per q/k leaf, the share of first-gradient entries
    above 1e-7 whose sign differs from float64's (Adam's first steps move
    each such entry by about the learning rate, whichever its size)."""
    from jacobiforcing_tpu_torch.models import qwen
    from jacobiforcing_tpu_torch.ops import train_attention as ta
    from jacobiforcing_tpu_torch.parallel.mesh import make_mesh

    kernel = qwen.train_attention
    qwen.train_attention = lambda q, k, v, **kw: ta.train_attention_ref(q, k, v, **kw)
    try:
        plain = mesh_demo_runs(counter, workdir, lambda dp, tp: make_mesh(1, 1), "plain",
                               tags=("tp2",))["tp2"]
    finally:
        qwen.train_attention = kernel
    start = checkpoint_leaves(DEMO)
    first = checkpoint_leaves(os.path.join(workdir, "tp2-f64", "checkpoint-1"))
    seen = {}
    for name, run in (("one", one["tp2"]), ("plain", plain)):
        r = mesh_demo_readings(workdir, "tp2", name, "f64", start, [run["history"]],
                               exact["tp2"]["history"])
        got = checkpoint_leaves(os.path.join(workdir, f"tp2-{name}", "checkpoint-1"))
        flips = {}
        for leaf in ("wq", "wk", "bq", "bk"):
            g, e = got[f"exp_avg layers.{leaf}"], first[f"exp_avg layers.{leaf}"]
            big = e.abs() > 1e-8  # the first moment is a tenth of the gradient
            flips[leaf] = float(((torch.sign(g) != torch.sign(e)) & big).double().mean())
        log(f"[train-exact] demo (1, 2) configuration in one process, f32 on the card with "
            f"{'kernel 3' if name == 'one' else 'the plain attention'}, against float64 on the "
            f"host: relative loss error per step {[f'{x:.2e}' for x in r['step_err']]}, change "
            f"of the weights over all leaves {r['delta3']:.3e}, first-gradient sign flips "
            f"{[(k, f'{v:.2e}') for k, v in flips.items()]}, kernel 3 launches "
            f"{ {k: run['launches'][k] for k in TRAIN_KERNEL_NAMES} }, plain attention calls "
            f"on CUDA {run['plain']}; {smi}")
        seen[name] = (r["step_err"][2], flips)
    # the aim of the f32 dQ's sum P dP delta: step 3's loss error within 10x
    # the plain attention's, each leaf's sign-flip share within 2x (a share of
    # 0 in the plain run counts as 1e-3, the resolution of the smallest leaf)
    (k3, kf), (p3, pf) = seen["one"], seen["plain"]
    loss_ratio = k3 / max(p3, 1e-12)
    flip_ratio = {leaf: kf[leaf] / max(pf[leaf], 1e-3) for leaf in kf}
    met = loss_ratio <= 10 and all(x <= 2 for x in flip_ratio.values())
    log(f"[train-exact] kernel 3 against the plain attention: step-3 loss error "
        f"{k3:.2e} / {p3:.2e} = {loss_ratio:.1f}x (aim <= 10x), sign-flip share ratio "
        f"{[(k, round(v, 2)) for k, v in flip_ratio.items()]} (aim <= 2x): aim "
        f"{'met' if met else 'NOT met'}; {smi}")


def phase_train_mesh(counter, timing, launches_out):
    """(c) kernel 3 at TP 2's shapes; (a) the demo widths on (2, 1) fsdp dense
    (global batch 2) and (1, 2) splash + remat, two ranks sharing the card
    over gloo, against one process on a (1, 1) mesh and beside float64 on
    the host; the same with planted faults, which must fail the gates; where
    the f32 runs leave float64 (`report_exactness`); (b) Qwen2.5-7B widths
    on (2, 1) fsdp dense and (1, 2) splash over gloo.  With two cards or
    more, (a) and (b) again over NCCL, one rank per card."""
    from jacobiforcing_tpu_torch.data import pack_trajectories, synthesize_trajectories_masking
    from jacobiforcing_tpu_torch.parallel.mesh import make_mesh

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    phase_train_tp_kernel(timing)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_mesh_", dir=os.path.join(REPO, "build"))
    faults = []
    worlds = ["gloo"] + (["nccl"] if DEV == "cuda" and torch.cuda.device_count() >= 2 else [])
    try:
        traj = synthesize_trajectories_masking(copy_task_samples(16, seed=0), chunk_size=32,
                                               pad_id=0, seed=0)
        pack_trajectories(traj, 32, output_path=os.path.join(workdir, "rows.jsonl"))
        one = mesh_demo_runs(counter, workdir, lambda dp, tp: make_mesh(1, 1), "one")
        one["workdir"] = workdir
        t0 = time.perf_counter()
        exact = mesh_demo_runs(counter, workdir, lambda dp, tp: make_mesh(1, 1), "f64",
                               torch.float64, "cpu")
        log(f"[train-mesh] demo float64 on the host (1, 1): {time.perf_counter() - t0:.1f}s")
        report_exactness(counter, workdir, one, exact, smi)
        for backend in worlds:
            tag = "gloo, both ranks on card 0" if backend == "gloo" else "NCCL, cards 0 and 1"
            t0 = time.perf_counter()
            ranks = spawn_train_ranks("demo", backend, workdir, timeout=300)
            log(f"[train-mesh] demo {tag}: ranks on cards {[r['device'] for r in ranks]}, "
                f"{time.perf_counter() - t0:.1f}s")
            faults += [f"{backend} demo {t}" for t, ok in
                       report_mesh_demo(ranks, one, exact, smi).items() if not ok]
            missed = []
            for name, tags in MESH_FAULTS.items():
                verdict = report_mesh_demo([r["faults"][name] for r in ranks], one, None, smi,
                                           suffix=f"fault-{name}",
                                           label=f"planted fault {name!r} ", tags=tags)
                missed += [f"{name} {t}" for t, ok in verdict.items() if ok]
            log(f"[train-mesh] {backend}: planted faults the gates missed: {missed or 'none'} "
                "(each planted run above must read FAIL)")
            faults += [f"{backend} planted fault passed: {m}" for m in missed]
            gc.collect()
            if DEV == "cuda":
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            ranks = spawn_train_ranks("full", backend, workdir, timeout=700)
            log(f"[train-mesh] full width {tag}: ranks on cards {[r['device'] for r in ranks]}, "
                f"{time.perf_counter() - t0:.1f}s")
            faults += report_mesh_full(backend, ranks, smi)
            if backend == "gloo":
                launches_out["train_tp2_full"] = ranks[0]["full_tp"]["launches"]
        if worlds == ["gloo"]:
            log(f"[train-mesh] NCCL: not run ({torch.cuda.device_count()} card; NCCL takes one "
                "rank per card)")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if faults:
        raise AssertionError("train_mesh: " + "; ".join(faults))


COMPARE_PATTERNS = {
    # [train-kernel-time] L=4096 ...: sdpa forward X ms, forward+backward Y ms
    "sdpa": r"\[train-kernel-time\] L=(\d+) .*sdpa forward ([\d.]+) ms, forward\+backward ([\d.]+)",
    # [train-kernel-time]   train_attention_fwd: X ms, bound Y ms
    "kernel": r"\[train-kernel-time\]\s+(train_attention_\w+): ([\d.]+) ms, bound ([\d.]+) ms",
    "steps": r"\[train-full\] .*steady ([\d.]+) steps/s = ([\d.]+) tokens/s",
    "step_ms": r"\[train-profile\] one step under the profiler: ([\d.]+) ms .*device busy "
               r"([\d.]+) ms",
    "group": r"\[train-profile\]\s+([^:]+\)|GEMM \(cuBLAS\)|AdamW \(fused\)|other): "
             r"([\d.]+) ms \(([\d.]+)% of device time\)",
    # [int4-kernel-time] gateup M=4 ... bf16: kernel X ms, ... weight bytes) Y ms, bound Z ms
    "int4": r"\[int4-kernel-time\] (\w+) M=(\d+) K=\d+ N=\d+ bf16: kernel ([\d.]+) ms, plain "
            r"[\d.]+ ms, x @ W_bf16 [^)]+\) ([\d.]+) ms, bound ([\d.]+) ms",
    # [train-kernel-time f32] train_attention_dq L=4096: X ms, bound Y ms
    "f32": r"\[train-kernel-time f32\] (train_attention_\w+) L=(\d+): ([\d.]+) ms",
}


def compare(parent: str, phases: str = "train_kernel,train", order: str = "PCCP",
            log_dir: str = "build/compare") -> int:
    """Run `chip_smoke.py <phases>` from the parent tree (P) and from this
    tree (C) in turns, each in a process of its own on the same card, and
    print the training kernels' times, the full-width steps/s, the step
    profile and the int4 kernel's times of every run side by side.  Each run's whole output goes to
    <log_dir>/compare-<n>-<P|C>.log (log_dir relative to this tree)."""
    import re

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip())
    trees = {"P": os.path.abspath(parent), "C": REPO}
    out_dir = os.path.join(REPO, log_dir)
    os.makedirs(out_dir, exist_ok=True)
    rows = []
    for n, tag in enumerate(order):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "chip_smoke.py", phases], cwd=trees[tag],
                              capture_output=True, text=True)
        text = proc.stdout + proc.stderr
        with open(os.path.join(out_dir, f"compare-{n}-{tag}.log"), "w") as f:
            f.write(text)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            log(f"[compare] run {n} ({tag}, {trees[tag]}) failed (rc {proc.returncode}) after "
                f"{wall:.1f}s:\n{text[-3000:]}")
            return 1
        got = {name: re.findall(pat, text) for name, pat in COMPARE_PATTERNS.items()}
        rows.append((n, tag, got))
        log(f"[compare] run {n}: {'parent' if tag == 'P' else 'change'} {trees[tag]}, "
            f"{wall:.1f}s")
        # kernel lines follow their L's sdpa line, in order
        for (L, f_ms, fb_ms), i in zip(got["sdpa"], range(0, 3 * len(got["sdpa"]), 3)):
            parts = [f"{k} {float(ms):.3f} ms (bound {float(b):.4f})"
                     for k, ms, b in got["kernel"][i:i + 3]]
            log(f"[compare]   {tag} L={L}: " + ", ".join(parts)
                + f"; sdpa forward {f_ms} ms, forward+backward {fb_ms} ms")
        for sps, tps in got["steps"]:
            log(f"[compare]   {tag} full-width training: {sps} steps/s, {tps} tokens/s")
        for step_ms, busy in got["step_ms"]:
            log(f"[compare]   {tag} profiled step {step_ms} ms, device busy {busy} ms")
        for g, ms, share in got["group"]:
            log(f"[compare]   {tag}   {g}: {ms} ms ({share}% of device time)")
        for sname, M, ms, gemm, b in got["int4"]:
            log(f"[compare]   {tag} int4 {sname} M={M}: {ms} ms (bound {b}), bf16 GEMM {gemm} ms")
    # every run's numbers of one kind side by side: parent runs, then change runs
    table = {}
    for _, tag, got in rows:
        for (L, *_), i in zip(got["sdpa"], range(0, 3 * len(got["sdpa"]), 3)):
            for kname, ms, _ in got["kernel"][i:i + 3]:
                table.setdefault(f"{kname} L={L} ms", {}).setdefault(tag, []).append(ms)
        for sps, _ in got["steps"]:
            table.setdefault("full-width training steps/s", {}).setdefault(tag, []).append(sps)
        for kname, L, ms in got["f32"]:
            table.setdefault(f"{kname} f32 L={L} ms", {}).setdefault(tag, []).append(ms)
        for sname, M, ms, gemm, _ in got["int4"]:
            table.setdefault(f"int4 {sname} M={M} ms", {}).setdefault(tag, []).append(ms)
            table.setdefault(f"int4 {sname} M={M} bf16 GEMM ms", {}).setdefault(tag, []).append(gemm)
    for what, by_tag in table.items():
        log(f"[compare] {what}: parent {', '.join(by_tag.get('P', []))}; change "
            f"{', '.join(by_tag.get('C', []))}")
    return 0


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "compare":
        # python3 chip_smoke.py compare PARENT_TREE PHASES [ORDER [LOG_DIR]]
        return compare(sys.argv[2], *sys.argv[3:6])
    if len(sys.argv) == 6 and sys.argv[1] == "tp-rank":
        # one rank of the `tp` phase: tp-rank RANK PORT OUT_JSON BACKEND
        return tp_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
    if len(sys.argv) == 8 and sys.argv[1] == "train-rank":
        # one rank of the `train_mesh` phase: train-rank PART RANK PORT OUT_JSON BACKEND WORKDIR
        return train_rank(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6],
                          sys.argv[7])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from jacobiforcing_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases = (sys.argv[1].split(",") if len(sys.argv) > 1
              else ["kernel", "train_kernel", "demo", "sampling", "apps", "full", "engine",
                    "full_quant", "tp", "train", "train_mesh"])

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    log(smi)  # name, power limit
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    seconds = _build.build_many(list(SOURCES))  # one nvcc per source, started together
    for name, sec in seconds.items():
        log(f"[build] {name}.cu built in {sec:.2f}s")
    log(f"[build] all kernels built in {time.perf_counter() - t0:.2f}s")

    timing = {}
    launches = {}
    def run(name, fn, *args):
        """One part of a phase, with its wall time on a line of its own."""
        t = time.perf_counter()
        out = fn(*args)
        log(f"[phase] {name}: {time.perf_counter() - t:.1f}s")
        return out

    if "kernel" in phases:
        kernel_design()
        run("kernel (paged attention)", phase_kernel, timing)
        run("kernel (paged attention, the cells' shapes)", phase_paged_cells, timing)
    for p in phases:
        if p.startswith("paged_cells"):
            # paged_cells[:REFERENCE_TREE]
            run(p, phase_paged_cells, timing, p.partition(":")[2] or None)
        run("kernel (speculative attention)", phase_spec_kernel, timing)
        run("kernel (TP local heads)", phase_tp_kernel, timing)
    if "kernel" in phases or "int4" in phases:
        run("kernel (int4 matmul)", phase_int4_kernel, timing)
        phase_int4_path(launches)
    if "kernel" in phases:
        phase_int8_gemm()
    if "kernel" in phases or "pointwise" in phases:
        run("pointwise", phase_pointwise, timing)
    if "train_kernel" in phases:
        run("train_kernel", phase_train_kernel, timing)
    if "train_f32_time" in phases:
        train_kernel_f32_times(timing)
    counter = PlainOnCudaCounter()
    params = None
    if "demo" in phases:
        run("demo", phase_demo, counter, launches)
        run("demo (quantized engines)", phase_demo_quant, counter, launches)
    if "sampling" in phases:
        run("sampling", phase_sampling, counter, launches)
    if "apps" in phases:
        run("apps", phase_apps, counter, launches)
    if "full" in phases:
        params = run("full", phase_full_width, counter, launches)
    if "engine" in phases:
        params = run("engine", phase_engine, counter, launches, params)
    if "full_quant" in phases:
        run("full_quant", phase_full_quant, counter, launches, params)
    if "tp" in phases:
        run("tp", phase_tp, counter, launches, params)
    if "train" in phases:
        run("train", phase_train, counter, launches, params)
    if "train_mesh" in phases:
        params = None  # two ranks of Qwen2.5-7B training share the card next
        gc.collect()
        torch.cuda.empty_cache()
        run("train_mesh", phase_train_mesh, counter, timing, launches)
    log(f"[phase] all, the build included: {time.perf_counter() - t0:.1f}s")

    if all(p in phases for p in ("kernel", "train_kernel", "full", "full_quant", "train")):
        # each kernel at its main-path shape (Jacobi decode B=4, L=64; the MR
        # run's most frequent tier, B=4; the same two on the fp8 cache of the
        # W8A8 run and on the e5m2 cache of the bf16 run; one decoder layer's
        # gate/up product at M=256; the trainer's row of 4096 tokens), with
        # the launches of that path's run
        rows = [("paged_attention", timing["decode"], launches["jacobi"]["paged_attention"]),
                ("spec_attention", timing[launches["mr_main_shape"]],
                 launches["mr"]["spec_attention"]),
                ("paged_attention_fp8", timing["decode_fp8"],
                 launches["w8a8_fp8_jacobi"]["paged_attention"]),
                ("spec_attention_fp8", timing[launches["w8a8_fp8_mr_main_shape"] + "_fp8"],
                 launches["w8a8_fp8_mr"]["spec_attention"]),
                ("paged_attention_e5m2", timing["decode_e5m2"],
                 launches["bf16_e5m2_jacobi"]["paged_attention"]),
                ("spec_attention_e5m2", timing[launches["bf16_e5m2_mr_main_shape"] + "_e5m2"],
                 launches["bf16_e5m2_mr"]["spec_attention"]),
                ("int4_matmul", timing["int4_gateup_M256"], launches["int4_path"]["int4_matmul"])]
        rows += [(n, timing[f"{n}_L4096"], launches["train"][n]) for n in TRAIN_KERNEL_NAMES]
        if "train_mesh" in phases:
            # kernel 3 at TP 2's local heads; launches: rank 0 of the
            # Qwen2.5-7B (1, 2) run on rows of 4096 tokens
            rows += [(f"{n}_kh2", timing[f"{n}_kh2_L4096"], launches["train_tp2_full"][n])
                     for n in TRAIN_KERNEL_NAMES]
        # the fused pointwise kernels at cell 1's trip shape, with the launches
        # of the full-width Jacobi path
        rows += [(n, timing[f"pointwise_{n}_coder7b_trip"], launches["jacobi"][n])
                 for n in POINTWISE]
        if "tp" in phases:
            # rank 0 of the TP 2 run: its Jacobi and MR paths on 2 KV heads
            rows += [("paged_attention_kh2", timing["decode_kh2"],
                      launches["tp2_jacobi"]["paged_attention"]),
                     ("spec_attention_kh2", timing[launches["tp2_mr_main_shape"] + "_kh2"],
                      launches["tp2_mr"]["spec_attention"])]
        print(json.dumps({"kernels": [{
            "name": name, "route": "cuda", **KERNELS[name], "launches": count,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        } for name, t, count in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
