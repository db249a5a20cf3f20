#!/usr/bin/env python3
"""Drive the PyTorch port (`jacobiforcing_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

    python3 chip_smoke.py kernel,train_kernel   # the kernels against their plain versions only

Phases (each prints its lines; any failure exits non-zero and prints no
result line):
  1. the card's name and power limit; build the CUDA kernels (one nvcc per
     source, started together).
  2. `kernel`: each serving kernel against its plain PyTorch version, f32 and
     bf16, at the demo (D=64, KH=2, G=2) and Qwen2.5-7B (D=128, KH=4, G=7) head
     shapes, with shuffled page tables, ragged lengths and -1 padding rows
     (tolerances in `check`).  The paged-attention kernel: the bitwise
     AR-row == Jacobi-row check; times at the decode and prefill shapes.  The
     speculative-attention kernel of the multiblock (MR) decoder: T in
     {N, 2N, 6N} in-flight tokens, committed lengths from 0 up, the decoder's
     tree mask with holes and a random mask; bitwise, the RA rows of a T=6N
     call == the rows of a T=N call and a row of a B=8 call == the same row
     at B=1; times at T = 64 / 128 / 384.  Every timed shape prints kernel,
     plain-version and SDPA times beside the bound and is held to `check`.
  3. `train_kernel`: the training-attention kernels (forward, dQ, dK/dV)
     against the plain version under autograd in float32: f32 and bf16, both
     head shapes, the three mask variants, rows shorter than their bucket, T
     below the pairs the row holds, prompt lengths off every tile edge, N
     16/32/64 (tolerances in `check` and `check_grad`); gradients bitwise equal
     across two runs; rows that see nothing zero.  Times at L 4096 and
     L 16384 (Qwen2.5-7B heads, bf16), each kernel beside its bound, the plain
     version and SDPA under a dense boolean mask, forward and backward.
  4. `demo`: the trained demo checkpoint `assets/tpf_demo_n32_v7` in f32
     through `LLM` and the port's `bench_generate.run`: `ar`, `jacobi` and
     `mr` (auto-policy off, then on) on all 64 held-out prompts.  All token
     streams must be identical, 2033 tokens, 64/64 EOS, and with the policy
     off every MR tier (full / no-candidate / RA-only) must have run.
  5. `full`: Qwen2.5-7B widths with random bf16 weights, 4 requests of
     256-1024 random prompt tokens through `LLM.generate`: prefill, AR,
     Jacobi and MR (policy off).  Each kernel's launch count is zeroed before
     each path and must grow in the paths that run it; the JSON line reports
     the Jacobi run's count for the paged kernel and the MR run's for the
     speculative one.
  6. `train`: the consistency trainer through `train(TrainerArgs(...))` with
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

The line before the last is a JSON object with the kernels' numbers; the last
line is {"ok": true, "device": {...}}.  Without a CUDA device, or outside the
repository, it exits non-zero.
"""

from __future__ import annotations

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
REPO = os.path.dirname(os.path.abspath(__file__))
DEMO = os.path.join(REPO, "assets", "tpf_demo_n32_v7")
SOURCES = ("paged_attention", "spec_attention", "train_attention")  # csrc/<name>.cu
_TRAIN = dict(source="jacobiforcing_tpu_torch/csrc/train_attention.cu",
              replaces="jacobiforcing_tpu/ops/pallas/train_attention.py:112")
KERNELS = {
    "paged_attention": dict(source="jacobiforcing_tpu_torch/csrc/paged_attention.cu",
                            replaces="jacobiforcing_tpu/ops/pallas/paged_attention.py:736"),
    "spec_attention": dict(source="jacobiforcing_tpu_torch/csrc/spec_attention.cu",
                           replaces="jacobiforcing_tpu/ops/pallas/spec_attention.py:245"),
    "train_attention_fwd": _TRAIN,
    "train_attention_dkdv": _TRAIN,
    "train_attention_dq": _TRAIN,
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


def make_case(B, L, KH, G, D, page, ctx_max, dtype, seed, n_pad=0, full=False):
    """Random paged inputs: shuffled pages, ragged lengths (all `ctx_max` when
    `full`), -1 table tails and `n_pad` batch-bucket padding rows (all -1
    table, as the engine pads)."""
    r = np.random.RandomState(seed)
    P = -(-(ctx_max + L) // page) + 1
    n_real = B - n_pad
    lens = r.randint(max(L, 1), ctx_max + 1, size=n_real)
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
    return dict(q=q, k=k, v=v, bt=t(bt), clen=t(clen), pos=t(pos), page=page,
                scale=1.0 / math.sqrt(D), n_real=n_real)


def run_kernel(c):
    from jacobiforcing_tpu_torch.ops.paged_attention_cuda import paged_attention_cuda

    return paged_attention_cuda(c["q"], c["k"], c["v"], c["bt"], c["clen"], c["pos"],
                                c["scale"], page_size=c["page"])


def run_plain(c):
    from jacobiforcing_tpu_torch.ops.attention import paged_attention_ref

    return paged_attention_ref(c["q"], c["k"], c["v"], c["bt"], c["clen"], c["pos"],
                               c["scale"], page_size=c["page"])


def check(out, ref, n_real=None):
    """(max_abs_err, worst err/tol, ok) over the real rows (the first `n_real`
    sequences, or every row given).  f32: |err| <=
    1e-5 * max|ref|.  bf16 (the plain version rounds the probabilities and
    the output to bf16): per element |err| <= 2^-5 * |ref| + 2^-7 * max|ref|
    of its row, i.e. a few bf16 ulps of the element and of its row, so a
    long-context row whose outputs are ~0.03 is held to ~1e-3, not to 2e-2."""
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
    kv_bytes = 2 * int(clen.sum()) * KH * D * it
    nbytes = (2 * q.numel() * it + kv_bytes + c["bt"].numel() * 4 + c["clen"].numel() * 4
              + c["pos"].numel() * 4)
    visible = torch.minimum(pos + 1, clen[:, None]).clamp(min=0).sum()
    ops = 4 * D * NH * int(visible)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sdpa_ms(c):
    """One `scaled_dot_product_attention` call on the same function, with the
    pages gathered to dense K/V beforehand (the gather is not timed)."""
    from jacobiforcing_tpu_torch.ops.kv_cache import gather_pages

    q, page = c["q"], c["page"]
    B, L, NH, D = q.shape
    k = gather_pages(c["k"], c["bt"], page).permute(0, 2, 1, 3).contiguous()  # [B,KH,S,D]
    v = gather_pages(c["v"], c["bt"], page).permute(0, 2, 1, 3).contiguous()
    S = k.shape[2]
    key = torch.arange(S, device=q.device)
    mask = (key[None, None, :] <= c["pos"][:, :, None]) & (key[None, None, :] < c["clen"][:, None, None])
    mask = mask[:, None]
    qt = q.transpose(1, 2).contiguous()
    f = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, k, v, attn_mask=mask, scale=c["scale"], enable_gqa=True)
    return time_ms(f)


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

    # bitwise: a row from an L=1, B=1 call == the same row inside a B=8, L=64 block
    for dname, dtype in dtypes.items():
        for sname, KH, G, D, page in shapes:
            c = make_case(8, 64, KH, G, D, page, 2048, dtype, seed=1000, n_pad=1)
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
            log(f"[kernel] bitwise AR-row == Jacobi-row {dname} {sname}: 9 rows, {diffs} differ "
                f"{'ok' if diffs == 0 else 'FAIL'}")
            if diffs:
                raise AssertionError("AR row and Jacobi row differ bitwise")

    # times at the main path's shapes (Qwen2.5-7B heads, bf16, page 256)
    for name, (B, L, ctx) in {"decode": (4, 64, 1024), "prefill": (1, 1024, 1024)}.items():
        c = make_case(B, L, 4, 7, 128, 256, ctx, torch.bfloat16, seed=2000, full=True)
        ms = time_ms(lambda: run_kernel(c))
        plain = time_ms(lambda: run_plain(c), iters=5)
        lib = sdpa_ms(c)
        bms, by = bound(c)
        err, worst, ok = check(run_kernel(c), run_plain(c), c["n_real"])
        log(f"[kernel-time] {name} B={B} L={L} ctx={ctx} bf16 D=128 KH=4 G=7: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.5f} ms ({by}), "
            f"{bms / ms * 100:.2f}% of bound, max_abs_err {err:.3e} max err/tol {worst:.3f} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with the plain version at the {name} shape")
        timing[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                            max_abs_err=err)


# ---------------------------------------------------------------------------
# Phase 2, the speculative-attention kernel
# ---------------------------------------------------------------------------


def make_spec_case(B, N, K, C, KH, G, D, page, ctx_max, dtype, seed, n_pad=0, mask="tree",
                   full=False):
    """Random inputs of the MR decoder's attention: T = (1+C+K-1)*N in-flight
    tokens per sequence over shuffled pages with ragged committed lengths from
    0 up to `ctx_max` (all `ctx_max` when `full`) and `n_pad` batch-bucket
    padding rows (all -1 table, length 1, all-false mask).  `mask`: "tree" is
    the decoder's mask (same-segment causal, pseudos see RA and earlier
    pseudos) with holes where segments are inactive or drafts short (none when
    `full`); "random" lets each key through with probability 0.3."""
    from jacobiforcing_tpu_torch.engine.multiblock import tree_mask

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
    return dict(q=f(B, T, KH * G, D), k=f(KH, num_pages * page, D), v=f(KH, num_pages * page, D),
                bt=t(bt), clen=t(clen), k_new=f(B, T, KH, D), v_new=f(B, T, KH, D),
                mask=t(m), page=page, scale=1.0 / math.sqrt(D), n_real=n_real, N=N)


def spec_args(c):
    return (c["q"], c["k"], c["v"], c["bt"], c["clen"], c["k_new"], c["v_new"], c["mask"],
            c["scale"])


def run_spec_kernel(c):
    from jacobiforcing_tpu_torch.ops.spec_attention_cuda import spec_attention_cuda

    return spec_attention_cuda(*spec_args(c), page_size=c["page"])


def run_spec_plain(c):
    from jacobiforcing_tpu_torch.ops.attention import paged_attention_with_block_ref

    return paged_attention_with_block_ref(*spec_args(c), page_size=c["page"])


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
    nbytes = (2 * q.numel() * it + 2 * int(clen.sum()) * KH * D * it
              + 2 * c["k_new"].numel() * it + c["mask"].numel() + c["bt"].numel() * 4
              + c["clen"].numel() * 4)
    visible = int(clen.sum()) * T + int(c["mask"][:n].sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * D * NH * visible / PEAK_OPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spec_sdpa_ms(c):
    """One `scaled_dot_product_attention` call on the same function: dense
    K/V, committed pages gathered beforehand and the in-flight block appended,
    under one boolean mask (neither the gather nor the concatenation is timed)."""
    from jacobiforcing_tpu_torch.ops.kv_cache import gather_pages

    q, page = c["q"], c["page"]
    kc = gather_pages(c["k"], c["bt"], page)  # [B, S, KH, D]
    vc = gather_pages(c["v"], c["bt"], page)
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

    # bitwise: RA rows of a T=6N call == the rows of a T=N call on the same
    # sequence (the batch-global tier choice must not change a row's bits), and
    # a row of a B=8 call == the same row at B=1
    for dname, dtype in dtypes.items():
        for sname, KH, G, D, page in shapes:
            for N in (32, 64):
                c = make_spec_case(8, N, 2, 4, KH, G, D, page, 2048, dtype, seed=5000 + N, n_pad=1)
                big = run_spec_kernel(c)
                ra = run_spec_kernel(spec_slice(c, T=N))
                tier_diffs = int((bits(big[:, :N]) != bits(ra)).any(-1).any(-1).sum())
                batch_diffs = 0
                for b in (0, 3, 6):
                    solo = run_spec_kernel(spec_slice(c, b=b))
                    batch_diffs += int((bits(solo[0]) != bits(big[b])).any(-1).any(-1).sum())
                ok = tier_diffs == 0 and batch_diffs == 0
                log(f"[spec-kernel] bitwise {dname} {sname} N={N}: RA rows of T=6N vs T=N, "
                    f"{8 * N} rows, {tier_diffs} differ; rows of B=8 vs B=1, {3 * 6 * N} rows, "
                    f"{batch_diffs} differ {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("spec kernel rows depend on the tier or the batch")

    # times at the MR path's shapes (Qwen2.5-7B heads, bf16, page 256, B=4, ctx 1024, N=64)
    for name, (K, C) in {"T64": (1, 0), "T128": (2, 0), "T384": (2, 4)}.items():
        c = make_spec_case(4, 64, K, C, 4, 7, 128, 256, 1024, torch.bfloat16, seed=6000, full=True)
        T = c["q"].shape[1]
        ms = time_ms(lambda: run_spec_kernel(c))
        plain = time_ms(lambda: run_spec_plain(c), iters=5)
        lib = spec_sdpa_ms(c)
        bms, by = spec_bound(c)
        err, worst, ok = check(run_spec_kernel(c), run_spec_plain(c))
        log(f"[spec-kernel-time] T={T} B=4 ctx=1024 bf16 D=128 KH=4 G=7: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {bms:.5f} ms ({by}), "
            f"{bms / ms * 100:.2f}% of bound, max_abs_err {err:.3e} max err/tol {worst:.3f} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"spec kernel disagrees with the plain version at T={T}")
        timing[name] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by,
                            max_abs_err=err)


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
    of its row, as `check`, + 2^-9 * max|ref| of the tensor: the kernels read
    the saved output rounded to bf16, so delta = rowsum(dO * O) is off by
    2^-9 relative, which shows where the reference cancels exactly (a row that
    sees a single key has P = 1 and dS = dP - delta = 0)."""
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
    S, takes dP, dV and dK."""
    q = c["q"]
    L, NH, D = q.shape
    KH = c["k"].shape[1]
    it = q.element_size()
    qb, kb, rowb = L * NH * D * it, L * KH * D * it, L * NH * 4
    pairs = train_pairs(c, NH)
    work = {"train_attention_fwd": (2 * qb + 2 * kb + rowb, 2),  # q,k,v -> out,lse
            "train_attention_dq": (4 * qb + 2 * kb + 2 * rowb, 3),  # q,k,v,out,dO,lse -> dq,delta
            "train_attention_dkdv": (2 * qb + 4 * kb + 2 * rowb, 4)}  # q,k,v,dO,lse,delta -> dk,dv
    out = {}
    for name, (nbytes, products) in work.items():
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = products * 2 * D * pairs * NH / PEAK_OPS[q.dtype] * 1e3
        out[name] = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return out


def phase_train_kernel(timing):
    from jacobiforcing_tpu_torch.ops import train_attention_cuda as tac
    from jacobiforcing_tpu_torch.ops.train_attention import (
        train_attention, train_attention_ref, train_mask)

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    shapes = [("demo", 2, 2, 64), ("qwen7b", 4, 7, 128)]
    # (L, prompt_len, T, seq_len, N, window): seq_len < L everywhere, prompt
    # lengths off every tile edge, N 16/32/64, and in the last T below the
    # pairs that seq_len holds (rows past pair T take no part)
    layouts = [(1024, 100, 14, 996, 32, 2), (1024, 37, 6, 805, 64, 3), (768, 250, 16, 762, 16, 4),
               (1024, 128, 10, 896, 32, 2)]
    n = 0
    for dname, dtype in dtypes.items():
        for sname, KH, G, D in shapes:
            for variant in ("single", "multiblock", "window"):
                for L, P, T, S, N, W in layouts:
                    c = make_train_case(L, P, T, S, N, KH, G, D, dtype, variant, W, seed=7000 + n)
                    n += 1
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
                    tag = (f"{dname} {sname} {variant} L={L} P={P} T={T} seq_len={S} N={N}"
                           + (f" W={W}" if variant == "window" else ""))
                    log(f"[train-kernel] {tag}: err/tol out {res[0][1]:.3f} dq {res[1][1]:.3f} "
                        f"dk {res[2][1]:.3f} dv {res[3][1]:.3f} max_abs_err out {res[0][0]:.3e} "
                        f"finite={finite} bitwise-repeat={same} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"train kernel disagrees with the plain version: {tag}")

    # times at the trainer's shapes: Qwen2.5-7B heads, bf16, `single`, N=32
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for name, (L, P, T) in {"L4096": (4096, 512, 56), "L16384": (16384, 1024, 240)}.items():
        c = make_train_case(L, P, T, L, 32, 4, 7, 128, torch.bfloat16, "single", 4, seed=8000)
        q, k, v, dout = c["q"], c["k"], c["v"], c["dout"]
        layout = tuple(c["layout"].values())
        iters = 10 if L <= 4096 else 3
        out, lse = tac.train_attention_fwd_cuda(q, k, v, layout)
        dq, delta = tac.train_attention_dq_cuda(q, k, v, out, lse, dout, layout)
        ms = {
            "train_attention_fwd": time_ms(
                lambda: tac.train_attention_fwd_cuda(q, k, v, layout), iters),
            "train_attention_dq": time_ms(
                lambda: tac.train_attention_dq_cuda(q, k, v, out, lse, dout, layout), iters),
            "train_attention_dkdv": time_ms(
                lambda: tac.train_attention_dkdv_cuda(q, k, v, lse, delta, dout, layout), iters),
        }
        # the plain version materialises [heads, L, L] scores: all heads at once
        # at L=4096, one query head at a time (times summed) at L=16384
        step = 28 if L <= 4096 else 1
        plain_f = plain_fb = 0.0
        errs = {}
        got = train_grads(train_attention, c)
        ref_parts = []
        for h0 in range(0, 28, step):
            kv = slice(h0 // 7, max(h0 // 7 + 1, (h0 + step) // 7))
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
        kt = k.repeat_interleave(7, dim=1).transpose(0, 1)[None].contiguous().requires_grad_()
        vt = v.repeat_interleave(7, dim=1).transpose(0, 1)[None].contiguous().requires_grad_()
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
        pairs = train_pairs(c, 28)
        log(f"[train-kernel-time] L={L} P={P} T={T} N=32 single bf16 D=128 KH=4 G=7: "
            f"{pairs} visible pairs of {L * L} ({pairs / L / L * 100:.1f}%); plain forward "
            f"{plain_f:.3f} ms, forward+backward {plain_fb:.3f} ms; sdpa forward {lib_f:.3f} ms, "
            f"forward+backward {lib_fb:.3f} ms; kernel out vs sdpa err/tol {w_lib:.3f}"
            + "".join(f", {k_} vs f32 plain err/tol {r[1]:.3f}" for k_, r in errs.items())
            + f" {'ok' if ok else 'FAIL'}")
        for kname, t in ms.items():
            bms, by = bounds[kname]
            log(f"[train-kernel-time]   {kname}: {t:.3f} ms, bound {bms:.4f} ms ({by}), "
                f"{bms / t * 100:.2f}% of bound")
        log(f"[train-kernel-time]   backward (delta + dQ + dK/dV) "
            f"{ms['train_attention_dq'] + ms['train_attention_dkdv']:.3f} ms, "
            f"forward+backward {sum(ms.values()):.3f} ms")
        if not ok:
            raise AssertionError(f"train kernel disagrees at the timed shape L={L}")
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
    from jacobiforcing_tpu_torch.ops import train_attention_cuda as tac
    from jacobiforcing_tpu_torch.ops.paged_attention_cuda import paged_attention_cuda
    from jacobiforcing_tpu_torch.ops.spec_attention_cuda import spec_attention_cuda

    return {"paged_attention": paged_attention_cuda, "spec_attention": spec_attention_cuda,
            "train_attention_fwd": tac.train_attention_fwd_cuda,
            "train_attention_dkdv": tac.train_attention_dkdv_cuda,
            "train_attention_dq": tac.train_attention_dq_cuda}


def zero_counts(counter):
    for fn in _wrappers().values():
        fn.launches = 0
    counter.n = 0


def read_counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


MR_STATS = ("mr_full", "mr_nocand", "mr_ra_only", "mr_single")


def phase_demo(counter, launches_out):
    from jacobiforcing_tpu_torch.apps import bench_generate
    from jacobiforcing_tpu_torch.engine.llm import LLM

    with open(os.path.join(DEMO, "tpf_demo.json")) as f:
        meta = json.load(f)

    def make_llm(**kw):
        return LLM(model=DEMO, device="cuda", dtype=torch.float32, kvcache_page_size=16,
                   max_model_len=512, jacobi_chunk_tokens=64, eos=int(meta["eos"]),
                   prefill_token_buckets=(32, 64, 128, 256, 512), num_kv_pages=1024, **kw)

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


def phase_full_width(counter, launches_out):
    from jacobiforcing_tpu_torch.config import SamplingParams
    from jacobiforcing_tpu_torch.engine.llm import LLM
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params

    torch.cuda.reset_peak_memory_stats()
    cfg = ModelConfig()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for v in params.values()
                   for t in (v.values() if isinstance(v, dict) else [v]))
    log(f"[full] Qwen2.5-7B widths: {n_params / 1e9:.3f}B random bf16 params in "
        f"{time.perf_counter() - t0:.1f}s")
    # MR runs the requested program (auto-policy off), so every MR iteration
    # goes through the speculative kernel; the option touches no other strategy
    llm = LLM(device="cuda", model_cfg=cfg, params=params, num_kv_pages=512,
              kvcache_page_size=256, eos=-1, jacobi_mr_auto_policy=False)
    r = np.random.RandomState(0)
    prompts = [r.randint(0, cfg.vocab_size, size=n).tolist() for n in (256, 512, 768, 1024)]
    streams, launches, plain_on_cuda = {}, {}, {}
    # prefill alone first (one token each), to time it apart from decode; the
    # prefix cache then holds the prompts' full pages for every strategy
    zero_counts(counter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    llm.generate(prompts, SamplingParams(temperature=0.0, max_tokens=1))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches["prefill"], plain_on_cuda["prefill"] = read_counts(), counter.n
    log(f"[full] prefill of 4 prompts (2560 tokens, cold) {prefill_ms:.1f} ms; kernel launches "
        f"{launches['prefill']}; plain attention calls on CUDA: {counter.n}")
    sps = {
        "autoregressive": SamplingParams(temperature=0.0, max_tokens=128),
        "jacobi": SamplingParams(temperature=0.0, max_tokens=128, decode_strategy="jacobi",
                                 jacobi_block_len=64, jacobi_max_iterations=1 << 20),
        "mr": SamplingParams(temperature=0.0, max_tokens=128, decode_strategy=MR,
                             jacobi_block_len=64, jacobi_max_blocks=2,
                             jacobi_n_gram_pool_size=4, jacobi_max_iterations=1 << 20),
    }
    for strategy, sp in sps.items():
        stats0 = dict(llm.stats)
        zero_counts(counter)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = llm.generate(prompts, sp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[strategy], plain_on_cuda[strategy] = read_counts(), counter.n
        streams[strategy] = [o["token_ids"] for o in outs]
        toks = sum(len(s) for s in streams[strategy])
        delta = {k: llm.stats.get(k, 0) - stats0.get(k, 0) for k in llm.stats}
        iters, fwds, steps = delta["jacobi_iterations"], delta["chunk_forwards"], delta["ar_steps"]
        line = (f"[full] {strategy}: {toks} tokens in {wall:.3f}s = {toks / wall:.2f} tok/s "
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
            launches_out["mr_main_shape"] = {
                "mr_ra_only": "T64", "mr_nocand": "T128", "mr_full": "T384",
            }[max(tiers, key=tiers.get)]
        log(line + f"; kernel launches {launches[strategy]}; plain attention calls on CUDA: "
            f"{counter.n}")
    for other in ("jacobi", "mr"):
        pairs = list(zip(streams["autoregressive"], streams[other]))
        match = [sum(x == y for x, y in zip(a[:128], b[:128])) / max(min(len(a), len(b), 128), 1)
                 for a, b in pairs]
        first_diff = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
                      for a, b in pairs]
        log(f"[full] AR vs {other} first-128-token match rate per request: "
            f"{[round(m, 4) for m in match]} (first differing index {first_diff}); bf16 "
            f"near-ties on a random model make this a reported number, not a gate")
    log(f"[full] peak torch.cuda.max_memory_allocated = "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    lens_ok = all(len(s) == 128 for v in streams.values() for s in v)
    for name in ("jacobi", "mr"):
        profile_decode(llm, prompts, name, sps[name])
    llm.exit()
    del llm  # the KV pool goes; the weights stay for the `train` phase
    missed = [p for p in launches if launches[p]["paged_attention"] <= 0 or plain_on_cuda[p]]
    if launches["mr"]["spec_attention"] <= 0:
        missed.append("mr (speculative kernel)")
    if any(launches[p]["spec_attention"] for p in ("prefill", "autoregressive", "jacobi")):
        missed.append("a non-MR path launched the speculative kernel")
    if missed or not lens_ok:
        raise AssertionError(f"full width: paths {missed} did not run through the kernels alone, "
                             f"or a request came up short of 128 tokens ({lens_ok=})")
    launches_out.update(launches)
    return params


def profile_decode(llm, prompts, name, sp):
    """Where the device time of serving one strategy goes: torch.profiler over
    4 requests (prefill + 32 new tokens each, block 64), device kernel time
    summed by kernel name, and the device's busy share of the wall."""
    from dataclasses import replace

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sp = replace(sp, max_tokens=32)
    # prompts that are not prefix-cached, and not shared between the strategies
    prompts = [p[::-1] if name == "jacobi" else p[1:][::-1] for p in prompts]
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
              "spec_attention (this repo's kernel)": 0.0, "GEMM (cuBLAS)": 0.0, "other": 0.0}
    for kname, t in kernels.items():
        low = kname.lower()
        if "paged_attention" in low:
            groups["paged_attention (this repo's kernel)"] += t
        elif "spec_attention" in low:
            groups["spec_attention (this repo's kernel)"] += t
        elif any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma")):
            groups["GEMM (cuBLAS)"] += t
        else:
            groups["other"] += t
    log(f"[profile] {name}, 4 requests x 32 new tokens, {fwds} batched forwards: wall "
        f"{wall_ms:.1f} ms under the profiler, device busy {busy:.1f} ms "
        f"({busy / wall_ms * 100:.1f}% of wall, idle {100 - busy / wall_ms * 100:.1f}%)")
    for g, t in groups.items():
        log(f"[profile]   {g}: {t:.2f} ms ({t / max(busy, 1e-9) * 100:.1f}% of device time)")
    for kname, t in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   top kernel {t:8.2f} ms  {kname[:110]}")


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


def param_items(params):
    for k, v in params.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                yield f"layers.{kk}", vv
        else:
            yield k, v


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
    """Device time by group inside the `profiled_step` range of a trace."""
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
    for e in events:
        # kernels and copies only: a record_function range also shows on the
        # device's timeline, as an annotation that spans what it launched
        if (e.device_type != DeviceType.CUDA or e.is_user_annotation
                or not (lo <= e.time_range.start <= hi)):
            continue
        t = (e.time_range.end - e.time_range.start) / 1e3  # us -> ms
        named[e.name] = named.get(e.name, 0.0) + t
        low = e.name.lower()
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
        step_profile(prof, (stamps[-1] - stamps[-2]) * 1e3)


def phase_train(counter, launches_out, params=None):
    out_root = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=os.path.join(REPO, "build"))
    try:
        phase_train_demo(counter, out_root)
    finally:
        shutil.rmtree(out_root, ignore_errors=True)
    phase_train_full(counter, launches_out, params)


def main() -> int:
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
              else ["kernel", "train_kernel", "demo", "full", "train"])

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
    if "kernel" in phases:
        phase_kernel(timing)
        phase_spec_kernel(timing)
    if "train_kernel" in phases:
        phase_train_kernel(timing)
    counter = PlainOnCudaCounter()
    params = None
    if "demo" in phases:
        phase_demo(counter, launches)
    if "full" in phases:
        params = phase_full_width(counter, launches)
    if "train" in phases:
        phase_train(counter, launches, params)

    if all(p in phases for p in ("kernel", "train_kernel", "full", "train")):
        # each kernel at its main-path shape (Jacobi decode B=4, L=64; the MR
        # run's most frequent tier, B=4; the trainer's row of 4096 tokens),
        # with the launches of that path's run
        rows = [("paged_attention", timing["decode"], launches["jacobi"]),
                ("spec_attention", timing[launches["mr_main_shape"]], launches["mr"])]
        rows += [(n, timing[f"{n}_L4096"], launches["train"]) for n in TRAIN_KERNEL_NAMES]
        print(json.dumps({"kernels": [{
            "name": name, "route": "cuda", **KERNELS[name], "launches": counts[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        } for name, t, counts in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
