#!/usr/bin/env python3
"""Drive the PyTorch port (`jacobiforcing_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

    python3 chip_smoke.py kernel     # the kernels against their plain versions only

Phases (each prints its lines; any failure exits non-zero and prints no
result line):
  1. the card's name and power limit; build the CUDA kernels (one nvcc per
     source, started together).
  2. `kernel`: each kernel against its plain PyTorch version, f32 and bf16, at
     the demo (D=64, KH=2, G=2) and Qwen2.5-7B (D=128, KH=4, G=7) head shapes,
     with shuffled page tables, ragged lengths and -1 padding rows
     (tolerances in `check`).  The paged-attention kernel: the bitwise
     AR-row == Jacobi-row check; times at the decode and prefill shapes.  The
     speculative-attention kernel of the multiblock (MR) decoder: T in
     {N, 2N, 6N} in-flight tokens, committed lengths from 0 up, the decoder's
     tree mask with holes and a random mask; bitwise, the RA rows of a T=6N
     call == the rows of a T=N call and a row of a B=8 call == the same row
     at B=1; times at T = 64 / 128 / 384.  Every timed shape prints kernel,
     plain-version and SDPA times beside the bound and is held to `check`.
  3. `demo`: the trained demo checkpoint `assets/tpf_demo_n32_v7` in f32
     through `LLM` and the port's `bench_generate.run`: `ar`, `jacobi` and
     `mr` (auto-policy off, then on) on all 64 held-out prompts.  All token
     streams must be identical, 2033 tokens, 64/64 EOS, and with the policy
     off every MR tier (full / no-candidate / RA-only) must have run.
  4. `full`: Qwen2.5-7B widths with random bf16 weights, 4 requests of
     256-1024 random prompt tokens through `LLM.generate`: prefill, AR,
     Jacobi and MR (policy off).  Each kernel's launch count is zeroed before
     each path and must grow in the paths that run it; the JSON line reports
     the Jacobi run's count for the paged kernel and the MR run's for the
     speculative one.

The line before the last is a JSON object with the kernels' numbers; the last
line is {"ok": true, "device": {...}}.  Without a CUDA device, or outside the
repository, it exits non-zero.
"""

from __future__ import annotations

import json
import math
import os
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
KERNELS = {
    "paged_attention": dict(source="jacobiforcing_tpu_torch/csrc/paged_attention.cu",
                            replaces="jacobiforcing_tpu/ops/pallas/paged_attention.py:736"),
    "spec_attention": dict(source="jacobiforcing_tpu_torch/csrc/spec_attention.cu",
                           replaces="jacobiforcing_tpu/ops/pallas/spec_attention.py:245"),
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
# Phases 3 and 4
# ---------------------------------------------------------------------------


class PlainOnCudaCounter:
    """Counts calls of the plain attentions (paged and speculative) on CUDA
    tensors from inside the port; there must be none."""

    def __init__(self):
        from jacobiforcing_tpu_torch.ops import attention

        self.n = 0
        for name in ("paged_attention_ref", "paged_attention_with_block_ref"):
            setattr(attention, name, self._counting(getattr(attention, name)))

    def _counting(self, orig):
        def wrapped(q, *a, **kw):
            self.n += int(q.is_cuda)
            return orig(q, *a, **kw)

        return wrapped


def zero_counts(counter):
    from jacobiforcing_tpu_torch.ops.paged_attention_cuda import paged_attention_cuda
    from jacobiforcing_tpu_torch.ops.spec_attention_cuda import spec_attention_cuda

    paged_attention_cuda.launches = spec_attention_cuda.launches = counter.n = 0


def read_counts():
    from jacobiforcing_tpu_torch.ops.paged_attention_cuda import paged_attention_cuda
    from jacobiforcing_tpu_torch.ops.spec_attention_cuda import spec_attention_cuda

    return {"paged_attention": paged_attention_cuda.launches,
            "spec_attention": spec_attention_cuda.launches}


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
    missed = [p for p in launches if launches[p]["paged_attention"] <= 0 or plain_on_cuda[p]]
    if launches["mr"]["spec_attention"] <= 0:
        missed.append("mr (speculative kernel)")
    if any(launches[p]["spec_attention"] for p in ("prefill", "autoregressive", "jacobi")):
        missed.append("a non-MR path launched the speculative kernel")
    if missed or not lens_ok:
        raise AssertionError(f"full width: paths {missed} did not run through the kernels alone, "
                             f"or a request came up short of 128 tokens ({lens_ok=})")
    launches_out.update(launches)


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
    phases = sys.argv[1].split(",") if len(sys.argv) > 1 else ["kernel", "demo", "full"]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    log(smi)  # name, power limit
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    seconds = _build.build_many(list(KERNELS))  # one nvcc per source, started together
    for name, sec in seconds.items():
        log(f"[build] {name}.cu built in {sec:.2f}s")
    log(f"[build] all kernels built in {time.perf_counter() - t0:.2f}s")

    timing = {}
    launches = {}
    counter = PlainOnCudaCounter()
    if "kernel" in phases:
        phase_kernel(timing)
        phase_spec_kernel(timing)
    if "demo" in phases:
        phase_demo(counter, launches)
    if "full" in phases:
        phase_full_width(counter, launches)

    if "kernel" in phases and "full" in phases:
        # each kernel at its main-path shape (Jacobi decode B=4, L=64; the MR
        # run's most frequent tier, B=4), with the launches of that path's run
        rows = [("paged_attention", timing["decode"], launches["jacobi"]),
                ("spec_attention", timing[launches["mr_main_shape"]], launches["mr"])]
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
