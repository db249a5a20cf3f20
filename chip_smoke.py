#!/usr/bin/env python3
"""Drive the PyTorch port (`jacobiforcing_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases (each prints its lines; any failure exits non-zero and prints no
result line):
  1. the card's name and power limit; build the CUDA kernel (nvcc).
  2. the paged-attention kernel against its plain PyTorch version, f32 and
     bf16, at the demo (D=64, KH=2, G=2) and Qwen2.5-7B (D=128, KH=4, G=7)
     head shapes, with shuffled page tables, ragged lengths and -1 padding
     rows (tolerances in `check`); the bitwise AR-row == Jacobi-row check;
     kernel, plain-version and SDPA times beside the bound at the main path's
     decode and prefill shapes, where the kernel is held to the same check.
  3. the trained demo checkpoint `assets/tpf_demo_n32_v7` in f32 through
     `LLM` and the port's `bench_generate.run`, `ar` and `jacobi` on all 64
     held-out prompts: the two token streams must be identical, 2033 tokens,
     64/64 EOS.
  4. Qwen2.5-7B widths with random bf16 weights, 4 requests of 256-1024
     random prompt tokens through `LLM.generate`, both strategies.  The
     kernel's launch count is zeroed before each path (prefill, AR, Jacobi)
     and must grow in each; the JSON line reports the Jacobi run's count.

The line before the last is a JSON object with the kernel's numbers; the last
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
KERNEL_SOURCE = "jacobiforcing_tpu_torch/csrc/paged_attention.cu"
REPLACES = "jacobiforcing_tpu/ops/pallas/paged_attention.py:736"
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


def check(out, ref, n_real):
    """(max_abs_err, worst err/tol, ok) over the real rows.  f32: |err| <=
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
# Phases 3 and 4
# ---------------------------------------------------------------------------


class PlainOnCudaCounter:
    """Counts calls of the plain attention on CUDA tensors (there must be none)."""

    def __init__(self):
        from jacobiforcing_tpu_torch.ops import attention

        self.orig, self.n = attention.paged_attention_ref, 0

        def wrapped(q, *a, **kw):
            self.n += int(q.is_cuda)
            return self.orig(q, *a, **kw)

        attention.paged_attention_ref = wrapped


def phase_demo(counter):
    from jacobiforcing_tpu_torch.apps import bench_generate
    from jacobiforcing_tpu_torch.engine.llm import LLM
    from jacobiforcing_tpu_torch.ops.paged_attention_cuda import paged_attention_cuda

    with open(os.path.join(DEMO, "tpf_demo.json")) as f:
        meta = json.load(f)
    llm = LLM(model=DEMO, device="cuda", dtype=torch.float32, kvcache_page_size=16,
              max_model_len=512, jacobi_chunk_tokens=64, eos=int(meta["eos"]),
              prefill_token_buckets=(32, 64, 128, 256, 512), num_kv_pages=1024)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_demo_", dir=os.path.join(REPO, "build"))
    streams, launches, faults = {}, {}, []
    for strategy in ("ar", "jacobi"):
        args = bench_generate.make_parser().parse_args([])
        args.strategy = strategy
        args.n_token_seq_len = int(meta["block_len"])
        args.max_blocks = 1
        args.max_new_tokens = int(meta["max_tokens"])
        args.max_iterations = 1 << 20
        args.dataset = os.path.join(DEMO, "heldout_prompts.jsonl")
        args.output_dir = out_dir
        paged_attention_cuda.launches = counter.n = 0
        t0 = time.perf_counter()
        agg, _ = bench_generate.run(args, engine=llm.engine)
        dt = time.perf_counter() - t0
        launches[strategy] = paged_attention_cuda.launches
        with open(os.path.join(out_dir, f"generations_{strategy}.jsonl")) as f:
            streams[strategy] = [json.loads(line)["token_ids"] for line in f]
        log(f"[demo] {strategy}: total_tokens={agg['total_tokens']} "
            f"eos={agg['n_eos_terminated']}/{agg['n_examples']} "
            f"aggregate_tpf={agg['aggregate_tokens_per_forward']} wall={dt:.2f}s; "
            f"kernel launches {launches[strategy]}; plain attention calls on CUDA: {counter.n}")
        if (agg["total_tokens"], agg["n_eos_terminated"], agg["n_examples"]) != (DEMO_TOKENS, 64, 64):
            faults.append(f"{strategy}: {agg['total_tokens']} tokens (want {DEMO_TOKENS}), "
                          f"{agg['n_eos_terminated']}/{agg['n_examples']} EOS (want 64/64)")
        if launches[strategy] <= 0 or counter.n:
            faults.append(f"{strategy} did not go through the kernel alone")
    diff = [i for i, (a, b) in enumerate(zip(streams["ar"], streams["jacobi"])) if a != b]
    log(f"[demo] ar == jacobi on {len(streams['ar'])} prompts: {not diff} (rows differing: {diff})")
    llm.exit()
    if diff:
        faults.append(f"ar and jacobi streams differ in rows {diff}")
    if faults:
        raise AssertionError("demo checkpoint: " + "; ".join(faults))


def phase_full_width(counter, launches_out):
    from jacobiforcing_tpu_torch.config import SamplingParams
    from jacobiforcing_tpu_torch.engine.llm import LLM
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params
    from jacobiforcing_tpu_torch.ops.paged_attention_cuda import paged_attention_cuda

    torch.cuda.reset_peak_memory_stats()
    cfg = ModelConfig()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for v in params.values()
                   for t in (v.values() if isinstance(v, dict) else [v]))
    log(f"[full] Qwen2.5-7B widths: {n_params / 1e9:.3f}B random bf16 params in "
        f"{time.perf_counter() - t0:.1f}s")
    llm = LLM(device="cuda", model_cfg=cfg, params=params, num_kv_pages=512,
              kvcache_page_size=256, eos=-1)
    r = np.random.RandomState(0)
    prompts = [r.randint(0, cfg.vocab_size, size=n).tolist() for n in (256, 512, 768, 1024)]
    streams, launches, plain_on_cuda = {}, {}, {}
    # prefill alone first (one token each), to time it apart from decode; the
    # prefix cache then holds the prompts' full pages for both strategies
    paged_attention_cuda.launches = counter.n = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    llm.generate(prompts, SamplingParams(temperature=0.0, max_tokens=1))
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    launches["prefill"], plain_on_cuda["prefill"] = paged_attention_cuda.launches, counter.n
    log(f"[full] prefill of 4 prompts (2560 tokens, cold) {prefill_ms:.1f} ms; kernel launches "
        f"{launches['prefill']}; plain attention calls on CUDA: {counter.n}")
    for strategy in ("autoregressive", "jacobi"):
        sp = SamplingParams(temperature=0.0, max_tokens=128, decode_strategy=strategy,
                            jacobi_block_len=64, jacobi_max_iterations=1 << 20)
        stats0 = dict(llm.stats)
        paged_attention_cuda.launches = counter.n = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = llm.generate(prompts, sp)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[strategy], plain_on_cuda[strategy] = paged_attention_cuda.launches, counter.n
        streams[strategy] = [o["token_ids"] for o in outs]
        toks = sum(len(s) for s in streams[strategy])
        iters = llm.stats["jacobi_iterations"] - stats0["jacobi_iterations"]
        fwds = llm.stats["chunk_forwards"] - stats0["chunk_forwards"]
        steps = llm.stats["ar_steps"] - stats0["ar_steps"]
        line = (f"[full] {strategy}: {toks} tokens in {wall:.3f}s = {toks / wall:.2f} tok/s "
                f"(prompts' full pages prefix-cached; the rest prefilled in the wall)")
        if strategy == "jacobi":
            line += (f"; {iters} row-iterations, {fwds} batched forwards = "
                     f"{fwds / wall:.2f} iterations/s, TPF {toks / max(iters, 1):.3f}")
        else:
            line += f"; {steps} AR steps = {steps / wall:.2f} steps/s"
        log(line + f"; kernel launches {launches[strategy]}; plain attention calls on CUDA: "
            f"{counter.n}")
    match = []
    for a, b in zip(streams["autoregressive"], streams["jacobi"]):
        n = min(len(a), len(b), 128)
        match.append(sum(x == y for x, y in zip(a[:n], b[:n])) / max(n, 1))
    first_diff = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
                  for a, b in zip(streams["autoregressive"], streams["jacobi"])]
    log(f"[full] AR vs Jacobi first-128-token match rate per request: "
        f"{[round(m, 4) for m in match]} (first differing index {first_diff}); bf16 near-ties "
        f"on a random model make this a reported number, not a gate")
    log(f"[full] peak torch.cuda.max_memory_allocated = "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    lens_ok = all(len(s) == 128 for v in streams.values() for s in v)
    profile_jacobi(llm, prompts)
    llm.exit()
    missed = [p for p in launches if launches[p] <= 0 or plain_on_cuda[p]]
    if missed or not lens_ok:
        raise AssertionError(f"full width: paths {missed} did not run through the kernel alone, "
                             f"or a request came up short of 128 tokens ({lens_ok=})")
    launches_out.update(launches)


def profile_jacobi(llm, prompts):
    """Where the device time of Jacobi serving goes: torch.profiler over 4
    requests (prefill + 32 new tokens each, block 64), device kernel time
    summed by kernel name, and the device's busy share of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from jacobiforcing_tpu_torch.config import SamplingParams

    sp = SamplingParams(temperature=0.0, max_tokens=32, decode_strategy="jacobi",
                        jacobi_block_len=64, jacobi_max_iterations=1 << 20)
    prompts = [p[::-1] for p in prompts]  # not prefix-cached
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
    groups = {"paged_attention (this repo's kernel)": 0.0, "GEMM (cuBLAS)": 0.0, "other": 0.0}
    for name, t in kernels.items():
        low = name.lower()
        if "paged_attention" in low:
            groups["paged_attention (this repo's kernel)"] += t
        elif any(w in low for w in ("gemm", "nvjet", "cutlass", "xmma")):
            groups["GEMM (cuBLAS)"] += t
        else:
            groups["other"] += t
    log(f"[profile] jacobi, 4 requests x 32 new tokens, {fwds} batched forwards: wall "
        f"{wall_ms:.1f} ms under the profiler, device busy {busy:.1f} ms "
        f"({busy / wall_ms * 100:.1f}% of wall, idle {100 - busy / wall_ms * 100:.1f}%)")
    for g, t in groups.items():
        log(f"[profile]   {g}: {t:.2f} ms ({t / max(busy, 1e-9) * 100:.1f}% of device time)")
    for name, t in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[profile]   top kernel {t:8.2f} ms  {name[:110]}")


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
    _build.build("paged_attention")
    log(f"[build] paged_attention.cu built in {time.perf_counter() - t0:.2f}s")

    timing = {}
    launches = {}
    counter = PlainOnCudaCounter()
    if "kernel" in phases:
        phase_kernel(timing)
    if "demo" in phases:
        phase_demo(counter)
    if "full" in phases:
        phase_full_width(counter, launches)

    if "kernel" in phases and "full" in phases:
        t = timing["decode"]
        print(json.dumps({"kernels": [{
            "name": "paged_attention", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES, "launches": launches["jacobi"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
