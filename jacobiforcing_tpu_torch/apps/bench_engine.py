"""Engine-level batched serving benchmark (PyTorch port of
`jacobiforcing_tpu/apps/bench_engine.py`).

The reference engine's headline figure ("800-1000 tok/s on a single GPU",
reference README.md:192) is an ENGINE-level number: it includes the
scheduler, prefill, host<->device chunk boundaries and per-request
bookkeeping, not just the raw decode loop.  `run_engine_bench` times
`LLMEngine.step` end to end on Qwen2.5-7B widths as W8A8 (random int8
weights, `ops/quant.init_quantized_params`) with B concurrent requests and
continuous batching (R > B, so finished slots backfill).

Random weights accept ~1 token per iteration, so raw committed tokens/s would
conflate framework speed with (absent) training; throughput is reported as
iterations/s x TPF at the reference's measured TPF = 4.0 (README.md:261),
plus the committed rate.  The STEADY-STATE window cuts the drain tail: once
fewer than B requests remain unfinished there is nothing left to backfill
with, and the shrinking batch measures the bench's finite request list, not
the engine.

Knobs beside the JAX app's: `device`, `kv_cache_dtype` ("fp8", "int8",
"bf16"), and the environment's `JF_ASYNC_HOST=0` (the synchronous engine,
copied from the JAX app) and `JF_ENFORCE_EAGER=1` (no CUDA graphs).

    python -m jacobiforcing_tpu_torch.apps.bench_engine --B 8 --max-tokens 128

prints the result as one JSON line; under PROFILE=1 the engine's profile
report of the measured run (`utils/profiling.report`: each span's total and
self time, the counters, tokens per forward and per second, the programs)
goes to standard error first.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Optional

import numpy as np


def run_engine_bench(
    B: int = 8,
    prompt_len: int = 512,
    max_tokens: int = 256,
    L: int = 64,
    chunk_iters: int = 8,
    requests: Optional[int] = None,
    max_model_len: int = 8192,
    chunk_tokens: int = 128,
    model_cfg=None,
    params=None,
    strategy: str = "jacobi",  # "jacobi" | "nongreedy" | "mr"
    temperature: float = 0.7,  # nongreedy only (greedy strategies ignore it)
    mr_blocks: int = 2,
    mr_pool: int = 4,
    mr_auto: bool = False,  # False = measure the raw MR configuration
    prefill_buckets: Optional[tuple] = None,
    kv_cache_dtype: str = "",
    device="cuda",
) -> dict:
    from jacobiforcing_tpu_torch.config import Config, SamplingParams
    from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig
    from jacobiforcing_tpu_torch.ops.quant import init_quantized_params
    from jacobiforcing_tpu_torch.utils import profiling

    if model_cfg is None:
        # default benchmark model: Qwen2.5-7B widths, W8A8
        model_cfg = dataclasses.replace(ModelConfig(), act_quant=True)
    mc = model_cfg
    if params is None:
        params = init_quantized_params(mc, 0, device=device)
    R = requests if requests is not None else 4 * B

    # Sub-B batch buckets matter for engine throughput even though
    # steady-state decode always runs the full batch: backfill prefills
    # usually admit a single request, and the drain tail decodes a shrinking
    # batch.  Each bucket is one program (a CUDA graph on the card), made by
    # `warmup` before the measured run.
    bbs = tuple(b for b in (1, 2, 4, 8, 16, 32) if b < B) + (B,)
    cfg = Config(
        max_model_len=max_model_len,
        max_num_seqs=B,
        jacobi_chunk_tokens=chunk_tokens,
        # iteration-budget chunking: finer chunks backfill finished slots
        # sooner
        jacobi_chunk_iters=chunk_iters,
        jacobi_max_blocks=mr_blocks,
        jacobi_n_gram_pool_size=mr_pool,
        jacobi_mr_auto_policy=mr_auto,
        batch_buckets=bbs,
        prefill_token_buckets=(prefill_buckets if prefill_buckets else (prompt_len + 2 * L,)),
        # A/B knobs: the speculative host pipeline (on by default) and graphs
        jacobi_async_host=os.environ.get("JF_ASYNC_HOST", "1") != "0",
        enforce_eager=os.environ.get("JF_ENFORCE_EAGER", "0") == "1",
        # the W8A8 model runs the int8 products (and their weight layout)
        quantization="w8a8" if mc.act_quant else "",
        kv_cache_dtype=kv_cache_dtype,
        eos=-1,
    )
    pages_per_seq = (prompt_len + max_tokens + 3 * L) // cfg.kvcache_page_size + 1
    eng = LLMEngine(cfg, model_cfg=mc, params=params, num_kv_pages=(B + 2) * pages_per_seq + 8,
                    device=device)

    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, mc.vocab_size, prompt_len - (i % 5)).tolist() for i in range(R)]
    if strategy == "nongreedy":
        sp = SamplingParams(
            temperature=temperature, max_tokens=max_tokens, decode_strategy="jacobi_nongreedy",
            jacobi_block_len=L, jacobi_max_blocks=1, ignore_eos=True,
            jacobi_max_iterations=1 << 20,
        )
        warm = ("jacobi_nongreedy",)
    elif strategy == "mr":
        sp = SamplingParams(
            temperature=0.0, max_tokens=max_tokens,
            decode_strategy="jacobi_multiblock_rejection_recycling", jacobi_block_len=L,
            jacobi_max_blocks=mr_blocks, jacobi_n_gram_pool_size=mr_pool, ignore_eos=True,
            jacobi_max_iterations=1 << 20,
        )
        # the auto-policy's single-block arm needs the jacobi program warm
        warm = ("mr", "jacobi") if mr_auto else ("mr",)
    else:
        sp = SamplingParams(
            temperature=0.0, max_tokens=max_tokens, decode_strategy="jacobi",
            jacobi_block_len=L, jacobi_max_blocks=1, ignore_eos=True,
            jacobi_max_iterations=1 << 20,
        )
        warm = ("jacobi",)

    # Build every kernel and capture every bucket's graph through the real
    # scheduler path, so the measured run does neither.
    eng.warmup(strategies=warm, block_lens=(L,))
    eng.generate(prompts[:B], sp, use_tqdm=False)
    eng._mr_policies.clear()  # measured run starts with a fresh probe window

    stats0 = dict(eng.stats)  # the report's window leaves warm-up out
    seqs = [eng.add_request(p, s) for p, s in zip(prompts, [sp] * R)]
    t0 = time.perf_counter()
    it0 = eng.stats["jacobi_iterations"]
    fw0 = eng.stats["chunk_forwards"]
    g0 = eng.stats["generated_tokens"]
    timeline = []  # (t, iters, forwards, tokens, unfinished)
    while not eng.scheduler.is_finished:
        eng.step()
        timeline.append((
            time.perf_counter() - t0,
            eng.stats["jacobi_iterations"] - it0,
            eng.stats["chunk_forwards"] - fw0,
            eng.stats["generated_tokens"] - g0,
            sum(not s.is_finished for s in seqs),
        ))
    dt = time.perf_counter() - t0
    iters = eng.stats["jacobi_iterations"] - it0
    forwards = eng.stats["chunk_forwards"] - fw0
    tokens = sum(len(s.completion_token_ids) for s in seqs)

    steady = [x for x in timeline if x[4] >= B]
    if steady:
        t_ss, it_ss, fw_ss, tok_ss, _ = steady[-1]
    else:  # degenerate: R < B
        t_ss, it_ss, fw_ss, tok_ss = dt, iters, forwards, tokens

    tag = (
        "7b_w8a8"
        if (mc.hidden_size, mc.num_layers, mc.act_quant) == (3584, 28, True)
        else f"{mc.hidden_size}h{mc.num_layers}L"
    )
    stag = "" if strategy == "jacobi" else f"_{strategy}"
    out = {
        "metric": f"engine_tps_at_tpf4_{tag}{stag}_B{B}_L{L}",
        "value": round(4.0 * it_ss / t_ss, 2),
        "unit": "tok/s",
        "strategy": strategy,
        "steady_window_s": round(t_ss, 3),
        "steady_iters_per_s": round(it_ss / t_ss, 2),
        "steady_occupancy": round(it_ss / max(fw_ss * B, 1), 3),
        "overall_tps_at_tpf4": round(4.0 * iters / dt, 2),
        "iters_per_s": round(iters / dt, 2),
        "forwards": forwards,
        "ms_per_forward": round(1e3 * dt / max(forwards, 1), 2),
        "batch_occupancy": round(iters / max(forwards * B, 1), 3),
        "committed_tok_per_s": round(tokens / dt, 2),
        "wall_s": round(dt, 3),
        "prompt_len": prompt_len,
        "max_tokens": max_tokens,
        "requests": R,
    }
    # the committed rate over the steady window complements the @TPF4
    # convention for every strategy
    out["committed_tok_per_s_steady"] = round(tok_ss / t_ss, 2)
    if strategy == "mr":
        if eng._mr_policies:
            out["mr_policy"] = eng.mr_policy_snapshot()
        for k in ("mr_full", "mr_nocand", "mr_ra_only", "mr_single"):
            if k in eng.stats:
                out[k] = int(eng.stats[k])
    if eng.spans.requested:
        print(profiling.report(profiling.stats_delta(stats0, eng.stats), dt, eng.programs),
              file=sys.stderr, flush=True)
    eng.exit()
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--B", type=int, default=8)
    p.add_argument("--prompt-len", type=int, default=512)
    p.add_argument("--max-tokens", type=int, default=256)
    p.add_argument("--L", type=int, default=64)
    p.add_argument("--chunk-iters", type=int, default=8)
    p.add_argument("--requests", type=int, default=None)
    p.add_argument("--max-model-len", type=int, default=8192)
    p.add_argument("--chunk-tokens", type=int, default=128)
    p.add_argument("--strategy", choices=("jacobi", "nongreedy", "mr"), default="jacobi")
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--kv-cache-dtype", default="")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    print(json.dumps(run_engine_bench(
        B=a.B, prompt_len=a.prompt_len, max_tokens=a.max_tokens, L=a.L,
        chunk_iters=a.chunk_iters, requests=a.requests, max_model_len=a.max_model_len,
        chunk_tokens=a.chunk_tokens, strategy=a.strategy, temperature=a.temperature,
        kv_cache_dtype=a.kv_cache_dtype, device=a.device)), flush=True)


if __name__ == "__main__":
    main()
