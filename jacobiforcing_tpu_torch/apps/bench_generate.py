"""Benchmark/eval script: AR vs Jacobi vs MR generation with per-example profiles.

Copy of `jacobiforcing_tpu/apps/bench_generate.py` for the PyTorch port:
the same prompt construction, the same evalchemy-compatible JSONL
generations, the same CSV per-example profile columns and the same EOS-only
aggregate summary, so the two packages' summaries compare field by field.
`run(args, engine=None)` builds the port's `LLM` on `args.device`.  The
strategies are `ar`, `jacobi`, `mr` (multiblock with rejection recycling) and
`nongreedy` (rejection-sampling Jacobi at `--temperature`); `--max-blocks`,
`--spawn-ratio`, `--lookahead-start-ratio` and `--n-gram-pool-size` shape `mr`; `--quantization int8|w8a8` and
`--kv-cache-dtype fp8|int8|bf16` serve the model quantized.
`--tensor-parallel-size N` serves it tensor-parallel under `torchrun
--nproc_per_node N` (a flag the JAX app does not have: there one controller
drives the mesh); every rank serves the same requests and only rank 0
writes the files and prints.

Usage:
    python -m jacobiforcing_tpu_torch.apps.bench_generate \
        --model /path/to/ckpt --dataset prompts.jsonl --strategy jacobi \
        --n-token-seq-len 64 --max-new-tokens 1024 --output-dir out/
    python -m jacobiforcing_tpu_torch.apps.bench_generate \
        --model /path/to/ckpt --dataset prompts.jsonl --strategy mr \
        --n-token-seq-len 64 --max-blocks 2 --n-gram-pool-size 4 --output-dir out/
    python -m jacobiforcing_tpu_torch.apps.bench_generate \
        --model /path/to/ckpt --dataset prompts.jsonl --strategy jacobi \
        --quantization w8a8 --kv-cache-dtype fp8 --output-dir out/
    python -m jacobiforcing_tpu_torch.apps.bench_generate \
        --model /path/to/ckpt --dataset prompts.jsonl --strategy nongreedy \
        --temperature 0.7 --n-token-seq-len 64 --output-dir out/
    torchrun --nproc_per_node 2 -m jacobiforcing_tpu_torch.apps.bench_generate \
        --model /path/to/ckpt --dataset prompts.jsonl --strategy jacobi \
        --tensor-parallel-size 2 --output-dir out/
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
import time
from typing import List, Optional

import numpy as np

HUMANEVAL_TEMPLATE = """
Please continue to complete the function. You are not allowed to modify the given code and do the completion only. Please return all completed function in a codeblock. Here is the given code to do completion:
```python
{}
```
""".strip()

QWEN_SYSTEM = "You are Qwen, created by Alibaba Cloud. You are a helpful assistant."

STRATEGIES = {
    "ar": "autoregressive",
    "jacobi": "jacobi",
    "mr": "jacobi_multiblock_rejection_recycling",
    "nongreedy": "jacobi_nongreedy",
}


def extract_python_code(text: str) -> str:
    """First ```python fenced block, or the raw text."""
    m = re.search(r"```python([\s\S]*?)```", text)
    return m.group(1).strip() if m else text


def build_prompt_ids(row: dict, fmt: str, tokenizer) -> List[int]:
    """Dataset-format-aware prompt construction (chat template included)."""
    if "prompt_ids" in row and fmt == "generic":
        return list(row["prompt_ids"])
    assert tokenizer is not None, "text prompts need a tokenizer"
    if fmt == "humaneval":
        content = HUMANEVAL_TEMPLATE.format(str(row["prompt"]).strip())
        messages = [{"role": "user", "content": content}]
    elif fmt == "math500":
        messages = [
            {"role": "system", "content": QWEN_SYSTEM},
            {"role": "user", "content": row.get("problem", row.get("prompt", ""))},
        ]
    else:
        return tokenizer.encode(row["prompt"])
    if hasattr(tokenizer, "apply_chat_template"):
        text = tokenizer.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=True
        )
    else:
        text = "\n".join(m["content"] for m in messages) + "\n"
    return tokenizer.encode(text)


def build_sampling_params(args):
    from jacobiforcing_tpu_torch.config import SamplingParams

    return SamplingParams(
        temperature=args.temperature,
        max_tokens=args.max_new_tokens,
        decode_strategy=STRATEGIES[args.strategy],
        jacobi_block_len=args.n_token_seq_len,
        jacobi_max_blocks=args.max_blocks,
        jacobi_spawn_ratio=args.spawn_ratio,
        jacobi_lookahead_start_ratio=args.lookahead_start_ratio,
        jacobi_n_gram_pool_size=args.n_gram_pool_size,
        jacobi_max_iterations=args.max_iterations,
    )


def load_prompts(args, tokenizer) -> List[dict]:
    rows = []
    if args.dataset:
        with open(args.dataset) as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                r = json.loads(line)
                ids = build_prompt_ids(r, args.dataset_format, tokenizer)
                rows.append({"task_id": r.get("task_id", f"task_{i}"), "prompt_ids": ids})
                if args.limit and len(rows) >= args.limit:
                    break
    else:
        rng = np.random.RandomState(0)
        for i in range(args.limit or 8):
            lo = min(16, args.synthetic_prompt_len)
            n = int(rng.randint(lo, args.synthetic_prompt_len + 1))
            rows.append({
                "task_id": f"synthetic_{i}",
                "prompt_ids": rng.randint(1, args.synthetic_vocab, n).tolist(),
            })
    return rows


def run(args, engine=None, tokenizer=None):
    from jacobiforcing_tpu_torch.parallel.multihost import initialize_multihost, is_primary

    if engine is None:
        from jacobiforcing_tpu_torch.engine.llm import LLM

        if args.tensor_parallel_size > 1:
            # the torchrun environment; NCCL between cards, gloo on the CPU
            initialize_multihost(backend="nccl" if args.device.startswith("cuda") else "gloo")
        llm = LLM(model=args.model, device=args.device, num_kv_pages=args.num_kv_pages,
                  quantization=args.quantization, kv_cache_dtype=args.kv_cache_dtype,
                  tensor_parallel_size=args.tensor_parallel_size)
        engine, tokenizer = llm.engine, llm.tokenizer

    sp = build_sampling_params(args)
    rows = load_prompts(args, tokenizer)
    # every rank serves; the first writes the files and prints
    primary = is_primary()
    if primary:
        os.makedirs(args.output_dir, exist_ok=True)

    def out_path(name: str) -> str:
        return os.path.join(args.output_dir, name) if primary else os.devnull

    L = max(args.n_token_seq_len, 1)
    profiles = []
    gen_path = out_path(f"generations_{args.strategy}.jsonl")
    with open(gen_path, "w") as gen_f:
        for idx, row in enumerate(rows):
            iters0 = engine.stats["jacobi_iterations"]
            t0 = time.perf_counter()
            out = engine.generate([row["prompt_ids"]], sp)[0]
            dt = time.perf_counter() - t0
            toks = out["token_ids"]
            iters = engine.stats["jacobi_iterations"] - iters0
            text: Optional[str] = None
            if tokenizer is not None:
                text = tokenizer.decode(toks)
            rec = {"task_id": row["task_id"], "token_ids": toks}
            if text is not None:
                rec["output"] = text
                rec["generation"] = (
                    extract_python_code(text) if args.dataset_format == "humaneval" else text
                )
            gen_f.write(json.dumps(rec) + "\n")
            eos_hit = bool(toks) and engine.config.eos >= 0 and toks[-1] == engine.config.eos
            stop_reason = (
                "eos" if eos_hit
                else "max_new_tokens" if len(toks) >= args.max_new_tokens
                else "max_iterations"
            )
            # calls ~ completed Jacobi blocks (one forward call per block)
            calls = len(toks) if args.strategy == "ar" else max(1, -(-len(toks) // L))
            profiles.append({
                "index": idx,
                "task_id": row["task_id"],
                "prompt_tokens": len(row["prompt_ids"]),
                "new_tokens": len(toks),
                "calls": calls,
                "total_iterations": iters,
                "avg_iter_per_call": round(iters / max(calls, 1), 4),
                "avg_iter_per_token": round(iters / max(len(toks), 1), 4),
                "tokens_per_forward": round(len(toks) / max(iters, 1), 4),
                "time_sec": round(dt, 4),
                "toks_per_sec": round(len(toks) / max(dt, 1e-9), 2),
                "stop_reason": stop_reason,
            })

    csv_path = out_path(f"profile_{args.strategy}.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(profiles[0].keys()))
        w.writeheader()
        w.writerows(profiles)

    # EOS-only aggregate; TPF is a ratio of sums (what a rate multiplies)
    eos_rows = [p for p in profiles if p["stop_reason"] == "eos"] or profiles
    sum_toks = sum(p["new_tokens"] for p in eos_rows)
    sum_iters = sum(p["total_iterations"] for p in eos_rows)
    agg = {
        "strategy": args.strategy,
        "n_examples": len(profiles),
        "n_eos_terminated": sum(p["stop_reason"] == "eos" for p in profiles),
        "mean_new_tokens": round(float(np.mean([p["new_tokens"] for p in eos_rows])), 4),
        "mean_calls": round(float(np.mean([p["calls"] for p in eos_rows])), 4),
        "mean_iter_per_call": round(
            float(np.mean([p["avg_iter_per_call"] for p in eos_rows])), 4
        ),
        "mean_iter_per_token": round(
            float(np.mean([p["avg_iter_per_token"] for p in eos_rows])), 4
        ),
        "mean_tokens_per_forward": round(
            float(np.mean([p["tokens_per_forward"] for p in eos_rows])), 4
        ),
        "aggregate_tokens_per_forward": round(sum_toks / max(sum_iters, 1), 4),
        "mean_tokens_per_s": round(float(np.mean([p["toks_per_sec"] for p in eos_rows])), 2),
        "total_tokens": int(sum(p["new_tokens"] for p in profiles)),
        "stop_reasons": {
            r: sum(p["stop_reason"] == r for p in profiles)
            for r in sorted({p["stop_reason"] for p in profiles})
        },
    }
    with open(out_path(f"summary_{args.strategy}.json"), "w") as f:
        json.dump(agg, f, indent=2)
    if primary:
        print(json.dumps(agg))
    return agg, profiles


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--num-kv-pages", type=int, default=-1,
                   help="KV pool size in pages; -1 sizes it from free device memory")
    p.add_argument("--quantization", choices=["", "int8", "w8a8"], default="",
                   help="int8: weight-only; w8a8: int8 weights and activations")
    p.add_argument("--kv-cache-dtype", choices=["", "fp8", "int8", "bf16"], default="",
                   help="KV storage type; fp8 and int8 carry per-row scales")
    p.add_argument("--tensor-parallel-size", type=int, default=1,
                   help="ranks of the model group; run under torchrun --nproc_per_node N")
    p.add_argument("--dataset", default="")
    p.add_argument("--dataset-format", choices=["generic", "humaneval", "math500"],
                   default="generic")
    p.add_argument("--output-dir", default="bench_out")
    p.add_argument("--strategy", choices=sorted(STRATEGIES), default="jacobi")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--max-new-tokens", type=int, default=1024)
    p.add_argument("--n-token-seq-len", type=int, default=64)
    p.add_argument("--max-blocks", type=int, default=2)
    p.add_argument("--spawn-ratio", type=float, default=0.85)
    p.add_argument("--lookahead-start-ratio", type=float, default=0.0)
    p.add_argument("--n-gram-pool-size", type=int, default=4)
    p.add_argument("--max-iterations", type=int, default=1024)
    p.add_argument("--limit", type=int, default=0)
    p.add_argument("--synthetic-prompt-len", type=int, default=64)
    p.add_argument("--synthetic-vocab", type=int, default=256)
    return p


if __name__ == "__main__":
    run(make_parser().parse_args())
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
