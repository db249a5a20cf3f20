"""Hyperparameter grid search over Jacobi/MR decode knobs.

Re-design of the reference sweep
(JacobiForcing/jacobi_forcing_inference_MR_humaneval_config_grid_search.py:50-76
+ scripts/inference/scanning_hyperparameter_jacobi_decoding_mr.sh:23-122):
fan out over (n, K, r, pool), run the benchmark app per point, collect a
CSV of TPF/TPS; the shell script's GPU-token FIFO semaphore is unnecessary —
points run sequentially on the chip (or the caller shards the grid).

PyTorch port of `jacobiforcing_tpu/apps/grid_search.py` over the port's
`apps/bench_generate`; a point with K > 1 or pool > 1 runs MR (the
speculative-attention kernel on the card).  From the shell the engines are
built on `--device` (the card by default):

    python -m jacobiforcing_tpu_torch.apps.grid_search --model /path/to/ckpt \
        --block-sizes 16 32 --Ks 1 2 --rs 0.8 --pools 1 4 --output-dir grid_out
"""

from __future__ import annotations

import argparse
import csv
import itertools
import os
from jacobiforcing_tpu_torch.apps import bench_generate


def run_grid(args, engine_factory):
    grid = list(itertools.product(args.block_sizes, args.Ks, args.rs, args.pools))
    os.makedirs(args.output_dir, exist_ok=True)
    results = []
    for n, K, r, pool in grid:
        sub = bench_generate.make_parser().parse_args([])
        sub.strategy = "mr" if K > 1 or pool > 1 else "jacobi"
        sub.n_token_seq_len = n
        sub.max_blocks = K
        sub.spawn_ratio = r
        sub.n_gram_pool_size = pool
        sub.max_new_tokens = args.max_new_tokens
        sub.limit = args.limit
        sub.dataset = args.dataset
        sub.output_dir = os.path.join(args.output_dir, f"n{n}_K{K}_r{r}_p{pool}")
        engine, tokenizer = engine_factory()
        try:
            agg, _ = bench_generate.run(sub, engine=engine, tokenizer=tokenizer)
            results.append({
                "n": n, "K": K, "r": r, "pool": pool,
                "tokens_per_forward": agg["mean_tokens_per_forward"],
                "tokens_per_s": agg["mean_tokens_per_s"],
            })
        except Exception as e:  # tolerate per-point failures like the shell sweep
            results.append({"n": n, "K": K, "r": r, "pool": pool, "error": str(e)})

    path = os.path.join(args.output_dir, "grid_results.csv")
    keys = ["n", "K", "r", "pool", "tokens_per_forward", "tokens_per_s", "error"]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for row in results:
            w.writerow({k: row.get(k, "") for k in keys})
    best = max(
        (r for r in results if "error" not in r),
        key=lambda r: r["tokens_per_s"],
        default=None,
    )
    print(f"grid done: {len(results)} points -> {path}; best = {best}")
    return results


def make_parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="")
    p.add_argument("--dataset", default="")
    p.add_argument("--output-dir", default="grid_out")
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--limit", type=int, default=4)
    p.add_argument("--block-sizes", type=int, nargs="+", default=[16, 32, 64])
    p.add_argument("--Ks", type=int, nargs="+", default=[1, 2])
    p.add_argument("--rs", type=float, nargs="+", default=[0.5, 0.85])
    p.add_argument("--pools", type=int, nargs="+", default=[1, 4])
    p.add_argument("--device", default="cuda")
    return p


if __name__ == "__main__":
    args = make_parser().parse_args()

    def factory():
        from jacobiforcing_tpu_torch.engine.llm import LLM

        llm = LLM(model=args.model, device=args.device)
        return llm.engine, llm.tokenizer

    run_grid(args, factory)
