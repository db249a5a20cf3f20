"""End-to-end learning validation: does consistency training raise TPF?

PyTorch port of `jacobiforcing_tpu/apps/validate_learning.py`.  It runs the
complete JacobiForcing loop in one process on one device: measure greedy
Jacobi tokens per forward (TPF), collect the model's own trajectories through
the port's engine (greedy on-policy collection), pack them with the
progressive noise schedule, train the AR + consistency objective with the
port's train step and AdamW, re-measure TPF, and report the improvement.

    python -m jacobiforcing_tpu_torch.apps.validate_learning --device cuda   # tiny model, D 64
    python -m jacobiforcing_tpu_torch.apps.validate_learning --rounds 3 --epochs 50
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def run(args) -> dict:
    import torch

    from jacobiforcing_tpu_torch.config import Config, SamplingParams
    from jacobiforcing_tpu_torch.data import collect_trajectories, pack_trajectories
    from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params, rope_table
    from jacobiforcing_tpu_torch.train.consistency import (
        TrainConfig, make_train_step, prepare_sample,
    )
    from jacobiforcing_tpu_torch.train.optim import AdamW
    from jacobiforcing_tpu_torch.utils.device import resolve_device
    from jacobiforcing_tpu_torch.utils.loader import load_checkpoint

    dev = resolve_device(args.device)
    N = args.block_len
    if args.model:
        mc, params = load_checkpoint(args.model, device=dev)
    else:
        # head_dim 64 where the JAX app's tiny model has 16: the CUDA attention
        # kernels serve head dims 64 and 128
        mc = ModelConfig.tiny(dtype=torch.float32, head_dim=64)
        params = init_params(mc, 0, device=dev)

    def make_engine(p):
        cfg = Config(
            kvcache_page_size=args.page_size, max_model_len=args.max_model_len,
            jacobi_chunk_tokens=64, eos=args.eos,
            prefill_token_buckets=(32, 64, 128, 256, 512),
        )
        return LLMEngine(cfg, model_cfg=mc, params=p, num_kv_pages=args.num_pages, device=dev)

    rng = np.random.RandomState(0)
    prompts = [
        rng.randint(1, mc.vocab_size, rng.randint(5, 12)).tolist()
        for _ in range(args.n_prompts)
    ]
    sp = SamplingParams(
        temperature=0.0, max_tokens=args.max_tokens, decode_strategy="jacobi",
        jacobi_block_len=N, jacobi_max_blocks=1, jacobi_max_iterations=1024,
    )

    def measure_tpf(p):
        eng = make_engine(p)
        eng.generate(prompts, sp)
        return eng.stats["generated_tokens"] / max(eng.stats["jacobi_iterations"], 1)

    tpf0 = measure_tpf(params)
    history = [tpf0]
    tc = TrainConfig(
        N=N, seq_bucket=args.seq_bucket, ar_pair_bucket=args.seq_bucket,
        cons_pair_bucket=args.seq_bucket,
    )
    opt = AdamW(args.lr)
    step = make_train_step(mc, tc, opt)
    opt_state = opt.init(params)
    rope = rope_table(mc, dev)

    for rnd in range(args.rounds):
        eng = make_engine(params)
        rows = collect_trajectories(
            eng, prompts, block_len=N, max_tokens=args.max_tokens, temperature=0.0
        )
        packed = pack_trajectories(rows, N, window_size=4)
        for _ in range(args.epochs):
            for row in packed:
                T = len(row["traj_position_indices"])
                b = {
                    k: torch.as_tensor(v, device=dev)
                    for k, v in prepare_sample(
                        row["complete_training_sequence_ids"],
                        row["prompt_ids_len"], T, tc,
                    ).items()
                }
                params, opt_state, m = step(params, opt_state, rope, b)
        tpf = measure_tpf(params)
        history.append(tpf)
        print(f"round {rnd}: loss={float(m['loss']):.3f} TPF={tpf:.3f}", flush=True)

    result = {
        "tpf_before": round(tpf0, 4),
        "tpf_after": round(history[-1], 4),
        "improvement": round(history[-1] / tpf0, 3),
        "history": [round(h, 4) for h in history],
    }
    print(json.dumps(result))
    return result


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--block-len", type=int, default=8)
    p.add_argument("--max-tokens", type=int, default=32)
    p.add_argument("--n-prompts", type=int, default=8)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--seq-bucket", type=int, default=256)
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=256)
    p.add_argument("--max-model-len", type=int, default=256)
    p.add_argument("--eos", type=int, default=-1)
    return p


def main():
    run(make_parser().parse_args())


if __name__ == "__main__":
    main()
