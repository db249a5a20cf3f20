"""CPU anchors of the non-greedy and on-policy paths on the trained demo checkpoint.

    JAX_PLATFORMS=cpu python -m tests.torch_sampling_demo_anchors [part ...]

Parts (all by default), each on the JAX package in f32 on the CPU and, where
it says so, on the port's engine on the CPU beside it:
  * `nongreedy`: rejection-sampling Jacobi at temperature 0.7 on the 64
    held-out prompts of `assets/tpf_demo_n32_v7` (page 16, N=32, max_tokens
    96, one request at a time as `bench_generate` serves them), engine seeds
    0 / 1 / 2: total tokens, EOS count, aggregate tokens per forward (TPF);
    the port's engine the same;
  * `collect`: greedy on-policy collection (`collect_trajectories`, N 32,
    max_tokens 96) of the 64 prompts in one call: rows (records), total
    tokens, total iterations; the port's engine the same, with whether every
    row equals the JAX row;
  * `learning`: `apps/validate_learning` at its defaults (the tiny f32 model,
    2 rounds of 30 epochs, 8 prompts): TPF before and after; again with the
    tiny model at head_dim 64, the port app's model (the CUDA attention
    kernels serve 64 and 128); and the port's app (its random weights are not
    the JAX app's).

`chip_smoke.py` holds the card's runs against these numbers.  Not a test: it
takes minutes.
"""

import json
import os
import sys
import time

import jax.numpy as jnp
import torch

from jacobiforcing_tpu.config import Config as JConfig
from jacobiforcing_tpu.config import SamplingParams as JSamplingParams
from jacobiforcing_tpu.data.collect import collect_trajectories as jcollect
from jacobiforcing_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from jacobiforcing_tpu.utils.loader import load_checkpoint as jload
from jacobiforcing_tpu_torch import LLM, SamplingParams
from jacobiforcing_tpu_torch.data import collect_trajectories

DEMO = os.path.join(os.path.dirname(__file__), "..", "assets", "tpf_demo_n32_v7")
PARTS = ("nongreedy", "collect", "learning")


def _demo():
    with open(os.path.join(DEMO, "tpf_demo.json")) as f:
        meta = json.load(f)
    with open(os.path.join(DEMO, "heldout_prompts.jsonl")) as f:
        prompts = [json.loads(line)["prompt_ids"] for line in f]
    kw = dict(kvcache_page_size=16, max_model_len=512, jacobi_chunk_tokens=64,
              eos=int(meta["eos"]), prefill_token_buckets=(32, 64, 128, 256, 512))
    return meta, prompts, kw


def _engines(kw, seed):
    mc, params = jload(DEMO, dtype=jnp.float32)
    jeng = JLLMEngine(JConfig(seed=seed, **kw), model_cfg=mc, params=params, num_kv_pages=1024)
    llm = LLM(model=DEMO, device="cpu", dtype=torch.float32, num_kv_pages=1024, seed=seed, **kw)
    return ("JAX", jeng), ("port", llm.engine)


def nongreedy():
    meta, prompts, kw = _demo()
    n, L = int(meta["max_tokens"]), int(meta["block_len"])
    for seed in (0, 1, 2):
        for who, eng in _engines(kw, seed):
            cls = JSamplingParams if who == "JAX" else SamplingParams
            sp = cls(temperature=0.7, max_tokens=n, decode_strategy="jacobi_nongreedy",
                     jacobi_block_len=L, jacobi_max_blocks=1, jacobi_max_iterations=1 << 20)
            t0 = time.perf_counter()
            outs = [eng.generate([p], sp)[0]["token_ids"] for p in prompts]
            toks = sum(len(o) for o in outs)
            n_eos = sum(bool(o) and o[-1] == kw["eos"] for o in outs)
            print(f"[anchor] nongreedy T=0.7 seed {seed}: {who} on the CPU, f32: {toks} tokens, "
                  f"{n_eos}/64 EOS, aggregate TPF "
                  f"{eng.stats['generated_tokens'] / eng.stats['jacobi_iterations']:.4f} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)


def collect():
    meta, prompts, kw = _demo()
    n, L = int(meta["max_tokens"]), int(meta["block_len"])
    rows = {}
    for who, eng in _engines(kw, 0):
        fn = jcollect if who == "JAX" else collect_trajectories
        rows[who] = fn(eng, prompts, block_len=L, max_tokens=n)
        toks = sum(len(r["teacher_output_ids"]) - len(prompts[int(r["data_id"][5:])])
                   for r in rows[who] if r["diffusion_itr_id"] == "itr_0")
        iters = sum(len(r["answer_trajectory_ids"]) - 1 for r in rows[who])
        print(f"[anchor] greedy on-policy collection, N {L}, max_tokens {n}, 64 prompts in one "
              f"call: {who} on the CPU, f32: {len(rows[who])} rows, {toks} tokens, {iters} "
              f"iterations", flush=True)
    same = [a == b for a, b in zip(rows["JAX"], rows["port"])]
    print(f"[anchor] port rows equal to the JAX rows: {sum(same)}/{len(same)}"
          f" (rows {len(rows['port'])} vs {len(rows['JAX'])})", flush=True)


def learning():
    import argparse

    from jacobiforcing_tpu.apps import validate_learning as jvl
    from jacobiforcing_tpu.models import qwen as jq
    from jacobiforcing_tpu_torch.apps import validate_learning as tvl

    # the JAX app's defaults (its parser is built inside `main`)
    jargs = argparse.Namespace(model="", block_len=8, max_tokens=32, n_prompts=8, rounds=2,
                               epochs=30, lr=3e-4, seq_bucket=256, page_size=16, num_pages=256,
                               max_model_len=256, eos=-1)
    tiny = jq.ModelConfig.tiny
    runs = (("JAX, head_dim 16 (its default)", jvl.run, jargs, 16),
            ("JAX, head_dim 64 (the port app's tiny model)", jvl.run, jargs, 64),
            ("port, head_dim 64", tvl.run, tvl.make_parser().parse_args(["--device", "cpu"]), 64))
    for who, run, args, head_dim in runs:
        jq.ModelConfig.tiny = staticmethod(
            lambda vocab_size=256, **kw: tiny(vocab_size, **{"head_dim": head_dim, **kw}))
        t0 = time.perf_counter()
        try:
            res = run(args)
        finally:
            jq.ModelConfig.tiny = staticmethod(tiny)
        print(f"[anchor] validate_learning at its defaults: {who} on the CPU: tpf_before "
              f"{res['tpf_before']}, tpf_after {res['tpf_after']}, improvement "
              f"{res['improvement']} ({time.perf_counter() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    for part in sys.argv[1:] or PARTS:
        globals()[part]()
