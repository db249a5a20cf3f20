"""CPU anchors of quantized serving on the trained demo checkpoint.

    JAX_PLATFORMS=cpu python -m tests.torch_quant_demo_anchors [config ...]

For each quantized configuration (`int8`, `w8a8`, `fp8` KV, `int8` KV, `e5m2`
KV; all by default) the JAX engine serves the 64 held-out prompts of
`assets/tpf_demo_n32_v7` in f32 on the CPU with greedy Jacobi (page 16, N=32,
max_tokens 96, the settings of tests/test_torch_engine.py), and the port's
engine serves them on the CPU with `ar`, `jacobi` and `mr` (policy off).  It
prints, per configuration, the JAX engine's total tokens, EOS count and
aggregate tokens per forward, the same for the first 16 prompts, and whether
every port stream equals the JAX stream (the first differing prompt if not).
`chip_smoke.py` holds the card's runs against these numbers.  Not a test: it
takes minutes.
"""

import json
import os
import sys

import jax.numpy as jnp
import torch

from jacobiforcing_tpu.config import Config as JConfig
from jacobiforcing_tpu.config import SamplingParams as JSamplingParams
from jacobiforcing_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from jacobiforcing_tpu.utils.loader import load_checkpoint as jload
from jacobiforcing_tpu_torch import LLM, SamplingParams

DEMO = os.path.join(os.path.dirname(__file__), "..", "assets", "tpf_demo_n32_v7")
MR = "jacobi_multiblock_rejection_recycling"
CONFIGS = {
    "int8": dict(quantization="int8"),
    "w8a8": dict(quantization="w8a8"),
    "fp8": dict(kv_cache_dtype="fp8"),
    "int8kv": dict(kv_cache_dtype="int8"),
    "e5m2": {},  # reached through kv_dtype= alone, in both packages
}
# engine arguments beside the configuration: (JAX engine, port LLM)
ENGINE_KW = {"e5m2": (dict(kv_dtype=jnp.float8_e5m2), dict(kv_dtype=torch.float8_e5m2))}


def main(names):
    with open(os.path.join(DEMO, "tpf_demo.json")) as f:
        meta = json.load(f)
    with open(os.path.join(DEMO, "heldout_prompts.jsonl")) as f:
        prompts = [json.loads(line)["prompt_ids"] for line in f]
    kw = dict(kvcache_page_size=16, max_model_len=512, jacobi_chunk_tokens=64,
              eos=int(meta["eos"]), prefill_token_buckets=(32, 64, 128, 256, 512))
    n, block = int(meta["max_tokens"]), int(meta["block_len"])

    def sp(cls, strategy, blocks=1):
        return cls(temperature=0.0, max_tokens=n, decode_strategy=strategy, jacobi_block_len=block,
                   jacobi_max_blocks=blocks, jacobi_n_gram_pool_size=4,
                   jacobi_max_iterations=1 << 20)

    for name in names:
        mc, params = jload(DEMO, dtype=jnp.float32)
        jkw, tkw = ENGINE_KW.get(name, ({}, {}))
        jeng = JLLMEngine(JConfig(**kw, **CONFIGS[name]), model_cfg=mc, params=params,
                          num_kv_pages=1024, **jkw)
        want, iters = [], []
        for p in prompts:
            it0 = jeng.stats["jacobi_iterations"]
            want.append(jeng.generate([p], sp(JSamplingParams, "jacobi"))[0]["token_ids"])
            iters.append(jeng.stats["jacobi_iterations"] - it0)
        eos = [bool(s) and s[-1] == kw["eos"] for s in want]
        for k in (64, 16):
            toks = sum(len(s) for s in want[:k])
            print(f"[anchor] {name}: JAX on the CPU, f32, first {k} prompts: {toks} tokens, "
                  f"{sum(eos[:k])}/{k} EOS, aggregate TPF {toks / sum(iters[:k]):.4f}", flush=True)
        print(f"[anchor] {name}: tokens per prompt, first 16: {[len(s) for s in want[:16]]}",
              flush=True)
        llm = LLM(model=DEMO, device="cpu", dtype=torch.float32, num_kv_pages=1024,
                  jacobi_mr_auto_policy=False, **kw, **CONFIGS[name], **tkw)
        for strategy, blocks in (("autoregressive", 1), ("jacobi", 1), (MR, 2)):
            got = [llm.engine.generate([p], sp(SamplingParams, strategy, blocks))[0]["token_ids"]
                   for p in prompts]
            diff = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
            print(f"[anchor] {name}: port on the CPU, {strategy}: "
                  f"{sum(len(s) for s in got)} tokens, equal to JAX on "
                  f"{len(prompts) - len(diff)}/{len(prompts)} prompts"
                  + (f" (first differing prompt {diff[0]})" if diff else ""), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or list(CONFIGS))
