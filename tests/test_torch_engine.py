"""The port's serving engine on the trained demo checkpoint, in f32, against
the JAX engine (settings of bench.py's measured_tpf_metrics: page 16, N=32,
max_tokens 96, eos from the checkpoint's metadata).

Token streams must be identical.  TPF depends on the random tail of each
Jacobi draft, whose bits differ between jax.random and torch.Generator: the
JAX package on the CPU measured aggregate TPF 4.7279 / 4.6628 / 4.7279 for
engine seeds 0 / 1 / 2 (2033 tokens, 64/64 EOS each), so the port's TPF is
held to that spread plus a margin, [4.55, 4.85].
"""

import json
import os

import jax.numpy as jnp
import pytest
import torch

from jacobiforcing_tpu.config import Config as JConfig
from jacobiforcing_tpu.config import SamplingParams as JSamplingParams
from jacobiforcing_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from jacobiforcing_tpu.utils.loader import load_checkpoint as jload
from jacobiforcing_tpu_torch import LLM, Config, SamplingParams
from jacobiforcing_tpu_torch.apps import bench_generate

DEMO = os.path.join(os.path.dirname(__file__), "..", "assets", "tpf_demo_n32_v7")
with open(os.path.join(DEMO, "tpf_demo.json")) as _f:
    META = json.load(_f)
ENGINE_KW = dict(kvcache_page_size=16, max_model_len=512, jacobi_chunk_tokens=64,
                 eos=int(META["eos"]), prefill_token_buckets=(32, 64, 128, 256, 512))


def _prompts(n):
    with open(os.path.join(DEMO, "heldout_prompts.jsonl")) as f:
        return [json.loads(line)["prompt_ids"] for line in f][:n]


def _sp(cls, strategy):
    return cls(temperature=0.0, max_tokens=int(META["max_tokens"]), decode_strategy=strategy,
               jacobi_block_len=int(META["block_len"]), jacobi_max_blocks=1,
               jacobi_max_iterations=1 << 20)


@pytest.fixture(scope="module")
def port_llm():
    return LLM(model=DEMO, device="cpu", dtype=torch.float32, num_kv_pages=1024, **ENGINE_KW)


def test_port_engine_equals_jax_engine(port_llm):
    prompts = _prompts(16)
    mc, params = jload(DEMO, dtype=jnp.float32)
    jeng = JLLMEngine(JConfig(**ENGINE_KW), model_cfg=mc, params=params, num_kv_pages=1024)
    for p in prompts:
        j = jeng.generate([p], _sp(JSamplingParams, "jacobi"))[0]["token_ids"]
        t = port_llm.engine.generate([p], _sp(SamplingParams, "jacobi"))[0]["token_ids"]
        assert t == j
    # AR through the port's engine gives the same streams as its Jacobi
    outs = port_llm.generate(prompts[:4], _sp(SamplingParams, "autoregressive"))
    for p, o in zip(prompts[:4], outs):
        assert o["token_ids"] == jeng.generate([p], _sp(JSamplingParams, "jacobi"))[0]["token_ids"]


def test_bench_generate_demo_anchor(port_llm, tmp_path):
    """All 64 held-out prompts through the port's bench_generate: 2033
    tokens, 64/64 EOS, aggregate TPF inside the JAX seed spread."""
    args = bench_generate.make_parser().parse_args([])
    args.strategy = "jacobi"
    args.n_token_seq_len = int(META["block_len"])
    args.max_blocks = 1
    args.max_new_tokens = int(META["max_tokens"])
    args.max_iterations = 1 << 20
    args.dataset = os.path.join(DEMO, "heldout_prompts.jsonl")
    args.output_dir = str(tmp_path)
    agg, profiles = bench_generate.run(args, engine=port_llm.engine)
    assert len(profiles) == 64
    assert agg["total_tokens"] == 2033
    assert agg["n_eos_terminated"] == 64
    assert 4.55 <= agg["aggregate_tokens_per_forward"] <= 4.85


@pytest.mark.parametrize("kw", [dict(data_parallel_size=2)])
def test_unported_config_options_raise(kw):
    with pytest.raises(NotImplementedError):
        Config(**kw)


def test_tensor_parallel_needs_a_world_with_a_model_group():
    """tensor_parallel_size=2 is a valid configuration; an engine outside a
    torch.distributed world of that size has no model group to run it on and
    raises ValueError."""
    from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params

    cfg = Config(tensor_parallel_size=2, kvcache_page_size=16, max_model_len=64)
    mc = ModelConfig.tiny()
    with pytest.raises(ValueError, match="tensor_parallel_size=2"):
        LLMEngine(cfg, model_cfg=mc, params=init_params(mc, 0, "cpu"), num_kv_pages=8,
                  device="cpu")


@pytest.mark.parametrize("strategy,temperature", [
    ("jacobi_multiblock_rejection_recycling", 0.7),
])
def test_unported_strategies_raise(port_llm, strategy, temperature):
    """MR is greedy only: a sampled MR request raises (the JAX engine would
    decode it greedily without saying so)."""
    sp = SamplingParams(temperature=temperature, decode_strategy=strategy)
    with pytest.raises(NotImplementedError):
        port_llm.engine.add_request([1, 2, 3], sp)


def test_llm_without_a_card_needs_explicit_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LLM(model=DEMO, dtype=torch.float32, num_kv_pages=64, **ENGINE_KW)


def test_cpu_kv_pool_needs_num_kv_pages():
    """Device memory sizes the pool on the card; on the CPU the caller must."""
    with pytest.raises(ValueError, match="num_kv_pages"):
        LLM(model=DEMO, device="cpu", dtype=torch.float32, **ENGINE_KW)
