"""Public serving API (PyTorch port of `jacobiforcing_tpu/engine/llm.py`).

    from jacobiforcing_tpu_torch import LLM, SamplingParams
    llm = LLM(model="/path/to/ckpt", device="cuda")
    outs = llm.generate(prompt_ids, SamplingParams(max_tokens=128), greedy=True,
                        jacobi_decoding=True)

`generate` merges the greedy/Jacobi convenience kwargs into SamplingParams
and delegates to the engine.  Keyword arguments that name a `Config` field
configure the engine; the rest (`device`, `dtype`, `num_kv_pages`, `kv_dtype`,
`model_cfg`, `params`, `mesh`) go to `LLMEngine`.  Quantized serving is configuration:

    llm = LLM(model=..., quantization="w8a8", kv_cache_dtype="fp8")

`quantization` is "int8" (weight-only) or "w8a8"; `kv_cache_dtype` is "fp8",
"int8" or "bf16".  Every greedy strategy runs inside each, with identical
token streams.

Sampled decoding: `SamplingParams(temperature=0.7, decode_strategy="jacobi")`
(or "jacobi_nongreedy", with `top_k` / `top_p`) runs rejection-sampling
Jacobi; `decode_strategy="jacobi_on_policy"` runs on-policy rollouts and adds
`rollout_records` to each output (temperature 0 is the greedy trajectory
collector of `data/collect.collect_trajectories`).

Tensor-parallel serving under `torchrun`: every rank joins the world
(`parallel.multihost.initialize_multihost`) and builds the same
`LLM(model=..., tensor_parallel_size=N)`; each loads the checkpoint on the
host, moves its share to its card, serves the same requests and returns the
same outputs.  Full `params` given instead are cut the same way.
"""

from __future__ import annotations

import os
from dataclasses import fields, replace
from typing import Any, Dict, List, Optional, Union

from jacobiforcing_tpu_torch.config import Config, SamplingParams
from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine


class LLM:
    def __init__(self, model: str = "", tokenizer=None, device="cuda", **kwargs):
        cfg_fields = {f.name for f in fields(Config)}
        cfg_kwargs = {k: v for k, v in kwargs.items() if k in cfg_fields}
        engine_kwargs = {k: v for k, v in kwargs.items() if k not in cfg_fields}
        config = Config(model=model, **cfg_kwargs)
        if tokenizer is None and model:
            tokenizer = _load_tokenizer(config.model_path)
        self.engine = LLMEngine(config, tokenizer=tokenizer, device=device, **engine_kwargs)
        self.tokenizer = tokenizer

    def generate(
        self,
        prompts: Union[List[str], List[List[int]]],
        sampling_params: Optional[SamplingParams] = None,
        *,
        greedy: Optional[bool] = None,
        jacobi_decoding: Optional[bool] = None,
        jacobi_block_len: Optional[int] = None,
        jacobi_max_iterations: Optional[int] = None,
        use_tqdm: bool = False,
    ) -> List[Dict[str, Any]]:
        sp = sampling_params or SamplingParams()
        updates: Dict[str, Any] = {}
        if greedy:
            updates["temperature"] = 0.0
        if jacobi_decoding is not None:
            updates["decode_strategy"] = "jacobi" if jacobi_decoding else "autoregressive"
        if jacobi_block_len is not None:
            updates["jacobi_block_len"] = jacobi_block_len
        if jacobi_max_iterations is not None:
            updates["jacobi_max_iterations"] = jacobi_max_iterations
        if updates:
            sp = replace(sp, **updates)
        if sp.decode_strategy == "jacobi" and sp.temperature > 0 and not sp.jacobi_on_policy:
            # a sampled Jacobi request takes the rejection-sampling decoder
            sp = replace(sp, decode_strategy="jacobi_nongreedy")

        if prompts and isinstance(prompts[0], str):
            assert self.tokenizer is not None, "text prompts need a tokenizer"
            prompt_ids = [self.tokenizer.encode(p) for p in prompts]
        else:
            prompt_ids = prompts
        return self.engine.generate(prompt_ids, sp, use_tqdm=use_tqdm)

    def warmup(self, **kw):
        """Build the kernels and capture the graphs of the serving buckets
        (see `LLMEngine.warmup`)."""
        return self.engine.warmup(**kw)

    @property
    def stats(self):
        return self.engine.stats

    def exit(self) -> None:
        self.engine.exit()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.exit()
        return False


def _load_tokenizer(path: str):
    """The checkpoint's HF tokenizer, or None where the directory holds none
    (the in-repo demo checkpoints work on token ids)."""
    if not any(
        os.path.exists(os.path.join(path, f)) for f in ("tokenizer.json", "tokenizer_config.json")
    ):
        return None
    from transformers import AutoTokenizer

    return AutoTokenizer.from_pretrained(path)
