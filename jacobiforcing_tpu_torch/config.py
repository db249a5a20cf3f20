"""Engine configuration and per-request sampling parameters (PyTorch port).

A copy of `jacobiforcing_tpu/config.py`: the same fields and defaults, so a
configuration reads the same in both packages.  The port serves every decode
strategy of the JAX engine: autoregressive (greedy or sampled), greedy
single-block Jacobi, rejection-sampling Jacobi (`jacobi_nongreedy`, shaped by
`top_k` / `top_p`), on-policy rollouts (`jacobi_on_policy`, with
`jacobi_accept_threshold` and the `stop_token_ids` stop set) and multiblock
(MR) decoding, so the MR options (`pad`, the `jacobi_mr_*` auto-policy fields,
the spawn / lookahead / pool fields) are read as in the JAX engine, and so are
`quantization` ("int8" weight-only, "w8a8") and `kv_cache_dtype` ("fp8",
"int8", "bf16"); any other string there raises `ValueError`.

Single-block Jacobi chunks run through the JAX engine's one-chunk-lag
speculative host pipeline (`jacobi_async_host`, on by default).  On a CUDA
device the AR step and every Jacobi trip replay one CUDA graph per shape
bucket, the counterpart of the JAX package's one compiled executable per
bucket; `enforce_eager=True` (the reference engine's switch of that name)
runs them eagerly instead.  `tensor_parallel_size` > 1 serves the model
tensor-parallel over a `torch.distributed` world (`parallel/`; the engine
raises `ValueError` where the world's model axis differs or the KV heads do
not divide).  `data_parallel_size` > 1 raises `NotImplementedError`: the JAX
engine never reads it either, and the data axis takes its meaning in
training.  The XLA compilation-cache and TPU
memory-sizing fields have no counterpart here, nor does `jacobi_enabled`,
which neither package reads.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64)
QUANTIZATIONS = ("", "int8", "w8a8")
KV_CACHE_DTYPES = ("", "fp8", "int8", "bf16")


def _reject_unported(obj, defaults: dict) -> None:
    for name, default in defaults.items():
        if getattr(obj, name) != default:
            raise NotImplementedError(
                f"{type(obj).__name__}.{name}={getattr(obj, name)!r} is not "
                f"supported by the PyTorch port yet (only {default!r})"
            )


@dataclass
class Config:
    """Engine-level configuration (mirrors jacobiforcing_tpu.config.Config)."""

    model: str = ""
    max_num_batched_tokens: int = 16384
    max_num_seqs: int = 256
    max_model_len: int = 8192
    tensor_parallel_size: int = 1
    data_parallel_size: int = 1
    eos: int = -1
    pad: int = -1
    # Extra stop tokens for on-policy rollouts (the config's eos joins them).
    stop_token_ids: tuple = ()
    # Paged KV cache: any page size that is a multiple of 16.
    kvcache_page_size: int = 256
    num_kv_pages: int = -1  # -1 = size from free device memory at startup
    hbm_utilization: float = 0.9

    jacobi_block_len: int = 64
    jacobi_max_blocks: int = 2
    jacobi_spawn_ratio: float = 0.8
    jacobi_lookahead_start_ratio: float = 0.0
    jacobi_n_gram_pool_size: int = 4
    jacobi_max_iterations: int = 128
    # Measured MR auto-policy (engine/mr_policy.py): MR requests are served by
    # whichever of {full MR, MR without candidates, RA-only MR, single-block
    # Jacobi} measures the highest tokens/s online; all are greedy and commit
    # identical tokens.  False forces the requested MR configuration.
    jacobi_mr_auto_policy: bool = True
    jacobi_mr_probe_chunks: int = 4
    jacobi_mr_reprobe_every: int = 256
    jacobi_mr_single_arm: bool = True

    # Shape buckets: the batch is padded to the next batch bucket and the
    # prefill suffix to the next token bucket, as in the JAX engine.
    batch_buckets: tuple = DEFAULT_BATCH_BUCKETS
    prefill_token_buckets: tuple = (256, 512, 1024, 2048, 4096, 8192)
    # Tokens committed per Jacobi chunk before control returns to the
    # scheduler (admission/retirement).
    jacobi_chunk_tokens: int = 256
    # > 0: iteration-budget chunking (a fixed number of loop trips per chunk).
    jacobi_chunk_iters: int = 0
    # Speculative host pipeline: dispatch Jacobi chunk k+1 from chunk k's
    # device outputs before reading chunk k back, and commit chunk k on the
    # host while chunk k+1's first trip runs.  Exact: every finish condition
    # is mirrored on the device, so a pending chunk's rows of finished
    # sequences are inert; commits (and finish detection) lag one chunk.
    jacobi_async_host: bool = True
    # True: no CUDA graphs; the AR step and the Jacobi trips run eagerly on
    # the card (on the CPU they always do).
    enforce_eager: bool = False

    seed: int = 0
    # "int8": weight-only int8 linear layers and lm_head; "w8a8": int8 weights
    # and per-token int8 activations (int8 x int8 products).
    quantization: str = ""
    # KV storage: "fp8" (e4m3) or "int8", each with per-row dequant scales, or
    # "bf16" (a bfloat16 cache under a wider model); "" = the model dtype.
    kv_cache_dtype: str = ""

    # Resolved at engine init.
    model_path: str = field(default="", repr=False)

    def __post_init__(self):
        assert self.kvcache_page_size % 16 == 0
        if self.quantization not in QUANTIZATIONS:
            raise ValueError(f"quantization={self.quantization!r}: expected one of "
                             f"{QUANTIZATIONS}")
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype={self.kv_cache_dtype!r}: expected one of "
                             f"{KV_CACHE_DTYPES}")
        _reject_unported(self, {"data_parallel_size": 1})
        if self.model:
            self.model_path = resolve_checkpoint_dir(self.model)


def resolve_checkpoint_dir(model_path: str) -> str:
    """Auto-select the latest `checkpoint-*` subdir if present."""
    if os.path.isdir(model_path):
        ckpts = [
            d
            for d in os.listdir(model_path)
            if d.startswith("checkpoint-") and os.path.isdir(os.path.join(model_path, d))
        ]
        if ckpts:
            latest = max(ckpts, key=lambda x: int(x.split("-")[1]))
            return os.path.join(model_path, latest)
    return model_path


@dataclass
class SamplingParams:
    """Per-request sampling parameters (mirrors the JAX SamplingParams)."""

    temperature: float = 1.0
    top_k: int = -1
    top_p: float = 1.0
    max_tokens: int = 64
    ignore_eos: bool = False

    # "autoregressive" | "jacobi" | "jacobi_nongreedy" | "jacobi_on_policy" |
    # "jacobi_multiblock_rejection_recycling" ("jacobi" and MR are greedy)
    decode_strategy: str = "autoregressive"

    jacobi_block_len: int = 64
    jacobi_max_blocks: int = 2
    jacobi_spawn_ratio: float = 0.8
    jacobi_lookahead_start_ratio: float = 0.0
    jacobi_n_gram_pool_size: int = 4
    jacobi_max_iterations: int = 128

    # Emit training rollout records instead of plain generations
    # (reference: jacobi_decoding_nongreedy_on_policy.py).
    jacobi_on_policy: bool = False
    # On-policy collection acceptance: 0 = rejection sampling; > 0 accepts a
    # drafted token deterministically when p(x) >= threshold.
    jacobi_accept_threshold: float = 0.0

    def __post_init__(self):
        assert self.temperature >= 0.0
        if self.jacobi_on_policy:
            assert self.temperature > 0.0, "on-policy rollouts require temperature > 0"

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0
