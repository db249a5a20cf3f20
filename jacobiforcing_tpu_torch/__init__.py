"""JacobiForcing in PyTorch for NVIDIA Hopper (H100).

A port of `jacobiforcing_tpu` (JAX/Pallas on TPU) that keeps its module
layout and names, so each module's counterpart is easy to find.  It imports
`torch` and never `jax`, and nothing of `jacobiforcing_tpu`: the host
modules it shares with the JAX package are its own copies.

Entry points (`LLM`, `LLMEngine`, `load_checkpoint`, `init_params`, the
per-call API of `jacobiforcing_tpu_torch.modeling`, and the trainer
`jacobiforcing_tpu_torch.train.trainer.train`) take an explicit `device`,
"cuda" by default; without a card they raise unless `device="cpu"` is given.
On a CUDA tensor the paged attention, the speculative attention of the
multiblock (MR) decoder, the trainer's block-sparse attention (forward and
backward) and the int4 dequant-matmul run the hand-written kernels in
`csrc/paged_attention.cu`, `csrc/spec_attention.cu`, `csrc/train_attention.cu`
and `csrc/int4_matmul.cu` (built with `nvcc` at first use into
`build/kernels/`); on a CPU tensor they run their plain PyTorch versions.
Serving can be quantized: int8 or W8A8 weights (`ops/quant.py`) and an fp8 /
int8 KV cache with per-row scales that the attention kernels read directly.
"""

__version__ = "0.1.0"

__all__ = ["Config", "SamplingParams", "LLM"]


def __getattr__(name):
    # Lazy, so that `import jacobiforcing_tpu_torch` stays light.
    if name in ("Config", "SamplingParams"):
        from jacobiforcing_tpu_torch import config

        return getattr(config, name)
    if name == "LLM":
        from jacobiforcing_tpu_torch.engine.llm import LLM

        return LLM
    raise AttributeError(name)
