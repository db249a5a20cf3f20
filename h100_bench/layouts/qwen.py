"""The Qwen2 / Qwen3 dense decoder: its checkpoint, the port's loader and
its shapes for the counts (`lib/registry.py` has the contract).

Checkpoint: the Hugging Face `Qwen2ForCausalLM` / `Qwen3ForCausalLM` names
and shapes ([out, in] linear weights): GQA attention with q/k/v biases
(Qwen2) or per-head q/k RMSNorm weights (Qwen3), a dense SwiGLU MLP, an
untied head.  Three draws: every linear weight (grouped by fan-in), the
embedding, every bias and norm weight (made in float32).  The port takes
them through `utils/loader.assemble_params`, which stacks the layers.
"""

from __future__ import annotations

import torch

from h100_bench.lib.weights import NORM, SMALL, Draw


def dims(cfg: dict) -> dict:
    H = cfg["hidden_size"]
    NH = cfg["num_attention_heads"]
    D = cfg.get("head_dim") or H // NH
    return dict(H=H, NH=NH, KH=cfg.get("num_key_value_heads", NH), D=D,
                I=cfg["intermediate_size"], V=cfg["vocab_size"], NL=cfg["num_hidden_layers"],
                qkv_bias=cfg.get("attention_bias", cfg["model_type"] == "qwen2"),
                qk_norm=cfg["model_type"] == "qwen3",
                tied=cfg.get("tie_word_embeddings", False))


def draws(cfg: dict):
    d = dims(cfg)
    H, D, I = d["H"], d["D"], d["I"]
    qs, kvs = d["NH"] * D, d["KH"] * D
    pre = "model.layers.{}."
    mats_h, mats_q, mats_i, vecs = [], [], [], []
    for i in range(d["NL"]):
        p = pre.format(i)
        mats_h += [(p + "self_attn.q_proj.weight", (qs, H)),
                   (p + "self_attn.k_proj.weight", (kvs, H)),
                   (p + "self_attn.v_proj.weight", (kvs, H)),
                   (p + "mlp.gate_proj.weight", (I, H)),
                   (p + "mlp.up_proj.weight", (I, H))]
        mats_q.append((p + "self_attn.o_proj.weight", (H, qs)))
        mats_i.append((p + "mlp.down_proj.weight", (H, I)))
        vecs += [(p + "input_layernorm.weight", (H,), NORM),
                 (p + "post_attention_layernorm.weight", (H,), NORM)]
        if d["qkv_bias"]:
            vecs += [(p + "self_attn.q_proj.bias", (qs,), SMALL),
                     (p + "self_attn.k_proj.bias", (kvs,), SMALL),
                     (p + "self_attn.v_proj.bias", (kvs,), SMALL)]
        if d["qk_norm"]:
            vecs += [(p + "self_attn.q_norm.weight", (D,), NORM),
                     (p + "self_attn.k_norm.weight", (D,), NORM)]
    if not d["tied"]:
        mats_h.append(("lm_head.weight", (d["V"], H)))
    vecs.append(("model.norm.weight", (H,), NORM))
    mats = ([(n, s, H) for n, s in mats_h] + [(n, s, qs) for n, s in mats_q]
            + [(n, s, I) for n, s in mats_i])
    return [Draw(mats), Draw([("model.embed_tokens.weight", (d["V"], H), SMALL)]),
            Draw(vecs, torch.float32)]


def port_params(cfg: dict, pieces, dtype, device):
    """(ModelConfig, params): the three pieces gathered, then stacked by the
    port's loader."""
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig
    from jacobiforcing_tpu_torch.utils.loader import assemble_params

    mc = ModelConfig.from_hf_config(cfg)
    mc = ModelConfig(**{**mc.__dict__, "dtype": dtype})
    tensors = {}
    for piece in pieces:
        tensors.update(piece)
    return mc, assemble_params(mc, tensors, dtype, device)


def row_linear_flops(cfg: dict) -> int:
    """q, k, v, o and the three MLP matrices, in every layer."""
    d = dims(cfg)
    H, I = d["H"], d["I"]
    q, kv = d["NH"] * d["D"], d["KH"] * d["D"]
    return 2 * (H * (q + 2 * kv) + q * H + 3 * H * I) * d["NL"]


def attention_layers(cfg: dict):
    """Every layer full causal, one head shape."""
    d = dims(cfg)
    return [(d["NH"], d["KH"], d["D"], None)] * d["NL"]
