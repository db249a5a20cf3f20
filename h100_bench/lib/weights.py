"""A configuration's weights, made on the device from the run's seed.

The tensors carry the Hugging Face checkpoint names and shapes ([out, in]
linear weights), as a checkpoint of the configuration would hold them, and
are made in the configuration's dtype in three calls of one
`torch.Generator` on the device: every linear weight in one buffer, the
embedding in a second, every bias and norm weight in a third.  The same seed
on the same device gives the same bits, so the plain reference makes them
again after the program has been freed, and the program gets them through
its own loading path (`utils/loader.assemble_params`).

Scales: a linear weight N(0, 1) / sqrt(fan_in), the embedding N(0, 1) * 0.02,
a bias N(0, 1) * 0.02, a norm weight 1 + N(0, 1) * 0.1.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
          "float64": torch.float64}


def dims(cfg: dict) -> dict:
    H = cfg["hidden_size"]
    NH = cfg["num_attention_heads"]
    D = cfg.get("head_dim") or H // NH
    return dict(H=H, NH=NH, KH=cfg.get("num_key_value_heads", NH), D=D,
                I=cfg["intermediate_size"], V=cfg["vocab_size"], NL=cfg["num_hidden_layers"],
                qkv_bias=cfg.get("attention_bias", cfg["model_type"] == "qwen2"),
                qk_norm=cfg["model_type"] == "qwen3",
                tied=cfg.get("tie_word_embeddings", False))


def _layouts(cfg: dict) -> Tuple[List[tuple], List[tuple]]:
    """(matrices, vectors): (name, shape, fan_in or scale kind) in buffer
    order.  Matrices are grouped by fan-in so that one scaling covers each
    group."""
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
        vecs += [(p + "input_layernorm.weight", (H,), "norm"),
                 (p + "post_attention_layernorm.weight", (H,), "norm")]
        if d["qkv_bias"]:
            vecs += [(p + "self_attn.q_proj.bias", (qs,), "bias"),
                     (p + "self_attn.k_proj.bias", (kvs,), "bias"),
                     (p + "self_attn.v_proj.bias", (kvs,), "bias")]
        if d["qk_norm"]:
            vecs += [(p + "self_attn.q_norm.weight", (D,), "norm"),
                     (p + "self_attn.k_norm.weight", (D,), "norm")]
    if not d["tied"]:
        mats_h.append(("lm_head.weight", (d["V"], H)))
    vecs.append(("model.norm.weight", (H,), "norm"))
    mats = ([(n, s, H) for n, s in mats_h] + [(n, s, qs) for n, s in mats_q]
            + [(n, s, I) for n, s in mats_i])
    return mats, vecs


def make_hf_tensors(cfg: dict, seed: int, device, dtype=None) -> Dict[str, torch.Tensor]:
    """{HF name: tensor} on `device`, from `seed`.  Views into three
    buffers; `model.embed_tokens.weight` is a buffer of its own, so a
    loader that keeps it as it is does not keep the others alive."""
    dtype = dtype or DTYPES[cfg["torch_dtype"]]
    d = dims(cfg)
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    mats, vecs = _layouts(cfg)
    out: Dict[str, torch.Tensor] = {}

    total = sum(math.prod(s) for _, s, _ in mats)
    buf = torch.randn(total, generator=gen, device=dev, dtype=dtype)
    off = 0
    seg_start, seg_fan = 0, mats[0][2]
    for name, shape, fan in mats + [(None, (0,), None)]:
        if fan != seg_fan:  # one scaling per group of equal fan-in
            buf[seg_start:off].mul_(1.0 / math.sqrt(seg_fan))
            seg_start, seg_fan = off, fan
        if name is None:
            break
        n = math.prod(shape)
        out[name] = buf[off: off + n].view(shape)
        off += n

    out["model.embed_tokens.weight"] = torch.randn(
        (d["V"], d["H"]), generator=gen, device=dev, dtype=dtype).mul_(0.02)

    vtotal = sum(math.prod(s) for _, s, _ in vecs)
    vbuf = torch.randn(vtotal, generator=gen, device=dev, dtype=torch.float32)
    off = 0
    for name, shape, kind in vecs:
        n = math.prod(shape)
        seg = vbuf[off: off + n]
        if kind == "norm":
            seg.mul_(0.1).add_(1.0)
        else:
            seg.mul_(0.02)
        off += n
    vbuf = vbuf.to(dtype)
    off = 0
    for name, shape, _ in vecs:
        n = math.prod(shape)
        out[name] = vbuf[off: off + n].view(shape)
        off += n
    return out


def port_params(cfg: dict, seed: int, device):
    """(ModelConfig, params) of the port, through its own loading path."""
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig
    from jacobiforcing_tpu_torch.utils.loader import assemble_params

    dtype = DTYPES[cfg["torch_dtype"]]
    mc = ModelConfig.from_hf_config(cfg)
    mc = ModelConfig(**{**mc.__dict__, "dtype": dtype})
    tensors = make_hf_tensors(cfg, seed, device, dtype)
    params = assemble_params(mc, tensors, dtype, torch.device(device))
    del tensors
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return mc, params
