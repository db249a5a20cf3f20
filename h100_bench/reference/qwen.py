"""Plain reference of the Qwen2 / Qwen3 decoder, in float32 with TF32 off.

It follows the Hugging Face `Qwen2ForCausalLM` / `Qwen3ForCausalLM`
equations and reads the configuration file and the tensors under their
checkpoint names (`layouts/qwen.py`), nothing of the program:

    h = embed[ids]
    per layer:  x = rms(h) * w_in
                q, k, v = x Wq^T (+ bq), x Wk^T (+ bk), x Wv^T (+ bv)
                Qwen3: q, k = rms_head(q) * q_norm, rms_head(k) * k_norm
                q, k = rope(q), rope(k)          rotate-half, theta^(-2i/D)
                h = h + softmax(q k^T / sqrt(D) + causal) v  Wo^T   (GQA:
                    query head j reads KV head j // (NH / KH))
                x = rms(h) * w_post
                h = h + (silu(x Wg^T) * (x Wu^T)) Wd^T
    logits = (rms(h) * w_final) Wlm^T

Departures: the rotary angles are taken in float64 and rounded once to
float32 (the published code takes them in float32).  The model runs layer by
layer over all the sequences it is given, so that only one layer's weights
are ever held in float32.  With `fp8=True` every linear product takes its
input rows and weight rows rounded to float8 e4m3 (one scale per row, the
amax over 448): the control, one precision below bfloat16.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

import torch

F32 = torch.float32
FP8_MAX = 448.0


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per row (last axis)."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


class Reference:
    def __init__(self, cfg: dict, tensors: Dict[str, torch.Tensor], fp8: bool = False):
        self.cfg = cfg
        self.t = tensors
        self.fp8 = fp8
        self.H = cfg["hidden_size"]
        self.NH = cfg["num_attention_heads"]
        self.KH = cfg.get("num_key_value_heads", self.NH)
        self.D = cfg.get("head_dim") or self.H // self.NH
        self.eps = cfg["rms_norm_eps"]
        self.theta = float(cfg["rope_theta"])
        self.qwen3 = cfg["model_type"] == "qwen3"
        self.bias = cfg.get("attention_bias", cfg["model_type"] == "qwen2")

    def w(self, name: str) -> torch.Tensor:
        return self.t[name].to(F32)

    def linear(self, x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
        if self.fp8:
            x, w = fp8_rows(x), fp8_rows(w)
        y = x @ w.T
        return y if b is None else y + b

    def rms(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * w

    def rope(self, x: torch.Tensor, T: int) -> torch.Tensor:
        """x [T, heads, D], positions 0..T-1."""
        D = self.D
        inv = 1.0 / (self.theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                                 device=x.device) / D))
        ang = torch.outer(torch.arange(T, dtype=torch.float64, device=x.device), inv)
        ang = torch.cat([ang, ang], dim=-1)
        cos, sin = ang.cos().to(F32)[:, None, :], ang.sin().to(F32)[:, None, :]
        x1, x2 = x[..., : D // 2], x[..., D // 2:]
        return x * cos + torch.cat([-x2, x1], dim=-1) * sin

    def attention(self, x: torch.Tensor, i: int) -> torch.Tensor:
        p = f"model.layers.{i}.self_attn."
        T = x.shape[0]
        b = (lambda n: self.w(p + n + "_proj.bias")) if self.bias else (lambda n: None)
        q = self.linear(x, self.w(p + "q_proj.weight"), b("q")).view(T, self.NH, self.D)
        k = self.linear(x, self.w(p + "k_proj.weight"), b("k")).view(T, self.KH, self.D)
        v = self.linear(x, self.w(p + "v_proj.weight"), b("v")).view(T, self.KH, self.D)
        if self.qwen3:
            q = self.rms(q, self.w(p + "q_norm.weight"))
            k = self.rms(k, self.w(p + "k_norm.weight"))
        q, k = self.rope(q, T), self.rope(k, T)
        G = self.NH // self.KH
        k = k.repeat_interleave(G, dim=1)
        v = v.repeat_interleave(G, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) / (self.D ** 0.5)
        causal = torch.ones(T, T, dtype=torch.bool, device=x.device).triu(1)
        s = s.masked_fill(causal, float("-inf")).softmax(-1)
        o = torch.einsum("hqk,khd->qhd", s, v).reshape(T, self.NH * self.D)
        return self.linear(o, self.w(p + "o_proj.weight"))

    def mlp(self, x: torch.Tensor, i: int) -> torch.Tensor:
        p = f"model.layers.{i}.mlp."
        g = self.linear(x, self.w(p + "gate_proj.weight"))
        u = self.linear(x, self.w(p + "up_proj.weight"))
        return self.linear(torch.nn.functional.silu(g) * u, self.w(p + "down_proj.weight"))

    @torch.no_grad()
    def logits_at(self, seqs: Sequence[Sequence[int]],
                  positions: Sequence[Sequence[int]]) -> List[torch.Tensor]:
        """For each sequence, the float32 logits [len(positions), V] at the
        given positions (the prediction of the token after each)."""
        with no_tf32():
            dev = self.t["model.embed_tokens.weight"].device
            emb = self.t["model.embed_tokens.weight"]
            hs = [emb[torch.as_tensor(list(s), device=dev)].to(F32) for s in seqs]
            for i in range(self.cfg["num_hidden_layers"]):
                p = f"model.layers.{i}."
                w_in, w_post = self.w(p + "input_layernorm.weight"), \
                    self.w(p + "post_attention_layernorm.weight")
                for j, h in enumerate(hs):
                    h = h + self.attention(self.rms(h, w_in), i)
                    hs[j] = h + self.mlp(self.rms(h, w_post), i)
            head = self.w("lm_head.weight") if "lm_head.weight" in self.t else emb.to(F32)
            w_f = self.w("model.norm.weight")
            out = []
            for h, pos in zip(hs, positions):
                x = self.rms(h[torch.as_tensor(list(pos), device=dev)], w_f)
                out.append(self.linear(x, head))
            return out
