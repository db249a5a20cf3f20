"""Qwen2.5 / Qwen3 decoder in PyTorch with a paged KV cache.

Port of `jacobiforcing_tpu/models/qwen.py`.  Parameters are a plain dict laid
out as the JAX pytree: per-layer weights stacked on a leading layer axis,
linear weights as [in, out] for `x @ W`.  The decoder runs as a Python loop
over layers; per layer it scatters the new K/V into the cache (in place) and
then attends through `ops/attention.paged_attention`, so one attention path
serves prefill, AR decode and Jacobi blocks, as in the JAX package.
`forward_spec` is the speculative forward of the multiblock (MR) decoder: it
reads the committed cache, writes nothing, and returns the block's K/V.
`forward_dense` is the training forward: no cache, differentiable, attention
under a dense mask or through the block-sparse training kernels.

Sums are accumulated in float32, or float64 for a float64 model, exactly as
`acc_dtype` does there.  Qwen2-style (QKV bias) and Qwen3-style (per-head
q/k RMSNorm) checkpoints are both supported through `ModelConfig` flags.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from jacobiforcing_tpu_torch.ops.attention import paged_attention, paged_attention_with_block
from jacobiforcing_tpu_torch.ops.train_attention import masked_attention, train_attention
from jacobiforcing_tpu_torch.ops.kv_cache import KVCache, write_kv, write_plan
from jacobiforcing_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model hyper-parameters; the defaults are Qwen2.5-7B's widths."""

    vocab_size: int = 151936
    hidden_size: int = 3584
    intermediate_size: int = 18944
    num_layers: int = 28
    num_heads: int = 28
    num_kv_heads: int = 4
    head_dim: int = 128
    rope_theta: float = 1_000_000.0
    rms_norm_eps: float = 1e-6
    max_position: int = 32768
    qkv_bias: bool = True  # Qwen2-style; False => Qwen3-style qk-norm
    qk_norm: bool = False
    tie_word_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @staticmethod
    def tiny(vocab_size: int = 256, **kw) -> "ModelConfig":
        """A CPU-testable toy config, in float64 like the JAX one: greedy
        argmax of a tiny random model is then immune to reassociation noise."""
        defaults = dict(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            max_position=1024,
            qkv_bias=True,
            qk_norm=False,
            dtype=torch.float64,
        )
        defaults.update(kw)
        return ModelConfig(**defaults)

    @staticmethod
    def from_hf_config(hf: Dict[str, Any]) -> "ModelConfig":
        """Build from an HF config.json dict (Qwen2/Qwen3 families)."""
        mt = hf.get("model_type", "qwen2")
        qkv_bias = hf.get("attention_bias", mt == "qwen2")
        head_dim = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
        return ModelConfig(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
            head_dim=head_dim,
            rope_theta=hf.get("rope_theta", 1_000_000.0),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
            max_position=hf.get("max_position_embeddings", 32768),
            qkv_bias=qkv_bias,
            qk_norm=(not qkv_bias) or mt == "qwen3",
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
        )


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------


def init_params(
    cfg: ModelConfig,
    generator: Union[torch.Generator, int] = 0,
    device="cuda",
) -> Dict[str, Any]:
    """Random-init a layer-stacked parameter dict, with the JAX version's
    scales (normal / sqrt(fan_in), embeddings 0.02).  For tests/benchmarks.

    `generator` is a torch.Generator on `device`, or an int seed for one.
    Each weight is drawn in float32 one layer at a time and cast to
    `cfg.dtype`, so the full-width model never holds a float32 copy.
    """
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    qs, kvs, D = cfg.q_size, cfg.kv_size, cfg.head_dim
    dt = cfg.dtype

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=dev, dtype=torch.float32)
        return (x * scale).to(dt)

    def dense(shape, scale=None):
        scale = scale or (1.0 / math.sqrt(shape[-2]))
        if len(shape) == 2:
            return normal(shape, scale)
        out = torch.empty(shape, dtype=dt, device=dev)
        for i in range(shape[0]):
            out[i] = normal(shape[1:], scale)
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    layers = {
        "ln1": ones(L, H),
        "ln2": ones(L, H),
        "wq": dense((L, H, qs)),
        "wk": dense((L, H, kvs)),
        "wv": dense((L, H, kvs)),
        "wo": dense((L, qs, H)),
        "w_gate": dense((L, H, I)),
        "w_up": dense((L, H, I)),
        "w_down": dense((L, I, H)),
    }
    if cfg.qkv_bias:
        layers["bq"] = torch.zeros((L, qs), dtype=dt, device=dev)
        layers["bk"] = torch.zeros((L, kvs), dtype=dt, device=dev)
        layers["bv"] = torch.zeros((L, kvs), dtype=dt, device=dev)
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, D)
        layers["k_norm"] = ones(L, D)

    params = {
        "embed": dense((cfg.vocab_size, H), scale=0.02),
        "layers": layers,
        "final_norm": ones(H),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense((H, cfg.vocab_size))
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: float32, or float64 when the model runs in float64."""
    return torch.float64 if dtype == torch.float64 else torch.float32


class _MmWide(torch.autograd.Function):
    """x [M, K] @ w [K, N] on the card as one low-precision GEMM that
    accumulates and writes `acc` (no wide copy of the weight).  The backward
    is written out, so training does not depend on `torch.mm(out_dtype=...)`
    having a derivative: the cotangent is cast to the operands' dtype and both
    products accumulate in float32 inside the GEMM."""

    @staticmethod
    def forward(ctx, x, w, acc):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=acc)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ w.T if ctx.needs_input_grad[0] else None
        dw = x.T @ g if ctx.needs_input_grad[1] else None
        return dx, dw, None


def _mm_acc(x: torch.Tensor, w: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """x @ w with the result in `acc` (JAX `preferred_element_type=acc`)."""
    if x.dtype == acc:
        return x @ w
    if x.is_cuda:
        out = _MmWide.apply(x.reshape(-1, x.shape[-1]), w, acc)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return x.to(acc) @ w.to(acc)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm accumulated in float32 (float64 for float64 inputs)."""
    xf = x.to(acc_dtype(x.dtype))
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.to(xf.dtype)).to(x.dtype)


def rope_table(cfg: ModelConfig, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE cos/sin [max_position, head_dim // 2] in float32."""
    half = cfg.head_dim // 2
    inv_freq = 1.0 / (
        cfg.rope_theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half)
    )
    t = torch.arange(cfg.max_position, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)  # [P, half]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE. x: [..., T, n_heads, head_dim]; cos/sin: [..., T, half]."""
    half = x.shape[-1] // 2
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    ad = acc_dtype(x.dtype)
    xf1, xf2 = x[..., :half].to(ad), x[..., half:].to(ad)
    o1 = xf1 * c - xf2 * s
    o2 = xf2 * c + xf1 * s
    return torch.cat([o1, o2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def forward(
    params: Dict[str, Any],
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # [B, T]
    positions: torch.Tensor,  # [B, T] absolute (padding rows may repeat)
    kv_cache: KVCache,  # paged cache for all layers (updated in place)
    block_tables: torch.Tensor,  # [B, max_pages] page ids (-1 = unused)
    cache_lens: torch.Tensor,  # [B] valid KV tokens INCLUDING this call's
    rope: Tuple[torch.Tensor, torch.Tensor],
    *,
    write_mask: Optional[torch.Tensor] = None,  # [B, T] bool: write KV for token?
) -> Tuple[torch.Tensor, KVCache]:
    """One forward over T tokens per sequence against the paged cache.

    Serves prefill (positions 0..P-1), AR decode (T=1, position S-1) and
    Jacobi blocks (T=L, positions S-1..S+L-2).  Returns (hidden [B, T, H],
    kv_cache); the cache tensors are written in place.
    """
    B, T = input_ids.shape
    page = kv_cache.page_size
    num_slots = kv_cache.num_slots
    block_tables = block_tables.to(torch.int32).contiguous()
    cache_lens = cache_lens.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    pos_l = positions.long()

    x = params["embed"][input_ids.long()].to(cfg.dtype)  # [B, T, H]
    cos_t, sin_t = rope
    cos, sin = cos_t[pos_l], sin_t[pos_l]  # [B, T, half] float32

    # Slot mapping: absolute position -> flat cache slot via the block table.
    P = block_tables.shape[1]
    page_idx = torch.gather(block_tables, 1, (pos_l // page).clamp(0, P - 1)).long()
    slots = page_idx * page + pos_l % page
    if write_mask is not None:
        slots = torch.where(write_mask, slots, num_slots)
    slots = torch.where(page_idx < 0, num_slots, slots)
    plan = write_plan(slots, num_slots)  # one plan for every layer

    lp = params["layers"]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    h = x
    for i in range(cfg.num_layers):
        w = {name: t[i] for name, t in lp.items()}
        q, kk, vv = _layer_qkv(cfg, w, h, cos, sin)
        k_l, v_l = kv_cache.k[i], kv_cache.v[i]
        write_kv(k_l, v_l, kk, vv, slots, plan)
        o = paged_attention(
            q, k_l, v_l, block_tables, cache_lens, positions, scale, page_size=page,
        )  # [B, T, NH, D]
        h = _layer_out(cfg, w, h, o)
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    return h, kv_cache


def _layer_qkv(cfg: ModelConfig, w, h, cos, sin):
    """Pre-norm, QKV projection (+bias / qk-norm) and RoPE of one layer:
    (q [B,T,NH,D], k [B,T,KH,D], v [B,T,KH,D])."""
    B, T, _ = h.shape
    hn = rms_norm(h, w["ln1"], cfg.rms_norm_eps)
    q = hn @ w["wq"]
    kk = hn @ w["wk"]
    vv = hn @ w["wv"]
    if cfg.qkv_bias:
        q = q + w["bq"]
        kk = kk + w["bk"]
        vv = vv + w["bv"]
    q = q.reshape(B, T, cfg.num_heads, cfg.head_dim)
    kk = kk.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    vv = vv.reshape(B, T, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, w["q_norm"], cfg.rms_norm_eps)
        kk = rms_norm(kk, w["k_norm"], cfg.rms_norm_eps)
    return apply_rope(q, cos, sin), apply_rope(kk, cos, sin), vv


def _layer_out(cfg: ModelConfig, w, h, o):
    """Output projection of the attention result `o` and the MLP, both residual."""
    B, T, _ = h.shape
    h = h + o.reshape(B, T, cfg.q_size) @ w["wo"]
    hn = rms_norm(h, w["ln2"], cfg.rms_norm_eps)
    g = hn @ w["w_gate"]
    u = hn @ w["w_up"]
    return h + (F.silu(g.to(acc_dtype(cfg.dtype))).to(u.dtype) * u) @ w["w_down"]


def forward_spec(
    params: Dict[str, Any],
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # [B, T] speculative token block (RA/candidates/pseudos)
    positions: torch.Tensor,  # [B, T] semantic position of each token
    kv_cache: KVCache,
    block_tables: torch.Tensor,  # [B, max_pages]
    cache_lens: torch.Tensor,  # [B] committed KV length
    intra_mask: torch.Tensor,  # [B, T, T] bool: visibility within the block
    rope: Tuple[torch.Tensor, torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative forward: reads the committed paged KV, writes NOTHING.

    Returns (hidden [B, T, H], k_new [layers, B, T, KH, D], v_new [...]), so
    the caller can scatter only the verified winner's K/V into the cache.
    """
    if kv_cache.k.dtype != cfg.dtype:
        # the JAX version fake-quantizes the in-flight block for a scaled
        # (fp8/int8) cache; narrow KV storage is not ported yet
        raise NotImplementedError(f"a KV cache stored as {kv_cache.k.dtype} under a "
                                  f"{cfg.dtype} model is not supported by the PyTorch port yet")
    block_tables = block_tables.to(torch.int32).contiguous()
    cache_lens = cache_lens.to(torch.int32).contiguous()
    intra_mask = intra_mask.contiguous()
    pos_l = positions.long().clamp(max=cfg.max_position - 1)

    h = params["embed"][input_ids.long()].to(cfg.dtype)
    cos_t, sin_t = rope
    cos, sin = cos_t[pos_l], sin_t[pos_l]
    lp = params["layers"]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    k_new, v_new = [], []
    for i in range(cfg.num_layers):
        w = {name: t[i] for name, t in lp.items()}
        q, kk, vv = _layer_qkv(cfg, w, h, cos, sin)
        o = paged_attention_with_block(
            q, kv_cache.k[i], kv_cache.v[i], block_tables, cache_lens, kk, vv, intra_mask,
            scale, page_size=kv_cache.page_size,
        )
        h = _layer_out(cfg, w, h, o)
        k_new.append(kk)
        v_new.append(vv)
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    return h, torch.stack(k_new), torch.stack(v_new)


def forward_dense(
    params: Dict[str, Any],
    cfg: ModelConfig,
    input_ids: torch.Tensor,  # [B, T]
    positions: torch.Tensor,  # [B, T] (shared RoPE positions for k_j/last_j packing)
    rope: Tuple[torch.Tensor, torch.Tensor],
    attn_mask: Optional[torch.Tensor] = None,  # [B|1, T, T] bool, True = visible
    splash_spec: Optional[tuple] = None,  # static layout -> block-sparse kernels
    remat: bool = False,  # recompute each layer's activations in the backward
) -> torch.Tensor:
    """Training-path forward: no KV cache, differentiable.  Returns [B, T, H].

    `attn_mask` is the packed-trajectory mask of the consistency trainer; None
    means plain causal.  With `splash_spec` = (prompt_len, T_pairs, seq_len, N,
    variant, window_size) the mask is instead realised inside
    `ops/train_attention.train_attention` (B must be 1): the hand-written
    kernels on CUDA tensors, never an [T, T] mask.  A per-layer weight may be a
    stacked tensor or a list of per-layer tensors.
    """
    B, T = input_ids.shape
    pos_l = positions.long()
    x = params["embed"][input_ids.long()].to(cfg.dtype)
    cos_t, sin_t = rope
    cos, sin = cos_t[pos_l], sin_t[pos_l]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    if splash_spec is not None:
        if B != 1:
            raise ValueError("the block-sparse training attention packs one sequence per step")
        p_len, t_pairs, seq_len, n_blk, variant, window = splash_spec
    elif attn_mask is None:
        idx = torch.arange(T, device=x.device)
        attn_mask = (idx[:, None] >= idx[None, :])[None]  # [1, T, T] causal

    def layer(h, w):
        q, kk, vv = _layer_qkv(cfg, w, h, cos, sin)
        if splash_spec is not None:
            o = train_attention(q[0], kk[0], vv[0], prompt_len=p_len, T_pairs=t_pairs,
                                seq_len=seq_len, N=n_blk, variant=variant,
                                window_size=window)[None]
        else:
            o = masked_attention(q, kk, vv, attn_mask, scale)
        return _layer_out(cfg, w, h, o)

    lp = params["layers"]
    h = x
    for i in range(cfg.num_layers):
        w = {name: t[i] for name, t in lp.items()}
        h = checkpoint(layer, h, w, use_reentrant=False) if remat else layer(h, w)
    return rms_norm(h, params["final_norm"], cfg.rms_norm_eps)


def _head(params: Dict[str, Any], cfg: ModelConfig) -> torch.Tensor:
    """The LM head as [H, V] (a transposed view when tied)."""
    if cfg.tie_word_embeddings:
        return params["embed"].T
    return params["lm_head"]


def logits_at(params: Dict[str, Any], cfg: ModelConfig, hidden: torch.Tensor) -> torch.Tensor:
    """LM head over an (already gathered) hidden slice; float32+ logits."""
    return _mm_acc(hidden, _head(params, cfg).to(cfg.dtype), acc_dtype(cfg.dtype))


def greedy_tokens(
    params: Dict[str, Any], cfg: ModelConfig, hidden: torch.Tensor, *, vocab_chunk: int = 32768
) -> torch.Tensor:
    """argmax(lm_head(hidden)) over vocab CHUNKS, never materialising the full
    [..., V] logits.  Same rules as the JAX version: the last chunk is clamped
    to overlap the previous one, argmax takes the first maximum inside a
    chunk, and a later chunk wins only with a strictly greater maximum."""
    w = _head(params, cfg)
    V = cfg.vocab_size
    if V <= vocab_chunk:
        return torch.argmax(logits_at(params, cfg, hidden), dim=-1).to(torch.int32)
    acc = acc_dtype(cfg.dtype)
    n_chunks = (V + vocab_chunk - 1) // vocab_chunk
    best = torch.full(hidden.shape[:-1], float("-inf"), dtype=acc, device=hidden.device)
    best_idx = torch.zeros(hidden.shape[:-1], dtype=torch.int32, device=hidden.device)
    for c in range(n_chunks):
        start = min(c * vocab_chunk, V - vocab_chunk)
        logits = _mm_acc(hidden, w[:, start : start + vocab_chunk].to(cfg.dtype), acc)
        cmax = torch.amax(logits, dim=-1)
        carg = torch.argmax(logits, dim=-1)  # first maximum, as jnp.argmax
        take = cmax > best
        best = torch.where(take, cmax, best)
        best_idx = torch.where(take, (carg + start).to(torch.int32), best_idx)
    return best_idx
