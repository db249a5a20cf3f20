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

Quantized serving: a linear weight may be the int8 dict of `ops/quant.py`
(weight-only, or W8A8 with `ModelConfig.act_quant`), and the KV cache may be
stored as fp8 e4m3 / int8 with per-row scales (`ops/kv_cache.py`); `forward`
then quantizes what it writes and `forward_spec` fake-quantizes the in-flight
block, so every decoder sees the same stored values.

Tensor parallelism: `forward`, `forward_spec`, `forward_dense` and the heads
take the model group (`group`, a `torch.distributed` ProcessGroup, None for
one rank) and this rank's share of the parameters (`parallel/sharding`):
column-parallel q/k/v, gate and up projections (local heads are read from
the weights' widths), row-parallel o and down projections whose partial
products are all-reduced before each residual add, and a vocab-parallel
embedding and head.  The residual stream and the norms stay replicated, so
every rank holds the same hidden states.  The head never gathers [..., V]
logits where a reduction will do: `greedy_tokens` reduces each rank's
(max, first arg-max) and `chunked_token_logprob` each rank's online (max,
sum) in O(rows) bytes; `logits_at` gathers the logits in vocab order for
the callers that need the whole distribution.

Sums are accumulated in float32, or float64 for a float64 model, exactly as
`acc_dtype` does there.  Qwen2-style (QKV bias) and Qwen3-style (per-head
q/k RMSNorm) checkpoints are both supported through `ModelConfig` flags.

The decoder layer's pointwise chains (the residual add folded into the next
RMSNorm, the q/k/v bias / q/k norm and RoPE, SiLU times up) run as one-pass
CUDA kernels (`ops/decoder_pointwise_cuda`, csrc/decoder_pointwise.cu) on
bfloat16 tensors on the card outside autograd (`_fuse`), and raise on an
input they do not take (as kernel 1 does).  Everything else (the CPU,
float32 / float64 models, training under autograd) runs the plain
functions, which are the reference.
For the fold, `forward` and `forward_spec` carry each layer's MLP output to
the next layer's first norm (or the final norm) instead of adding it at the
end of the layer: the same additions in the same order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from jacobiforcing_tpu_torch.ops import decoder_pointwise_cuda as dpc
from jacobiforcing_tpu_torch.ops.attention import paged_attention, paged_attention_with_block
from jacobiforcing_tpu_torch.ops.train_attention import masked_attention, train_attention
from jacobiforcing_tpu_torch.ops.kv_cache import (
    KVCache,
    dequantize_rows,
    quantize_rows,
    write_kv,
    write_kv_scaled,
    write_plan,
)
from jacobiforcing_tpu_torch.ops.quant import act_quantize, int8_matmul, mm
from jacobiforcing_tpu_torch.parallel.collectives import (
    Group,
    copy_in,
    gather_last,
    gather_stack,
    group_rank,
    reduce_sum,
)
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
    # W8A8 serving: per-token activation quantization and int8 x int8 products
    # (`ops/quant.mm` with a8=True); the engine sets it for quantization="w8a8".
    act_quant: bool = False
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


def _layer_weights(lp: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i's weights: a stacked tensor (or a list of per-layer tensors) is
    indexed, a quantized leaf {"q", "s"} is indexed leaf by leaf."""
    return {name: {k: v[i] for k, v in t.items()} if isinstance(t, dict) else t[i]
            for name, t in lp.items()}


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


def _fuse(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether a pointwise chain over these tensors takes its fused kernel:
    bfloat16 on the card, outside autograd."""
    x = tensors[0]
    return (x.is_cuda and x.dtype == torch.bfloat16
            and not (torch.is_grad_enabled()
                     and any(t is not None and t.requires_grad for t in tensors)))


def add_rms_norm(h: torch.Tensor, delta: Optional[torch.Tensor], w: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(h + delta, rms_norm(h + delta, w, eps)): a residual add and the norm
    that reads its sum; without `delta`, (h, rms_norm(h, w, eps))."""
    if _fuse(h, delta, w):
        return dpc.add_rms_norm_cuda(h, w, eps, delta)
    if delta is not None:
        h = h + delta
    return h, rms_norm(h, w, eps)


def silu_mul(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The MLP's SiLU(gate) * up, the SiLU taken in the accumulation dtype."""
    if _fuse(g, u):
        return dpc.silu_mul_cuda(g, u)
    return F.silu(g.to(acc_dtype(g.dtype))).to(u.dtype) * u


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


def embed(params: Dict[str, Any], cfg: ModelConfig, input_ids: torch.Tensor,
          group: Group = None) -> torch.Tensor:
    """Token embeddings [..., H].  Vocab-parallel under a model group: each
    rank looks up the ids in its own rows, writes zeros for the others, and
    the ranks' rows are summed."""
    table = params["embed"]
    ids = input_ids.long()
    if group is None:
        return table[ids].to(cfg.dtype)
    rows = table.shape[0]
    local = ids - group_rank(group) * rows
    mine = (local >= 0) & (local < rows)
    x = torch.where(mine[..., None], table[local.clamp(0, rows - 1)], 0).to(cfg.dtype)
    return reduce_sum(x, group)


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
    group: Group = None,  # the model group (tensor parallelism)
) -> Tuple[torch.Tensor, KVCache]:
    """One forward over T tokens per sequence against the paged cache.

    Serves prefill (positions 0..P-1), AR decode (T=1, position S-1) and
    Jacobi blocks (T=L, positions S-1..S+L-2).  Returns (hidden [B, T, H],
    kv_cache); the cache tensors are written in place.  Under a model group
    the cache holds this rank's KV heads.
    """
    B, T = input_ids.shape
    page = kv_cache.page_size
    num_slots = kv_cache.num_slots
    block_tables = block_tables.to(torch.int32).contiguous()
    cache_lens = cache_lens.to(torch.int32).contiguous()
    positions = positions.to(torch.int32).contiguous()
    pos_l = positions.long()

    x = embed(params, cfg, input_ids, group)  # [B, T, H]
    cos_t, sin_t = rope
    cos, sin = cos_t[pos_l], sin_t[pos_l]  # [B, T, half] float32

    # Slot mapping: absolute position -> flat cache slot via the block table.
    P = block_tables.shape[1]
    page_idx = torch.gather(block_tables, 1, (pos_l // page).clamp(0, P - 1)).long()
    slots = page_idx * page + pos_l % page
    if write_mask is not None:
        slots = torch.where(write_mask, slots, num_slots)
    slots = torch.where(page_idx < 0, num_slots, slots)
    plan = write_plan(slots, num_slots, kv_cache.k.shape[1])  # one plan for every layer

    lp = params["layers"]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    scaled = kv_cache.scaled  # narrow KV with per-row dequant scales
    h, mlp = x, None  # the residual stream and the MLP output not yet added to it
    for i in range(cfg.num_layers):
        w = _layer_weights(lp, i)
        h, q, kk, vv = _layer_qkv(cfg, w, h, mlp, cos, sin, group)
        k_l, v_l = kv_cache.k[i], kv_cache.v[i]
        ks_l = vs_l = None
        if scaled:
            ks_l, vs_l = kv_cache.k_scale[i], kv_cache.v_scale[i]
            write_kv_scaled(k_l, v_l, ks_l, vs_l, kk, vv, slots, plan)
        else:
            write_kv(k_l, v_l, kk, vv, slots, plan)
        o = paged_attention(
            q, k_l, v_l, block_tables, cache_lens, positions, scale, page_size=page,
            k_scale_l=ks_l, v_scale_l=vs_l,
        )  # [B, T, NH, D]
        h, mlp = _layer_out(cfg, w, h, o, group)
    return add_rms_norm(h, mlp, params["final_norm"], cfg.rms_norm_eps)[1], kv_cache


def _layer_qkv(cfg: ModelConfig, w, h, mlp, cos, sin, group: Group = None):
    """The previous layer's MLP output `mlp` added to the residual stream `h`
    (None: nothing to add), then pre-norm, QKV projection (+bias / qk-norm)
    and RoPE of one layer: (h, q [B,T,NH,D], k [B,T,KH,D], v [B,T,KH,D]),
    with this rank's heads under a model group (column-parallel: NH and KH
    are read off the weights' widths)."""
    a8 = cfg.act_quant
    h, hn = add_rms_norm(h, mlp, w["ln1"], cfg.rms_norm_eps)
    hn = copy_in(hn, group)
    q = mm(hn, w["wq"], a8)
    kk = mm(hn, w["wk"], a8)
    vv = mm(hn, w["wv"], a8)
    return (h, *_bias_norm_rope(cfg, w, q, kk, vv, cos, sin))


def _bias_norm_rope(cfg: ModelConfig, w, q, kk, vv, cos, sin):
    """The q/k/v bias (Qwen2), the per-head q/k RMSNorm (Qwen3) and RoPE on
    the projections [B, T, heads * D]; returns them as [B, T, heads, D]."""
    B, T, _ = q.shape
    heads = [t.reshape(B, T, -1, cfg.head_dim) for t in (q, kk, vv)]
    bias = [w["bq"], w["bk"], w["bv"]] if cfg.qkv_bias else [None] * 3
    norm = [w["q_norm"], w["k_norm"]] if cfg.qk_norm else [None] * 2
    if _fuse(q, kk, vv, *bias, *norm):
        return dpc.qkv_rope_cuda(*heads, cos, sin, cfg.rms_norm_eps, bq=bias[0], bk=bias[1],
                                 bv=bias[2], q_norm=norm[0], k_norm=norm[1])
    if cfg.qkv_bias:
        q = q + w["bq"]
        kk = kk + w["bk"]
        vv = vv + w["bv"]
    q = q.reshape(B, T, -1, cfg.head_dim)
    kk = kk.reshape(B, T, -1, cfg.head_dim)
    vv = vv.reshape(B, T, -1, cfg.head_dim)
    if cfg.qk_norm:
        q = rms_norm(q, w["q_norm"], cfg.rms_norm_eps)
        kk = rms_norm(kk, w["k_norm"], cfg.rms_norm_eps)
    return apply_rope(q, cos, sin), apply_rope(kk, cos, sin), vv


def _layer_out(cfg: ModelConfig, w, h, o, group: Group = None):
    """Output projection of the attention result `o`, added to the residual
    stream, and the MLP: (h + o's projection, the MLP's output), the second
    for the caller to add.  Under a model group `wo` and `w_down` are
    row-parallel: `mm` sums the ranks' partial products."""
    B, T, _ = h.shape
    a8 = cfg.act_quant
    h, hn = add_rms_norm(h, mm(o.reshape(B, T, -1), w["wo"], a8, group), w["ln2"],
                         cfg.rms_norm_eps)
    hn = copy_in(hn, group)
    g = mm(hn, w["w_gate"], a8)
    u = mm(hn, w["w_up"], a8)
    return h, mm(silu_mul(g, u), w["w_down"], a8, group)


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
    *,
    group: Group = None,  # the model group (tensor parallelism)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Speculative forward: reads the committed paged KV, writes NOTHING.

    Returns (hidden [B, T, H], k_new [layers, B, T, KH, D], v_new [...]), so
    the caller can scatter only the verified winner's K/V into the cache
    (KH = this rank's KV heads under a model group).
    """
    block_tables = block_tables.to(torch.int32).contiguous()
    cache_lens = cache_lens.to(torch.int32).contiguous()
    intra_mask = intra_mask.contiguous()
    pos_l = positions.long().clamp(max=cfg.max_position - 1)

    h = embed(params, cfg, input_ids, group)
    cos_t, sin_t = rope
    cos, sin = cos_t[pos_l], sin_t[pos_l]
    lp = params["layers"]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    scaled = kv_cache.scaled
    k_new, v_new = [], []
    mlp = None
    for i in range(cfg.num_layers):
        w = _layer_weights(lp, i)
        h, q, kk, vv = _layer_qkv(cfg, w, h, mlp, cos, sin, group)
        kk_attn, vv_attn, ks_l, vs_l = kk, vv, None, None
        if scaled:
            # fake-quantize the in-flight block so that speculative
            # verification sees EXACTLY the values a commit would store and a
            # later read would return: MR stays bit-identical to AR / Jacobi
            ks_l, vs_l = kv_cache.k_scale[i], kv_cache.v_scale[i]
            kk_attn = dequantize_rows(*quantize_rows(kk, kv_cache.k.dtype), kk.dtype)
            vv_attn = dequantize_rows(*quantize_rows(vv, kv_cache.v.dtype), vv.dtype)
        o = paged_attention_with_block(
            q, kv_cache.k[i], kv_cache.v[i], block_tables, cache_lens, kk_attn, vv_attn,
            intra_mask, scale, page_size=kv_cache.page_size, k_scale_l=ks_l, v_scale_l=vs_l,
        )
        h, mlp = _layer_out(cfg, w, h, o, group)
        k_new.append(kk)
        v_new.append(vv)
    h = add_rms_norm(h, mlp, params["final_norm"], cfg.rms_norm_eps)[1]
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
    group: Group = None,  # the model group (tensor parallelism)
    gather: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None,  # fsdp
) -> torch.Tensor:
    """Training-path forward: no KV cache, differentiable.  Returns [B, T, H].

    `attn_mask` is the packed-trajectory mask of the consistency trainer; None
    means plain causal.  With `splash_spec` = (prompt_len, T_pairs, seq_len, N,
    variant, window_size) the mask is instead realised inside
    `ops/train_attention.train_attention` (B must be 1): the hand-written
    kernels on CUDA tensors, never an [T, T] mask.  A per-layer weight may be a
    stacked tensor or a list of per-layer tensors.  Under a model group the
    collectives carry gradients as Megatron's layers do
    (`parallel/collectives.reduce_sum` / `copy_in`).

    `gather(name, block)` (fsdp, `parallel/sharding.fsdp_gather`) turns a
    rank's block of the embedding and of each layer's weights into the whole
    weight where it is used: inside the layer, so under `remat` a layer's
    weights are gathered again in the recompute and only one layer's are
    held at a time.
    """
    B, T = input_ids.shape
    pos_l = positions.long()
    if gather is None:
        x = embed(params, cfg, input_ids, group)
    else:
        x = embed({"embed": gather("embed", params["embed"])}, cfg, input_ids, group)
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
        if gather is not None:
            w = {name: gather(name, t) for name, t in w.items()}
        h, q, kk, vv = _layer_qkv(cfg, w, h, None, cos, sin, group)
        if splash_spec is not None:
            o = train_attention(q[0], kk[0], vv[0], prompt_len=p_len, T_pairs=t_pairs,
                                seq_len=seq_len, N=n_blk, variant=variant,
                                window_size=window)[None]
        else:
            o = masked_attention(q, kk, vv, attn_mask, scale)
        h, mlp = _layer_out(cfg, w, h, o, group)
        return h + mlp

    lp = params["layers"]
    h = x
    for i in range(cfg.num_layers):
        w = _layer_weights(lp, i)
        h = checkpoint(layer, h, w, use_reentrant=False) if remat else layer(h, w)
    return rms_norm(h, params["final_norm"], cfg.rms_norm_eps)


def _head(params: Dict[str, Any], cfg: ModelConfig):
    """The LM head as [H, V] (a transposed view when tied), or its int8 dict;
    this rank's vocab columns under a model group."""
    if cfg.tie_word_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _head_width(w) -> int:
    return (w["q"] if isinstance(w, dict) else w).shape[-1]


def _head_logits(cfg: ModelConfig, wq, ws, hidden, hq, acc) -> torch.Tensor:
    """Logits for one (possibly full) vocab slice of an int8 lm_head.
    `hq` = (xq, sx) from `act_quantize` when cfg.act_quant, else None."""
    if hq is not None:
        xq, sx = hq
        return int8_matmul(xq, wq).to(acc) * sx.to(acc) * ws.to(acc)[..., 0, :]
    return _mm_acc(hidden, wq.to(cfg.dtype), acc) * ws.to(acc)[..., 0, :]


def _cols_logits(cfg: ModelConfig, w, hidden, hq, acc, cols=slice(None)) -> torch.Tensor:
    """Logits of the head's columns `cols` (plain or int8 head)."""
    if isinstance(w, dict):
        return _head_logits(cfg, w["q"][:, cols], w["s"][:, cols], hidden, hq, acc)
    return _mm_acc(hidden, w[:, cols].to(cfg.dtype), acc)


def _act_q(w, cfg: ModelConfig, hidden):
    """The head input's int8 activations under W8A8 (the head's input is
    replicated, so no reduction over the model group)."""
    return act_quantize(hidden) if (isinstance(w, dict) and cfg.act_quant) else None


def _chunks(V: int, vocab_chunk: int):
    """(chunk index, first column, columns) of the head's vocab chunks; the
    last chunk is clamped to overlap the one before."""
    for c in range((V + vocab_chunk - 1) // vocab_chunk):
        start = min(c * vocab_chunk, V - vocab_chunk)
        yield c, start, slice(start, start + vocab_chunk)


def logits_at(params: Dict[str, Any], cfg: ModelConfig, hidden: torch.Tensor,
              group: Group = None) -> torch.Tensor:
    """LM head over an (already gathered) hidden slice; float32+ logits.
    Under a model group the ranks' vocab slices are gathered in vocab order,
    so every rank returns the same [..., V]; under autograd the head's input
    gradient is summed over the group (`copy_in`: each rank's columns
    contribute their part)."""
    w = _head(params, cfg)
    acc = acc_dtype(cfg.dtype)
    hidden = copy_in(hidden, group)
    return gather_last(_cols_logits(cfg, w, hidden, _act_q(w, cfg, hidden), acc), group)


def greedy_tokens(
    params: Dict[str, Any], cfg: ModelConfig, hidden: torch.Tensor, *, vocab_chunk: int = 32768,
    group: Group = None,
) -> torch.Tensor:
    """argmax(lm_head(hidden)) over vocab CHUNKS, never materialising the full
    [..., V] logits.  Same rules as the JAX version: the last chunk is clamped
    to overlap the previous one, argmax takes the first maximum inside a
    chunk, and a later chunk wins only with a strictly greater maximum.

    Under a model group each rank takes the (max, first arg-max) of its own
    columns, and the ranks' pairs are reduced to the largest value, then the
    smallest global index: a logit does not depend on how the columns are
    split, so this is the first maximum over the whole vocab, as above."""
    w = _head(params, cfg)
    V = _head_width(w)
    acc = acc_dtype(cfg.dtype)
    hq = _act_q(w, cfg, hidden)
    if V <= vocab_chunk:
        logits = _cols_logits(cfg, w, hidden, hq, acc)
        best_idx = torch.argmax(logits, dim=-1).to(torch.int32)
        if group is None:
            return best_idx
        best = torch.amax(logits, dim=-1)
    else:
        best = torch.full(hidden.shape[:-1], float("-inf"), dtype=acc, device=hidden.device)
        best_idx = torch.zeros(hidden.shape[:-1], dtype=torch.int32, device=hidden.device)
        for _, start, cols in _chunks(V, vocab_chunk):
            logits = _cols_logits(cfg, w, hidden, hq, acc, cols)
            cmax = torch.amax(logits, dim=-1)
            carg = torch.argmax(logits, dim=-1)  # first maximum, as jnp.argmax
            take = cmax > best
            best = torch.where(take, cmax, best)
            best_idx = torch.where(take, (carg + start).to(torch.int32), best_idx)
        if group is None:
            return best_idx
    # [ranks, 2, ...]: each rank's maximum and its global index (exact in acc)
    parts = gather_stack(torch.stack([best, (best_idx + group_rank(group) * V).to(acc)]), group)
    vals, idxs = parts[:, 0], parts[:, 1]
    first = torch.where(vals == vals.amax(0), idxs, float("inf")).amin(0)
    return first.to(torch.int32)


def chunked_token_logprob(
    params: Dict[str, Any],
    cfg: ModelConfig,
    hidden: torch.Tensor,  # [..., H]
    tokens: torch.Tensor,  # [...] token whose log-prob is needed
    temperature: torch.Tensor,  # [...] > 0 (broadcast)
    *,
    vocab_chunk: int = 32768,
    group: Group = None,
) -> torch.Tensor:
    """log p(token | hidden) at `temperature` without materialising the full
    [..., V] logits: an online logsumexp over vocab chunks plus the token's
    logit (the rejection-sampling verify needs only p(drafted token)).  The
    last chunk is clamped to overlap the one before; its overlap columns and
    columns past V are -inf there, and a token's logit is taken from the
    chunk that owns it before clamping.  Sums are in `acc_dtype`.

    Under a model group each rank keeps the online (max, sum) of its own
    columns, and the token's logit comes from the rank that owns it; the
    ranks' triples are merged (O(rows) bytes)."""
    w = _head(params, cfg)
    V = _head_width(w)
    acc = acc_dtype(cfg.dtype)
    t = temperature.to(acc).clamp(min=1e-6)
    tok = tokens.long() - group_rank(group) * V  # this rank's column of the token
    hq = _act_q(w, cfg, hidden)
    if V <= vocab_chunk:
        logits = _cols_logits(cfg, w, hidden, hq, acc) / t[..., None]
        if group is None:
            lx = torch.gather(logits, -1, tok[..., None])[..., 0]
            return lx - torch.logsumexp(logits, dim=-1)
        m = logits.amax(dim=-1)
        s = torch.exp(logits - m[..., None]).sum(-1)
        val = torch.gather(logits, -1, tok.clamp(0, V - 1)[..., None])[..., 0]
        lx = torch.where((tok >= 0) & (tok < V), val, float("-inf"))
    else:
        shape, dev = hidden.shape[:-1], hidden.device
        m = torch.full(shape, float("-inf"), dtype=acc, device=dev)
        s = torch.zeros(shape, dtype=acc, device=dev)
        lx = torch.full(shape, float("-inf"), dtype=acc, device=dev)
        col0 = torch.arange(vocab_chunk, device=dev)
        for c, start, cols in _chunks(V, vocab_chunk):
            logits = _cols_logits(cfg, w, hidden, hq, acc, cols) / t[..., None]
            col = start + col0
            logits = logits.masked_fill(~((col >= c * vocab_chunk) & (col < V)), float("-inf"))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[..., None]).sum(-1)
            m = m_new
            owned = (tok >= c * vocab_chunk) & (tok < (c + 1) * vocab_chunk) & (tok < V)
            col_of_tok = (tok - start).clamp(0, vocab_chunk - 1)
            val = torch.gather(logits, -1, col_of_tok[..., None])[..., 0]
            lx = torch.where(owned, val, lx)
    if group is not None:
        parts = gather_stack(torch.stack([m, s, lx]), group)  # [ranks, 3, ...]
        m = parts[:, 0].amax(0)
        s = (parts[:, 1] * torch.exp(parts[:, 0] - m)).sum(0)
        lx = parts[:, 2].amax(0)
    return lx - (m + torch.log(s.clamp(min=1e-30)))
