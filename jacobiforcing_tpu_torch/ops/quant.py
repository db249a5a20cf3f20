"""Int8 quantization of the linear weights for serving.

PyTorch port of `jacobiforcing_tpu/ops/quant.py`.  A quantized weight is the
dict `{"q": int8 [..., in, out], "s": bfloat16 [..., 1, out]}`: symmetric,
one scale per output channel.  `mm(x, w)` serves plain and quantized weights:

  * weight-only (`a8=False`): `(x @ q.to(x.dtype)) * s`.  The product is a
    library GEMM on an `x.dtype` copy of the weight made for the call (the
    JAX package leaves the same product to XLA);
  * W8A8 (`a8=True`): the activations are quantized per token (symmetric,
    amax / 127), the product is int8 x int8 -> int32, and the epilogue applies
    (token scale) x (channel scale) in float32.  Integer sums do not depend on
    the order they are taken in, so a row's result is the same for any batch.
    On the card the product is `torch._int_mm` (it wants more than 16 rows:
    fewer are padded with zero rows; it takes a row-major weight but is
    several times faster on a column-major one, which `int_mm_layout` makes
    once when the engine starts); on the CPU it is taken in float64, which is
    exact for these magnitudes (127 * 127 * in < 2^53).

Greedy AR == Jacobi holds inside either mode because both run the same
quantized program.

Row-parallel layers (`group`, the model group of tensor parallelism) see
their input split along K.  Their partial products are summed over the
group before the scales are applied, as XLA sums the partial int32 dot
products of the JAX package's sharded W8A8 layers; and the per-token
activation scale comes from the amax over the whole hidden row, a maximum
over the group, as GSPMD computes it there.  A per-rank scale would give
other int8 activations and so another token stream.

One constant is written differently from the JAX source on purpose.  There
the activation scale is `amax / 127.0` inside jitted code, and XLA compiles a
division by a constant into a multiplication by its float32 reciprocal; the
port multiplies by that reciprocal (`INV_127`), so activations quantize to
the same bytes as in the JAX engine.  `quantize_tensor` runs outside `jit`
there and is a true division in both packages.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Union

import numpy as np
import torch

from jacobiforcing_tpu_torch.parallel.collectives import Group, reduce_max, reduce_sum
from jacobiforcing_tpu_torch.utils.device import resolve_device

QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_INT_MM_MIN_ROWS = 32  # torch._int_mm needs more than 16 rows
INV_127 = float(np.float32(1.0) / np.float32(127.0))  # what jitted `x / 127.0` multiplies by


def quantize_tensor(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Symmetric per-output-channel (last axis) int8 quantization.  `q` comes
    from the unrounded float32 scale; the scale is stored as bfloat16."""
    wf = w.to(torch.float32)
    scale = (wf.abs().amax(dim=-2, keepdim=True) / 127.0).clamp(min=1e-8)  # [..., 1, out]
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return {"q": q, "s": scale.to(torch.bfloat16)}


def quantize_params(params: Dict[str, Any], include_lm_head: bool = True) -> Dict[str, Any]:
    """Quantize the layer-stacked linear weights (+ lm_head); norms, biases and
    the embedding table stay in the model dtype."""
    out = dict(params)
    layers = dict(params["layers"])
    for k in QUANT_KEYS:
        if k in layers and not is_quantized(layers[k]):
            layers[k] = quantize_tensor(layers[k])
    out["layers"] = layers
    if include_lm_head and "lm_head" in params and not is_quantized(params["lm_head"]):
        out["lm_head"] = quantize_tensor(params["lm_head"])
    return out


def init_quantized_params(
    cfg, generator: Union[torch.Generator, int] = 0, device="cuda"
) -> Dict[str, Any]:
    """Random-init parameters DIRECTLY in int8 (large configs without a
    transient full-precision copy): uniform int8 in [-127, 127] with the
    scale (1 / sqrt(fan_in)) / 127.  `generator` is a torch.Generator on
    `device`, or an int seed for one."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    L, H, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    qs, kvs = cfg.q_size, cfg.kv_size
    dt = cfg.dtype

    def qrand(shape):
        q = torch.randint(-127, 128, shape, generator=generator, device=dev, dtype=torch.int8)
        s = torch.full(shape[:-2] + (1, shape[-1]), (1.0 / math.sqrt(shape[-2])) / 127.0,
                       dtype=torch.bfloat16, device=dev)
        return {"q": q, "s": s}

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    layers: Dict[str, Any] = {
        "ln1": ones(L, H),
        "ln2": ones(L, H),
        "wq": qrand((L, H, qs)),
        "wk": qrand((L, H, kvs)),
        "wv": qrand((L, H, kvs)),
        "wo": qrand((L, qs, H)),
        "w_gate": qrand((L, H, I)),
        "w_up": qrand((L, H, I)),
        "w_down": qrand((L, I, H)),
    }
    if cfg.qkv_bias:
        layers["bq"] = torch.zeros((L, qs), dtype=dt, device=dev)
        layers["bk"] = torch.zeros((L, kvs), dtype=dt, device=dev)
        layers["bv"] = torch.zeros((L, kvs), dtype=dt, device=dev)
    if cfg.qk_norm:
        layers["q_norm"] = ones(L, cfg.head_dim)
        layers["k_norm"] = ones(L, cfg.head_dim)
    embed = torch.randn((cfg.vocab_size, H), generator=generator, device=dev, dtype=torch.float32)
    params: Dict[str, Any] = {
        "embed": (embed * 0.02).to(dt),
        "layers": layers,
        "final_norm": ones(H),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = qrand((H, cfg.vocab_size))
    return params


def int_mm_layout(params: Dict[str, Any]) -> Dict[str, Any]:
    """The same parameters with every int8 `q` re-laid column-major: still
    indexed [..., in, out], but over a contiguous [..., out, in] buffer, the
    layout `torch._int_mm` is fastest on.  A layer slice `q[i]` and a block of
    output columns `q[:, a:b]` keep that layout.  One copy per weight, made
    once; values and shapes do not change."""

    def relay(w):
        if is_quantized(w):
            return {"q": w["q"].transpose(-1, -2).contiguous().transpose(-1, -2), "s": w["s"]}
        return w

    out = {k: relay(v) for k, v in params.items()}
    out["layers"] = {k: relay(v) for k, v in params["layers"].items()}
    return out


def act_quantize(x: torch.Tensor, group: Group = None):
    """Per-row symmetric int8 activation quantization: (int8 [..., K],
    float32 scale [..., 1]).  Under a model group `x` is this rank's slice of
    the row and the amax is taken over the whole row."""
    xf = x.to(torch.float32)
    amax = reduce_max(xf.abs().amax(dim=-1, keepdim=True), group)
    sx = (amax * INV_127).clamp(min=1e-8)
    return torch.round(xf / sx).to(torch.int8), sx


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq [..., K] int8 @ wq [K, N] int8, summed exactly; the result holds the
    int32 sums (as float64 on the CPU, where that product is exact too)."""
    if not xq.is_cuda:
        return xq.to(torch.float64) @ wq.to(torch.float64)
    x2 = xq.reshape(-1, xq.shape[-1])
    m = x2.shape[0]
    if m < _INT_MM_MIN_ROWS:
        x2 = torch.cat([x2, x2.new_zeros((_INT_MM_MIN_ROWS - m, x2.shape[1]))])
    y = torch._int_mm(x2.contiguous(), wq)[:m]
    return y.reshape(*xq.shape[:-1], wq.shape[-1])


def mm(x: torch.Tensor, w, a8: bool = False, group: Group = None) -> torch.Tensor:
    """x @ w for plain or quantized weights (see the module docstring); with
    `group`, a row-parallel layer's product summed over the model group."""
    if isinstance(w, dict):
        if a8:
            xq, sx = act_quantize(x, group)
            y = reduce_sum(int8_matmul(xq, w["q"]), group)
            return (y.to(torch.float32) * sx * w["s"].to(torch.float32)[..., 0, :]).to(x.dtype)
        return reduce_sum(x @ w["q"].to(x.dtype), group) * w["s"].to(x.dtype)[..., 0, :]
    return reduce_sum(x @ w, group)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w
