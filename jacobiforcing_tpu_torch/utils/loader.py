"""Checkpoint loading: HF safetensors -> layer-stacked parameter dict.

Port of `jacobiforcing_tpu/utils/loader.py` with the same HF name map: per
layer weights stacked on a leading axis, linear weights transposed to
[in, out].  The safetensors files are read directly (an 8-byte header length,
a JSON header, raw little-endian data), so loading needs numpy and nothing
else.

`params_from_numpy` carries the JAX package's parameter pytree (as numpy
arrays) over to the port, so a test can give both packages the same weights.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from jacobiforcing_tpu_torch.models.qwen import ModelConfig
from jacobiforcing_tpu_torch.utils.device import resolve_device

_ST_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": np.uint16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of one .safetensors file, as CPU tensors."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out: Dict[str, torch.Tensor] = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        lo, hi = meta["data_offsets"]
        dt = np.dtype(_ST_DTYPES[meta["dtype"]]).newbyteorder("<")
        arr = np.frombuffer(data, dtype=dt, count=(hi - lo) // dt.itemsize, offset=lo)
        t = torch.from_numpy(arr.astype(dt.newbyteorder("="))).reshape(meta["shape"])
        if meta["dtype"] == "BF16":
            t = t.view(torch.bfloat16)
        out[name] = t
    return out


def load_checkpoint(
    path: str, dtype=torch.bfloat16, device="cuda"
) -> Tuple[ModelConfig, Dict[str, Any]]:
    """Load config.json + *.safetensors from an HF checkpoint dir onto `device`."""
    dev = resolve_device(device)
    with open(os.path.join(path, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = ModelConfig.from_hf_config(hf_cfg)
    cfg = ModelConfig(**{**cfg.__dict__, "dtype": dtype})
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors in {path}")
    tensors: Dict[str, torch.Tensor] = {}
    for fname in files:
        tensors.update(read_safetensors(os.path.join(path, fname)))
    return cfg, assemble_params(cfg, tensors, dtype, dev)


def assemble_params(
    cfg: ModelConfig, tensors: Dict[str, torch.Tensor], dtype, device
) -> Dict[str, Any]:
    """Map HF Qwen2/Qwen3 tensor names into the stacked parameter dict."""

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device, dtype=dtype).contiguous()

    def get(name: str) -> torch.Tensor:
        return tensors[name]

    def lin(name: str) -> torch.Tensor:  # HF [out, in] -> [in, out]
        return tensors[name].T

    pre = "model.layers.{}."

    def stack(f) -> torch.Tensor:
        return put(torch.stack([f(pre.format(i)) for i in range(cfg.num_layers)]))

    layers: Dict[str, Any] = {
        "ln1": stack(lambda p: get(p + "input_layernorm.weight")),
        "ln2": stack(lambda p: get(p + "post_attention_layernorm.weight")),
        "wq": stack(lambda p: lin(p + "self_attn.q_proj.weight")),
        "wk": stack(lambda p: lin(p + "self_attn.k_proj.weight")),
        "wv": stack(lambda p: lin(p + "self_attn.v_proj.weight")),
        "wo": stack(lambda p: lin(p + "self_attn.o_proj.weight")),
        "w_gate": stack(lambda p: lin(p + "mlp.gate_proj.weight")),
        "w_up": stack(lambda p: lin(p + "mlp.up_proj.weight")),
        "w_down": stack(lambda p: lin(p + "mlp.down_proj.weight")),
    }
    if cfg.qkv_bias:
        layers["bq"] = stack(lambda p: get(p + "self_attn.q_proj.bias"))
        layers["bk"] = stack(lambda p: get(p + "self_attn.k_proj.bias"))
        layers["bv"] = stack(lambda p: get(p + "self_attn.v_proj.bias"))
    if cfg.qk_norm:
        layers["q_norm"] = stack(lambda p: get(p + "self_attn.q_norm.weight"))
        layers["k_norm"] = stack(lambda p: get(p + "self_attn.k_norm.weight"))

    params: Dict[str, Any] = {
        "embed": put(get("model.embed_tokens.weight")),
        "layers": layers,
        "final_norm": put(get("model.norm.weight")),
    }
    if not cfg.tie_word_embeddings:
        if "lm_head.weight" in tensors:
            params["lm_head"] = put(lin("lm_head.weight"))
        else:
            params["lm_head"] = put(get("model.embed_tokens.weight").T)
    return params


def params_from_numpy(jax_params: Dict[str, Any], dtype=None, device="cpu") -> Dict[str, Any]:
    """The JAX package's parameter pytree (numpy arrays, or anything
    `np.asarray` takes) as the port's parameter dict, same layout.

    `dtype=None` keeps each array's dtype (bfloat16 arrays stay bfloat16).
    """
    dev = resolve_device(device)

    def conv(x) -> torch.Tensor:
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":  # numpy has no bfloat16: go via float32
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))  # a writable copy
        return t.to(device=dev, dtype=dtype or t.dtype)

    return {
        k: {kk: conv(vv) for kk, vv in v.items()} if isinstance(v, dict) else conv(v)
        for k, v in jax_params.items()
    }
