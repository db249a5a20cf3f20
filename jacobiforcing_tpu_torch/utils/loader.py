"""Checkpoint loading: HF safetensors -> layer-stacked parameter dict.

Port of `jacobiforcing_tpu/utils/loader.py` with the same HF name map: per
layer weights stacked on a leading axis, linear weights transposed to
[in, out].  The safetensors files are read directly (an 8-byte header length,
a JSON header, raw little-endian data), so loading needs numpy and nothing
else.

`save_checkpoint` writes the same HF layout back (config.json +
model.safetensors, float32 on disk) through the port's own writer, so a
trained model is served by either package's loader.

`params_from_numpy` carries the JAX package's parameter pytree (as numpy
arrays) over to the port, so a test can give both packages the same weights;
`params_to_numpy` carries parameters or gradients back.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from jacobiforcing_tpu_torch.models.qwen import ModelConfig
from jacobiforcing_tpu_torch.parallel.sharding import shard_params
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


def write_safetensors(path: str, shapes: Dict[str, Tuple[int, ...]], tensor_of) -> None:
    """Write float32 tensors as one .safetensors file.  `shapes` maps each
    name to its shape, `tensor_of(name)` yields it (any dtype or device) when
    its turn comes, so only one tensor at a time is held as float32."""
    header: Dict[str, Any] = {}
    offset = 0
    for name in sorted(shapes):
        n = 4 * int(np.prod(shapes[name], dtype=np.int64))
        header[name] = {"dtype": "F32", "shape": list(shapes[name]),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)  # the data starts on an 8-byte boundary
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in sorted(shapes):
            t = tensor_of(name).detach().to(device="cpu", dtype=torch.float32).contiguous()
            if tuple(t.shape) != tuple(shapes[name]):
                raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shapes[name])}")
            f.write(t.numpy().astype("<f4", copy=False).tobytes())


# (parameter key, HF name inside a layer, stored transposed)
_LAYER_NAMES = (
    ("ln1", "input_layernorm.weight", False),
    ("ln2", "post_attention_layernorm.weight", False),
    ("wq", "self_attn.q_proj.weight", True),
    ("wk", "self_attn.k_proj.weight", True),
    ("wv", "self_attn.v_proj.weight", True),
    ("wo", "self_attn.o_proj.weight", True),
    ("w_gate", "mlp.gate_proj.weight", True),
    ("w_up", "mlp.up_proj.weight", True),
    ("w_down", "mlp.down_proj.weight", True),
    ("bq", "self_attn.q_proj.bias", False),
    ("bk", "self_attn.k_proj.bias", False),
    ("bv", "self_attn.v_proj.bias", False),
    ("q_norm", "self_attn.q_norm.weight", False),
    ("k_norm", "self_attn.k_norm.weight", False),
)


def save_checkpoint(path: str, cfg: ModelConfig, params: Dict[str, Any]) -> None:
    """Write HF-layout config.json + model.safetensors (float32), the layout
    `load_checkpoint` reads: per-layer tensors unstacked, linear weights
    transposed back to [out, in]."""
    os.makedirs(path, exist_ok=True)
    hf_cfg = {
        "model_type": "qwen2" if cfg.qkv_bias else "qwen3",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "max_position_embeddings": cfg.max_position,
        "attention_bias": cfg.qkv_bias,
        "tie_word_embeddings": cfg.tie_word_embeddings,
    }
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f)

    lp = params["layers"]
    sources: Dict[str, Any] = {}  # HF name -> (tensor, transpose)
    for key, hf_name, transpose in _LAYER_NAMES:
        if key in lp:
            for i in range(cfg.num_layers):
                sources[f"model.layers.{i}.{hf_name}"] = (lp[key][i], transpose)
    sources["model.embed_tokens.weight"] = (params["embed"], False)
    sources["model.norm.weight"] = (params["final_norm"], False)
    if not cfg.tie_word_embeddings:
        sources["lm_head.weight"] = (params["lm_head"], True)

    def tensor_of(name):
        t, transpose = sources[name]
        return t.T if transpose else t

    shapes = {name: tuple(tensor_of(name).shape) for name in sources}
    write_safetensors(os.path.join(path, "model.safetensors"), shapes, tensor_of)


def load_checkpoint(
    path: str, dtype=torch.bfloat16, device="cuda", mesh=None, fsdp: bool = False
) -> Tuple[ModelConfig, Dict[str, Any]]:
    """Load config.json + *.safetensors from an HF checkpoint dir onto `device`.

    With a `mesh` (`parallel/mesh.py`) each tensor is cut to this rank's
    share (`parallel/sharding.shard_params`, fsdp blocks with `fsdp=True`) on
    the host and only the share moves to `device`: the card never holds the
    full model."""
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
    if mesh is None:
        return cfg, assemble_params(cfg, tensors, dtype, dev)
    host = assemble_params(cfg, tensors, dtype, torch.device("cpu"))
    return cfg, move_params(shard_params(host, cfg, mesh, fsdp=fsdp), dev)


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


def _map_params(tree, leaf, quantized_leaf):
    """Map a parameter pytree of any depth: `quantized_leaf` takes a quantized
    weight (the dict {"q", "s"} of `ops/quant.py`), `leaf` any other array."""
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"}:
            return quantized_leaf(tree)
        return {k: _map_params(v, leaf, quantized_leaf) for k, v in tree.items()}
    return leaf(tree)


def move_params(params: Dict[str, Any], device) -> Dict[str, Any]:
    """The same parameters on `device` (quantized leaves keep their dtypes)."""
    return _map_params(params, lambda t: t.to(device),
                       lambda w: {"q": w["q"].to(device), "s": w["s"].to(device)})


def params_from_numpy(jax_params: Dict[str, Any], dtype=None, device="cpu") -> Dict[str, Any]:
    """The JAX package's parameter pytree (numpy arrays, or anything
    `np.asarray` takes) as the port's parameter dict, same layout.

    `dtype=None` keeps each array's dtype (bfloat16 arrays stay bfloat16).  A
    quantized weight {"q", "s"} keeps int8 `q` and bfloat16 `s` whatever
    `dtype` says.
    """
    dev = resolve_device(device)

    def conv(x, dtype=dtype) -> torch.Tensor:
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":  # numpy has no bfloat16: go via float32
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))  # a writable copy
        return t.to(device=dev, dtype=dtype or t.dtype)

    return _map_params(
        jax_params, conv,
        lambda w: {"q": conv(w["q"], torch.int8), "s": conv(w["s"], torch.bfloat16)})


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """A parameter dict (or one of the same layout: gradients, moments) as
    numpy arrays, float32 for bfloat16 tensors; the inverse of
    `params_from_numpy`."""

    def conv(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return _map_params(params, conv, lambda w: {"q": conv(w["q"]), "s": conv(w["s"])})
