"""The Megatron layout of the parameters, the KV pool and the decode state
(PyTorch port of `jacobiforcing_tpu/parallel/sharding.py`).

The spec table is the JAX package's, name by name: a spec is a tuple with
one entry per array axis, the mesh axis it is split over or None.

  * qkv / gate / up projections: column-parallel, the output axis over
    "model" (the reference's ColumnParallelLinear / QKVParallelLinear);
  * o_proj / down_proj: row-parallel, the input axis over "model"; the
    forward all-reduces the partial products (`parallel/collectives`);
  * embeddings + lm_head: vocab-parallel over "model";
  * KV pool: KV heads over "model", so attention is local to each rank;
  * batch axes of the decode state over "data".

`fsdp=True` (ZeRO-3, the reference's ds_config.json) also splits the hidden
axis of the large layer stacks, the embedding and the head over "data"; the
serving engine does not use it.  `shard_params` cuts a full parameter dict
to this rank's share, on the host (numpy arrays, CPU tensors) or wherever
the tensors are, so a checkpoint can be sliced before anything reaches the
card; `unshard_array` is its inverse over the mesh's groups (a checkpoint
written from a mesh), and `fsdp_gather` the weight gather the trainer's
forward runs layer by layer.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from jacobiforcing_tpu_torch.parallel.collectives import Group, gather_cat, gather_data
from jacobiforcing_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh

Spec = Tuple[Any, ...]


def P(*axes) -> Spec:
    return tuple(axes)


def param_specs(cfg, *, fsdp: bool = False) -> Dict[str, Any]:
    """Spec tree matching the `init_params` structure.

    With fsdp=True the large 3D layer stacks additionally split their
    hidden-size axis over "data" (the ZeRO-3 / FSDP analog for training).
    """
    d = DATA_AXIS if fsdp else None
    m = MODEL_AXIS
    layers = {
        "ln1": P(None, None),
        "ln2": P(None, None),
        "wq": P(None, d, m),
        "wk": P(None, d, m),
        "wv": P(None, d, m),
        "wo": P(None, m, d),
        "w_gate": P(None, d, m),
        "w_up": P(None, d, m),
        "w_down": P(None, m, d),
    }
    if cfg.qkv_bias:
        layers["bq"] = P(None, m)
        layers["bk"] = P(None, m)
        layers["bv"] = P(None, m)
    if cfg.qk_norm:
        layers["q_norm"] = P(None, None)
        layers["k_norm"] = P(None, None)
    specs = {
        "embed": P(m, d),
        "layers": layers,
        "final_norm": P(None),
    }
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = P(d, m)
    return specs


def kv_cache_spec() -> Dict[str, Spec]:
    """KV pages split over KV heads on the model axis: k/v [layers, kv_heads,
    slots, head_dim]; the per-row dequant scales [layers, kv_heads, slots]
    of a narrow cache follow the heads."""
    return {
        "k": P(None, MODEL_AXIS, None, None), "v": P(None, MODEL_AXIS, None, None),
        "k_scale": P(None, MODEL_AXIS, None), "v_scale": P(None, MODEL_AXIS, None),
    }


def decode_state_specs() -> Dict[str, Spec]:
    """Batch-major decode state splits over "data"."""
    return {
        "tokens": P(DATA_AXIS, None),
        "cur_len": P(DATA_AXIS),
        "draft": P(DATA_AXIS, None),
        "block_tables": P(DATA_AXIS, None),
    }


def _scale_spec(spec: Spec, ndim: int) -> Spec:
    """The spec of a quantized weight's per-output-channel scale [..., 1,
    out]: the weight's output axis, nothing on its input axis."""
    parts = list(spec) + [None] * (ndim - len(spec))
    return P(*(parts[:-2] + [None, parts[-1]]))


def shard_array(x, spec: Spec, mesh: Mesh):
    """This rank's block of `x` (a numpy array or a tensor) under `spec`.
    A tensor's block is a copy of its own, so the full tensor can be freed;
    raises ValueError where an axis does not divide."""
    idx = []
    for axis, name in enumerate(spec):
        if name is None:
            idx.append(slice(None))
            continue
        n, i = mesh.shape[name], mesh.index(name)
        size = x.shape[axis]
        if size % n:
            raise ValueError(f"axis {axis} of size {size} does not split over {n} "
                             f"ranks of the {name!r} axis")
        idx.append(slice(i * (size // n), (i + 1) * (size // n)))
    block = x[tuple(idx)]
    if isinstance(block, torch.Tensor):
        return block.clone()
    return np.ascontiguousarray(block)


def shard_params(params: Dict[str, Any], cfg, mesh: Mesh, *, fsdp: bool = False):
    """Cut the full parameter dict to this rank's share.

    A quantized weight ({"q": int8, "s": scale}, `ops/quant.py`) is cut leaf
    by leaf: `q` follows the weight's spec, the per-output-channel scale
    follows the spec's output axis.  Re-lay int8 weights for the card's
    GEMM (`ops/quant.int_mm_layout`) after this, never before.
    """

    def cut(x, spec):
        if isinstance(x, dict) and "q" in x:
            return {"q": shard_array(x["q"], spec, mesh),
                    "s": shard_array(x["s"], _scale_spec(spec, x["q"].ndim), mesh)}
        return shard_array(x, spec, mesh)

    if not is_full(params, cfg):  # a share cut again would still divide
        raise ValueError(f"shard_params takes the full weights: embed is "
                         f"{tuple(params['embed'].shape)}, wk {tuple(_width_of(params))}; the "
                         f"model's are {(cfg.vocab_size, cfg.hidden_size)} and [.., "
                         f"{cfg.hidden_size}, {cfg.kv_size}]")
    specs = param_specs(cfg, fsdp=fsdp)
    out = {k: cut(v, specs[k]) for k, v in params.items() if k != "layers"}
    out["layers"] = {k: cut(v, specs["layers"][k]) for k, v in params["layers"].items()}
    return out


def _width_of(params) -> Tuple[int, ...]:
    wk = params["layers"]["wk"]
    return tuple((wk["q"] if isinstance(wk, dict) else wk).shape)


def is_full(params: Dict[str, Any], cfg) -> bool:
    """Whether `params` holds the whole weights (and not a rank's share): the
    embedding is [vocab, hidden] and wk [layers, hidden, kv_size]."""
    return (tuple(params["embed"].shape) == (cfg.vocab_size, cfg.hidden_size)
            and _width_of(params)[-2:] == (cfg.hidden_size, cfg.kv_size))


def unshard_array(x: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which `x` is this rank's block under `spec`: the
    inverse of `shard_array`, an all-gather over each split axis's group
    (collective: every rank of the mesh calls it)."""
    for axis, name in enumerate(spec):
        if name is not None:
            x = gather_cat(x, axis, mesh.groups[name])
    return x


def fsdp_gather(cfg, group: Group) -> Callable[[str, torch.Tensor], torch.Tensor]:
    """`gather(name, block)` for `models/qwen.forward_dense`: a rank's block
    of the leaf `name` (a per-layer weight or a top-level one) gathered over
    the data group along its fsdp axis, with the gradient reduce-scattered
    back (`collectives.gather_data`); a leaf that fsdp leaves whole passes
    through."""
    specs = param_specs(cfg, fsdp=True)
    dims = {k: v.index(DATA_AXIS) for k, v in specs.items() if k != "layers" and DATA_AXIS in v}
    # a layer's weight drops the stack's leading axis
    dims.update({k: v.index(DATA_AXIS) - 1 for k, v in specs["layers"].items() if DATA_AXIS in v})

    def gather(name: str, block: torch.Tensor) -> torch.Tensor:
        return block if name not in dims else gather_data(block, dims[name], group)

    return gather

