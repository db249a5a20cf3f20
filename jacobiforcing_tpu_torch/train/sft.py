"""SFT baseline trainer: plain next-token CE on packed rows.

PyTorch port of `jacobiforcing_tpu/train/sft.py` (the fairness baseline of
the reference's `baseline_sft_train.py`): `sft_loss` is the plain-causal use
of `forward_dense`, `make_optimizer` the reference's AdamW, and
`make_sft_train_step` the step on one device or over a (data, model) mesh:
parameters cut over "model" (`param_specs(fsdp=False)`) and whole on every
data rank, the batch split over "data" when it divides, the gradients summed
over the data group (DDP).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from jacobiforcing_tpu_torch.models.qwen import ModelConfig, forward_dense, logits_at
from jacobiforcing_tpu_torch.parallel.collectives import Group, reduce_sum
from jacobiforcing_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from jacobiforcing_tpu_torch.parallel.sharding import shard_params
from jacobiforcing_tpu_torch.train.consistency import data_slice, grad_views, reduce_grads
from jacobiforcing_tpu_torch.train.optim import AdamW


def _nll_sums(params, cfg: ModelConfig, rope, input_ids, loss_mask,
              group: Group = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of masked next-token NLL, sum of the mask) over the batch."""
    B, T = input_ids.shape
    positions = torch.arange(T, dtype=torch.int32, device=input_ids.device)[None, :].repeat(B, 1)
    h = forward_dense(params, cfg, input_ids, positions, rope, group=group)
    logits = logits_at(params, cfg, h[:, :-1, :], group)  # [B, T-1, V]
    targets = input_ids[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    m = loss_mask[:, 1:].to(nll.dtype)
    return torch.sum(nll * m), torch.sum(m)


def sft_loss(
    params: Dict[str, Any],
    cfg: ModelConfig,
    rope,
    input_ids: torch.Tensor,  # [B, T]
    loss_mask: torch.Tensor,  # [B, T] float; 0 masks pad/prompt positions
) -> torch.Tensor:
    """Mean next-token cross-entropy over masked positions (labels = input
    shifted; PAD -> masked)."""
    nll, count = _nll_sums(params, cfg, rope, input_ids, loss_mask)
    return nll / torch.clamp(count, min=1.0)


def make_optimizer(lr: float = 1e-5, weight_decay: float = 0.0) -> AdamW:
    """AdamW beta=(0.9, 0.95), the reference's training setup."""
    return AdamW(lr, b1=0.9, b2=0.95, weight_decay=weight_decay)


def make_sft_train_step(cfg: ModelConfig, mesh: Optional[Mesh] = None, optimizer=None):
    """Build (init_fn, step_fn) for one device or for this rank of `mesh`.

    init_fn(params) -> (params, opt_state): the full weights, cut to the
    rank's model share over a mesh;
    step_fn(params, opt_state, rope, input_ids, loss_mask) -> (params,
    opt_state, loss), updating the parameters in place.  Every rank passes
    the whole batch [B, T]; over a mesh with B % dp == 0 each data rank takes
    its B / dp rows and the loss divides their masked NLL by the GLOBAL mask
    count (one scalar all-reduce), so the summed gradients are those of the
    global mean; otherwise every rank runs the whole batch, as the JAX step
    leaves an indivisible batch replicated."""
    if mesh is not None and mesh.coords is None:
        raise ValueError("this rank lies outside the mesh")
    optimizer = optimizer or make_optimizer()
    group = None if mesh is None else mesh.model_group
    data = None if mesh is None else mesh.data_group
    dp = 1 if mesh is None else mesh.shape[DATA_AXIS]

    def init_fn(params):
        if mesh is not None:
            params = shard_params(params, cfg, mesh)
        return params, optimizer.init(params)

    def step_fn(params, opt_state, rope, input_ids, loss_mask):
        split = dp > 1 and input_ids.shape[0] % dp == 0
        if split:
            mine = data_slice(mesh, input_ids.shape[0])
            input_ids, loss_mask = input_ids[mine], loss_mask[mine]
        nll, count = _nll_sums(grad_views(params, opt_state), cfg, rope, input_ids, loss_mask,
                               group)
        if split:
            count = reduce_sum(count.detach(), data)
        loss = nll / torch.clamp(count, min=1.0)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            # a replicated batch gives every data rank the whole gradient already
            reduce_grads(params, cfg, data if split else None, group, fsdp=False)
            if split:
                reduce_sum(loss, data)
        optimizer.apply(opt_state)
        return params, opt_state, loss

    return init_fn, step_fn
