"""SFT baseline trainer: plain next-token CE on packed rows.

PyTorch port of `jacobiforcing_tpu/train/sft.py` (the fairness baseline of
the reference's `baseline_sft_train.py`): `sft_loss` is the plain-causal use
of `forward_dense`, `make_optimizer` the reference's AdamW, and
`make_sft_train_step` a single-device step; the mesh-sharded step of the JAX
package is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from jacobiforcing_tpu_torch.models.qwen import ModelConfig, forward_dense, logits_at
from jacobiforcing_tpu_torch.train.consistency import grad_views
from jacobiforcing_tpu_torch.train.optim import AdamW


def sft_loss(
    params: Dict[str, Any],
    cfg: ModelConfig,
    rope,
    input_ids: torch.Tensor,  # [B, T]
    loss_mask: torch.Tensor,  # [B, T] float; 0 masks pad/prompt positions
) -> torch.Tensor:
    """Mean next-token cross-entropy over masked positions (labels = input
    shifted; PAD -> masked)."""
    B, T = input_ids.shape
    positions = torch.arange(T, dtype=torch.int32, device=input_ids.device)[None, :].repeat(B, 1)
    h = forward_dense(params, cfg, input_ids, positions, rope)
    logits = logits_at(params, cfg, h[:, :-1, :])  # [B, T-1, V]
    targets = input_ids[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None])[..., 0]
    m = loss_mask[:, 1:].to(nll.dtype)
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def make_optimizer(lr: float = 1e-5, weight_decay: float = 0.0) -> AdamW:
    """AdamW beta=(0.9, 0.95), the reference's training setup."""
    return AdamW(lr, b1=0.9, b2=0.95, weight_decay=weight_decay)


def make_sft_train_step(cfg: ModelConfig, mesh=None, optimizer=None):
    """Build (init_fn, step_fn) for one device.

    init_fn(params) -> (params, opt_state);
    step_fn(params, opt_state, rope, input_ids, loss_mask) -> (params,
    opt_state, loss), updating the parameters in place."""
    if mesh is not None:
        raise NotImplementedError("mesh-sharded SFT training is not ported yet")
    optimizer = optimizer or make_optimizer()

    def init_fn(params):
        return params, optimizer.init(params)

    def step_fn(params, opt_state, rope, input_ids, loss_mask):
        loss = sft_loss(grad_views(params, opt_state), cfg, rope, input_ids, loss_mask)
        loss.backward()
        optimizer.apply(opt_state)
        return params, opt_state, loss.detach()

    return init_fn, step_fn
