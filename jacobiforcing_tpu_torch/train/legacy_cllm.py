"""Legacy CLLM-v1 trainer: AR loss on teacher output + HARD consistency loss.

PyTorch port of `jacobiforcing_tpu/train/legacy_cllm.py` (reference:
JacobiForcing/train/cllm_trainer.py:12-181 + train_cllm.py:55-318), the
predecessor objective kept for comparability:
  * AR loss: next-token CE over the full teacher output (prompt + completion);
  * consistency loss: pick a RANDOM intermediate trajectory state of one
    n-token block, forward [prompt-prefix + noisy block], and hard-CE the
    block positions against the fixed-point tokens;
  * the reference runs two separate backward passes; one backward of the
    summed losses accumulates the same gradients (one accumulation step).

Built on `forward_dense` / `logits_at` (plain causal attention) and
`train/optim.AdamW`, whose defaults are `optax.adamw`'s (weight decay 1e-4 on
every parameter), so `AdamW(1e-4)` is the JAX tests' `optax.adamw(1e-4)`.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from jacobiforcing_tpu_torch.models.qwen import ModelConfig, forward_dense, logits_at
from jacobiforcing_tpu_torch.train.consistency import grad_views
from jacobiforcing_tpu_torch.train.optim import AdamW, OptState


def prepare_legacy_sample(
    row: Dict[str, Any],
    rng: np.random.RandomState,
    seq_bucket: int,
    pad_id: int = 0,
) -> Dict[str, np.ndarray]:
    """One trajectory row -> fixed-shape arrays.

    Row contract: {prompt_ids, answer_trajectory_ids, teacher_output_ids}
    (stage-1 format, generate_trajectory_...greedy.py:170-176).  The noisy
    input is the full prefix of the chosen trajectory state; block positions
    are supervised against the fixed point.
    """
    traj = row["answer_trajectory_ids"]
    i = int(rng.randint(0, max(len(traj) - 1, 1)))  # random non-final state
    noisy_state = list(traj[i])
    fixed_state = list(traj[-1])
    n_blk = len(fixed_state)
    prompt = list(row["prompt_ids"])
    # block-local states (length n) get the prompt prefix; full-prefix states
    # (masking format) already carry it
    if len(noisy_state) == n_blk and n_blk < len(row["teacher_output_ids"]):
        prefix = prompt
    else:
        prefix = []
    noisy_ids = (prefix + noisy_state)[:seq_bucket]
    fixed_tail = fixed_state[-n_blk:]
    blk_start = len(noisy_ids) - min(n_blk, len(noisy_ids))

    teacher = list(row["teacher_output_ids"])[:seq_bucket]

    def pad_to(x, n, fill):
        out = np.full((n,), fill, np.int32)
        out[: len(x)] = x
        return out

    cons_labels = np.full((seq_bucket,), -100, np.int32)
    for j, t in enumerate(fixed_tail[: len(noisy_ids) - blk_start]):
        cons_labels[blk_start + j] = t

    ar_labels = np.full((seq_bucket,), -100, np.int32)
    for j in range(max(len(prompt) - 1, 0), len(teacher) - 1):
        ar_labels[j] = teacher[j + 1]

    return {
        "noisy_ids": pad_to(noisy_ids, seq_bucket, pad_id),
        "noisy_len": np.int32(len(noisy_ids)),
        "cons_labels": cons_labels,
        "teacher_ids": pad_to(teacher, seq_bucket, pad_id),
        "teacher_len": np.int32(len(teacher)),
        "ar_labels": ar_labels,
    }


def legacy_losses(
    params: Dict[str, Any],
    cfg: ModelConfig,
    rope,
    batch: Dict[str, torch.Tensor],
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, {loss_ar, loss_consistency, loss}) of one prepared sample, whose
    arrays are tensors on the parameters' device."""
    Lb = batch["noisy_ids"].shape[0]
    pos = torch.arange(Lb, dtype=torch.int32, device=batch["noisy_ids"].device)[None, :]

    def masked_ce(ids, labels):
        h = forward_dense(params, cfg, ids[None], pos, rope)[0]
        logp = torch.log_softmax(logits_at(params, cfg, h), dim=-1)
        valid = labels >= 0
        tgt = torch.clamp(labels, min=0).long()
        nll = -torch.gather(logp, -1, tgt[:, None])[:, 0]
        w = valid.to(nll.dtype)
        return torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0)

    # hard consistency: noisy block positions -> fixed-point tokens (the
    # labels align to the same positions, not shifted: predict the token AT
    # the position from its left context, CLLM-v1 style via offset -1)
    loss_cons = masked_ce(batch["noisy_ids"], torch.roll(batch["cons_labels"], -1))
    loss_ar = masked_ce(batch["teacher_ids"], batch["ar_labels"])
    total = loss_ar + loss_cons
    return total, {"loss_ar": loss_ar, "loss_consistency": loss_cons, "loss": total}


def make_legacy_train_step(cfg: ModelConfig, optimizer: AdamW):
    """step(params, opt_state, rope, batch) -> (params, opt_state, metrics):
    one AdamW update from one prepared sample, the parameters updated in
    place (`opt_state = optimizer.init(params)`); `batch` holds tensors or
    numpy arrays, moved to the parameters' device.  Metrics are detached
    scalars."""

    def step(params: Dict[str, Any], opt_state: OptState, rope, batch):
        dev = params["embed"].device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        total, metrics = legacy_losses(grad_views(params, opt_state), cfg, rope, batch)
        total.backward()
        optimizer.apply(opt_state)
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return step
