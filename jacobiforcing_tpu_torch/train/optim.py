"""AdamW and the learning-rate schedules of the trainers, equal to optax's.

`AdamW(lr, b1, b2, eps, weight_decay)` computes what `optax.adamw` computes
with the same arguments: decoupled weight decay on EVERY parameter (norms and
biases too, optax's default 1e-4), bias-corrected moments, `eps` outside the
square root, moments kept in the parameters' dtype, and a schedule evaluated
at the number of updates made BEFORE the current one (so a schedule that
starts at 0 makes the first step change nothing but the moments).

The arithmetic is `torch.optim.AdamW`'s, the fused kernel on the card (the
`foreach` one allocates temporaries as large as the parameters).  Parameters
are updated in place; the gradients live in buffers that the state owns and
that a train step zeroes and fills.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Union

import torch

Schedule = Callable[[int], float]


def warmup_cosine_schedule(init_value: float, peak_value: float, warmup_steps: int,
                           decay_steps: int, end_value: float = 0.0) -> Schedule:
    """`optax.warmup_cosine_decay_schedule` as a function of the step count:
    linear from `init_value` to `peak_value` over `warmup_steps`, then a
    cosine from `peak_value` to `end_value` that ends at `decay_steps` (the
    total, warm-up included) and stays there."""
    cosine_steps = decay_steps - warmup_steps
    if not cosine_steps > 0:
        raise ValueError(f"the cosine needs decay_steps > warmup_steps, got {decay_steps=} "
                         f"{warmup_steps=}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(float(count - warmup_steps), float(cosine_steps))
        cosine = 0.5 * (1 + math.cos(math.pi * c / cosine_steps))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    """`optax.cosine_decay_schedule` as a function of the step count: from
    `init_value` down a cosine to `alpha * init_value` at `decay_steps`, and
    there after."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine needs decay_steps > 0, got {decay_steps=}")

    def schedule(count: int) -> float:
        c = min(float(count), float(decay_steps))
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)

    return schedule


def param_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """The tensors of a parameter dict in a fixed order (sorted by name)."""
    out = []
    for name in sorted(params):
        v = params[name]
        out.extend(v[k] for k in sorted(v)) if isinstance(v, dict) else out.append(v)
    return out


class OptState:
    """What an optimizer keeps for one parameter dict: the torch optimizer
    (moments, step counts), one gradient buffer per parameter tensor (also
    bound as its `.grad`), and the number of updates made."""

    def __init__(self, opt: torch.optim.Optimizer, leaves: List[torch.Tensor]):
        self.opt = opt
        self.leaves = leaves
        self.count = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"opt": self.opt.state_dict(), "count": self.count}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.opt.load_state_dict(sd["opt"])
        self.count = int(sd["count"])


class AdamW:
    """`optax.adamw(learning_rate, b1, b2, eps, weight_decay=...)`; the
    learning rate is a float or a schedule of the update count."""

    def __init__(self, learning_rate: Union[float, Schedule], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params: Dict[str, Any]) -> OptState:
        leaves = param_leaves(params)
        for p in leaves:
            p.grad = torch.zeros_like(p)
        opt = torch.optim.AdamW(leaves, lr=0.0, betas=(self.b1, self.b2), eps=self.eps,
                                weight_decay=self.weight_decay,
                                fused=all(p.is_cuda for p in leaves))
        return OptState(opt, leaves)

    def apply(self, state: OptState) -> float:
        """One update from the gradients in the state's buffers, in place;
        returns the learning rate it ran at."""
        lr = self.lr_at(state.count)
        for group in state.opt.param_groups:
            group["lr"] = lr
        state.opt.step()
        state.count += 1
        return lr
