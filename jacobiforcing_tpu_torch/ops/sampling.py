"""Token sampling (PyTorch port of `jacobiforcing_tpu/ops/sampling.py`).

Gumbel-max `sample` (the AR decode step), `shape_logits` (temperature /
top-k / top-p applied to logits) and `target_probs` (the target distribution
p(.) of the rejection-sampling Jacobi decoders), with the JAX version's exact
rules: a top-k threshold keeps every value tied with the k-th, the nucleus
keeps the sorted prefix with cdf <= top_p and always its first token, sums are
renormalised with max(sum, 1e-12), and temperature is floored at 1e-6.  Sorts
are stable, as `jnp.argsort` is, so tied probabilities keep their order.

Random bits come from an explicit `torch.Generator`; they differ from
`jax.random`'s, so sampled tokens agree with the JAX package in distribution
only, while every greedy row (temperature 0, top_k=1) agrees token for token.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def shape_logits(
    logits: torch.Tensor,  # [..., V]
    temperature: torch.Tensor,  # [...] broadcastable; 0 => greedy handled by caller
    top_k: int = -1,
    top_p: float = 1.0,
) -> torch.Tensor:
    """Apply temperature / top-k / top-p to produce target-shaped logits."""
    t = temperature.clamp(min=1e-6)
    logits = logits / t[..., None]
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, _NEG_INF, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True, stable=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p (>= 1 token)
        cutoff = cum - probs < top_p
        kth = torch.where(cutoff, sorted_logits, _NEG_INF).amax(dim=-1, keepdim=True)
        logits = torch.where(logits < kth, _NEG_INF, logits)
    return logits


def sample(
    logits: torch.Tensor,  # [..., V] (already shaped by temperature)
    generator: torch.Generator,
    temperature: torch.Tensor,  # [...]: rows with 0 take argmax
) -> torch.Tensor:
    """Gumbel-max sampling; rows with temperature == 0 reduce to argmax."""
    noisy = logits + torch.where(temperature[..., None] > 0,
                                 gumbel(logits.shape, generator, logits.device).to(logits.dtype),
                                 0.0)
    return torch.argmax(noisy, dim=-1).to(torch.int32)


def gumbel(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Gumbel(0, 1) noise in float32, `-log(-log(u + 1e-10) + 1e-10)` as in
    the JAX decoders, from one uniform draw of `generator`."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u + 1e-10) + 1e-10)


def target_probs(
    logits: torch.Tensor,  # [..., V]
    temperature: torch.Tensor,  # [...] > 0
    top_k: int = -1,
    top_p: Optional[torch.Tensor] = None,  # [...] nucleus threshold per row
) -> torch.Tensor:
    """logits -> target sampling distribution p(.): temperature softmax, then
    top-k zero + renormalise, then the nucleus keeping the smallest sorted
    prefix with cdf <= top_p (always >= 1 token)."""
    t = temperature.clamp(min=1e-6)[..., None]
    probs = torch.softmax(logits / t, dim=-1)
    if 0 < top_k < probs.shape[-1]:
        kth = torch.topk(probs, top_k, dim=-1).values[..., -1:]
        probs = torch.where(probs < kth, 0.0, probs)
        probs = probs / probs.sum(-1, keepdim=True).clamp(min=1e-12)
    if top_p is not None:
        order = torch.argsort(-probs, dim=-1, stable=True)
        sorted_p = torch.gather(probs, -1, order)
        cdf = torch.cumsum(sorted_p, dim=-1)
        keep_sorted = cdf <= top_p[..., None]
        keep_sorted[..., 0].fill_(True)  # a scalar fill: capturable in a CUDA graph
        keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)  # unsort
        probs = torch.where(keep, probs, 0.0)
        probs = probs / probs.sum(-1, keepdim=True).clamp(min=1e-12)
    return probs
