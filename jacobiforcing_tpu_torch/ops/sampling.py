"""Token sampling (PyTorch port of `jacobiforcing_tpu/ops/sampling.py::sample`).

Only Gumbel-max `sample` is ported: the AR decode step needs it.  The
target-shaping helpers of the non-greedy decoder come with that decoder.
"""

from __future__ import annotations

import torch


def sample(
    logits: torch.Tensor,  # [..., V] (already shaped by temperature)
    generator: torch.Generator,
    temperature: torch.Tensor,  # [...]: rows with 0 take argmax
) -> torch.Tensor:
    """Gumbel-max sampling; rows with temperature == 0 reduce to argmax.

    The uniform noise comes from `generator`, so it differs from the JAX
    version's bits; greedy rows do not depend on it.
    """
    u = torch.rand(logits.shape, generator=generator, device=logits.device, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u + 1e-10) + 1e-10)
    noisy = logits + torch.where(temperature[..., None] > 0, gumbel.to(logits.dtype), 0.0)
    return torch.argmax(noisy, dim=-1).to(torch.int32)
