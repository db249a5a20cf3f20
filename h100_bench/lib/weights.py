"""A configuration's weights, made on the device from the run's seed.

The architecture's layout (`layouts/<name>.py`) lists the checkpoint's
tensors, under their checkpoint names and shapes, grouped into draws.  Each
draw is one `torch.randn` call of one `torch.Generator` on the device, made
and scaled in the draw's dtype and cast to the configuration's; the
generator runs on from draw to draw.  The same seed on the same device gives
the same bits, so the plain reference makes them again after the program has
been freed, and the program gets them through its own loading path (the
layout's `port_params`).

Scales, one of three kinds per tensor:
    an int n     a linear weight: N(0, 1) / sqrt(n), n its fan-in
    SMALL        N(0, 1) * 0.02 (embeddings, biases)
    NORM         1 + N(0, 1) * 0.1 (norm weights)
Consecutive tensors of one scale are scaled in one call.

`draw` yields the draws one at a time and keeps none: a `port_params` that
turns each piece into the port's own tensors and lets it go holds at most
one piece beyond what it has built.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16, "float32": torch.float32,
          "float64": torch.float64}
SMALL = "small"
NORM = "norm"


class Draw(NamedTuple):
    """One call of the generator: (name, shape, scale) in buffer order, made
    and scaled in `dtype` (None: the configuration's), then cast to the
    configuration's dtype."""

    tensors: List[Tuple[str, tuple, object]]
    dtype: Optional[torch.dtype] = None


def _scale(seg: torch.Tensor, scale) -> None:
    if scale == NORM:
        seg.mul_(0.1).add_(1.0)
    elif scale == SMALL:
        seg.mul_(0.02)
    elif isinstance(scale, int):
        seg.mul_(1.0 / math.sqrt(scale))
    else:
        raise ValueError(f"unknown scale {scale!r}: an int fan-in, {SMALL!r} or {NORM!r}")


def _draw(d: Draw, gen: torch.Generator, dev: torch.device, dtype) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(s) for _, s, _ in d.tensors)
    buf = torch.randn(total, generator=gen, device=dev, dtype=d.dtype or dtype)
    off, seg_start, seg_scale = 0, 0, d.tensors[0][2]
    for _, shape, scale in d.tensors:
        if scale != seg_scale:
            _scale(buf[seg_start:off], seg_scale)
            seg_start, seg_scale = off, scale
        off += math.prod(shape)
    _scale(buf[seg_start:off], seg_scale)
    buf = buf.to(dtype)
    out, off = {}, 0
    for name, shape, _ in d.tensors:
        n = math.prod(shape)
        out[name] = buf[off: off + n].view(shape)
        off += n
    return out


def draw(draws: List[Draw], seed: int, device, dtype) -> Iterator[Dict[str, torch.Tensor]]:
    """{name: tensor} of each draw in turn, views into one buffer a draw."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for d in draws:
        yield _draw(d, gen, dev, dtype)


def make_hf_tensors(layout, cfg: dict, seed: int, device, dtype=None) -> Dict[str, torch.Tensor]:
    """Every tensor of the configuration at once, {name: tensor} on `device`."""
    out: Dict[str, torch.Tensor] = {}
    for piece in draw(layout.draws(cfg), seed, device, dtype or DTYPES[cfg["torch_dtype"]]):
        out.update(piece)
    return out


def port_params(layout, cfg: dict, seed: int, device):
    """The port's model, through the layout's `port_params`, which takes the
    draws one piece at a time."""
    dtype = DTYPES[cfg["torch_dtype"]]
    dev = torch.device(device)
    out = layout.port_params(cfg, draw(layout.draws(cfg), seed, dev, dtype), dtype, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out
