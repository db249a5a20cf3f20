"""Operations of the rows a serving step forwards through the decoder.

A row is one token position through every layer: the linear layers take
what the architecture's layout gives (`row_linear_flops`: every layer's
projections; an expert layer its router, the k experts a token is routed
to and its shared experts), the head 2 * H * V where the row's logits are
taken, and attention 4 * D * NH per visible (query, key) pair and layer.
Visible pairs come per attention shape of the layout, {(NH, KH, D, window):
pairs of one layer and one query head}.  Norms, rotary embedding and the
elementwise work are left out (well under 1% of a row).
"""

from __future__ import annotations


def linear_flops(arch) -> int:
    return arch.linear_flops


def head_flops(arch) -> int:
    return 2 * arch.dims["H"] * arch.dims["V"]


def attention_flops(arch, *pairs) -> float:
    """Operations over the pairs of each of `pairs`, summed per attention
    shape, times each shape's operations a pair (4 * D * NH * layers)."""
    return sum(sum(p.get(shape, 0) for p in pairs) * (4 * shape[2] * shape[0] * n)
               for shape, n in arch.attention)


def rows_flops(arch, rows: int, head_rows: int, *pairs) -> float:
    return rows * linear_flops(arch) + head_rows * head_flops(arch) + attention_flops(arch, *pairs)
