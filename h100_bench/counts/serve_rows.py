"""Operations of the rows a serving step forwards through the decoder.

A row is one token position through every layer: the linear layers take
2 * (H * (q + 2 kv) + q * H + 3 * H * I) operations per layer, the head
2 * H * V where the row's logits are taken, and attention 4 * D * NH per
visible (query, key) pair and layer.  Norms, rotary embedding and the
elementwise work are left out (well under 1% of a row).
"""

from __future__ import annotations


def linear_flops(d: dict) -> int:
    H, I = d["H"], d["I"]
    q, kv = d["NH"] * d["D"], d["KH"] * d["D"]
    return 2 * (H * (q + 2 * kv) + q * H + 3 * H * I) * d["NL"]


def head_flops(d: dict) -> int:
    return 2 * d["H"] * d["V"]


def attention_flops_per_pair(d: dict) -> int:
    return 4 * d["D"] * d["NH"] * d["NL"]


def rows_flops(d: dict, rows: int, head_rows: int, pairs: int) -> int:
    return (rows * linear_flops(d) + head_rows * head_flops(d)
            + pairs * attention_flops_per_pair(d))
