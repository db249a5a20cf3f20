"""The benchmark's operation and byte counts against the bounds that the
kernel table in PERF.md (section 6) gives for kernel 1 and the serving rows,
and kernel 1's counts under a window against counts made by hand."""

import pytest

from h100_bench.lib.peaks import peaks
from h100_bench.lib.registry import Registry

PK = peaks("NVIDIA H100 80GB HBM3")
K1 = Registry().counts("paged_attention")
ROWS = Registry().counts("serve_rows")
REG = Registry()
CODER = REG.arch(REG.config("qwen2.5-coder-7b"))


def bound_ms(launches):
    ops = sum(o for o, _ in launches)
    nb = sum(b for _, b in launches)
    t, which = K1.bound_s(ops, nb, PK["bf16_flops"], PK["hbm_bytes_per_s"])
    return t * 1e3, which


def test_kernel1_jacobi_block_bound():
    # B 4, L 64, 1024 keys per row (the block's 64 included): 0.00368 ms, operations
    t, which = bound_ms([K1.launch(1024 - 64, 64, 28, 4, 128)] * 4)
    assert which == "operations"
    assert t == pytest.approx(0.00368, rel=0.005)


def test_kernel1_prefill_bound():
    # one prompt of 1024 tokens from an empty cache: 0.00761 ms, operations
    t, which = bound_ms([K1.launch(0, 1024, 28, 4, 128)])
    assert which == "operations"
    assert t == pytest.approx(0.00761, rel=0.005)


def test_kernel1_ar_decode_is_bound_by_bytes():
    # one query row over 1024 keys reads far more than it computes
    _, which = bound_ms([K1.launch(1023, 1, 28, 4, 128)] * 4)
    assert which == "bytes"


def test_kernel1_counts_each_kv_byte_once():
    ops, nb = K1.launch(100, 10, 1, 1, 2, kv_bytes=1, q_bytes=1)
    assert ops == 4 * 2 * (10 * 100 + 55)
    assert nb == 2 * 2 * 110 + 2 * 10 * 2


@pytest.mark.parametrize("first, n, window, pairs, keys", [
    (100, 64, 64, 64 * 64, 127),  # every query sees a full window: keys 37..163
    (0, 164, 64, sum(range(1, 64)) + 101 * 64, 164),  # queries 0..62 see p + 1 keys
    (30, 10, 64, sum(range(31, 41)), 40),  # no query reaches the window
    (100, 64, None, 64 * 100 + 64 * 65 // 2, 164),  # full causal
])
def test_kernel1_window_counts_by_hand(first, n, window, pairs, keys):
    assert K1.pairs(first, n, window) == pairs
    ops, nb = K1.launch(first, n, 3, 1, 8, window=window)
    assert ops == 4 * 8 * 3 * pairs
    assert nb == 2 * 1 * 8 * 2 * keys + 2 * n * 3 * 8 * 2


def test_serving_row_is_14_1_gflop_at_coder_7b():
    # a Jacobi trip at B 32, L 64 is 2048 rows of 14.1 GFLOP each, head included
    per_row = ROWS.linear_flops(CODER) + ROWS.head_flops(CODER)
    assert per_row == pytest.approx(14.14e9, rel=0.002)
    assert ROWS.rows_flops(CODER, 2, 1) == 2 * ROWS.linear_flops(CODER) + ROWS.head_flops(CODER)
    assert CODER.attention == [((28, 4, 128, None), 28)]
    assert ROWS.rows_flops(CODER, 0, 0, {(28, 4, 128, None): 10}) == 10 * 4 * 128 * 28 * 28
