"""The per-layer metrics read from the engine's spans and counters
(`queue_wait_ms`, `first_commit_ms`, `prefill_mfu_pct.open`,
`trip_row_use_pct`, `engine_host_pct.batch` / `.open`): the tiny closed and
Poisson cells run with `--trace 1` on the CPU with the entries added as a
later change adds them, and report each, in range; `prefill_mfu_pct.open`
needs the card's peak and reads nothing here.  A program without the
counters (the engine before they existed) gives every reader nothing to
read, and none raises."""

import pytest
import torch

from conftest import tiny_bench

import h100_bench.run as runmod
from h100_bench.lib.registry import Registry

NEW = [
    ("queue_wait_ms", "ms", "lower", "scheduler", "ttft_p95_ms", ["tiny-poisson"]),
    ("first_commit_ms", "ms", "lower", "decode loops", "ttft_p95_ms", ["tiny-poisson"]),
    ("prefill_mfu_pct.open", "%", "higher", "model step", "ttft_p95_ms", ["tiny-poisson"]),
    ("trip_row_use_pct", "%", "higher", "decode loops", "output_tokens_per_s",
     ["tiny-closed", "tiny-poisson"]),
    ("engine_host_pct.batch", "%", "lower", "API / engine", "output_tokens_per_s",
     ["tiny-closed"]),
    ("engine_host_pct.open", "%", "lower", "API / engine", "ttft_p95_ms", ["tiny-poisson"]),
]


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def bench_with_new_entries() -> dict:
    bench = tiny_bench()
    for name, unit, better, layer, moves, cells in NEW:
        bench["per_layer"].append({"name": name, "unit": unit, "better": better,
                                   "source": "program_counter", "layer": layer,
                                   "moves": moves, "workloads": cells})
    return bench


@pytest.mark.parametrize("cell", ["tiny-closed", "tiny-poisson"])
def test_traced_tiny_cell_reports_the_engine_metrics(tiny_root, cell):
    reg = Registry(tiny_root)
    args = runmod.parse(["--workload", cell, "--seed", "2400000011",
                         "--seconds", "2", "--trace", "1"])
    ctx = runmod.Context(args, bench_with_new_entries(), reg, torch.device("cpu"))
    out = runmod.measure(ctx)
    line = runmod.result_line(ctx, out)
    assert line["correct"], line["checks"]
    got = line["metrics"]
    want = {name for name, *_, cells in NEW if cell in cells} - {"prefill_mfu_pct.open"}
    assert want <= set(got), got
    assert "prefill_mfu_pct.open" not in got  # no card, no peak
    for name in want:
        v = got[name]["value"]
        assert v == v and v >= 0, (name, v)
        if got[name]["unit"] == "%":
            assert v <= 100, (name, v)
    st = out["data"].work.stats
    assert st["trip_slots"] >= st["jacobi_iterations"] > 0
    assert st["step_s"] >= st["device_wait_s"] > 0
    if cell == "tiny-poisson":
        assert st["admissions"] > 0 and st["first_commits"] > 0


def test_readers_find_nothing_in_a_program_without_the_counters(tiny_root):
    """The parent's engine has none of these stats keys: each reader returns
    None (the metric is left out of the line) and raises nothing."""
    from h100_bench.run import RunData
    from h100_bench.tasks import serve

    reg = Registry(tiny_root)
    work = serve.Work(seq_trips=40, prefill_rows=300, prefill_head_rows=24,
                      prefill_pairs={(4, 2, 16, None): 9000},
                      stats={"prefill_tokens": 276, "generated_tokens": 50,
                             "jacobi_iterations": 40, "chunk_forwards": 12, "chunk_calls": 3})
    run = RunData(window_s=2.0, work=work, device_name="NVIDIA H100 80GB HBM3",
                  counts=reg.counts, arch=reg.arch(reg.config("tiny-qwen2")))
    for name, *_ in NEW:
        assert reg.metric(name).compute(run) is None, name
