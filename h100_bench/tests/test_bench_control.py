"""The control of each cell's `correct`: the plain reference computed in
fp8 (one precision below the configurations' bfloat16) in the program's
place must come out not correct.

On the CPU at a tiny size, the fp8 reference's widest gap is far above the
float32 reference's own.  On the card, at each cell's own size on three
seeds, a run with `--control` (the fp8 reference's tokens judged by the
harness's own check in the program's place) prints `correct` false, its
widest gap above the cell's limit (the benchmark's own runs never pass
`--control`):

    python -m pytest h100_bench/tests/test_bench_control.py -q -m cuda
"""

import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, TINY_QWEN2
from h100_bench.lib.registry import Registry
from h100_bench.lib.weights import make_hf_tensors

CELLS = [c["name"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (2_147_483_911, 2_600_000_021, 3_100_000_007)


def test_the_fp8_control_reads_far_above_float32_at_a_tiny_size():
    cfg = dict(TINY_QWEN2)
    t = make_hf_tensors(Registry().layout("qwen"), cfg, 11, "cpu")
    Reference = Registry().reference("qwen").Reference
    g = torch.Generator().manual_seed(2)
    seqs = [[int(i) for i in torch.randint(1, 256, (40,), generator=g)] for _ in range(3)]
    pos = [list(range(10, 39))] * 3
    ref = Reference(cfg, t).logits_at(seqs, pos)
    low = Reference(cfg, t, fp8=True).logits_at(seqs, pos)
    gaps = [(r.max(-1).values - r.gather(1, c.argmax(-1)[:, None])[:, 0]).max().item()
            for r, c in zip(ref, low)]
    assert max(gaps) > 0.0
    same = [(r.argmax(-1) == c.argmax(-1)).float().mean().item() for r, c in zip(ref, low)]
    assert min(same) < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_each_cell_on_three_seeds(card, cell):
    for seed in SEEDS:
        r = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", cell, "--seed",
                            str(seed), "--seconds", "20", "--trace", "0", "--control"],
                           cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert r.returncode == 0, r.stderr[-3000:]
        line = json.loads(r.stdout.strip().splitlines()[-1])
        assert line["correct"] is False, (seed, line["checks"])
        gap = line["checks"]["widest_logit_gap"]
        assert gap["value"] > gap["limit"], (seed, gap)
