"""The harness end to end on the CPU at tiny sizes, with its look for a card
skipped: tiny cells added as files run and come out correct; planted faults
in the timed path make `correct` false; without a card the real command
fails; nothing it loads is JAX; its parts are found by name."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, tiny_bench

import h100_bench.run as runmod
from h100_bench.lib.registry import Registry


def run_tiny(root, cell, seed=3_000_000_019, seconds=2.0, before_window=None, control=False):
    args = runmod.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                         "--trace", "0"] + (["--control"] if control else []))
    ctx = runmod.Context(args, tiny_bench(), Registry(root), torch.device("cpu"))
    ctx.before_window = before_window
    out = runmod.measure(ctx)
    return runmod.result_line(ctx, out)


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("cell", ["tiny-closed", "tiny-poisson"])
def test_tiny_cell_runs_and_is_correct(tiny_root, cell):
    line = run_tiny(tiny_root, cell)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert "output_tokens_per_s" in line["metrics"] and "setup_s" in line["metrics"]
    assert ("ttft_p95_ms" in line["metrics"]) == (cell == "tiny-poisson")
    assert list(line)[-1] == "checks"
    assert line["checks"]["widest_logit_gap"]["value"] <= 1e-3


def _alter_token(monkeypatch):
    from jacobiforcing_tpu_torch.engine import runner

    orig = runner._commit_and_redraft

    def bad(cfg, state, kv, active, commit, *rest):
        commit = commit.clone()
        commit[0] = (commit[0] + 1) % cfg.vocab_size  # row 0's tokens, where they are made
        return orig(cfg, state, kv, active, commit, *rest)

    monkeypatch.setattr(runner, "_commit_and_redraft", bad)


def _state_unchanged(monkeypatch):
    """Every trip returns its state as it found it (its iteration count
    still moves, so the chunk's loop ends)."""
    from jacobiforcing_tpu_torch.engine import runner

    orig = runner._jacobi_step

    def bad(params, cfg, rope, state, *a, **k):
        return state._replace(iters=orig(params, cfg, rope, state, *a, **k).iters)

    monkeypatch.setattr(runner, "_jacobi_step", bad)


def _half_batch(monkeypatch):
    """The second half of each trip's batch is left out of the forward: its
    rows take the first row's hidden states."""
    from jacobiforcing_tpu_torch.engine import runner

    orig = runner._forward_draft

    def bad(params, cfg, rope, state, *a, **k):
        h, kv = orig(params, cfg, rope, state, *a, **k)
        B = h.shape[0]
        h = h.clone()
        h[B // 2:] = h[:1]
        return h, kv

    monkeypatch.setattr(runner, "_forward_draft", bad)


@pytest.mark.parametrize("plant", [_alter_token, _state_unchanged, _half_batch],
                         ids=["token_altered", "state_unchanged", "half_batch_left_out"])
def test_a_fault_in_the_timed_path_is_not_correct(tiny_root, monkeypatch, plant):
    traffic = json.loads((tiny_root / "traffic" / "tiny-closed.json").read_text())
    traffic["drain_s"] = 2
    (tiny_root / "traffic" / "tiny-closed.json").write_text(json.dumps(traffic))
    line = run_tiny(tiny_root, "tiny-closed", seconds=1.5, before_window=lambda: plant(monkeypatch))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell", ["tiny-closed", "tiny-poisson"])
def test_the_control_in_the_programs_place_is_not_correct(tiny_root, cell):
    line = run_tiny(tiny_root, cell, control=True)
    assert line["failed"] == 0
    assert not line["correct"], line["checks"]
    gap = line["checks"]["widest_logit_gap"]
    assert gap["value"] > gap["limit"], gap


def test_without_a_card_the_command_fails_and_prints_no_result():
    r = subprocess.run([sys.executable, "h100_bench/run.py", "--workload",
                        "coder7b-jacobi-closed32", "--seed", "2147483659", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode != 0
    assert "{" not in r.stdout
    assert "CUDA" in r.stderr


def test_a_result_is_withheld_when_jax_is_loaded(monkeypatch, capsys):
    """The look at `sys.modules` sits in `run.main`, after the task's window,
    check and readers, just before the result line, whatever the task."""
    import types

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch, "set_num_threads", lambda n: None)
    monkeypatch.setattr(runmod, "measure", lambda ctx: {"unused": True})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = runmod.main(["--workload", "coder7b-jacobi-closed32", "--seed", "2147483659",
                      "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0
    assert "{" not in out
    assert "jax" in err


def test_an_open_loop_window_offers_its_rate():
    """Each block of the arrivals' `block` lasts its count over the rate, so
    a window offers the rate it names, give or take part of one block."""
    from h100_bench.lib.traffic import Traffic

    traffic = json.loads((BENCH / "traffic" / "qwen3-8b-jacobi-poisson.json").read_text())
    block = traffic["arrivals"]["block"]
    for rate in (traffic["arrivals"]["rate"], 1.7, 3.5):
        for seed in (5, 2_999_999_999):
            due = Traffic(traffic, seed, 1000, rate=rate).arrival_times(200.0)
            assert due[block - 1] == pytest.approx(block / rate)
            assert due[4 * block - 1] == pytest.approx(4 * block / rate)
            assert abs(len(due[due <= 51.0]) - 51.0 * rate) <= block
            gaps = np.diff(due)
            assert gaps.min() > 0 and gaps.std() > 0.5 / rate  # still irregular


CHILD = """
import sys, json
sys.argv = ["run.py"]
import runpy
mod = runpy.run_path("h100_bench/run.py", run_name="h100_bench_run")
mod["set_environment"]()
import torch
from h100_bench.lib.registry import Registry, load_benchmark
from pathlib import Path
bench = load_benchmark(Path("."))
reg = Registry()
for cell in bench["workloads"]:
    reg.config(cell["config"])
    traffic = reg.traffic(cell["name"])
    task = reg.task(traffic["task"])
    reg.arch(reg.config(cell["config"]))
for m in bench["end_to_end"] + bench["per_layer"]:
    reg.metric(m["name"])
for c in ("paged_attention", "serve_rows"):
    reg.counts(c)
import jacobiforcing_tpu_torch.engine.llm_engine, jacobiforcing_tpu_torch.utils.loader
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_nothing_the_cells_load_is_jax():
    r = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    tops = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "torch" in tops and "jacobiforcing_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "jacobiforcing_tpu"}


def test_parts_are_found_by_name_with_no_harness_file_edited(tiny_root):
    before = {p.relative_to(tiny_root): p.read_bytes() for p in tiny_root.rglob("*.py")}
    (tiny_root / "metrics" / "dummy_rows.py").write_text(
        "def compute(run):\n    return float(run.work.seq_trips) if run.work else None\n")
    reg = Registry(tiny_root)
    assert {"tiny-qwen2", "tiny-qwen3", "qwen2.5-coder-7b", "qwen3-8b"} <= set(reg.configs())
    assert {"tiny-closed", "tiny-poisson"} <= set(reg.traffics())
    assert "dummy_rows" in reg.metrics()
    bench = tiny_bench()
    bench["per_layer"].append({"name": "dummy_rows", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "decode loops",
                               "moves": "output_tokens_per_s", "workloads": ["tiny-closed"]})
    args = runmod.parse(["--workload", "tiny-closed", "--seed", "77", "--seconds", "1",
                         "--trace", "1"])
    ctx = runmod.Context(args, bench, reg, torch.device("cpu"))
    line = runmod.result_line(ctx, runmod.measure(ctx))
    assert line["metrics"]["dummy_rows"]["value"] > 0
    assert {p.relative_to(tiny_root): p.read_bytes() for p in tiny_root.rglob("*.py")
            if p.name != "dummy_rows.py" and "__pycache__" not in p.parts} == before


def test_the_committed_cells_name_existing_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    reg = Registry(BENCH)
    for cfg in bench["configs"]:
        assert reg.config(cfg["name"])["name"] == cfg["name"]
        assert (ROOT / cfg["file"]).is_file()
    for cell in bench["workloads"]:
        assert reg.traffic(cell["traffic"])["task"] == "serve"
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(reg.metric(m["name"]).compute)
