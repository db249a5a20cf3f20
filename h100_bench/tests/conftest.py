"""Tests of the benchmark harness.  CPU tests run the harness's own code at
tiny sizes; tests marked `cuda` need the card and skip without one:

    python -m pytest h100_bench/tests -q             (here, on the CPU)
    python -m pytest h100_bench/tests -q -m cuda     (on the card)
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "h100_bench"

TINY_QWEN2 = {
    "name": "tiny-qwen2", "source": "a CPU test model", "reference": "qwen",
    "dtype": "float32", "reduced": [], "model_type": "qwen2", "hidden_size": 64,
    "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 2, "vocab_size": 256, "max_position_embeddings": 1024,
    "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "tie_word_embeddings": False,
    "torch_dtype": "float32",
}
TINY_QWEN3 = dict(TINY_QWEN2, name="tiny-qwen3", model_type="qwen3", attention_bias=False,
                  head_dim=16)


def tiny_traffic(kind: str) -> dict:
    arrivals = ({"kind": "closed", "clients": 3} if kind == "closed"
                else {"kind": "poisson", "rate": 20.0})
    return {
        "task": "serve", "arrivals": arrivals,
        "prompt_len": {"dist": "uniform", "min": 12, "max": 40},
        "output_len": {"dist": "lognormal", "median": 12, "sigma": 0.5, "min": 6, "max": 20},
        "shape_seed": 3, "pool": 64, "shuffle_block": 8,
        "sampling": {"decode_strategy": "jacobi", "temperature": 0.0, "jacobi_block_len": 8,
                     "jacobi_max_blocks": 1, "ignore_eos": True,
                     "jacobi_max_iterations": 1 << 20},
        "engine": {"jacobi_chunk_iters": 2, "max_model_len": 128, "max_num_seqs": 16,
                   "max_num_batched_tokens": 512, "kvcache_page_size": 16,
                   "num_kv_pages": 96, "batch_buckets": [1, 2, 4, 8],
                   "prefill_token_buckets": [32, 64]},
        "warmup": {"strategies": ["jacobi"]},
        "drain_s": 20,
        "check": {"sample": 3, "max_logit_gap": 1e-3},
    }


def tiny_bench() -> dict:
    cells = [("tiny-closed", "tiny-qwen2"), ("tiny-poisson", "tiny-qwen3")]
    return {
        "workloads": [{"name": c, "config": k, "traffic": c, "chips": 1, "why": "CPU test"}
                      for c, k in cells],
        "end_to_end": [
            {"name": "output_tokens_per_s", "unit": "tokens/s", "better": "higher",
             "bound": 0.05, "source": "host_clock"},
            {"name": "ttft_p95_ms", "unit": "ms", "better": "lower", "bound": 0.1,
             "source": "host_clock", "workloads": ["tiny-poisson"]},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"},
        ],
        "per_layer": [
            {"name": "tokens_per_forward", "unit": "tokens", "better": "higher",
             "source": "program_counter", "layer": "decode loops",
             "moves": "output_tokens_per_s"},
            {"name": "mfu_pct.serve", "unit": "%", "better": "higher",
             "source": "program_counter", "layer": "model step",
             "moves": "output_tokens_per_s", "workloads": ["tiny-closed"]},
        ],
    }


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark folder with two tiny configurations and two
    tiny cells added as files, as a later change would add them."""
    root = tmp_path / "h100_bench"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for cfg in (TINY_QWEN2, TINY_QWEN3):
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    (root / "traffic" / "tiny-closed.json").write_text(json.dumps(tiny_traffic("closed")))
    (root / "traffic" / "tiny-poisson.json").write_text(json.dumps(tiny_traffic("poisson")))
    return root


def cuda_available() -> bool:
    import torch

    return torch.cuda.is_available()


@pytest.fixture
def card():
    if not cuda_available():
        pytest.skip("needs an NVIDIA card; none is visible here")


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")
