"""The port stands alone: no file of `jacobiforcing_tpu_torch/` and not
`chip_smoke.py` imports `jax` or `jacobiforcing_tpu`, and a process that
imports the port and runs a tiny CPU forward never loads jax."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "jacobiforcing_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "jacobiforcing_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_process_never_loads_jax():
    code = """
import sys, torch
from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params, rope_table, forward
from jacobiforcing_tpu_torch.ops.kv_cache import alloc_kv_cache
from jacobiforcing_tpu_torch import LLM, Config, SamplingParams
cfg = ModelConfig.tiny()
params = init_params(cfg, 0, device="cpu")
kv = alloc_kv_cache(cfg.num_layers, 4, 16, cfg.num_kv_heads, cfg.head_dim, cfg.dtype, "cpu")
ids = torch.tensor([[1, 2, 3, 4]])
pos = torch.arange(4)[None]
h, _ = forward(params, cfg, ids, pos, kv, torch.tensor([[0, 1]]), torch.tensor([4]),
               rope_table(cfg))
assert h.shape == (1, 4, cfg.hidden_size) and bool(torch.isfinite(h).all())
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "jacobiforcing_tpu")]
print("LOADED", bad)
sys.exit(1 if bad else 0)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
