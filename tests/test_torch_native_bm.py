"""The port's native C++ block manager against its Python one.

  * the differential random workload of tests/test_native_bm.py: allocate /
    ensure / deallocate give identical page tables, cached lengths, free
    counts and prefix-cache counters;
  * the engine takes the native allocator by default and the Python one under
    JF_NATIVE_BM=0, with the same tokens;
  * a failed build raises, naming JF_NATIVE_BM=0 (no silent fallback);
  * the library is built into build/host/ from the port's own source, and
    nothing under native/ is written.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from jacobiforcing_tpu_torch.config import Config, SamplingParams
from jacobiforcing_tpu_torch.engine import native_block_manager as nbm
from jacobiforcing_tpu_torch.engine.block_manager import BlockManager
from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine
from jacobiforcing_tpu_torch.engine.sequence import Sequence
from jacobiforcing_tpu_torch.models import qwen as tq
from jacobiforcing_tpu_torch.ops import _build

PAGE = 16
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mk_seq(tokens):
    return Sequence(list(tokens), SamplingParams())


@pytest.mark.parametrize("seed", [0, 1])
def test_differential_random_workload(seed):
    rng = np.random.RandomState(seed)
    py = BlockManager(64, PAGE)
    cc = nbm.NativeBlockManager(64, PAGE)
    live = []  # (python seq, native seq) twins with one seq_id
    prompt_pool = [rng.randint(1, 50, rng.randint(3, 70)).tolist() for _ in range(12)]
    for step in range(400):
        op = rng.rand()
        if op < 0.45 and py.num_free_pages > 8:
            toks = prompt_pool[rng.randint(len(prompt_pool))]
            margin = int(rng.randint(0, 20))
            s_py, s_cc = _mk_seq(toks), _mk_seq(toks)
            s_cc.seq_id = s_py.seq_id
            assert py.can_allocate(s_py, margin) == cc.can_allocate(s_cc, margin)
            if not py.can_allocate(s_py, margin):
                continue
            c1 = py.allocate_prompt(s_py, margin)
            c2 = cc.allocate_prompt(s_cc, margin)
            assert c1 == c2 == s_cc.num_cached_tokens, f"step {step}"
            assert s_py.block_table == s_cc.block_table, f"step {step}"
            live.append((s_py, s_cc))
        elif op < 0.7 and live:
            s_py, s_cc = live[rng.randint(len(live))]
            upto = len(s_py) + int(rng.randint(0, 64))
            assert py.ensure_capacity(s_py, upto) == cc.ensure_capacity(s_cc, upto)
            assert s_py.block_table == s_cc.block_table
            assert py.capacity_tokens(s_py) == cc.capacity_tokens(s_cc)
        elif live:
            s_py, s_cc = live.pop(rng.randint(len(live)))
            py.deallocate(s_py)
            cc.deallocate(s_cc)
            assert s_cc.block_table == [] and s_cc.num_cached_tokens == 0
        assert py.num_free_pages == cc.num_free_pages, f"step {step}"
    assert py.prefix_cache_hits == cc.prefix_cache_hits
    assert py.prefix_cache_queries == cc.prefix_cache_queries
    assert py.prefix_cache_hits > 0  # the workload exercised the prefix cache


def _engine():
    cfg = tq.ModelConfig.tiny()
    params = tq.init_params(cfg, 0, "cpu")
    return LLMEngine(Config(kvcache_page_size=PAGE, max_model_len=256, jacobi_chunk_tokens=32,
                            prefill_token_buckets=(32, 64, 128, 256), eos=-1),
                     model_cfg=cfg, params=params, num_kv_pages=64, device="cpu")


def test_engine_takes_native_by_default(monkeypatch):
    prompts = [[5, 9, 17, 3, 22], [7, 8, 9, 10, 11, 12, 13, 14, 15]]
    sp = SamplingParams(temperature=0.0, max_tokens=12, decode_strategy="jacobi",
                        jacobi_block_len=8, jacobi_max_blocks=1)
    monkeypatch.delenv("JF_NATIVE_BM", raising=False)
    eng = _engine()
    assert type(eng.block_manager) is nbm.NativeBlockManager
    out = [o["token_ids"] for o in eng.generate(prompts, sp)]
    monkeypatch.setenv("JF_NATIVE_BM", "0")
    eng2 = _engine()
    assert type(eng2.block_manager) is BlockManager
    assert [o["token_ids"] for o in eng2.generate(prompts, sp)] == out
    assert all(len(t) == 12 for t in out)


def test_failed_build_raises(monkeypatch, tmp_path):
    """A compiler that fails (or is missing) raises a RuntimeError that names
    JF_NATIVE_BM=0, from the allocator and from the engine; nothing falls back."""
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.delenv("JF_NATIVE_BM", raising=False)
    for cxx in ("false", str(tmp_path / "no-such-compiler")):
        monkeypatch.setenv("CXX", cxx)
        with pytest.raises(RuntimeError, match="JF_NATIVE_BM=0"):
            nbm.NativeBlockManager(8, PAGE)
        with pytest.raises(RuntimeError, match="JF_NATIVE_BM=0"):
            _engine()
    assert not list((tmp_path / "host").glob("*.so"))  # no half-built library is left


def test_builds_into_build_host_and_leaves_native_alone(monkeypatch, tmp_path):
    native = REPO / "native"
    before = {p.name: p.stat().st_mtime_ns for p in native.iterdir()}
    calls = []
    real_run = _build.subprocess.run

    def run(cmd, *a, **kw):
        calls.append(list(cmd))
        return real_run(cmd, *a, **kw)

    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setattr(_build, "HOST_BUILD_DIR", tmp_path / "host")
    monkeypatch.setattr(_build, "_LIBS", {})
    bm = nbm.NativeBlockManager(8, PAGE)
    assert bm.num_free_pages == 8
    path = _build.host_library_path("block_manager")
    assert path.exists() and path.parent == tmp_path / "host"
    assert len(calls) == 1 and calls[0][-1] == str(_build.CSRC / "block_manager.cpp")
    assert not any("make" == os.path.basename(c[0]) or str(native) in " ".join(c) for c in calls)
    assert {p.name: p.stat().st_mtime_ns for p in native.iterdir()} == before
    # a second load reuses the library: no new build
    monkeypatch.setattr(_build, "_LIBS", {})
    _build.load_host("block_manager")
    assert len(calls) == 1
    # the default location is build/host/ at the repository root
    monkeypatch.undo()
    assert _build.HOST_BUILD_DIR == REPO / "build" / "host"
