"""The per-bucket decode programs of `engine/graphs.py`.

On the CPU (and with `enforce_eager`) every program runs its trip eagerly over
fixed buffers, one program per shape bucket.  On the card the programs are
CUDA graphs; the `cuda`-marked tests hold a graphed engine to the eager one on
a small f32 model (TF32 off): the same tokens, the same loop trips, and for
rejection sampling the same sampled stream (a replay draws what the eager
trip would have), and a capture that fails raises.  This file imports only the
port, so the card's test run collects it.
"""

import numpy as np
import pytest
import torch

from jacobiforcing_tpu_torch.config import Config, SamplingParams
from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine
from jacobiforcing_tpu_torch.models import qwen as tq
from jacobiforcing_tpu_torch.ops import paged_attention_cuda as pac


def _engine(device, enforce_eager=False, **kw):
    mc = tq.ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=64, max_position=1024,
                        dtype=torch.float32)
    params = tq.init_params(mc, 0, device=device)
    cfg = Config(kvcache_page_size=16, max_model_len=256, jacobi_chunk_tokens=32,
                 prefill_token_buckets=(32, 64, 128, 256), eos=-1, enforce_eager=enforce_eager,
                 batch_buckets=(1, 2, 4), **kw)
    return LLMEngine(cfg, model_cfg=mc, params=params, num_kv_pages=128, device=device)


def _prompts(n=3):
    r = np.random.RandomState(0)
    return [r.randint(1, 512, size=s).tolist() for s in (5, 9, 17, 3)[:n]]


def test_programs_one_per_bucket_eager_on_cpu():
    eng = _engine("cpu")
    progs = eng.programs
    assert not progs.capture and progs.pool is None
    g = progs.jacobi(2, 8, False, -1, False)
    assert progs.jacobi(2, 8, False, -1, False) is g
    assert progs.jacobi(2, 8, True, -1, False) is not g
    assert progs.jacobi(2, 8, True, 5, False) is not progs.jacobi(2, 8, True, -1, False)
    assert g.buf.draft.shape == (2, 8) and g.buf.tokens.shape == (2, eng.cap_tokens)
    a = progs.ar(4)
    assert a is progs.ar(4) and a.block_tables.shape == (4, eng.pages_bucket)
    eng.generate(_prompts(), SamplingParams(temperature=0.0, max_tokens=8,
                                            decode_strategy="jacobi", jacobi_block_len=8))
    assert progs.num_graphs == 0 and not progs.launches
    assert ("jacobi", 4, 8) in progs.programs and ("ar", 2) not in progs.programs


def test_replays_count_the_graph_launches_of_every_counter():
    """A replay adds a captured graph's launches to each wrapper count,
    kernel 1's warp-specialised launches (`ws_launches`) among them."""
    from jacobiforcing_tpu_torch.engine import graphs

    progs = _engine("cpu").programs
    counters = graphs._kernel_counters()
    assert (pac.paged_attention_cuda, "launches") in counters
    assert (pac.paged_attention_cuda, "ws_launches") in counters
    captured = [28 + 3 * n for n in range(len(counters))]
    progs.launches[("fake",)] = captured

    class FakeGraph:
        replays = 0

        def replay(self):
            FakeGraph.replays += 1

    before = [getattr(f, name) for f, name in counters]
    try:
        replay = progs._replay(("fake",), FakeGraph(), "out")
        assert replay() == "out" and replay() == "out"
        assert FakeGraph.replays == 2
        after = [getattr(f, name) for f, name in counters]
        assert [a - b for a, b in zip(after, before)] == [2 * n for n in captured]
    finally:
        for (f, name), b in zip(counters, before):
            setattr(f, name, b)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs capture only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("sp", [
    SamplingParams(temperature=0.0, max_tokens=24),
    SamplingParams(temperature=0.0, max_tokens=24, decode_strategy="jacobi",
                   jacobi_block_len=8, jacobi_max_iterations=256),
    SamplingParams(temperature=0.7, max_tokens=24, decode_strategy="jacobi_nongreedy",
                   jacobi_block_len=8, jacobi_max_iterations=256),
    SamplingParams(temperature=0.7, top_k=5, top_p=0.9, max_tokens=24,
                   decode_strategy="jacobi_nongreedy", jacobi_block_len=8,
                   jacobi_max_iterations=256),
], ids=["ar", "jacobi", "nongreedy", "nongreedy_top_k_top_p"])
def test_graphs_equal_eager_on_cuda(cuda, sp):
    """The same kernels in the same order, the same random draws: graph
    replays give the eager engine's tokens and loop trips, and the kernel's
    launch count grows by the graph's launches at each replay (plus the one
    eager run before each capture)."""
    outs, stats = {}, {}
    for eager in (True, False):
        eng = _engine("cuda", eager, jacobi_async_host=False)
        pac.paged_attention_cuda.launches = 0
        outs[eager] = [o["token_ids"] for o in eng.generate(_prompts(), sp)]
        warm = eng.programs.num_graphs * eng.model_cfg.num_layers
        stats[eager] = (eng.stats["chunk_forwards"], eng.stats["ar_steps"],
                        pac.paged_attention_cuda.launches - warm)
        assert eng.programs.capture == (not eager)
        assert (eng.programs.num_graphs > 0) == (not eager)
    assert outs[True] == outs[False]
    assert stats[True] == stats[False]


@pytest.mark.cuda
def test_ws_launches_through_graphs_on_cuda(cuda):
    """A bf16 model over a bf16 cache runs kernel 1's warp-specialised design
    at every launch, eager or replayed: `ws_launches` grows with `launches`."""
    mc = tq.ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=64, max_position=1024,
                        dtype=torch.bfloat16)
    sp = SamplingParams(temperature=0.0, max_tokens=24, decode_strategy="jacobi",
                        jacobi_block_len=8, jacobi_max_iterations=256)
    for eager in (True, False):
        cfg = Config(kvcache_page_size=16, max_model_len=256, jacobi_chunk_tokens=32,
                     prefill_token_buckets=(32, 64, 128, 256), eos=-1, batch_buckets=(1, 2, 4),
                     jacobi_async_host=False, enforce_eager=eager)
        eng = LLMEngine(cfg, model_cfg=mc, params=tq.init_params(mc, 0, device="cuda"),
                        num_kv_pages=128, device="cuda")
        k1, ws = pac.paged_attention_cuda.launches, pac.paged_attention_cuda.ws_launches
        eng.generate(_prompts(), sp)
        assert pac.paged_attention_cuda.launches - k1 > 0
        assert pac.paged_attention_cuda.ws_launches - ws == pac.paged_attention_cuda.launches - k1
        assert (eng.programs.num_graphs > 0) == (not eager)


@pytest.mark.cuda
def test_failed_capture_raises(cuda):
    """A trip that reads the device back cannot be captured: the capture
    raises, and nothing runs eagerly in its place."""
    progs = _engine("cuda").programs
    x = torch.arange(8, device="cuda")
    with pytest.raises(RuntimeError):
        progs._capture(("bad",), lambda: torch.nonzero(x > 3))
    assert ("bad",) not in progs.capture_s
