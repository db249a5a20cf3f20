"""The serving host path of the port: the one-chunk-lag speculative pipeline,
the fixed-shape KV write, `warmup`, `utils/profiling` and
`apps/bench_engine` (the CUDA graphs: tests/test_torch_graphs.py).

On the CPU, against the port's own synchronous engine and the JAX engine
(`tests/test_engine.py`'s tiny fp64 model, its weights carried over):
  * async == sync token for token, and in `jacobi_iterations` /
    `chunk_forwards` where both engines run the same chunks (the JAX test's
    setting); with backfills into four slots, or preemptions, the async
    engine runs one speculative chunk before the backfill's prefill, so its
    batches (and the random draft tails, hence the counts) differ: tokens
    must still be equal;
  * the port's async engine == the JAX async engine token for token, and
    non-greedy top_k=1 too; non-greedy T 0.7 async == sync under one seed;
  * MR with a rotating locked arm, async, == greedy AR; the single-arm
    probe lands the pipeline before its timed window opens (the JAX engine
    flushes inside it, `llm_engine.py:920-921`);
  * `write_kv` / `write_kv_scaled` == the jitted JAX functions for masked,
    -1-page and out-of-range slots, and nothing reads the trash rows.
Tokens and counters are compared exactly: no tolerance.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jacobiforcing_tpu.config import SamplingParams as JSamplingParams
from jacobiforcing_tpu.ops import kv_cache as jkv
from jacobiforcing_tpu_torch.config import Config, SamplingParams
from jacobiforcing_tpu_torch.engine import llm_engine, mr_policy
from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine
from jacobiforcing_tpu_torch.models import qwen as tq
from jacobiforcing_tpu_torch.ops import kv_cache as tkv
from jacobiforcing_tpu_torch.ops.attention import paged_attention_ref
from jacobiforcing_tpu_torch.utils import profiling
from tests import test_engine as jtests
from tests.test_torch_quant import _raw_bytes
from tests.test_torch_sampling import make_engine

MR = "jacobi_multiblock_rejection_recycling"
PROMPTS12 = (5, 9, 17, 3, 11, 7, 21, 4, 13, 6, 8, 15)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Several worker processes share the CPU: two torch threads each keep
    the engines' many small ops from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jac_sps(cls, n, base=10, step=7, L=8):
    return [cls(temperature=0.0, max_tokens=base + (i % 3) * step, decode_strategy="jacobi",
                jacobi_block_len=L, jacobi_max_blocks=1, jacobi_max_iterations=256)
            for i in range(n)]


def _run(async_on, prompts, sps, **kw):
    eng = make_engine(jacobi_async_host=async_on, **kw)
    outs = eng.generate(prompts, sps)
    assert not eng._pending, "pending chunks must drain by completion"
    return [o["token_ids"] for o in outs], eng


COUNTS = ("jacobi_iterations", "chunk_forwards", "generated_tokens")


def test_config_defaults_and_cpu_never_captures():
    cfg = Config()
    assert cfg.jacobi_async_host and not cfg.enforce_eager
    eng = make_engine()
    assert eng.config.jacobi_async_host and not eng.programs.capture
    assert eng.programs.pool is None


@pytest.mark.parametrize("chunk_iters", [0, 3])
def test_async_equals_sync(chunk_iters):
    """12 requests, staggered max_tokens, batches of at most 4 (the JAX
    test's setting, tests/test_engine.py:681): tokens and counters equal."""
    prompts = jtests.make_prompts(256, sizes=PROMPTS12)
    sps = _jac_sps(SamplingParams, len(prompts))
    kw = dict(num_pages=48, jacobi_chunk_iters=chunk_iters, batch_buckets=(1, 2, 4))
    a, ea = _run(True, prompts, sps, **kw)
    s, es = _run(False, prompts, sps, **kw)
    assert a == s
    assert {k: ea.stats[k] for k in COUNTS} == {k: es.stats[k] for k in COUNTS}


@pytest.mark.parametrize("kw", [
    dict(num_pages=48, max_num_seqs=4),  # backfills into four slots
    dict(num_pages=10, jacobi_chunk_tokens=32),  # preemptions (flushed first)
], ids=["backfill", "preempt"])
def test_async_equals_sync_with_backfill_and_preemption(kw):
    prompts = jtests.make_prompts(256, sizes=PROMPTS12)
    base = 24 if kw["num_pages"] == 10 else 10
    sps = _jac_sps(SamplingParams, len(prompts), base=base)
    kw = dict(kw, jacobi_chunk_iters=3, batch_buckets=(1, 2, 4))
    a, ea = _run(True, prompts, sps, **kw)
    s, es = _run(False, prompts, sps, **kw)
    assert a == s
    if kw["num_pages"] == 10:
        assert ea.scheduler.num_preemptions > 0 and es.scheduler.num_preemptions > 0


@pytest.mark.parametrize("eos", [117, 208])
def test_async_equals_sync_two_groups_with_eos(eos):
    """Two block lengths (two groups) and an EOS the model emits: a group
    whose membership changes flushes the other group's pending chunk, which
    can commit an EOS before the scheduler retires that sequence; the next
    chunk, built on the host, must keep it inert (with EOS 117 the stream
    runs past it otherwise)."""
    prompts = jtests.make_prompts(256, sizes=PROMPTS12)
    sps = [SamplingParams(temperature=0.0, max_tokens=20 + (i % 3) * 9, decode_strategy="jacobi",
                          jacobi_block_len=8 if i % 2 else 4, jacobi_max_blocks=1,
                          jacobi_max_iterations=256) for i in range(len(prompts))]
    kw = dict(batch_buckets=(1, 2, 4), jacobi_chunk_iters=2, eos=eos)
    assert _run(True, prompts, sps, **kw)[0] == _run(False, prompts, sps, **kw)[0]


@pytest.mark.parametrize("chunk_iters", [0, 3])
def test_async_port_equals_jax_async(chunk_iters):
    prompts = jtests.make_prompts(256, sizes=PROMPTS12)
    kw = dict(num_pages=48, jacobi_chunk_iters=chunk_iters, batch_buckets=(1, 2, 4))
    j = jtests.make_engine(**kw)
    assert j.config.jacobi_async_host
    jout = [o["token_ids"] for o in j.generate(prompts, _jac_sps(JSamplingParams, 12))]
    tout, _ = _run(True, prompts, _jac_sps(SamplingParams, 12), **kw)
    assert tout == jout


def test_async_nongreedy_equals_sync_and_top_k1_equals_jax():
    """Sampled chunks share the pipeline: one seed gives one stream in both
    modes (tests/test_engine.py:712); top_k=1 equals the JAX async engine."""
    prompts = jtests.make_prompts(256, sizes=(5, 9, 7))
    sp = SamplingParams(temperature=0.7, max_tokens=12, decode_strategy="jacobi_nongreedy",
                        jacobi_block_len=8, jacobi_max_blocks=1, jacobi_max_iterations=256)
    a, _ = _run(True, prompts, sp, seed=3)
    s, _ = _run(False, prompts, sp, seed=3)
    assert a == s
    jsp = JSamplingParams(temperature=0.7, top_k=1, max_tokens=12,
                          decode_strategy="jacobi_nongreedy", jacobi_block_len=8,
                          jacobi_max_blocks=1, jacobi_max_iterations=256)
    # top_k=1 draws cannot matter: any engine seed gives the same stream
    jout = [o["token_ids"] for o in jtests.make_engine().generate(prompts, jsp)]
    k1, _ = _run(True, prompts, SamplingParams(**{**sp.__dict__, "top_k": 1}))
    assert k1 == jout


def _mr_sp():
    return SamplingParams(temperature=0.0, max_tokens=32, decode_strategy=MR,
                          jacobi_block_len=8, jacobi_max_blocks=2, jacobi_max_iterations=512)


def test_mr_single_arm_locked_async_exact_match(monkeypatch):
    """A LOCKED single arm rides the pipeline; arm switches land it before
    reading host mirrors.  Rotating lock states across every arm each chunk
    (tests/test_engine.py:489) must still match greedy AR exactly."""
    counter = {"i": -1, "single_chunks": 0}

    def rotating_locked_pick(self):
        counter["i"] += 1
        arm = counter["i"] % self.n_arms
        self.locked = arm  # a locked single arm takes the async path
        counter["single_chunks"] += arm == mr_policy.ARM_SINGLE
        return arm

    monkeypatch.setattr(mr_policy.MRAutoPolicy, "pick", rotating_locked_pick)
    prompts = jtests.make_prompts(256)
    eng = make_engine(jacobi_mr_auto_policy=True, jacobi_chunk_iters=2)
    out = eng.generate(prompts, _mr_sp())
    assert counter["single_chunks"] >= 2 and eng.stats.get("mr_single", 0) > 0
    assert not eng._pending
    ar = make_engine().generate(prompts, SamplingParams(temperature=0.0, max_tokens=32))
    assert [o["token_ids"] for o in out] == [o["token_ids"] for o in ar]


def test_single_arm_probe_flushes_before_its_window(monkeypatch):
    """A probing single-arm chunk that follows a locked (async) one lands
    the pending chunk BEFORE gen0 / t0, so the probe's recorded tokens are
    its own chunk's: a deliberate divergence from the JAX engine, which
    flushes inside the window (`llm_engine.py:920-921`)."""
    log = []
    arms = iter([mr_policy.ARM_SINGLE] * 1000)
    state = {"n": 0}

    def pick(self):
        state["n"] += 1
        # locked on the single arm, then every third chunk a probe of it
        self.locked = None if state["n"] % 3 == 0 else mr_policy.ARM_SINGLE
        log.append(("pick", self.locked))
        return next(arms)

    def record(self, arm, toks, dt, slots=1, drained=False):
        log.append(("record", toks))

    orig_flush = LLMEngine._flush_pending

    def flush(self):
        touched = orig_flush(self)
        log.append(("flush",))
        return touched

    orig_commit = LLMEngine._commit_chunk

    def commit(self, pending):
        g0 = self.stats["generated_tokens"]
        orig_commit(self, pending)
        log.append(("commit", self.stats["generated_tokens"] - g0))

    class Clock:
        @staticmethod
        def perf_counter():
            log.append(("clock",))
            return time.perf_counter()

    monkeypatch.setattr(mr_policy.MRAutoPolicy, "pick", pick)
    monkeypatch.setattr(mr_policy.MRAutoPolicy, "record", record)
    monkeypatch.setattr(LLMEngine, "_flush_pending", flush)
    monkeypatch.setattr(LLMEngine, "_commit_chunk", commit)
    eng = make_engine(jacobi_mr_auto_policy=True, jacobi_chunk_iters=2)
    prompts = jtests.make_prompts(256)[:2]
    monkeypatch.setattr(llm_engine, "time", Clock)
    out = eng.generate(prompts, _mr_sp())
    monkeypatch.undo()
    probes = [i for i, e in enumerate(log) if e == ("pick", None)]
    checked = 0
    for i in probes:
        seg = log[i + 1 : next((j for j in range(i + 1, len(log)) if log[j][0] == "pick"),
                               len(log))]
        kinds = [e[0] for e in seg]
        if "flush" not in kinds:
            continue  # nothing was pending (the first chunk)
        # flush (with the pending chunk's commit), then t0, the probe's own
        # commit, the wall, and the record of exactly that commit's tokens
        assert kinds.index("flush") < kinds.index("clock"), kinds
        first_clock = kinds.index("clock")
        own = [e[1] for e in seg[first_clock:] if e[0] == "commit"]
        rec = [e[1] for e in seg if e[0] == "record"]
        assert len(own) == 1 and rec == own, seg
        checked += 1
    assert checked >= 2
    ar = make_engine().generate(prompts, SamplingParams(temperature=0.0, max_tokens=32))
    assert [o["token_ids"] for o in out] == [o["token_ids"] for o in ar]


def test_generate_stream_under_async_equals_generate():
    prompt = jtests.make_prompts(256)[2]
    sp = _jac_sps(SamplingParams, 1, base=24)[0]
    eng = make_engine(jacobi_chunk_tokens=8)
    chunks = list(eng.generate_stream(prompt, sp))
    assert len(chunks) >= 2 and not eng._pending
    assert sum(chunks, []) == make_engine(jacobi_async_host=False).generate(
        [prompt], sp)[0]["token_ids"]


def test_warmup_tags_pages_and_clean_state():
    """`warmup` drives dummy requests through the real buckets (the graph
    captures on the card), frees their pages, clears the MR policies and
    does not perturb generation (tests/test_engine.py:189)."""
    eng = make_engine()
    free0 = eng.block_manager.num_free_pages
    t = eng.warmup(strategies=("ar", "jacobi", "mr"), block_lens=(8,), batch_buckets=(1, 2),
                   prefill_token_buckets=(32, 64))
    assert set(t) == {
        "ar_B1", "ar_B2", "prefill_ar_T32", "prefill_ar_T64",
        "jacobi_L8_B1", "jacobi_L8_B2", "prefill_jacobi_L8_T32", "prefill_jacobi_L8_T64",
        "mr_L8_B1", "mr_L8_B2", "prefill_mr_L8_T32", "prefill_mr_L8_T64",
    }
    assert eng.block_manager.num_free_pages == free0
    assert eng.scheduler.is_finished and not eng._pending and not eng._mr_policies
    assert {("ar", 1), ("ar", 2), ("jacobi", 1, 8), ("jacobi", 2, 8)} <= set(eng.programs.programs)
    t2 = make_engine().warmup(strategies=("mr",), block_lens=(8,), batch_buckets=(1,),
                              prefill_token_buckets=(32,))
    assert {"mr_L8_B1", "jacobi_L8_B1", "ar_B1"} <= set(t2)
    prompts = jtests.make_prompts(256)
    sp = _jac_sps(SamplingParams, 1, base=16)[0]
    assert eng.generate(prompts, sp) == make_engine().generate(prompts, sp)


def test_profiler_counters_and_report(monkeypatch):
    """PROFILE=1 (tests/test_apps.py:72): the engine's spans record, and the
    report over a window's stats delta holds each span's total and self
    time, the counters, tokens per forward and per second, and one program
    per bucket (eagerly none is a CUDA graph).  Nothing waits for the
    device on the profiler's behalf."""
    monkeypatch.setenv("PROFILE", "1")
    eng = make_engine()
    assert eng.spans.requested
    before = dict(eng.stats)
    eng.generate(jtests.make_prompts(256)[:2], _jac_sps(SamplingParams, 1, base=12)[0])
    delta = profiling.stats_delta(before, eng.stats)
    assert delta["generated_tokens"] >= 24 and delta["jacobi_iterations"] >= 1
    assert delta["trip_slots"] >= delta["jacobi_iterations"]
    assert ("jacobi", 2, 8) in eng.programs.programs and eng.programs.num_graphs == 0
    rep = profiling.report(delta, 1.0, eng.programs)
    for name in ("step", "schedule", "prefill", "dispatch", "trips", "trips.wait", "commit",
                 "commit.wait"):
        assert f"\n  {name} " in rep, name
    assert "tokens_per_forward" in rep and "tokens_per_second" in rep and "programs: " in rep
    assert not hasattr(eng, "_sync")
    monkeypatch.delenv("PROFILE")
    assert not make_engine().spans.requested


# keys of the JAX app's result (jacobiforcing_tpu/apps/bench_engine.py)
BENCH_KEYS = {
    "metric", "value", "unit", "strategy", "steady_window_s", "steady_iters_per_s",
    "steady_occupancy", "overall_tps_at_tpf4", "iters_per_s", "forwards", "ms_per_forward",
    "batch_occupancy", "committed_tok_per_s", "wall_s", "prompt_len", "max_tokens", "requests",
    "committed_tok_per_s_steady",
}


def test_engine_bench_smoke():
    """run_engine_bench end to end on a tiny model (tests/test_apps.py:266):
    continuous batching with backfill, the steady-state window, the JAX
    app's metric name and keys."""
    from jacobiforcing_tpu_torch.apps.bench_engine import run_engine_bench

    mc = tq.ModelConfig.tiny(vocab_size=128)
    params = tq.init_params(mc, 0, device="cpu")
    out = run_engine_bench(
        B=2, prompt_len=24, max_tokens=16, L=8, chunk_iters=4, requests=5,
        max_model_len=128, chunk_tokens=16, model_cfg=mc, params=params, device="cpu",
    )
    assert out["metric"] == "engine_tps_at_tpf4_64h2L_B2_L8"
    assert set(out) == BENCH_KEYS
    for k in ("value", "steady_iters_per_s", "steady_occupancy", "ms_per_forward",
              "batch_occupancy", "committed_tok_per_s"):
        assert out[k] > 0, (k, out)
    assert out["requests"] == 5


# ---- the fixed-shape KV write ------------------------------------------------

PAGE = 16
KV_KINDS = {"f32": (torch.float32, jnp.float32), "fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
            "int8": (torch.int8, jnp.int8)}


def _forward_slots(num_slots):
    """[B, T] slots as `forward` makes them: a block table with -1 pages, a
    write mask, and positions past the table; unwritten tokens -> num_slots."""
    bt = np.asarray([[2, -1, 0], [3, 1, -1]], np.int32)
    pos = np.asarray([[3, 20, 37, 5, 60], [0, 17, 40, 33, 47]], np.int64)
    mask = np.asarray([[1, 1, 1, 0, 1], [1, 0, 1, 1, 1]], bool)
    page = bt[np.arange(2)[:, None], np.clip(pos // PAGE, 0, bt.shape[1] - 1)].astype(np.int64)
    slots = np.where(mask, page * PAGE + pos % PAGE, num_slots)
    slots = np.where(page < 0, num_slots, slots)
    slots[1, 4] = num_slots + 7  # out of range
    return slots.astype(np.int32)


@pytest.mark.parametrize("kind", list(KV_KINDS))
def test_fixed_shape_write_equals_jax(kind):
    tdt, jdt = KV_KINDS[kind]
    r = np.random.RandomState(11)
    KH, D, num_slots = 2, 16, 4 * PAGE
    k_new = (r.randn(2, 5, KH, D) * 300).astype(np.float32)
    v_new = (r.randn(2, 5, KH, D) * 3).astype(np.float32)
    slots = _forward_slots(num_slots)
    jc = jkv.alloc_kv_cache(1, 4, PAGE, KH, D, jdt)
    tc = tkv.alloc_kv_cache(1, 4, PAGE, KH, D, tdt)
    args = (jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(slots))
    targs = (torch.from_numpy(k_new), torch.from_numpy(v_new), torch.from_numpy(slots))
    if tc.scaled:
        jout = jax.jit(jkv.write_kv_scaled)(jc.k[0], jc.v[0], jc.k_scale[0], jc.v_scale[0], *args)
        tout = tkv.write_kv_scaled(tc.k[0], tc.v[0], tc.k_scale[0], tc.v_scale[0], *targs)
    else:
        jout = jax.jit(jkv.write_kv)(jc.k[0], jc.v[0], *args)
        tout = tkv.write_kv(tc.k[0], tc.v[0], *targs)
    for got, want in zip(tout, jout):
        np.testing.assert_array_equal(_raw_bytes(got), _raw_bytes(want))
    # the dropped tokens went to the trash row, nowhere else
    trash = tkv.with_trash(tkv.storage_view(tc.k[0]), 1)[-1]
    assert bool((trash != 0).any())


def test_write_plan_fixed_shape_and_trash_rows():
    slots = torch.from_numpy(_forward_slots(64))
    dest = tkv.write_plan(slots, 64, 2)
    assert dest.shape == (2 * slots.numel(),)
    assert int((dest == 128).sum()) == 2 * int(((slots < 0) | (slots >= 64)).sum())
    kv = tkv.alloc_kv_cache(3, 4, PAGE, 2, 16, torch.float32)
    assert kv.k[1].is_contiguous() and kv.k.shape == (3, 2, 64, 16)
    assert tkv.with_trash(kv.k, 1).shape == (3, 129, 16)
    assert tkv.with_trash(kv.k[2], 1).shape == (129, 16)
    with pytest.raises(ValueError, match="trash"):
        tkv.with_trash(torch.zeros(2, 64, 16), 1)  # a bare layer has no trash row


def test_trash_rows_are_never_read():
    """Poisoned trash rows change no attention output, and no gather reaches
    them: block tables name only real pages."""
    r = np.random.RandomState(5)
    KH, D, B, T = 2, 16, 2, 4
    kv = tkv.alloc_kv_cache(1, 4, PAGE, KH, D, torch.float64)
    kv.k[0].copy_(torch.from_numpy(r.randn(KH, 64, D)))
    kv.v[0].copy_(torch.from_numpy(r.randn(KH, 64, D)))
    bt = torch.tensor([[2, -1, 0, 3], [3, 1, -1, -1]], dtype=torch.int32)
    q = torch.from_numpy(r.randn(B, T, 2 * KH, D))
    lens = torch.tensor([60, 30], dtype=torch.int32)
    pos = (lens - T)[:, None] + torch.arange(T, dtype=torch.int32)[None]

    def attend():
        return paged_attention_ref(q, kv.k[0], kv.v[0], bt, lens, pos, 0.25, page_size=PAGE)

    clean = attend()
    tkv.with_trash(kv.k, 1)[:, -1] = float("nan")
    tkv.with_trash(kv.v, 1)[:, -1] = float("inf")
    poisoned = attend()
    assert torch.isfinite(poisoned).all()
    assert torch.equal(clean, poisoned)
