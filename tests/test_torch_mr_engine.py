"""Multiblock + rejection recycling (MR) through the port's serving engine.

The port's counterparts of tests/test_multiblock.py and of the MR tests of
tests/test_engine.py and tests/test_modeling_and_legacy.py (greedy MR must
equal greedy AR token for token, whatever arm the auto-policy serves), and
the port against the JAX engine on the same tiny fp64 model: the same token
streams, and with the auto-policy off (the MR arms draw only from the shared
host `RandomState`) the same iteration, chunk and tier counts.  Tokens and
counters are compared exactly: no tolerance.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from jacobiforcing_tpu.config import SamplingParams as JSamplingParams
from jacobiforcing_tpu.models import qwen as jq
from jacobiforcing_tpu_torch import LLM, modeling
from jacobiforcing_tpu_torch.config import Config, SamplingParams
from jacobiforcing_tpu_torch.engine import mr_policy
from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine
from jacobiforcing_tpu_torch.models import qwen as tq
from jacobiforcing_tpu_torch.utils.loader import params_from_numpy
from tests import test_engine as jtests

PAGE = 16
MR = "jacobi_multiblock_rejection_recycling"
DEMO = os.path.join(os.path.dirname(__file__), "..", "assets", "tpf_demo_n32_v7")


def tiny_params(seed=0):
    """The JAX tests' tiny model (tests/test_engine.make_engine), carried over."""
    jparams = jq.init_params(jq.ModelConfig.tiny(), jax.random.PRNGKey(seed))
    return tq.ModelConfig.tiny(), params_from_numpy(jax.tree.map(np.asarray, jparams))


def make_engine(num_pages=128, seed=0, **cfg_kw):
    mc, params = tiny_params(seed)
    defaults = dict(kvcache_page_size=PAGE, max_model_len=256, jacobi_chunk_tokens=32,
                    prefill_token_buckets=(32, 64, 128, 256), eos=-1)
    defaults.update(cfg_kw)
    return LLMEngine(Config(**defaults), model_cfg=mc, params=params, num_kv_pages=num_pages,
                     device="cpu")


make_prompts = jtests.make_prompts


def _mr_sp(max_tokens, N=8, K=2, pool=4, r=0.8, la=0.0, max_iters=256, cls=SamplingParams):
    return cls(
        temperature=0.0, max_tokens=max_tokens, decode_strategy=MR,
        jacobi_block_len=N, jacobi_max_blocks=K, jacobi_n_gram_pool_size=pool,
        jacobi_spawn_ratio=r, jacobi_lookahead_start_ratio=la, jacobi_max_iterations=max_iters,
    )


def _ar(prompts, max_tokens, **kw):
    return make_engine(**kw).generate(
        prompts, SamplingParams(temperature=0.0, max_tokens=max_tokens))


def _same(a, b):
    assert [o["token_ids"] for o in a] == [o["token_ids"] for o in b]


# ---- tests/test_multiblock.py ------------------------------------------------


@pytest.mark.parametrize("K", [1, 2])
def test_mr_equals_ar_single(K):
    prompts = make_prompts(256)[:2]
    ar = _ar(prompts, 24)
    mr = make_engine().generate(prompts, _mr_sp(24, K=K))
    for a, m in zip(ar, mr):
        assert m["token_ids"][:24] == a["token_ids"], K


def test_mr_equals_ar_k3():
    prompts = make_prompts(256)[:1]
    mr = make_engine().generate(prompts, _mr_sp(20, K=3, r=0.5))
    assert mr[0]["token_ids"][:20] == _ar(prompts, 20)[0]["token_ids"]


def test_mr_eos_stop():
    prompts = make_prompts(256)[:1]
    probe = _ar(prompts, 32)
    eos = probe[0]["token_ids"][9]
    ids = make_engine(eos=eos).generate(prompts, _mr_sp(32))[0]["token_ids"]
    assert ids[-1] == eos and eos not in ids[:-1]
    assert ids == probe[0]["token_ids"][: len(ids)]


def test_mr_makes_multi_token_progress():
    eng = make_engine()
    out = eng.generate(make_prompts(256)[:1], _mr_sp(24))
    assert len(out[0]["token_ids"]) >= 24
    assert eng.stats["generated_tokens"] >= eng.stats["jacobi_iterations"]


def test_mr_batched_equals_individual():
    """A BATCH of MR requests (mixed prompt lengths) decodes to exactly the
    per-request outputs, sharing chunks."""
    prompts = make_prompts(256)  # 4 prompts, lengths 5/9/17/3
    sp = _mr_sp(20)
    eng = make_engine(num_pages=512)
    batch_out = eng.generate(prompts, sp)
    assert eng.stats["chunk_calls"] < 4 * 3
    for i, p in enumerate(prompts):
        solo = make_engine(num_pages=512).generate([p], sp)
        assert batch_out[i]["token_ids"] == solo[0]["token_ids"], i


# ---- the MR tests of tests/test_engine.py -----------------------------------


def test_chunk_iters_mode_mr_exact_match():
    """MR verification is greedy and draws no randomness, so any trip budget
    commits the same tokens as token-budget chunking, and both match AR."""
    prompts = make_prompts(256, sizes=(5, 9, 17, 3))
    sp = _mr_sp(24)
    tok_mode = make_engine().generate(prompts, sp)
    for trips in (1, 3, 7):
        _same(tok_mode, make_engine(jacobi_chunk_iters=trips).generate(prompts, sp))
    _same(_ar(prompts, 24), tok_mode)


def test_mr_auto_policy_engine_exact_match():
    """With the auto-policy switching arms aggressively, MR output still
    matches plain MR and greedy AR: the arm is invisible in the stream."""
    prompts = make_prompts(256, sizes=(5, 9, 17))
    sp = _mr_sp(24, max_iters=512)
    plain = make_engine(jacobi_mr_auto_policy=False).generate(prompts, sp)
    eng = make_engine(jacobi_mr_auto_policy=True, jacobi_mr_probe_chunks=1,
                      jacobi_mr_reprobe_every=6, jacobi_chunk_tokens=8)
    _same(plain, eng.generate(prompts, sp))
    snap = eng.mr_policy_snapshot()
    assert snap, "policy never engaged"
    (_, s), = snap.items()
    assert s["calls"] >= 3
    _same(_ar(prompts, 24), plain)


def test_mr_single_arm_forced_exact_match(monkeypatch):
    """JF_MR_FORCE_ARM=3 serves MR requests entirely through the single-block
    program (MR -> single handoff at the first chunk)."""
    monkeypatch.setenv("JF_MR_FORCE_ARM", "3")
    prompts = make_prompts(256, sizes=(5, 9, 17, 3))
    eng = make_engine(jacobi_mr_auto_policy=True)
    out = eng.generate(prompts, _mr_sp(24, max_iters=512))
    assert eng.stats.get("mr_single", 0) > 0
    assert eng.stats.get("mr_full", 0) == 0  # the MR program never ran
    _same(_ar(prompts, 24), out)


def test_mr_single_arm_cycling_exact_match(monkeypatch):
    """Every arm in rotation, one per chunk: each rotation exercises both
    handoffs (MR state -> sliding draft, and the single -> MR re-entry with
    its verified-continuation forward)."""
    counter = {"i": -1}

    def cycling_pick(self):
        counter["i"] += 1
        return counter["i"] % self.n_arms

    monkeypatch.setattr(mr_policy.MRAutoPolicy, "pick", cycling_pick)
    prompts = make_prompts(256, sizes=(5, 9, 17, 3))
    eng = make_engine(jacobi_mr_auto_policy=True, jacobi_chunk_iters=2)
    out = eng.generate(prompts, _mr_sp(32, max_iters=512))
    assert counter["i"] >= 7, "rotation did not cover all arms"
    assert eng.stats.get("mr_single", 0) > 0
    _same(_ar(prompts, 32), out)


@pytest.mark.parametrize("arm", ["7", "-1"])
def test_force_arm_outside_the_arms_raises(monkeypatch, arm):
    monkeypatch.setenv("JF_MR_FORCE_ARM", arm)
    eng = make_engine(jacobi_mr_auto_policy=True)
    with pytest.raises(ValueError, match="JF_MR_FORCE_ARM"):
        eng.generate(make_prompts(256)[:1], _mr_sp(8))


def test_mr_needs_greedy_sampling():
    sp = SamplingParams(temperature=0.7, decode_strategy=MR)
    with pytest.raises(NotImplementedError):
        make_engine().add_request([1, 2, 3], sp)


def test_config_takes_the_mr_options():
    """The options MR reads are served now; a non-default value of each is kept."""
    kw = dict(pad=0, jacobi_spawn_ratio=0.5, jacobi_lookahead_start_ratio=0.25,
              jacobi_n_gram_pool_size=2, jacobi_mr_auto_policy=False, jacobi_mr_probe_chunks=2,
              jacobi_mr_reprobe_every=64, jacobi_mr_single_arm=False)
    cfg = Config(**kw)
    assert {k: getattr(cfg, k) for k in kw} == kw
    eng = make_engine(jacobi_mr_single_arm=False, jacobi_mr_probe_chunks=1,
                      jacobi_mr_reprobe_every=6, jacobi_chunk_tokens=8, pad=0)
    prompts = make_prompts(256)[:2]
    _same(_ar(prompts, 16), eng.generate(prompts, _mr_sp(16)))
    (_, snap), = eng.mr_policy_snapshot().items()
    assert len(snap["n"]) == 3 and "mr_single" not in eng.stats  # three arms only


# ---- preemption ---------------------------------------------------------------


def test_mr_preemption_under_page_pressure():
    """MR requests under a tight page pool: a preempted request keeps its
    `mb_state` (the positions are semantic), loses its drafts, is prefilled
    again, and still decodes to the ample-pool and AR streams."""
    prompts = make_prompts(256, sizes=(20, 20, 20, 20), rng=3)
    sp = _mr_sp(40)
    ample = make_engine(num_pages=256, jacobi_mr_auto_policy=False).generate(prompts, sp)
    tight_engine = make_engine(num_pages=12, jacobi_mr_auto_policy=False)
    tight = tight_engine.generate(prompts, sp)
    assert tight_engine.scheduler.num_preemptions > 0
    _same(ample, tight)
    _same(_ar(prompts, 40, num_pages=256), ample)


def test_preempt_keeps_mb_state_and_drops_drafts():
    eng = make_engine(jacobi_mr_auto_policy=False, jacobi_chunk_tokens=8)
    seq = eng.add_request(make_prompts(256)[0], _mr_sp(24))
    eng.step()  # prefill
    eng.step()  # one MR chunk of at most 8 tokens
    assert seq.mb_state is not None and not seq.is_finished
    state = seq.mb_state
    seq.draft = np.zeros(8, np.int32)
    eng.scheduler.preempt(seq)
    assert seq.mb_state is state and seq.draft is None and seq.prefill_draft is None
    while not eng.scheduler.is_finished:
        eng.step()
    assert seq.completion_token_ids == _ar([seq.token_ids[: seq.num_prompt_tokens]], 24)[0]["token_ids"]


# ---- the per-call API -----------------------------------------------------------


def test_modeling_multiblock_matches_ar():
    mc, params = tiny_params()
    prompts = make_prompts(256)[:1]
    out, stats = modeling.jacobi_generate_multiblock(
        params, mc, prompts[0], n_token_seq_len=8, K=2, r=0.8, max_new_tokens=20, page_size=16,
        device="cpu")
    assert out[:20] == _ar(prompts, 20)[0]["token_ids"]
    assert stats["tokens_per_forward"] >= 1.0
    greedy, _ = modeling.jacobi_generate_greedy(
        params, mc, prompts[0], n_token_seq_len=8, max_new_tokens=20, page_size=16, device="cpu")
    assert greedy[:20] == out[:20]


# ---- across packages ------------------------------------------------------------


@pytest.mark.parametrize("K,pool,chunk_iters", [(2, 4, 0), (3, 2, 2), (1, 1, 0)])
def test_port_engine_equals_jax_engine_policy_off(K, pool, chunk_iters):
    """Policy off: the MR arms draw only from the host RandomState both
    engines share, so tokens AND iteration / chunk / tier counters agree."""
    prompts = make_prompts(256)
    kw = dict(jacobi_mr_auto_policy=False, jacobi_chunk_iters=chunk_iters)
    jeng = jtests.make_engine(**kw)
    j = jeng.generate(prompts, _mr_sp(24, K=K, pool=pool, r=0.5, cls=JSamplingParams))
    eng = make_engine(**kw)
    t = eng.generate(prompts, _mr_sp(24, K=K, pool=pool, r=0.5))
    _same(j, t)
    for key in ("jacobi_iterations", "chunk_calls", "chunk_forwards", "generated_tokens",
                "mr_full", "mr_nocand", "mr_ra_only"):
        assert eng.stats.get(key, 0) == jeng.stats.get(key, 0), key


@pytest.mark.parametrize("kw", [
    dict(quantization="w8a8", kv_cache_dtype="fp8"), dict(quantization="int8", kv_cache_dtype="int8"),
], ids=lambda kw: "+".join(kw.values()))
def test_quantized_port_engine_equals_jax_engine_policy_off(kw):
    """Quantized weights and a scaled KV cache under MR with the policy off:
    tokens and every iteration / chunk / tier counter equal the JAX engine's,
    and the stream equals the same engine's AR stream."""
    prompts = make_prompts(256)
    kw = dict(jacobi_mr_auto_policy=False, **kw)
    jeng = jtests.make_engine(**kw)
    j = jeng.generate(prompts, _mr_sp(24, K=2, pool=4, r=0.5, cls=JSamplingParams))
    eng = make_engine(**kw)
    assert eng.kv.scaled and eng.kv.k.dtype != eng.model_cfg.dtype
    t = eng.generate(prompts, _mr_sp(24, K=2, pool=4, r=0.5))
    _same(j, t)
    for key in ("jacobi_iterations", "chunk_calls", "chunk_forwards", "generated_tokens",
                "mr_full", "mr_nocand", "mr_ra_only"):
        assert eng.stats.get(key, 0) == jeng.stats.get(key, 0), key
    _same(t, _ar(prompts, 24, **kw))


def test_port_engine_equals_jax_engine_policy_on():
    """Policy on: which arm serves a chunk depends on measured wall times, so
    only the token streams are held equal."""
    prompts = make_prompts(256, sizes=(5, 9, 17))
    kw = dict(jacobi_mr_auto_policy=True, jacobi_mr_probe_chunks=1, jacobi_mr_reprobe_every=6,
              jacobi_chunk_tokens=8)
    j = jtests.make_engine(**kw).generate(prompts, _mr_sp(24, cls=JSamplingParams))
    eng = make_engine(**kw)
    _same(j, eng.generate(prompts, _mr_sp(24)))
    assert eng.mr_policy_snapshot()


# ---- the trained demo checkpoint --------------------------------------------------


def test_demo_checkpoint_mr_equals_ar():
    """f32, policy off, N=32, K=2, pool 4: the port's MR stream equals its AR
    stream on the first 16 held-out prompts, and the MR tiers really ran."""
    with open(os.path.join(DEMO, "tpf_demo.json")) as f:
        meta = json.load(f)
    with open(os.path.join(DEMO, "heldout_prompts.jsonl")) as f:
        prompts = [json.loads(line)["prompt_ids"] for line in f][:16]
    llm = LLM(model=DEMO, device="cpu", dtype=torch.float32, num_kv_pages=1024,
              kvcache_page_size=16, max_model_len=512, jacobi_chunk_tokens=64,
              eos=int(meta["eos"]), prefill_token_buckets=(32, 64, 128, 256, 512),
              jacobi_mr_auto_policy=False)
    n = int(meta["max_tokens"])
    ar = llm.generate(prompts, SamplingParams(temperature=0.0, max_tokens=n))
    gen0 = llm.stats["generated_tokens"]
    mr = llm.generate(prompts, _mr_sp(n, N=int(meta["block_len"]), K=2, pool=4, r=0.85,
                                      max_iters=1 << 20))
    _same(ar, mr)
    assert llm.stats["mr_full"] + llm.stats["mr_nocand"] + llm.stats["mr_ra_only"] > 0
    assert llm.stats["generated_tokens"] - gen0 > llm.stats["jacobi_iterations"]  # TPF > 1


def test_mr_policy_log_prints_the_jax_line(monkeypatch, capsys):
    """JF_MR_POLICY_LOG=1 prints the JAX engine's `[mr_policy]` line for every
    policy-dispatched MR chunk, before the policy records it; unset, nothing."""
    prompts = make_prompts(256, sizes=(5, 9))
    sp = _mr_sp(16, max_iters=512)
    make_engine(jacobi_mr_auto_policy=True, jacobi_chunk_tokens=8).generate(prompts, sp)
    assert "[mr_policy]" not in capsys.readouterr().out
    monkeypatch.setenv("JF_MR_POLICY_LOG", "1")
    eng = make_engine(jacobi_mr_auto_policy=True, jacobi_chunk_tokens=8)
    eng.generate(prompts, sp)
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("[mr_policy]")]
    (_, snap), = eng.mr_policy_snapshot().items()
    assert len(lines) == snap["calls"] >= 1
    for l in lines:
        assert all(f" {k}=" in f" {l[12:]}" for k in ("arm", "B", "toks", "wall", "locked",
                                                      "drained"))
