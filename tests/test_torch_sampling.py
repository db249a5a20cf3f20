"""Rejection-sampling (non-greedy) Jacobi in the port against the JAX package.

The same seed-made numpy inputs go through `jacobiforcing_tpu` and
`jacobiforcing_tpu_torch`:
  * `shape_logits` and `target_probs` (top_k in {-1, 1, 5}, top_p in
    {1.0, 0.9, 0.3}, tied values included): fp64 within 1e-12, f32 within
    1e-6 relative;
  * `chunked_token_logprob` with untied, tied, int8 and W8A8 heads, one chunk
    and a vocab_chunk below V with a clamped last chunk: fp64 within 1e-12;
  * `top_k=1` streams token for token: the port's non-greedy engine == the
    JAX non-greedy engine == the port's greedy AR, on the tiny model (both
    chunking modes) and on the demo checkpoint;
  * `temperature > 0` in distribution: no torch generator reproduces
    `jax.random`'s bits, so sampled streams are held to AR sampling by total
    variation, as tests/test_nongreedy.py holds the JAX engine.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jacobiforcing_tpu.config import Config as JConfig
from jacobiforcing_tpu.config import SamplingParams as JSamplingParams
from jacobiforcing_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from jacobiforcing_tpu.models import qwen as jq
from jacobiforcing_tpu.ops import quant as jquant
from jacobiforcing_tpu.ops import sampling as jsampling
from jacobiforcing_tpu.utils.loader import load_checkpoint as jload
from jacobiforcing_tpu_torch import LLM
from jacobiforcing_tpu_torch.config import Config, SamplingParams
from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine
from jacobiforcing_tpu_torch.models import qwen as tq
from jacobiforcing_tpu_torch.ops import sampling as tsampling
from jacobiforcing_tpu_torch.utils.loader import params_from_numpy
from tests import test_engine as jtests
from tests.test_torch_mr_engine import tiny_params

DEMO = os.path.join(os.path.dirname(__file__), "..", "assets", "tpf_demo_n32_v7")
NG = "jacobi_nongreedy"
F64 = dict(rtol=1e-12, atol=1e-12)
F32 = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs several worker processes on the CPU; one torch thread
    per worker keeps the engines' many small ops from oversubscribing the
    cores (the tests' results do not depend on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_engine(num_pages=128, **cfg_kw):
    """The JAX tests' tiny engine (tests/test_engine.make_engine, model seed 0),
    its weights carried over; `seed` in `cfg_kw` seeds the engine's
    generators."""
    mc, params = tiny_params(0)
    defaults = dict(kvcache_page_size=16, max_model_len=256, jacobi_chunk_tokens=32,
                    prefill_token_buckets=(32, 64, 128, 256), eos=-1)
    defaults.update(cfg_kw)
    return LLMEngine(Config(**defaults), model_cfg=mc, params=params, num_kv_pages=num_pages,
                     device="cpu")


def _ng_sp(cls=SamplingParams, **kw):
    base = dict(temperature=1.0, max_tokens=16, decode_strategy=NG, jacobi_block_len=8,
                jacobi_max_blocks=1, jacobi_max_iterations=256)
    base.update(kw)
    return cls(**base)


def _logits(dtype, shape=(3, 4, 50), seed=0):
    """Random logits with exact ties: a duplicated maximum and a duplicated
    mid-range value in every row."""
    x = np.random.RandomState(seed).randn(*shape) * 2.0
    x[..., 7] = x[..., 3]
    top = x.max(-1)
    x[..., 11] = top
    x[..., 12] = top
    return x.astype(dtype)


# ---- ops/sampling.py -----------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(np.float64, F64), (np.float32, F32)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("top_p", [1.0, 0.9, 0.3])
@pytest.mark.parametrize("top_k", [-1, 1, 5])
def test_shape_logits_and_target_probs_equal_jax(top_k, top_p, dtype, tol):
    x = _logits(dtype)
    temp = np.asarray([0.7, 1.0, 1e-9], dtype)[:, None].repeat(4, 1)  # 1e-9: the 1e-6 floor
    got = tsampling.shape_logits(torch.from_numpy(x), torch.from_numpy(temp), top_k, top_p)
    want = jsampling.shape_logits(jnp.asarray(x), jnp.asarray(temp), top_k, top_p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)

    tp = None if top_p == 1.0 else np.full(temp.shape, top_p, dtype)
    got = tsampling.target_probs(torch.from_numpy(x), torch.from_numpy(temp), top_k,
                                 None if tp is None else torch.from_numpy(tp))
    want = np.asarray(jsampling.target_probs(jnp.asarray(x), jnp.asarray(temp), top_k,
                                             None if tp is None else jnp.asarray(tp)))
    np.testing.assert_allclose(got.numpy(), want, **tol)
    # the same tokens survive: ties at the k-th value and the first sorted
    # token of the nucleus are kept
    np.testing.assert_array_equal(got.numpy() > 0, want > 0)
    if top_k == 1 and top_p == 1.0:
        assert ((got.numpy() > 0).sum(-1) >= 2).all()  # the duplicated maximum stays


def test_sample_is_greedy_at_temperature_zero():
    x = torch.from_numpy(_logits(np.float64))
    g = torch.Generator().manual_seed(0)
    t = torch.zeros(x.shape[:-1])
    assert torch.equal(tsampling.sample(x, g, t), torch.argmax(x, -1).to(torch.int32))


# ---- models/qwen.py::chunked_token_logprob -------------------------------------


def _head_pair(kind, vocab=300, seed=0):
    """(jax cfg, jax params, port cfg, port params) of the tiny fp64 model
    with a dense, tied, int8 or W8A8 lm_head."""
    tie = kind == "tied"
    jcfg = jq.ModelConfig.tiny(vocab_size=vocab, tie_word_embeddings=tie)
    cfg = tq.ModelConfig.tiny(vocab_size=vocab, tie_word_embeddings=tie)
    jparams = jq.init_params(jcfg, jax.random.PRNGKey(seed))
    if kind in ("int8", "w8a8"):
        jparams = jquant.quantize_params(jparams)
    if kind == "w8a8":
        jcfg = dataclasses.replace(jcfg, act_quant=True)
        cfg = dataclasses.replace(cfg, act_quant=True)
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("chunk", [512, 128, 97])
@pytest.mark.parametrize("kind", ["dense", "tied", "int8", "w8a8"])
def test_chunked_token_logprob_equals_jax(kind, chunk):
    """V=300: chunk 512 is the one-chunk path; 128 and 97 clamp the last chunk
    onto the one before (columns 172-255 and 203-290 overlap)."""
    jcfg, jparams, cfg, params = _head_pair(kind)
    r = np.random.RandomState(1)
    h = r.randn(2, 5, cfg.hidden_size)
    tok = r.randint(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    tok[0, :4] = [0, 299, 256, 180]  # first, last, clamped-chunk and overlap columns
    temp = np.asarray([[0.7], [1.3]])
    fn = jax.jit(jq.chunked_token_logprob, static_argnums=1, static_argnames="vocab_chunk")
    want = np.asarray(fn(jparams, jcfg, jnp.asarray(h), jnp.asarray(tok), jnp.asarray(temp),
                         vocab_chunk=chunk))
    got = tq.chunked_token_logprob(params, cfg, torch.from_numpy(h), torch.from_numpy(tok),
                                   torch.from_numpy(temp), vocab_chunk=chunk)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **F64)
    # and it is the log-softmax of the full logits
    full = torch.log_softmax(tq.logits_at(params, cfg, torch.from_numpy(h))
                             / torch.from_numpy(temp)[..., None], dim=-1)
    ref = torch.gather(full, -1, torch.from_numpy(tok).long()[..., None])[..., 0]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-10, atol=1e-10)


# ---- the engine ------------------------------------------------------------------


def test_nongreedy_topk1_equals_jax_and_greedy_ar():
    """top_k=1 collapses the target to argmax: rejection sampling then accepts
    iff the draft is the argmax and the bonus is the argmax, so the stream is
    greedy AR's and the JAX engine's, in token-budget chunking and in
    iteration-budget chunking (1 and 3 trips per chunk)."""
    prompts = jtests.make_prompts(256, sizes=(5, 9, 17, 3, 12))
    sp = _ng_sp(temperature=0.7, top_k=1, max_tokens=24)
    ar = make_engine().generate(prompts, SamplingParams(temperature=0.0, max_tokens=24))
    jng = jtests.make_engine().generate(
        prompts, _ng_sp(JSamplingParams, temperature=0.7, top_k=1, max_tokens=24))
    streams = [[o["token_ids"] for o in outs] for outs in (ar, jng)]
    for trips in (0, 1, 3):
        streams.append([o["token_ids"] for o in
                        make_engine(jacobi_chunk_iters=trips).generate(prompts, sp)])
    assert all(s == streams[0] for s in streams)
    assert [len(t) for t in streams[0]] == [24] * 5


def test_demo_checkpoint_nongreedy_topk1_equals_jax_and_ar():
    """The trained demo checkpoint in f32, 16 held-out prompts, N=32: the
    port's non-greedy top_k=1 stream == the JAX engine's == the port's AR."""
    with open(os.path.join(DEMO, "tpf_demo.json")) as f:
        meta = json.load(f)
    with open(os.path.join(DEMO, "heldout_prompts.jsonl")) as f:
        prompts = [json.loads(line)["prompt_ids"] for line in f][:16]
    kw = dict(kvcache_page_size=16, max_model_len=512, jacobi_chunk_tokens=64,
              eos=int(meta["eos"]), prefill_token_buckets=(32, 64, 128, 256, 512))
    n, L = int(meta["max_tokens"]), int(meta["block_len"])
    llm = LLM(model=DEMO, device="cpu", dtype=torch.float32, num_kv_pages=1024, **kw)
    ar = llm.generate(prompts, SamplingParams(temperature=0.0, max_tokens=n))
    gen0, it0 = llm.stats["generated_tokens"], llm.stats["jacobi_iterations"]
    ng = llm.generate(prompts, _ng_sp(temperature=0.7, top_k=1, max_tokens=n,
                                      jacobi_block_len=L, jacobi_max_iterations=1 << 20))
    mc, params = jload(DEMO, dtype=jnp.float32)
    jeng = JLLMEngine(JConfig(**kw), model_cfg=mc, params=params, num_kv_pages=1024)
    jng = jeng.generate(prompts, _ng_sp(JSamplingParams, temperature=0.7, top_k=1, max_tokens=n,
                                        jacobi_block_len=L, jacobi_max_iterations=1 << 20))
    assert [o["token_ids"] for o in ng] == [o["token_ids"] for o in ar]
    assert [o["token_ids"] for o in ng] == [o["token_ids"] for o in jng]
    toks = llm.stats["generated_tokens"] - gen0
    assert toks == sum(len(o["token_ids"]) for o in ar)
    assert toks > 2 * (llm.stats["jacobi_iterations"] - it0)  # the trained model's TPF


def _first_tokens(engine, prompt, n, sp, batch=64):
    toks = []
    for _ in range(n // batch):
        toks += [o["token_ids"][0] for o in engine.generate([list(prompt)] * batch, sp)]
    return toks


def _tv(a, b, vocab=256):
    ha = np.bincount(a, minlength=vocab) / len(a)
    hb = np.bincount(b, minlength=vocab) / len(b)
    return 0.5 * np.abs(ha - hb).sum()


def test_nongreedy_distribution_matches_ar():
    """First-position marginal of rejection-sampling Jacobi against AR
    sampling, 512 samples each from one model, under the JAX test's rule: TV
    < max(2 x AR-vs-AR noise, noise + 0.08), the noise measured between two
    engine seeds.  The first token is the first iteration's verify of the
    prefill draft, so this holds the accept and bonus draws of the
    memory-light route."""
    prompt = jtests.make_prompts(256)[0]
    sp_ar = SamplingParams(temperature=1.0, max_tokens=3)
    sp_rs = _ng_sp(max_tokens=3, jacobi_max_iterations=64)
    ar1 = _first_tokens(make_engine(num_pages=512, seed=0), prompt, 512, sp_ar)
    ar2 = _first_tokens(make_engine(num_pages=512, seed=1), prompt, 512, sp_ar)
    rs = _first_tokens(make_engine(num_pages=512, seed=2), prompt, 512, sp_rs)
    noise = _tv(ar1, ar2)
    dist = _tv(ar1, rs)
    assert dist < max(2.0 * noise, noise + 0.08), (dist, noise)


@pytest.mark.parametrize("top_k,top_p", [(-1, 1.0), (5, 1.0), (-1, 0.9)])
def test_nongreedy_progress_and_lengths(top_k, top_p):
    """Every request reaches its budget, commits >= 1 token per iteration (the
    commit rule), and takes more than one iteration; both verify routes (the
    memory-light one and top-k / top-p over [B, L-1, V])."""
    eng = make_engine()
    outs = eng.generate(jtests.make_prompts(256),
                        _ng_sp(temperature=0.7, max_tokens=20, top_k=top_k, top_p=top_p))
    assert [len(o["token_ids"]) for o in outs] == [20] * 4
    assert eng.stats["jacobi_iterations"] > 4
    assert eng.stats["generated_tokens"] >= eng.stats["jacobi_iterations"]


def test_nongreedy_same_seed_same_stream():
    """Every device draw comes from the engine's generator: one seed, one
    stream; another seed, another."""
    prompts = jtests.make_prompts(256)
    sp = _ng_sp(temperature=1.0, max_tokens=20)
    a, b, c = (make_engine(seed=s).generate(prompts, sp) for s in (3, 3, 4))
    assert [o["token_ids"] for o in a] == [o["token_ids"] for o in b]
    assert [o["token_ids"] for o in a] != [o["token_ids"] for o in c]


def test_sampled_jacobi_routes_to_nongreedy_and_greedy_programs_refuse_it():
    """`LLM.generate` sends a temperature > 0 `jacobi` request to the
    rejection-sampling decoder; the engine refuses it for the greedy
    programs (`jacobi`, MR), which the JAX engine would decode greedily."""
    eng = make_engine()
    llm = LLM.__new__(LLM)
    llm.engine, llm.tokenizer = eng, None
    it0 = eng.stats["jacobi_iterations"]
    out = llm.generate([[5, 6, 7]], SamplingParams(temperature=0.7, max_tokens=6,
                                                   decode_strategy="jacobi", jacobi_block_len=4))
    assert len(out[0]["token_ids"]) == 6 and eng.stats["jacobi_iterations"] > it0
    for strategy in ("jacobi", "jacobi_multiblock_rejection_recycling"):
        with pytest.raises(NotImplementedError, match="jacobi_nongreedy"):
            eng.add_request([1, 2, 3], SamplingParams(temperature=0.7, decode_strategy=strategy))
