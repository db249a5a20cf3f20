"""The port's train_tpf_demo against the JAX app's, at a reduced size in fp64
(hidden 64, 2 layers, N 8), the same weights on both sides:

  * the SFT stage: 5 steps' losses equal the JAX app's stage 1 (the same
    rows from the same `RandomState`, the same schedule and AdamW) within
    1e-6 relative;
  * round 0's collected rows equal the JAX collection record for record;
  * the measured TPF (the eval harness on held-out prompts): the token
    streams are equal; the tokens per forward lie inside the JAX engine's
    spread over three engine seeds, since each Jacobi draft's random tail
    comes from jax.random / torch.Generator;
  * the countdown generator equals the JAX app's and
    scripts/probe_quant_acceptance.task_truth;
  * `run` end to end at a tiny size on the CPU writes its result and its
    checkpoint into the directory it is given.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jacobiforcing_tpu.apps import bench_generate as jbench
from jacobiforcing_tpu.apps import train_tpf_demo as jdemo
from jacobiforcing_tpu.config import Config as JConfig
from jacobiforcing_tpu.data import collect_trajectories as jcollect
from jacobiforcing_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from jacobiforcing_tpu.models import qwen as jq
from jacobiforcing_tpu_torch.apps import train_tpf_demo as demo
from jacobiforcing_tpu_torch.models.qwen import rope_table
from jacobiforcing_tpu_torch.train.consistency import TrainConfig, make_train_step
from jacobiforcing_tpu_torch.train.optim import AdamW
from jacobiforcing_tpu_torch.utils.loader import params_from_numpy
from tests.test_torch_onpolicy import _same_rows

GEOM = (64, 2, 2, 1)  # hidden, layers, heads, kv heads
N, MAX_TOKENS = 8, 24


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(JAX config, JAX weights, port config, port weights): fp64, the same
    numbers."""
    jmc = dataclasses.replace(jdemo.demo_model_cfg(*GEOM), dtype=jnp.float64)
    jparams = jq.init_params(jmc, jax.random.PRNGKey(0))
    mc = demo.demo_model_cfg(*GEOM, dtype=torch.float64)
    return jmc, jparams, mc, params_from_numpy(jax.tree.map(np.asarray, jparams))


def _jax_sft_losses(jmc, jparams, steps, batch, lr):
    """The JAX app's stage 1 (train_tpf_demo.run, countdown task), step for
    step: its rows, schedule, AdamW and loss."""
    rng = np.random.RandomState(0)
    rope = jq.rope_table(jmc)
    warmup = min(100, max(steps // 10, 1))
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup_steps=warmup,
                                               decay_steps=max(steps, warmup + 1),
                                               end_value=lr * 0.02)
    opt = optax.adamw(sched)
    state = opt.init(jparams)

    @jax.jit
    def step(params, opt_state, ids, loss_w):
        def loss_fn(p):
            pos = jnp.broadcast_to(jnp.arange(ids.shape[1] - 1), ids[:, :-1].shape)
            h = jq.forward_dense(p, jmc, ids[:, :-1], pos, rope)
            logp = jax.nn.log_softmax(jq.logits_at(p, jmc, h), axis=-1)
            nll = -jnp.take_along_axis(logp, ids[:, 1:, None], axis=-1)[..., 0]
            return jnp.sum(nll * loss_w) / jnp.maximum(jnp.sum(loss_w), 1.0)

        loss, g = jax.value_and_grad(loss_fn)(params)
        upd, opt_state = opt.update(g, opt_state, params)
        return optax.apply_updates(params, upd), opt_state, loss

    losses, T = [], 96
    for _ in range(steps):
        ids = np.zeros((batch, T), np.int32)
        w = np.zeros((batch, T - 1), np.float64)
        for b in range(batch):
            prompt, seq = jdemo.countdown_copy_row(rng, jmc.vocab_size)
            seq = seq[:T]
            ids[b, : len(seq)] = seq
            w[b, len(prompt) - 1 : len(seq) - 1] = 1.0
        jparams, state, loss = step(jparams, state, jnp.asarray(ids), jnp.asarray(w))
        losses.append(float(loss))
    return losses


def test_sft_stage_equals_jax(pair):
    jmc, jparams, mc, params = pair
    want = _jax_sft_losses(jmc, jparams, 5, 4, 2e-3)
    fresh = params_from_numpy(jax.tree.map(np.asarray, jparams))  # sft updates in place
    _, got = demo.sft(mc, fresh, np.random.RandomState(0), 5, 4, 2e-3, "countdown", "cpu",
                      log=lambda _m: None)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[-1] < got[0]


def _prompts(vocab, n, seed):
    rng = np.random.RandomState(seed)
    return [demo.countdown_copy_row(rng, vocab)[0] for _ in range(n)]


def test_round0_rows_equal_jax(pair):
    """Round 0 collects on-policy greedy trajectories of the train prompts with
    the current weights: the port's `consistency_round` (no epochs) against
    the JAX app's engine and collector."""
    jmc, jparams, mc, params = pair
    prompts = _prompts(mc.vocab_size, 4, 1)
    tc = TrainConfig(N=N, max_pairs=3, seq_bucket=64, ar_pair_bucket=64, cons_pair_bucket=64)
    opt = AdamW(1e-4)
    _, _, rows, packed, m = demo.consistency_round(
        mc, params, opt.init(params), make_train_step(mc, tc, opt), rope_table(mc), tc, prompts,
        N, MAX_TOKENS, 0, 4, demo.EOS_ID, "cpu")
    jrows = jcollect(jdemo.make_engine(jmc, jparams, eos=jdemo.EOS_ID), prompts, block_len=N,
                     max_tokens=MAX_TOKENS, temperature=0.0)
    _same_rows(rows, jrows, len(prompts))
    assert packed and m is None


def test_measured_tpf_equals_jax(pair, tmp_path):
    jmc, jparams, mc, params = pair
    heldout = _prompts(mc.vocab_size, 6, 2)
    tpf, sd, agg = demo.measure_tpf_via_harness(mc, params, heldout, N, MAX_TOKENS,
                                                str(tmp_path / "port"), eos=demo.EOS_ID,
                                                device="cpu")
    jagg = {}
    for seed in (0, 1, 2):
        # jdemo.make_engine's configuration with the engine seed set
        eng = JLLMEngine(JConfig(kvcache_page_size=16, max_model_len=512, jacobi_chunk_tokens=64,
                                 eos=jdemo.EOS_ID, prefill_token_buckets=(32, 64, 128, 256, 512),
                                 seed=seed), model_cfg=jmc, params=jparams, num_kv_pages=1024)
        args = jbench.make_parser().parse_args([])
        args.strategy, args.n_token_seq_len, args.max_blocks = "jacobi", N, 1
        args.max_new_tokens, args.max_iterations = MAX_TOKENS, 1 << 20
        args.output_dir = str(tmp_path / f"jax{seed}")
        args.dataset = str(tmp_path / "port" / "heldout_prompts.jsonl")
        jagg[seed], _ = jbench.run(args, engine=eng, tokenizer=None)
    def tokens(d):
        lines = (tmp_path / d / "generations_jacobi.jsonl").read_text().splitlines()
        return [json.loads(line)["token_ids"] for line in lines]

    assert tokens("port") == tokens("jax0")
    assert agg["total_tokens"] == jagg[0]["total_tokens"]
    spread = [a["aggregate_tokens_per_forward"] for a in jagg.values()]
    assert min(spread) * 0.95 <= agg["aggregate_tokens_per_forward"] <= max(spread) * 1.05
    assert tpf >= 1.0 and np.isfinite(sd)


def test_countdown_generator_equals_jax_and_task_truth(monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(__file__), "..", "scripts"))
    from probe_quant_acceptance import task_truth

    rng, jrng = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(50):
        prompt, seq = demo.countdown_copy_row(rng, 256)
        assert (prompt, seq) == jdemo.countdown_copy_row(jrng, 256)
        cont = seq[len(prompt):]
        assert cont == task_truth(prompt, "countdown", len(cont))
        assert cont[-1] == demo.EOS_ID and demo.EOS_ID not in cont[:-1]
        m = prompt[0] - demo.CD_BASE
        assert 3 <= m <= 6
    r1, r2 = np.random.RandomState(3), np.random.RandomState(3)
    assert demo.copy_language_row(r1, 256) == jdemo.copy_language_row(r2, 256)
    ids, w = demo.sft_batch(np.random.RandomState(1), 256, "countdown", 3)
    assert ids.shape == (3, 96) and w.shape == (3, 95) and w.sum() > 0


def test_run_end_to_end_tiny(tmp_path):
    """The whole app at a tiny size on the CPU: SFT, one round, three
    measurements; the checkpoint and tpf_demo.json land in --out."""
    out = tmp_path / "demo"
    result = demo.run(demo.make_parser().parse_args([
        "--out", str(out), "--device", "cpu", "--hidden", "64", "--layers", "1",
        "--heads", "1", "--kv-heads", "1", "--block-len", "8", "--max-tokens", "16",
        "--n-prompts", "2", "--heldout", "3", "--rounds", "1", "--epochs", "1",
        "--sft-steps", "2", "--sft-batch", "2"]))
    assert result["sft_steps"] == 2 and len(result["tpf_history"]) == 2
    assert result["tpf_final"] >= 1.0 and result["device"] == "cpu"
    assert json.loads((out / "tpf_demo.json").read_text())["tpf_final"] == result["tpf_final"]
    assert (out / "model.safetensors").exists() and (out / "config.json").exists()


@pytest.mark.parametrize("alpha,exponent", [(0.0, 1.0), (0.05, 1.0), (0.05, 2.0)])
def test_cosine_decay_schedule_equals_optax(alpha, exponent):
    """The consistency stage's schedule, `optax.cosine_decay_schedule`, step
    for step past its end (optax evaluates it in float32: 1e-6)."""
    from jacobiforcing_tpu_torch.train.optim import cosine_decay_schedule

    want = optax.cosine_decay_schedule(3e-4, decay_steps=17, alpha=alpha, exponent=exponent)
    got = cosine_decay_schedule(3e-4, decay_steps=17, alpha=alpha, exponent=exponent)
    np.testing.assert_allclose([got(i) for i in range(25)], [float(want(i)) for i in range(25)],
                               rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="decay_steps"):
        cosine_decay_schedule(3e-4, decay_steps=0)
