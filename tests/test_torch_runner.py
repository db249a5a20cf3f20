"""The port's runner: greedy Jacobi == greedy AR token for token (the cases of
tests/test_jacobi_greedy.py), and the port's tokens == the JAX runner's on
the same tiny fp64 model and prompts.  Tokens must be identical: no
tolerance.
"""

import jax
import numpy as np
import pytest
import torch

from jacobiforcing_tpu.models import qwen as jq
from jacobiforcing_tpu_torch.engine import runner
from jacobiforcing_tpu_torch.models import qwen as tq
from jacobiforcing_tpu_torch.ops.kv_cache import alloc_kv_cache
from jacobiforcing_tpu_torch.utils.loader import params_from_numpy
from tests import helpers as jhelpers

PAGE = 16


def tiny_setup(seed=0, vocab=128, num_pages=64):
    """The JAX helper's tiny model, carried over to the port."""
    jcfg = jq.ModelConfig.tiny(vocab_size=vocab)
    jparams = jq.init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = tq.ModelConfig.tiny(vocab_size=vocab)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    rope = tuple(torch.from_numpy(np.array(a)) for a in jq.rope_table(jcfg))
    kv = alloc_kv_cache(cfg.num_layers, num_pages, PAGE, cfg.num_kv_heads, cfg.head_dim,
                        cfg.dtype, "cpu")
    return cfg, params, rope, kv


def _t(a):
    return torch.from_numpy(np.array(a))


def ar_generate_greedy(cfg, params, rope, kv, prompts, max_new, block_tables):
    B = len(prompts)
    ids, lens = jhelpers.pad_batch(prompts)
    lens_t = _t(lens)
    kv, last_logits, _ = runner.prefill(
        params, cfg, rope, _t(ids), torch.zeros(B, dtype=torch.int32), lens_t, lens_t, kv,
        _t(block_tables), n_out=1,
    )
    nxt = torch.argmax(last_logits, dim=-1).to(torch.int32)
    out = [[int(nxt[b])] for b in range(B)]
    seq_lens = lens_t + 1
    gen = torch.Generator().manual_seed(0)
    for _ in range(max_new - 1):
        kv, nxt = runner.ar_decode_step(
            params, cfg, rope, kv, nxt, seq_lens, _t(block_tables), torch.ones(B, dtype=torch.bool),
            torch.zeros(B, dtype=torch.float32), gen,
        )
        seq_lens = seq_lens + 1
        for b in range(B):
            out[b].append(int(nxt[b]))
    return out


def jacobi_generate_greedy(cfg, params, rope, kv, prompts, max_new, block_tables, L=8,
                           eos_token_id=-1, chunk_budget=None, max_iters=512, seed=0):
    """The Jacobi generation loop of tests/helpers.py, on the port's runner."""
    B = len(prompts)
    capacity = np.full((B,), block_tables.shape[1] * PAGE, np.int32)
    ids, lens = jhelpers.pad_batch(prompts, extra=L)
    rng = np.random.RandomState(seed)
    for b in range(B):
        ids[b, lens[b] : lens[b] + L] = rng.randint(0, cfg.vocab_size, L)
    kv, _, prefill_draft = runner.prefill(
        params, cfg, rope, _t(ids), torch.zeros(B, dtype=torch.int32), _t(lens + L), _t(lens),
        kv, _t(block_tables), n_out=L,
    )
    cap_tokens = block_tables.shape[1] * PAGE + L + 1
    tokens = np.zeros((B, cap_tokens), np.int32)
    for b in range(B):
        tokens[b, : lens[b]] = prompts[b]
    tokens, cur_len = _t(tokens), _t(lens)
    gen = torch.Generator().manual_seed(seed)
    last = torch.tensor([p[-1] for p in prompts], dtype=torch.int32)
    draft = runner.make_first_draft(prefill_draft, last, L, gen, cfg.vocab_size)
    eos = torch.zeros(B, dtype=torch.bool)
    iters = torch.zeros(B, dtype=torch.int32)
    produced = torch.zeros(B, dtype=torch.int32)
    chunk_budget = chunk_budget or max_new
    while True:
        res = runner.jacobi_chunk_greedy(
            params, cfg, rope, kv, tokens, cur_len, draft, eos, iters, _t(block_tables),
            _t(capacity), _t(lens + max_new), gen, eos_token_id,
            torch.full((B,), max_iters, dtype=torch.int32), chunk_budget=chunk_budget,
        )
        kv, tokens, cur_len = res["kv"], res["tokens"], res["cur_len"]
        draft, eos, iters = res["draft"], res["eos"], res["iters"]
        produced = produced + res["generated"]
        done = eos.numpy() | (produced.numpy() >= max_new) | (iters.numpy() >= max_iters)
        if done.all():
            break
    outs = []
    for b in range(B):
        g = tokens[b, lens[b] : int(cur_len[b])].tolist()
        outs.append(g[:max_new] if eos_token_id < 0 else g)
    return outs, {"iters": iters.numpy(), "generated": produced.numpy()}


def make_prompts(vocab, rng=0):
    r = np.random.RandomState(rng)
    return [r.randint(1, vocab, size=n).tolist() for n in (5, 9, 17, 3)]


def bt_for(B):
    return jhelpers.contiguous_block_tables(B, 8, 64)


def test_single_sequence_exact_match():
    prompts = make_prompts(128)[:1]
    ar = ar_generate_greedy(*tiny_setup(), prompts, 40, bt_for(1))
    jac, stats = jacobi_generate_greedy(*tiny_setup(), prompts, 40, bt_for(1), L=8)
    assert jac[0] == ar[0]
    assert stats["generated"][0] >= stats["iters"][0]


def test_batch_exact_match():
    prompts = make_prompts(128)
    ar = ar_generate_greedy(*tiny_setup(), prompts, 32, bt_for(4))
    jac, _ = jacobi_generate_greedy(*tiny_setup(), prompts, 32, bt_for(4), L=8)
    assert jac == ar


def test_cross_mode_consistency():
    """A row decodes the same alone and inside a batch, AR and Jacobi."""
    prompts = make_prompts(128)[:2]
    ar_batch = ar_generate_greedy(*tiny_setup(), prompts, 24, bt_for(2))
    for b, p in enumerate(prompts):
        assert ar_generate_greedy(*tiny_setup(), [p], 24, bt_for(1))[0] == ar_batch[b]
        assert jacobi_generate_greedy(*tiny_setup(), [p], 24, bt_for(1), L=8)[0][0] == ar_batch[b]


def test_eos_termination():
    prompts = make_prompts(128)[:1]
    ar = ar_generate_greedy(*tiny_setup(), prompts, 48, bt_for(1))
    eos_id = ar[0][10]
    ar_stop = ar[0][: ar[0].index(eos_id) + 1]
    jac, _ = jacobi_generate_greedy(*tiny_setup(), prompts, 48, bt_for(1), L=8,
                                    eos_token_id=eos_id)
    assert jac[0] == ar_stop
    assert jac[0][-1] == eos_id


def test_chunked_equals_unchunked():
    prompts = make_prompts(128)[:2]
    full, _ = jacobi_generate_greedy(*tiny_setup(), prompts, 32, bt_for(2), L=8)
    chunked, _ = jacobi_generate_greedy(*tiny_setup(), prompts, 32, bt_for(2), L=8,
                                        chunk_budget=8)
    assert full == chunked


@pytest.mark.parametrize("L,eos_pick", [(8, None), (4, 7)])
def test_port_tokens_equal_jax_runner(L, eos_pick):
    """Same tiny model, same prompts: the port's runner commits the JAX
    runner's tokens (the random draft tails differ, the tokens cannot)."""
    prompts = make_prompts(128)
    bt = bt_for(4)
    cfg, jp, rope, jkvc = jhelpers.tiny_setup(num_pages=64)
    j_ar, _ = jhelpers.ar_generate_greedy(cfg, jp, rope, jkvc, prompts, 32, bt)
    eos_id = -1 if eos_pick is None else j_ar[0][eos_pick]
    cfg, jp, rope, jkvc = jhelpers.tiny_setup(num_pages=64)
    j_jac, _ = jhelpers.jacobi_generate_greedy(cfg, jp, rope, jkvc, prompts, 32, bt, L=L,
                                               eos_token_id=eos_id)
    t_jac, _ = jacobi_generate_greedy(*tiny_setup(), prompts, 32, bt, L=L, eos_token_id=eos_id)
    # a row without EOS may commit past max_new by an acceptance-dependent count
    assert [t[:32] for t in t_jac] == [j[:32] for j in j_jac]
    assert ar_generate_greedy(*tiny_setup(), prompts, 32, bt) == j_ar


def test_commit_window_and_first_draft():
    tokens = torch.arange(40, dtype=torch.int32).reshape(2, 20)
    win, start = runner._commit_window(torch.tensor([3, 18], dtype=torch.int32), tokens, 4, 6, 0)
    assert win.shape == (2, 10) and start.tolist() == [3, 10]
    assert win[0].tolist() == list(range(3, 13)) and win[1].tolist() == list(range(30, 40))
    gen = torch.Generator().manual_seed(0)
    d = runner.make_first_draft(torch.tensor([[7, 8]], dtype=torch.int32),
                                torch.tensor([5], dtype=torch.int32), 5, gen, 100)
    assert d.shape == (1, 5) and d[0, :3].tolist() == [5, 7, 8] and d.dtype == torch.int32
