"""The port's speculative forward and multiblock (MR) chunk program against
the JAX package, on the tiny fp64 model with the weights carried across by
`params_from_numpy`.

`forward_spec`: hidden, k_new and v_new within 1e-9 (fp64; the two run the
same arithmetic in another summation order), and the cache untouched.
`jacobi_chunk_multiblock`: EVERY key of the returned dict equal (integers and
bools exactly; the KV cache within 1e-9), chunk after chunk, over block and
pool counts, batch shapes with a finished row, both chunking modes and an EOS
inside the accepted region.  With a narrow cache (fp8 e4m3 / int8 with per-row
scales) the stored bytes and the scale planes are equal exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jacobiforcing_tpu.engine import multiblock as jmb
from jacobiforcing_tpu.engine import runner as jrunner
from jacobiforcing_tpu.models import qwen as jq
from jacobiforcing_tpu.ops import kv_cache as jkv
from jacobiforcing_tpu_torch.engine import multiblock as tmb
from jacobiforcing_tpu_torch.engine import runner as trunner
from jacobiforcing_tpu_torch.models import qwen as tq
from jacobiforcing_tpu_torch.ops import kv_cache as tkv
from jacobiforcing_tpu_torch.utils.loader import params_from_numpy
from tests import helpers as jhelpers

PAGE = 16
PAGES_PER_SEQ = 8
TOL = dict(rtol=1e-9, atol=1e-9)
STATE_KEYS = tmb.STATE_KEYS


KV_KINDS = {"fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn), "int8": (torch.int8, jnp.int8)}


def _setup(vocab, num_pages=64, seed=0, kind=None):
    """One tiny model in both packages, each with an empty KV cache (stored as
    `kind`, with per-row scales, when given)."""
    jcfg, jparams, jrope, jkvc = jhelpers.tiny_setup(seed=seed, vocab=vocab, num_pages=num_pages)
    cfg = tq.ModelConfig.tiny(vocab_size=vocab)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    rope = tuple(torch.from_numpy(np.array(a)) for a in jrope)
    tdt, jdt = KV_KINDS[kind] if kind else (cfg.dtype, jcfg.dtype)
    if kind:
        jkvc = jkv.alloc_kv_cache(jcfg.num_layers, num_pages, PAGE, jcfg.num_kv_heads,
                                  jcfg.head_dim, jdt)
    kvc = tkv.alloc_kv_cache(cfg.num_layers, num_pages, PAGE, cfg.num_kv_heads, cfg.head_dim,
                             tdt, "cpu")
    return (jcfg, jparams, jrope, jkvc), (cfg, params, rope, kvc)


def _assert_cache_equal(kvc, jkvc):
    """fp64 caches within 1e-9; a scaled cache's bytes and scales exactly."""
    if not kvc.scaled:
        np.testing.assert_allclose(kvc.k.numpy(), np.asarray(jkvc.k), **TOL)
        np.testing.assert_allclose(kvc.v.numpy(), np.asarray(jkvc.v), **TOL)
        return
    for got, want in ((kvc.k, jkvc.k), (kvc.v, jkvc.v)):
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(),
                                      np.asarray(want).view(np.uint8))
    np.testing.assert_array_equal(kvc.k_scale.numpy(), np.asarray(jkvc.k_scale))
    np.testing.assert_array_equal(kvc.v_scale.numpy(), np.asarray(jkvc.v_scale))


def _t(a):
    return torch.from_numpy(np.array(a))


def _prefill_both(jax_side, port_side, prompts, N, bt, seed=0):
    """Prefill the prompts plus a random N-token draft in both packages;
    returns (jax kv, port kv, greedy bootstrap draft [B, N])."""
    jcfg, jparams, jrope, jkvc = jax_side
    cfg, params, rope, kvc = port_side
    B = len(prompts)
    ids, lens = jhelpers.pad_batch(prompts, extra=N)
    rng = np.random.RandomState(seed)
    for b in range(B):
        ids[b, lens[b] : lens[b] + N] = rng.randint(0, cfg.vocab_size, N)
    zeros = np.zeros((B,), np.int32)
    jkvc, _, jpf = jrunner.prefill(
        jparams, jcfg, jrope, jnp.asarray(ids), jnp.asarray(zeros), jnp.asarray(lens + N),
        jnp.asarray(lens), jkvc, jnp.asarray(bt), n_out=N)
    kvc, _, pf = trunner.prefill(
        params, cfg, rope, _t(ids), _t(zeros), _t(lens + N), _t(lens), kvc, _t(bt), n_out=N)
    np.testing.assert_array_equal(pf.numpy(), np.asarray(jpf))
    return jkvc, kvc, np.asarray(jpf), lens


def test_forward_spec_matches_jax_and_writes_nothing():
    jax_side, port_side = _setup(vocab=64)
    prompts = [[3, 9, 4, 1, 7], [5, 2, 8, 8, 1, 6, 3, 2, 9]]
    bt = jhelpers.contiguous_block_tables(2, PAGES_PER_SEQ, 64)
    N, K, C = 4, 2, 2
    jkvc, kvc, _, lens = _prefill_both(jax_side, port_side, prompts, N, bt)
    jcfg, jparams, jrope, _ = jax_side
    cfg, params, rope, _ = port_side
    T = (1 + C + K - 1) * N
    r = np.random.RandomState(1)
    ids = r.randint(0, 64, (2, T)).astype(np.int32)
    # semantic positions, the last ones past max_position (clamped inside)
    pos = (lens[:, None] + r.randint(0, 2 * N, (2, T))).astype(np.int32)
    pos[1, -2:] = jcfg.max_position + 5
    tok_valid = r.rand(2, T) < 0.85
    mask = tmb.tree_mask(N, K, C, "cpu").numpy()[None] & tok_valid[:, :, None] & tok_valid[:, None]
    k_before, v_before = kvc.k.clone(), kvc.v.clone()
    jh, jk, jv = jq.forward_spec(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), jkvc, jnp.asarray(bt),
        jnp.asarray(lens), jnp.asarray(mask), jrope)
    h, k_new, v_new = tq.forward_spec(
        params, cfg, _t(ids), _t(pos), kvc, _t(bt), _t(lens), _t(mask), rope)
    assert k_new.shape == (cfg.num_layers, 2, T, cfg.num_kv_heads, cfg.head_dim)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(k_new.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v_new.numpy(), np.asarray(jv), **TOL)
    assert torch.equal(kvc.k, k_before) and torch.equal(kvc.v, v_before)


@pytest.mark.parametrize("kind", ["fp8", "int8"])
def test_forward_spec_rejects_a_narrow_kv_cache(kind):
    """A narrow cache is no longer refused: `forward_spec` fake-quantizes the
    in-flight block as the JAX version does, so its output equals JAX's, the
    block's K/V come back unquantized, and nothing is written."""
    jax_side, port_side = _setup(vocab=64, kind=kind)
    prompts = [[3, 9, 4, 1, 7], [5, 2, 8, 8, 1, 6, 3, 2, 9]]
    bt = jhelpers.contiguous_block_tables(2, PAGES_PER_SEQ, 64)
    N = 4
    jkvc, kvc, _, lens = _prefill_both(jax_side, port_side, prompts, N, bt)
    _assert_cache_equal(kvc, jkvc)
    jcfg, jparams, jrope, _ = jax_side
    cfg, params, rope, _ = port_side
    r = np.random.RandomState(2)
    ids = r.randint(0, 64, (2, 2 * N)).astype(np.int32)
    pos = (lens[:, None] + r.randint(0, N, (2, 2 * N))).astype(np.int32)
    mask = np.broadcast_to(tmb.tree_mask(N, 2, 0, "cpu").numpy(), (2, 2 * N, 2 * N))
    bytes_before = kvc.k.view(torch.uint8).clone()
    jh, jk, jv = jq.forward_spec(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), jkvc, jnp.asarray(bt),
        jnp.asarray(lens), jnp.asarray(mask), jrope)
    h, k_new, v_new = tq.forward_spec(
        params, cfg, _t(ids), _t(pos), kvc, _t(bt), _t(lens), _t(mask), rope)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(k_new.numpy(), np.asarray(jk), **TOL)
    np.testing.assert_allclose(v_new.numpy(), np.asarray(jv), **TOL)
    assert k_new.dtype == cfg.dtype and torch.equal(kvc.k.view(torch.uint8), bytes_before)


def _bootstrap(lens, pf, N, K, C, finished):
    """The engines' fresh MR state (LLMEngine._mb_bootstrap), batched."""
    B = len(lens)
    st = {
        "blk_draft": np.zeros((B, K, N), np.int32),
        "blk_dlen": np.tile(np.asarray([N] + [0] * (K - 1), np.int32), (B, 1)),
        "blk_acc": np.zeros((B, K), np.int32),
        "blk_acc_toks": np.zeros((B, K, N), np.int32),
        "blk_base": np.zeros((B, K), np.int32),
        "blk_active": np.tile(np.asarray([True] + [False] * (K - 1)), (B, 1)),
        "ra": np.zeros((B,), np.int32),
        "n_active": np.ones((B,), np.int32),
        "pool": np.zeros((B, C, 2 * N), np.int32),
        "pool_len": np.zeros((B, C), np.int32),
        "pool_next": np.zeros((B,), np.int32),
        "last_next": pf[:, 0].astype(np.int32),
    }
    st["blk_draft"][:, 0] = pf[:, :N]
    st["blk_base"][:, 0] = lens
    st["eos"] = np.asarray(finished, bool)
    st["iters"] = np.zeros((B,), np.int32)
    return st


def _run_chunks(K, C, B, chunk_iters, eos_pick, n_chunks=4, N=8, vocab=24, r=0.25, kind=None):
    """Drive both packages through `n_chunks` MR chunks from one bootstrap,
    each fed its own previous output; every key must agree after each."""
    jax_side, port_side = _setup(vocab=vocab, kind=kind)
    jcfg, jparams, jrope, _ = jax_side
    cfg, params, rope, _ = port_side
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, vocab, size=n).tolist() for n in (5, 9, 13)][:B]
    bt = jhelpers.contiguous_block_tables(B, PAGES_PER_SEQ, 64)
    jkvc, kvc, pf, lens = _prefill_both(jax_side, port_side, prompts, N, bt)
    finished = [B == 3 and b == 2 for b in range(B)]  # one already finished row
    st = _bootstrap(lens, pf, N, K, C, finished)
    cap = PAGES_PER_SEQ * PAGE + 1
    tokens = np.zeros((B, cap), np.int32)
    for b, p in enumerate(prompts):
        tokens[b, : len(p)] = p
    cur_len = lens.copy()
    fixed = dict(
        capacity=np.full((B,), PAGES_PER_SEQ * PAGE, np.int32),
        max_new=np.full((B,), 40, np.int32),
        spawn=np.full((B,), int(np.ceil(r * N)), np.int32),
        la=np.zeros((B,), np.int32),
        max_iters=np.full((B,), 64, np.int32),
    )
    eos_id = -1
    if eos_pick is not None:
        # a token that the greedy stream emits: the bootstrap draft is the
        # greedy continuation, so its entry `eos_pick` is accepted with the block
        eos_id = int(pf[0, eos_pick])
    kw = dict(N=N, K=K, C=C, W=2 * N, chunk_budget=12, chunk_iters=chunk_iters)
    tiers_total = np.zeros(3, np.int64)
    for chunk in range(n_chunks):
        def args(conv):
            return [conv(tokens), conv(cur_len)] + [conv(st[k]) for k in STATE_KEYS] + [
                conv(st["eos"]), conv(st["iters"]), conv(bt), conv(fixed["capacity"]),
                conv(fixed["max_new"]), eos_id, 0, conv(fixed["spawn"]), conv(fixed["la"]),
                conv(fixed["max_iters"])]
        jres = jmb.jacobi_chunk_multiblock(jparams, jcfg, jrope, jkvc, *args(jnp.asarray), **kw)
        tres = tmb.jacobi_chunk_multiblock(params, cfg, rope, kvc, *args(_t), **kw)
        assert set(tres) == set(jres)
        for key in jres:
            if key == "kv":
                continue
            want, got = np.asarray(jres[key]), tres[key].numpy()
            assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want, err_msg=f"chunk {chunk}: {key}")
        jkvc = jres["kv"]
        assert tres["kv"] is kvc  # updated in place
        _assert_cache_equal(kvc, jkvc)
        tiers_total += np.asarray(jres["tiers"])
        tokens, cur_len = np.asarray(jres["tokens"]), np.asarray(jres["cur_len"])
        for k in STATE_KEYS + ("eos", "iters"):
            st[k] = np.asarray(jres[k])
        fixed["max_new"] = np.maximum(fixed["max_new"] - np.asarray(jres["generated"]), 0)
    return st, tokens, cur_len, lens, tiers_total, eos_id


@pytest.mark.parametrize("K,C", [(1, 1), (2, 4), (3, 2)])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("chunk_iters", [0, 2])
def test_chunk_multiblock_equals_jax(K, C, B, chunk_iters):
    st, tokens, cur_len, lens, tiers, _ = _run_chunks(K, C, B, chunk_iters, eos_pick=None)
    assert (cur_len[: min(B, 2)] > lens[: min(B, 2)]).all()  # live rows made progress
    if B == 3:
        assert cur_len[2] == lens[2] and st["iters"][2] == 0  # the finished row stayed inert
    assert tiers.sum() > 0


@pytest.mark.parametrize("kind", ["fp8", "int8"])
@pytest.mark.parametrize("K,C,B,chunk_iters", [(2, 4, 3, 0), (3, 2, 1, 2)])
def test_chunk_multiblock_equals_jax_with_a_scaled_cache(kind, K, C, B, chunk_iters):
    """The commit of the winner's rows quantizes them and scatters the scales:
    every dict key, the cache bytes and the scale planes equal JAX's."""
    st, tokens, cur_len, lens, tiers, _ = _run_chunks(K, C, B, chunk_iters, None, kind=kind)
    assert (cur_len[: min(B, 2)] > lens[: min(B, 2)]).all() and tiers.sum() > 0


@pytest.mark.parametrize("K,C", [(2, 4), (3, 2)])
def test_chunk_multiblock_equals_jax_with_eos_in_the_accepted_region(K, C):
    st, tokens, cur_len, lens, _, eos_id = _run_chunks(K, C, 2, 0, eos_pick=3)
    out = tokens[0, lens[0] : cur_len[0]].tolist()
    assert st["eos"][0] and out[-1] == eos_id and eos_id not in out[:-1]


def test_compact_matches_jax():
    r = np.random.RandomState(0)
    toks = r.randint(0, 50, (3, 12))
    valid = r.rand(3, 12) < 0.5
    valid[1] = False
    got_t, got_n = tmb._compact(_t(toks), _t(valid))
    for b in range(3):
        want_t, want_n = jmb._compact(jnp.asarray(toks[b]), jnp.asarray(valid[b]))
        n = int(want_n)
        assert int(got_n[b]) == n == int(valid[b].sum())
        np.testing.assert_array_equal(got_t[b].numpy()[:n], np.asarray(want_t)[:n])
        np.testing.assert_array_equal(got_t[b].numpy()[:n], toks[b][valid[b]])


def test_first_max_tie_goes_to_the_lowest_index():
    """The winner among RA + candidates is `argmax`: on a tie the RA segment
    (index 0) must win, and the first hit of a bool mask is its lowest index."""
    acc = torch.tensor([[3, 3, 1], [0, 0, 0], [1, 4, 4], [2, 5, 5]])
    assert tmb._first_max(acc).tolist() == [0, 0, 1, 1]
    assert tmb._first_max(acc).tolist() == np.asarray(jnp.argmax(jnp.asarray(acc.numpy()), -1)).tolist()
    hit = torch.tensor([[False, True, True], [False, False, False], [True, False, True]])
    assert tmb._first_true(hit).tolist() == [1, 0, 0]
    assert tmb._first_true(hit).tolist() == np.asarray(jnp.argmax(jnp.asarray(hit.numpy()), -1)).tolist()
