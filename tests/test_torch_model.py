"""The port's Qwen model and loader against the JAX package.

Tiny random model in fp64, weights carried over by `params_from_numpy`; the
paged forward is compared in its three contexts (prefill, AR step, Jacobi
block).  Tolerance 1e-9 abs/rel in fp64 (same math, other summation order);
greedy tokens must be identical.  The demo checkpoint runs in f32: logits
within 2e-4 abs/rel (XLA and PyTorch CPU kernels reassociate f32 sums
differently over 8 layers).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jacobiforcing_tpu.models import qwen as jq
from jacobiforcing_tpu.ops import kv_cache as jkv
from jacobiforcing_tpu.utils import loader as jloader
from jacobiforcing_tpu_torch.models import qwen as tq
from jacobiforcing_tpu_torch.ops import kv_cache as tkv
from jacobiforcing_tpu_torch.utils import loader as tloader

PAGE = 16
TOL = dict(rtol=1e-9, atol=1e-9)
DEMO = os.path.join(os.path.dirname(__file__), "..", "assets", "tpf_demo_n32_v7")


def _pair(vocab=128, seed=0, **kw):
    jcfg = jq.ModelConfig.tiny(vocab_size=vocab, **kw)
    tcfg = tq.ModelConfig.tiny(vocab_size=vocab, **kw)
    jparams = jq.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = tloader.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("kw", [{}, dict(qkv_bias=False, qk_norm=True)])
def test_forward_three_contexts(kw):
    """Prefill, one AR step and a Jacobi block against the same cache."""
    jcfg, jp, tcfg, tp = _pair(**kw)
    B, L = 2, 6
    jkvc = jkv.alloc_kv_cache(jcfg.num_layers, 16, PAGE, jcfg.num_kv_heads, jcfg.head_dim, jcfg.dtype)
    tkvc = tkv.alloc_kv_cache(tcfg.num_layers, 16, PAGE, tcfg.num_kv_heads, tcfg.head_dim,
                              tcfg.dtype, "cpu")
    # the f32 RoPE tables agree to f32 rounding (XLA's and PyTorch's cos/sin
    # differ in the last bit); the forwards then share one table
    jrope = jq.rope_table(jcfg)
    for a, b in zip(tq.rope_table(tcfg), jrope):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-6)
    trope = tuple(_t(a) for a in jrope)
    r = np.random.RandomState(1)
    bt = np.asarray([[3, 7, 1, -1], [0, 5, 9, 2]], np.int32)
    lens = np.asarray([13, 21], np.int32)

    # prefill: padded to T=24, KV written below each row's length only
    T = 24
    ids = r.randint(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    wm = pos < lens[:, None]
    contexts = [(ids, pos, lens, wm)]
    # AR step at position S-1
    ids1 = r.randint(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
    contexts.append((ids1, (lens - 1)[:, None], lens, None))
    # Jacobi block at positions S-1 .. S+L-2
    idsL = r.randint(0, jcfg.vocab_size, (B, L)).astype(np.int32)
    posL = (lens - 1)[:, None] + np.arange(L, dtype=np.int32)[None, :]
    contexts.append((idsL, posL, lens - 1 + L, np.asarray([[True] * L, [False] * L])))

    for ids_c, pos_c, lens_c, wm_c in contexts:
        hj, jkvc = jq.forward(
            jp, jcfg, jnp.asarray(ids_c), jnp.asarray(pos_c), jkvc, jnp.asarray(bt),
            jnp.asarray(lens_c), jrope, write_mask=None if wm_c is None else jnp.asarray(wm_c),
        )
        ht, tkvc = tq.forward(
            tp, tcfg, _t(ids_c), _t(pos_c), tkvc, _t(bt), _t(lens_c), trope,
            write_mask=None if wm_c is None else _t(wm_c),
        )
        np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **TOL)
        np.testing.assert_allclose(tkvc.k.numpy(), np.asarray(jkvc.k), **TOL)
        np.testing.assert_allclose(tkvc.v.numpy(), np.asarray(jkvc.v), **TOL)
        np.testing.assert_allclose(
            tq.logits_at(tp, tcfg, ht).numpy(), np.asarray(jq.logits_at(jp, jcfg, hj)), **TOL)


@pytest.mark.parametrize("vocab,chunk,tie", [(128, 48, False), (128, 128, False), (100, 32, True)])
def test_greedy_tokens_chunk_rules(vocab, chunk, tie):
    """Vocab-chunked argmax: the clamped last chunk, first-max ties inside a
    chunk and `cmax > best` across chunks give the JAX tokens exactly."""
    jcfg, jp, tcfg, tp = _pair(vocab=vocab, tie_word_embeddings=tie)
    h = np.random.RandomState(2).randn(3, 5, jcfg.hidden_size)
    # exact ties across and inside chunks: duplicate head columns
    head = "embed" if tie else "lm_head"
    w = np.asarray(jp[head]).copy()
    if tie:
        w[70] = w[10]
        w[95] = w[10]
    else:
        w[:, 70] = w[:, 10]
        w[:, 95] = w[:, 10]
    jp = dict(jp, **{head: jnp.asarray(w)})
    tp = dict(tp, **{head: torch.from_numpy(w)})
    h[0, 0] = w[10] if tie else w[:, 10]  # make column 10 (and its copies) win
    gj = np.asarray(jq.greedy_tokens(jp, jcfg, jnp.asarray(h), vocab_chunk=chunk))
    gt = tq.greedy_tokens(tp, tcfg, torch.from_numpy(h), vocab_chunk=chunk).numpy()
    np.testing.assert_array_equal(gt, gj)
    assert gt[0, 0] == 10
    assert gt.dtype == np.int32


def test_rms_norm_and_rope_match():
    r = np.random.RandomState(4)
    x = r.randn(2, 3, 4, 16)
    w = r.randn(16)
    np.testing.assert_allclose(
        tq.rms_norm(_t(x), _t(w), 1e-6).numpy(),
        np.asarray(jq.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)), **TOL)
    cos, sin = r.randn(2, 3, 8).astype(np.float32), r.randn(2, 3, 8).astype(np.float32)
    np.testing.assert_allclose(
        tq.apply_rope(_t(x), _t(cos), _t(sin)).numpy(),
        np.asarray(jq.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))), **TOL)


def test_model_config_matches_jax():
    """Full-width defaults (Qwen2.5-7B) and the HF mapping agree field by field."""
    def fields(c):
        return {k: v for k, v in dataclasses.asdict(c).items() if k not in ("dtype", "act_quant")}

    assert fields(tq.ModelConfig()) == fields(jq.ModelConfig())
    hf = {"model_type": "qwen3", "vocab_size": 1000, "hidden_size": 64, "intermediate_size": 96,
          "num_hidden_layers": 3, "num_attention_heads": 4, "num_key_value_heads": 2,
          "head_dim": 32, "attention_bias": False, "tie_word_embeddings": True}
    assert fields(tq.ModelConfig.from_hf_config(hf)) == fields(jq.ModelConfig.from_hf_config(hf))
    assert tq.ModelConfig.tiny().dtype == torch.float64


def test_init_params_shapes_and_scales():
    """Same pytree layout as the JAX init; same scales (normal/sqrt(fan_in),
    embeddings 0.02); a generator seed makes it reproducible."""
    jcfg = jq.ModelConfig.tiny(vocab_size=512)
    tcfg = tq.ModelConfig.tiny(vocab_size=512)
    jp = jq.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tq.init_params(tcfg, 0, device="cpu")
    assert set(tp) == set(jp) and set(tp["layers"]) == set(jp["layers"])
    for name, v in tp["layers"].items():
        assert tuple(v.shape) == tuple(jp["layers"][name].shape)
        assert v.dtype == torch.float64
    assert abs(tp["embed"].std().item() - 0.02) < 0.002
    assert abs(tp["layers"]["w_down"].std().item() - 1 / np.sqrt(128)) < 0.01
    tp2 = tq.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(tp["layers"]["wq"], tp2["layers"]["wq"])


def test_demo_checkpoint_logits_match_jax_loader():
    jcfg, jp = jloader.load_checkpoint(DEMO, dtype=jnp.float32)
    tcfg, tp = tloader.load_checkpoint(DEMO, dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(tp["layers"]["wq"].numpy(), np.asarray(jp["layers"]["wq"]))
    np.testing.assert_array_equal(tp["lm_head"].numpy(), np.asarray(jp["lm_head"]))
    ids = np.asarray([[1, 17, 45, 200, 9, 3, 77, 128, 5, 61, 2, 250, 30]], np.int32)
    T = ids.shape[1]
    pos = np.arange(T, dtype=np.int32)[None]
    lens = np.asarray([T], np.int32)
    bt = np.asarray([[2, 0]], np.int32)
    jkvc = jkv.alloc_kv_cache(jcfg.num_layers, 4, PAGE, jcfg.num_kv_heads, jcfg.head_dim, jnp.float32)
    tkvc = tkv.alloc_kv_cache(tcfg.num_layers, 4, PAGE, tcfg.num_kv_heads, tcfg.head_dim,
                              torch.float32, "cpu")
    hj, _ = jq.forward(jp, jcfg, jnp.asarray(ids), jnp.asarray(pos), jkvc, jnp.asarray(bt),
                       jnp.asarray(lens), jq.rope_table(jcfg))
    ht, _ = tq.forward(tp, tcfg, _t(ids), _t(pos), tkvc, _t(bt), _t(lens), tq.rope_table(tcfg))
    lj = np.asarray(jq.logits_at(jp, jcfg, hj))
    lt = tq.logits_at(tp, tcfg, ht).numpy()
    np.testing.assert_allclose(lt, lj, rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(lt.argmax(-1), lj.argmax(-1))


def test_entry_points_need_explicit_cpu_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tq.init_params(tq.ModelConfig.tiny(), 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloader.load_checkpoint(DEMO)
