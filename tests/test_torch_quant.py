"""Quantized serving in the port against the JAX package.

The same numpy inputs go through `jacobiforcing_tpu` and
`jacobiforcing_tpu_torch`:
  * `quantize_tensor` / `quantize_params`: int8 bytes and bfloat16 scale bits
    equal;
  * `mm`: weight-only and W8A8 in fp64 within 1e-9 relative (the same
    arithmetic, another summation order); the W8A8 integer sums equal;
  * `quantize_rows` / `write_kv_scaled`, fp8 e4m3 and int8: stored bytes and
    float32 scales equal;
  * `forward`, `forward_spec`, `logits_at`, `greedy_tokens` on the tiny fp64
    model with quantized parameters and a scaled cache: 1e-9, tokens equal;
  * the counterparts of tests/test_quant.py, with the port engine's token
    streams equal to the JAX engine's for int8, w8a8, fp8 KV and int8 KV under
    AR, Jacobi and MR (exact, no tolerance).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jacobiforcing_tpu.config import SamplingParams as JSamplingParams
from jacobiforcing_tpu.models import qwen as jq
from jacobiforcing_tpu.ops import kv_cache as jkv
from jacobiforcing_tpu.ops import quant as jquant
from jacobiforcing_tpu_torch.config import Config, SamplingParams
from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine
from jacobiforcing_tpu_torch.models import qwen as tq
from jacobiforcing_tpu_torch.ops import kv_cache as tkv
from jacobiforcing_tpu_torch.ops import quant as tquant
from jacobiforcing_tpu_torch.ops.attention import paged_attention_ref
from jacobiforcing_tpu_torch.utils.loader import params_from_numpy, params_to_numpy
from tests import helpers as jhelpers
from tests import test_engine as jtests

PAGE = 16
MR = "jacobi_multiblock_rejection_recycling"
TOL = dict(rtol=1e-9, atol=1e-9)
KV_DTYPES = {"fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn), "int8": (torch.int8, jnp.int8)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _f32(x):
    """A JAX or torch array as float32 numpy (bfloat16 bits compare as floats)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _raw_bytes(x):
    """Stored bytes of a narrow (fp8 / int8) JAX or torch array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _assert_quantized_equal(t, j):
    """A port weight {"q", "s"} against the JAX one: bytes and scale bits."""
    assert t["q"].dtype == torch.int8 and t["s"].dtype == torch.bfloat16
    np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
    np.testing.assert_array_equal(_f32(t["s"]), _f32(j["s"]))


# ---- ops/quant.py --------------------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((4, 64, 32), 1.0), ((64, 300), 0.02), ((2, 8, 16), 1e-9)])
def test_quantize_tensor_equals_jax(shape, scale):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32) * scale
    w[..., 0] = 0.0  # an all-zero output channel: the 1e-8 floor
    _assert_quantized_equal(tquant.quantize_tensor(_t(w)), jquant.quantize_tensor(jnp.asarray(w)))


def test_quantize_roundtrip_error():
    r = np.random.RandomState(0)
    w = _t(r.randn(4, 64, 32).astype(np.float32))
    qd = tquant.quantize_tensor(w)
    deq = qd["q"].float() * qd["s"].float()
    assert float((deq - w).abs().max() / w.abs().max()) < 0.01
    x = _t(r.randn(5, 64).astype(np.float32))
    qd0 = {"q": qd["q"][0], "s": qd["s"][0]}  # a per-layer slice, as the forward takes it
    np.testing.assert_allclose(tquant.mm(x, qd0).numpy(), (x @ deq[0]).numpy(),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("a8", [False, True])
def test_mm_equals_jax(dtype, a8):
    r = np.random.RandomState(3)
    w = r.randn(64, 48).astype(np.float32)
    x = (r.randn(2, 5, 64) * 3.0).astype(dtype)
    x[0, 1] = 0.0  # an all-zero token: the activation scale's floor
    jw = jquant.quantize_tensor(jnp.asarray(w))
    tw = tquant.quantize_tensor(_t(w))
    want = np.asarray(jax.jit(jquant.mm, static_argnames="a8")(jnp.asarray(x), jw, a8=a8))
    got = tquant.mm(_t(x), tw, a8=a8)
    assert got.dtype == _t(x).dtype
    tol = TOL if dtype == np.float64 else dict(rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    assert np.asarray(jquant.mm(jnp.asarray(x), jnp.asarray(w))).shape == got.shape
    np.testing.assert_allclose(tquant.mm(_t(x), _t(w).to(_t(x).dtype)).numpy(), x @ w.astype(dtype),
                               rtol=1e-5, atol=1e-5)


def test_w8a8_integer_sums_equal_jax():
    """The int8 x int8 product is exact: equal to XLA's int32 sums, and a row's
    sums do not depend on the rows it is batched with."""
    r = np.random.RandomState(4)
    x = r.randn(7, 128).astype(np.float32) * 5
    wq = r.randint(-127, 128, (128, 40)).astype(np.int8)
    xq, sx = tquant.act_quantize(_t(x))
    jxq, jsx = jax.jit(jq._act_quantize)(jnp.asarray(x))
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    want = np.asarray(jnp.dot(jxq, jnp.asarray(wq), preferred_element_type=jnp.int32))
    got = tquant.int8_matmul(xq, _t(wq))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
    solo = tquant.int8_matmul(xq[3:4], _t(wq))
    assert torch.equal(solo[0], got[3])


def test_w8a8_mm_accuracy():
    r = np.random.RandomState(3)
    w = _t(r.randn(64, 32).astype(np.float32))
    x = _t((r.randn(5, 64) * 3.0).astype(np.float32))
    ref = (x @ w).numpy()
    got = tquant.mm(x, tquant.quantize_tensor(w), a8=True).numpy()
    assert np.abs(got - ref).max() / np.abs(ref).max() < 0.03


def _tiny_pair(seed=0, vocab=256, **kw):
    """The JAX tests' tiny fp64 model and the same weights in the port."""
    jcfg = jq.ModelConfig.tiny(vocab_size=vocab, **kw)
    jparams = jq.init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = tq.ModelConfig.tiny(vocab_size=vocab, **kw)
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams))


def test_quantize_params_equals_jax_leaf_for_leaf():
    """The port's `quantize_params` of the carried-over float weights, and the
    JAX package's quantized pytree carried over, are the same leaves."""
    jcfg, jparams, cfg, params = _tiny_pair()
    jqp = jquant.quantize_params(jparams)
    own = tquant.quantize_params(params)
    carried = params_from_numpy(jax.tree.map(np.asarray, jqp), dtype=torch.float64)
    for tree in (own, carried):
        for k in tquant.QUANT_KEYS:
            _assert_quantized_equal(tree["layers"][k], jqp["layers"][k])
        _assert_quantized_equal(tree["lm_head"], jqp["lm_head"])
        for k in ("ln1", "ln2", "bq", "bk", "bv"):
            assert tree["layers"][k].dtype == torch.float64
            np.testing.assert_array_equal(tree["layers"][k].numpy(), np.asarray(jqp["layers"][k]))
        np.testing.assert_array_equal(tree["embed"].numpy(), np.asarray(jqp["embed"]))
    assert tquant.is_quantized(own["lm_head"]) and not tquant.is_quantized(own["embed"])
    again = tquant.quantize_params(own)  # quantized leaves are left alone
    assert again["layers"]["wq"]["q"] is own["layers"]["wq"]["q"]
    no_head = tquant.quantize_params(params, include_lm_head=False)
    assert not tquant.is_quantized(no_head["lm_head"])


def test_quantized_params_round_trip_through_numpy():
    """params_to_numpy / params_from_numpy carry three-level pytrees: `q` stays
    int8 and `s` bfloat16 whatever `dtype` says."""
    _, _, _, params = _tiny_pair()
    qp = tquant.quantize_params(params)
    as_np = params_to_numpy(qp)
    assert as_np["layers"]["wq"]["q"].dtype == np.int8
    assert as_np["layers"]["wq"]["s"].dtype == np.float32  # bfloat16 leaves numpy as float32
    for dtype in (None, torch.float32):
        back = params_from_numpy(as_np, dtype=dtype)
        for leaf, orig in ((back["layers"]["w_down"], qp["layers"]["w_down"]),
                           (back["lm_head"], qp["lm_head"])):
            assert leaf["q"].dtype == torch.int8 and leaf["s"].dtype == torch.bfloat16
            assert torch.equal(leaf["q"], orig["q"]) and torch.equal(leaf["s"], orig["s"])
        assert back["layers"]["ln1"].dtype == (dtype or torch.float64)


def test_init_quantized_params_layout():
    cfg = tq.ModelConfig.tiny(vocab_size=300)
    p = tquant.init_quantized_params(cfg, 0, device="cpu")
    again = tquant.init_quantized_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jp = jquant.init_quantized_params(jq.ModelConfig.tiny(vocab_size=300), jax.random.PRNGKey(0))
    assert set(p) == set(jp) and set(p["layers"]) == set(jp["layers"])
    for k in tquant.QUANT_KEYS:
        q, s = p["layers"][k]["q"], p["layers"][k]["s"]
        assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
        assert tuple(q.shape) == jp["layers"][k]["q"].shape
        assert tuple(s.shape) == jp["layers"][k]["s"].shape
        assert int(q.min()) >= -127 and int(q.max()) <= 127 and q.float().std() > 60
        np.testing.assert_array_equal(_f32(s), _f32(jp["layers"][k]["s"]))  # the same scale rule
        assert torch.equal(q, again["layers"][k]["q"])
    assert p["lm_head"]["q"].shape == (cfg.hidden_size, 300)
    assert p["embed"].dtype == cfg.dtype and p["layers"]["bq"].dtype == cfg.dtype
    tied = tquant.init_quantized_params(tq.ModelConfig.tiny(tie_word_embeddings=True), 1, "cpu")
    assert "lm_head" not in tied


# ---- ops/kv_cache.py -----------------------------------------------------------


def test_jitted_division_by_a_constant_is_a_multiplication():
    """Why the port multiplies by `INV_127` and `1 / 448` where the JAX source
    divides: under `jax.jit` (every caller of `mm` and `quantize_rows` there)
    XLA multiplies by the float32 reciprocal, which differs from the eager
    division in a share of inputs; the port's constants are those
    reciprocals."""
    x = np.abs(np.random.RandomState(0).randn(100000)).astype(np.float32)
    for c, inv in ((127.0, tquant.INV_127), (448.0, tkv._INV_FP8_MAX)):
        jitted = np.asarray(jax.jit(lambda a, c=c: a / c)(jnp.asarray(x)))
        eager = np.asarray(jnp.asarray(x) / c)
        port = (_t(x) * inv).numpy()
        np.testing.assert_array_equal(port, jitted)
        differ = float((jitted != eager).mean())
        assert 0.01 < differ < 0.7, (c, differ)  # 4.5% for 127, 54% for 448
    assert tkv._INV_INT8_MAX == tquant.INV_127


@pytest.mark.parametrize("kind", ["fp8", "int8"])
def test_quantize_rows_equals_jax(kind):
    tdt, jdt = KV_DTYPES[kind]
    r = np.random.RandomState(5)
    x = (r.randn(3, 7, 2, 16) * r.choice([1e-3, 1.0, 700.0], size=(3, 7, 2, 1))).astype(np.float64)
    x[0, 0] = 0.0  # all-zero rows: scale floor 1e-12, zeros stored
    jq_, js = jax.jit(jkv.quantize_rows, static_argnums=1)(jnp.asarray(x), jdt)
    q, s = tkv.quantize_rows(_t(x), tdt)
    assert q.dtype == tdt and s.dtype == torch.float32 and tuple(s.shape) == (3, 7, 2)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_raw_bytes(q), _raw_bytes(jq_))
    assert float(s[0, 0, 0]) == np.float32(1e-12) and not _raw_bytes(q)[0, 0].any()
    # the row's amax maps onto the type's largest value exactly: nothing is out of range
    top = tkv.FP8_MAX if kind == "fp8" else tkv.INT8_MAX
    assert float(q.to(torch.float32).abs().max()) == top  # e4m3: 448.0x rounds to 448
    assert torch.isfinite(q.to(torch.float32)).all()


def test_needs_row_scales_and_alloc():
    assert tkv.FP8_MAX == jkv.FP8_MAX and tkv.INT8_MAX == jkv.INT8_MAX
    for dt in (torch.float8_e4m3fn, torch.float8_e5m2, torch.int8):
        assert tkv.needs_row_scales(dt)
    for dt in (torch.bfloat16, torch.float32, torch.float64):
        assert not tkv.needs_row_scales(dt)
    kv = tkv.alloc_kv_cache(2, 4, PAGE, 2, 16, torch.float8_e4m3fn)
    assert kv.scaled and kv.k_scale.shape == (2, 2, 64) and kv.k_scale.dtype == torch.float32
    assert bool((kv.k_scale == 1).all()) and bool((kv.v_scale == 1).all())
    plain = tkv.alloc_kv_cache(2, 4, PAGE, 2, 16, torch.bfloat16)
    assert not plain.scaled and plain.k_scale is None and plain.v_scale is None


@pytest.mark.parametrize("kind", ["fp8", "int8"])
def test_write_kv_scaled_equals_jax(kind):
    """Stored bytes and scales equal, with the drop semantics of `write_kv`
    (out-of-range slots are skipped), in place."""
    tdt, jdt = KV_DTYPES[kind]
    r = np.random.RandomState(6)
    KH, D, slots = 2, 16, 4 * PAGE
    k_new = r.randn(2, 5, KH, D) * 700
    v_new = r.randn(2, 5, KH, D) * 3
    dest = np.asarray([[3, 17, slots, 62, slots + 7], [slots, 0, 1, slots, 40]], np.int32)
    jc = jkv.alloc_kv_cache(1, 4, PAGE, KH, D, jdt)
    tc = tkv.alloc_kv_cache(1, 4, PAGE, KH, D, tdt)
    jout = jax.jit(jkv.write_kv_scaled)(jc.k[0], jc.v[0], jc.k_scale[0], jc.v_scale[0],
                               jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(dest))
    tout = tkv.write_kv_scaled(tc.k[0], tc.v[0], tc.k_scale[0], tc.v_scale[0],
                               _t(k_new), _t(v_new), _t(dest))
    assert tout[0].data_ptr() == tc.k.data_ptr() and tout[2].data_ptr() == tc.k_scale.data_ptr()
    for got, want in zip(tout[:2], jout[:2]):
        np.testing.assert_array_equal(_raw_bytes(got), _raw_bytes(want))
    for got, want in zip(tout[2:], jout[2:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(tc.k_scale[0, 0, slots - 1]) == 1.0  # untouched by the out-of-range tokens
    # gather_scales follows the block table like gather_pages
    bt = np.asarray([[2, 0, -1], [3, 1, 2]], np.int32)
    np.testing.assert_array_equal(
        tkv.gather_scales(tout[2], _t(bt), PAGE).numpy(),
        np.asarray(jkv.gather_scales(jout[2], jnp.asarray(bt), PAGE)))
    np.testing.assert_array_equal(
        _raw_bytes(tkv.gather_pages(tout[0], _t(bt), PAGE)),
        _raw_bytes(jkv.gather_pages(jout[0], jnp.asarray(bt), PAGE)))


def test_fp8_scaled_write_roundtrip():
    """Per-row scales keep the dequant error at fp8's relative precision for
    magnitudes far beyond the e4m3 maximum (448)."""
    r = np.random.RandomState(0)
    KH, D = 2, 16
    kv = tkv.alloc_kv_cache(1, 4, PAGE, KH, D, torch.float8_e4m3fn)
    k_new = _t((r.randn(1, 8, KH, D) * 700).astype(np.float32))
    v_new = _t((r.randn(1, 8, KH, D) * 700).astype(np.float32))
    slots = torch.arange(8, dtype=torch.int32)[None]
    tkv.write_kv_scaled(kv.k[0], kv.v[0], kv.k_scale[0], kv.v_scale[0], k_new, v_new, slots)
    bt = torch.tensor([[0]], dtype=torch.int32)
    deq = tkv.dequantize_rows(tkv.gather_pages(kv.k[0], bt, PAGE),
                              tkv.gather_scales(kv.k_scale[0], bt, PAGE), torch.float32)[0, :8]
    rel = (deq - k_new[0]).abs() / (k_new[0].abs() + 1e-6)
    assert float(rel.max()) < 0.07  # e4m3: 3 mantissa bits, 6.25% at worst


def test_int8_kv_write_roundtrip_bound():
    """int8 rows: the dequant error is at most half a step (amax / 254)."""
    r = np.random.RandomState(0)
    KH, D = 2, 16
    kv = tkv.alloc_kv_cache(1, 4, PAGE, KH, D, torch.int8)
    k_new = _t((r.randn(1, 8, KH, D) * 700).astype(np.float32))
    slots = torch.arange(8, dtype=torch.int32)[None]
    tkv.write_kv_scaled(kv.k[0], kv.v[0], kv.k_scale[0], kv.v_scale[0], k_new, k_new, slots)
    bt = torch.tensor([[0]], dtype=torch.int32)
    deq = tkv.dequantize_rows(tkv.gather_pages(kv.k[0], bt, PAGE),
                              tkv.gather_scales(kv.k_scale[0], bt, PAGE), torch.float32)[0, :8]
    amax = k_new[0].abs().amax(-1, keepdim=True)
    assert bool(((deq - k_new[0]).abs() <= amax / 254.0 * 1.01 + 1e-6).all())


def test_fp8_scaled_attention_bounded_delta():
    """Attention over a scaled fp8 cache with out-of-range magnitudes stays
    within fp8 precision of the float32 oracle."""
    r = np.random.RandomState(1)
    B, L, NH, KH, D, S = 2, 4, 4, 2, 32, 48
    kv8 = tkv.alloc_kv_cache(1, 8, PAGE, KH, D, torch.float8_e4m3fn)
    kv32 = tkv.alloc_kv_cache(1, 8, PAGE, KH, D, torch.float32)
    k_new = _t((r.randn(B, S, KH, D) * 600).astype(np.float32))
    v_new = _t((r.randn(B, S, KH, D) * 600).astype(np.float32))
    bt = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]], dtype=torch.int32)
    pos = torch.arange(S)[None].expand(B, S)
    slots = torch.gather(bt.long(), 1, pos // PAGE) * PAGE + pos % PAGE
    tkv.write_kv_scaled(kv8.k[0], kv8.v[0], kv8.k_scale[0], kv8.v_scale[0], k_new, v_new, slots)
    tkv.write_kv(kv32.k[0], kv32.v[0], k_new, v_new, slots)
    q = _t((r.randn(B, L, NH, D) / 600.0).astype(np.float32))
    lens = torch.tensor([S, S], dtype=torch.int32)
    qpos = (lens - L)[:, None] + torch.arange(L, dtype=torch.int32)[None]
    scale = 1.0 / np.sqrt(D)
    ref = paged_attention_ref(q, kv32.k[0], kv32.v[0], bt, lens, qpos, scale, page_size=PAGE)
    out = paged_attention_ref(q, kv8.k[0], kv8.v[0], bt, lens, qpos, scale, page_size=PAGE,
                              k_scale_l=kv8.k_scale[0], v_scale_l=kv8.v_scale[0])
    assert float((out - ref).abs().max() / ref.abs().max()) < 0.08


# ---- models/qwen.py ------------------------------------------------------------


def _quantized_pair(quantization, vocab=300, seed=0, **kw):
    """(jax cfg, jax params, port cfg, port params) of the tiny model, quantized
    by the JAX package and carried over."""
    jcfg, jparams, cfg, _ = _tiny_pair(seed, vocab, **kw)
    jparams = jquant.quantize_params(jparams)
    if quantization == "w8a8":
        jcfg = dataclasses.replace(jcfg, act_quant=True)
        cfg = dataclasses.replace(cfg, act_quant=True)
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("quantization", ["int8", "w8a8"])
def test_quantized_head_equals_jax(quantization):
    """`logits_at` and the chunked `greedy_tokens` with an int8 lm_head."""
    jcfg, jparams, cfg, params = _quantized_pair(quantization)
    h = np.random.RandomState(1).randn(3, 5, cfg.hidden_size)
    want = np.asarray(jax.jit(jq.logits_at, static_argnums=1)(jparams, jcfg, jnp.asarray(h)))
    got = tq.logits_at(params, cfg, _t(h))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    full = torch.argmax(got, dim=-1).to(torch.int32)
    chunked = tq.greedy_tokens(params, cfg, _t(h), vocab_chunk=128)
    assert torch.equal(chunked, full)
    jgreedy = jax.jit(jq.greedy_tokens, static_argnums=1, static_argnames="vocab_chunk")
    np.testing.assert_array_equal(
        chunked.numpy(), np.asarray(jgreedy(jparams, jcfg, jnp.asarray(h), vocab_chunk=128)))


@pytest.mark.parametrize("tied", [False, True])
def test_chunked_greedy_matches_full(tied):
    cfg = tq.ModelConfig.tiny(vocab_size=300, tie_word_embeddings=tied)
    params = tq.init_params(cfg, 2, device="cpu")
    h = _t(np.random.RandomState(3).randn(3, 5, cfg.hidden_size))
    full = torch.argmax(tq.logits_at(params, cfg, h), dim=-1).to(torch.int32)
    assert torch.equal(tq.greedy_tokens(params, cfg, h, vocab_chunk=128), full)


def _forward_case(quantization, kind):
    jcfg, jparams, cfg, params = _quantized_pair(quantization, vocab=64)
    tdt, jdt = KV_DTYPES[kind] if kind else (cfg.dtype, jcfg.dtype)
    jkvc = jkv.alloc_kv_cache(jcfg.num_layers, 64, PAGE, jcfg.num_kv_heads, jcfg.head_dim, jdt)
    kvc = tkv.alloc_kv_cache(cfg.num_layers, 64, PAGE, cfg.num_kv_heads, cfg.head_dim, tdt)
    jrope = jq.rope_table(jcfg)
    rope = tuple(_t(a) for a in jrope)
    return (jcfg, jparams, jrope, jkvc), (cfg, params, rope, kvc)


def _assert_cache_equal(kvc, jkvc):
    if kvc.scaled:
        np.testing.assert_array_equal(_raw_bytes(kvc.k), _raw_bytes(jkvc.k))
        np.testing.assert_array_equal(_raw_bytes(kvc.v), _raw_bytes(jkvc.v))
        np.testing.assert_array_equal(kvc.k_scale.numpy(), np.asarray(jkvc.k_scale))
        np.testing.assert_array_equal(kvc.v_scale.numpy(), np.asarray(jkvc.v_scale))
    else:
        np.testing.assert_allclose(kvc.k.numpy(), np.asarray(jkvc.k), **TOL)
        np.testing.assert_allclose(kvc.v.numpy(), np.asarray(jkvc.v), **TOL)


@pytest.mark.parametrize("quantization,kind", [
    ("int8", None), ("w8a8", None), ("", "fp8"), ("", "int8"), ("w8a8", "fp8"), ("int8", "int8"),
])
def test_forward_and_forward_spec_equal_jax(quantization, kind):
    """Prefill (`forward`, which writes the cache) and then a speculative
    block (`forward_spec`, which writes nothing) on the tiny fp64 model."""
    from jacobiforcing_tpu_torch.engine.multiblock import tree_mask

    jax_side, port_side = _forward_case(quantization, kind)
    if not quantization:
        jcfg, jparams, cfg, params = _tiny_pair(vocab=64)
        jax_side = (jcfg, jparams) + jax_side[2:]
        port_side = (cfg, params) + port_side[2:]
    jcfg, jparams, jrope, jkvc = jax_side
    cfg, params, rope, kvc = port_side
    prompts = [[3, 9, 4, 1, 7], [5, 2, 8, 8, 1, 6, 3, 2, 9]]
    bt = jhelpers.contiguous_block_tables(2, 8, 64)
    ids, lens = jhelpers.pad_batch(prompts)
    pos = np.broadcast_to(np.arange(ids.shape[1], dtype=np.int32), ids.shape)
    wmask = pos < lens[:, None]
    jh, jkvc = jq.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), jkvc, jnp.asarray(bt),
                          jnp.asarray(lens), jrope, write_mask=jnp.asarray(wmask))
    h, _ = tq.forward(params, cfg, _t(ids), _t(pos), kvc, _t(bt), _t(lens), rope,
                      write_mask=_t(wmask))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    _assert_cache_equal(kvc, jkvc)

    N, K, C = 4, 2, 2
    T = (1 + C + K - 1) * N
    r = np.random.RandomState(1)
    sids = r.randint(0, 64, (2, T)).astype(np.int32)
    spos = (lens[:, None] + r.randint(0, 2 * N, (2, T))).astype(np.int32)
    tv = r.rand(2, T) < 0.85
    mask = tree_mask(N, K, C, "cpu").numpy()[None] & tv[:, :, None] & tv[:, None]
    before = kvc.k.clone().view(torch.uint8) if kvc.scaled else kvc.k.clone()
    jh, jk, jv = jq.forward_spec(jparams, jcfg, jnp.asarray(sids), jnp.asarray(spos), jkvc,
                                 jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(mask), jrope)
    h, k_new, v_new = tq.forward_spec(params, cfg, _t(sids), _t(spos), kvc, _t(bt), _t(lens),
                                      _t(mask), rope)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(k_new.numpy(), np.asarray(jk), **TOL)  # returned unquantized
    np.testing.assert_allclose(v_new.numpy(), np.asarray(jv), **TOL)
    after = kvc.k.view(torch.uint8) if kvc.scaled else kvc.k
    assert torch.equal(after, before)


# ---- the engine ----------------------------------------------------------------

ENGINE_KW = dict(kvcache_page_size=PAGE, max_model_len=256, jacobi_chunk_tokens=32,
                 prefill_token_buckets=(32, 64, 128, 256), eos=-1)


def make_engine(num_pages=128, **cfg_kw):
    _, _, mc, params = _tiny_pair()
    return LLMEngine(Config(**{**ENGINE_KW, **cfg_kw}), model_cfg=mc, params=params,
                     num_kv_pages=num_pages, device="cpu")


def _sps(cls, max_tokens):
    return {
        "ar": cls(temperature=0.0, max_tokens=max_tokens),
        "jacobi": cls(temperature=0.0, max_tokens=max_tokens, decode_strategy="jacobi",
                      jacobi_block_len=8, jacobi_max_blocks=1),
        "mr": cls(temperature=0.0, max_tokens=max_tokens, decode_strategy=MR,
                  jacobi_block_len=8, jacobi_max_blocks=2),
    }


def _streams(outs):
    return [o["token_ids"] for o in outs]


@pytest.mark.parametrize("kw", [
    dict(quantization="int8"), dict(quantization="w8a8"), dict(kv_cache_dtype="fp8"),
    dict(kv_cache_dtype="int8"), dict(quantization="w8a8", kv_cache_dtype="fp8"),
], ids=lambda kw: "+".join(kw.values()))
def test_quantized_engine_equals_jax_engine(kw):
    """Inside each quantized engine AR == Jacobi == MR, and every stream
    equals the JAX engine's for the same configuration."""
    prompts = jtests.make_prompts(256)[:2]
    jeng = jtests.make_engine(**kw)
    want = {name: _streams(jeng.generate(prompts, sp))
            for name, sp in _sps(JSamplingParams, 16).items()}
    assert want["ar"] == want["jacobi"] == want["mr"]
    for name, sp in _sps(SamplingParams, 16).items():
        got = _streams(make_engine(**kw).generate(prompts, sp))
        assert got == want[name], name
        assert all(len(s) == 16 and all(0 <= t < 256 for t in s) for s in got)


def test_int8_engine_generates_close_to_fp():
    """The int8 engine runs every strategy; its outputs are valid and full length."""
    prompts = jtests.make_prompts(256)[:2]
    eng = make_engine(quantization="int8")
    assert tquant.is_quantized(eng.params["layers"]["wq"]) and not eng.model_cfg.act_quant
    for sp in _sps(SamplingParams, 16).values():
        for o in eng.generate(prompts, sp):
            assert len(o["token_ids"]) == 16 and all(0 <= t < 256 for t in o["token_ids"])


def test_int8_jacobi_equals_int8_ar():
    prompts = jtests.make_prompts(256)[:2]
    sps = _sps(SamplingParams, 20)
    ar = make_engine(quantization="int8").generate(prompts, sps["ar"])
    ja = make_engine(quantization="int8").generate(prompts, sps["jacobi"])
    assert _streams(ar) == _streams(ja)


def test_w8a8_engine_all_strategies():
    prompts = jtests.make_prompts(256)[:2]
    eng = make_engine(quantization="w8a8")
    assert eng.model_cfg.act_quant
    outs = {name: _streams(make_engine(quantization="w8a8").generate(prompts, sp))
            for name, sp in _sps(SamplingParams, 16).items()}
    assert outs["ar"] == outs["jacobi"] == outs["mr"]


@pytest.mark.parametrize("kind", ["fp8", "int8", "bf16"])
def test_narrow_kv_cache_engine_exact(kind):
    """Jacobi == MR == AR exactly inside an engine with a narrow KV cache."""
    prompts = jtests.make_prompts(256)[:2]
    want = {"fp8": torch.float8_e4m3fn, "int8": torch.int8, "bf16": torch.bfloat16}[kind]
    outs = {}
    for name, sp in _sps(SamplingParams, 16).items():
        eng = make_engine(kv_cache_dtype=kind)
        assert eng.kv.k.dtype == want and eng.kv.scaled == (kind != "bf16")
        outs[name] = _streams(eng.generate(prompts, sp))
    assert outs["ar"] == outs["jacobi"] == outs["mr"]


def test_quantized_params_passed_in_are_served_as_they_come():
    """`init_quantized_params` leaves go through `quantization="w8a8"` untouched."""
    cfg = tq.ModelConfig.tiny()
    params = tquant.init_quantized_params(cfg, 0, device="cpu")
    eng = LLMEngine(Config(quantization="w8a8", kv_cache_dtype="fp8", **ENGINE_KW), model_cfg=cfg,
                    params=params, num_kv_pages=64, device="cpu")
    assert eng.params["layers"]["wq"]["q"] is params["layers"]["wq"]["q"]
    prompts = jtests.make_prompts(256)[:2]
    sps = _sps(SamplingParams, 12)
    ar = _streams(eng.generate(prompts, sps["ar"]))
    assert ar == _streams(eng.generate(prompts, sps["jacobi"]))
    assert ar == _streams(eng.generate(prompts, sps["mr"]))


def test_standalone_api_with_a_scaled_cache():
    """`modeling.jacobi_generate_*` with quantized parameters and `kv_dtype`."""
    from jacobiforcing_tpu_torch import modeling

    _, _, cfg, params = _tiny_pair()
    qp = tquant.quantize_params(params)
    prompt = jtests.make_prompts(256)[1]
    a, _ = modeling.jacobi_generate_greedy(qp, cfg, prompt, n_token_seq_len=8, max_new_tokens=16,
                                           page_size=PAGE, kv_dtype=torch.int8, device="cpu")
    b, _ = modeling.jacobi_generate_multiblock(qp, cfg, prompt, n_token_seq_len=8, K=2,
                                               max_new_tokens=16, page_size=PAGE,
                                               kv_dtype=torch.int8, device="cpu")
    assert len(a) >= 16 and a[:16] == b[:16]


@pytest.mark.parametrize("kw", [
    dict(quantization="int4"), dict(quantization="fp8"), dict(kv_cache_dtype="fp4"),
    dict(kv_cache_dtype="e5m2"), dict(kv_cache_dtype="float8"),
])
def test_unknown_quantization_strings_raise(kw):
    with pytest.raises(ValueError, match="expected one of"):
        Config(**kw)


def test_e5m2_kv_cache_is_refused():
    _, _, cfg, params = _tiny_pair()
    with pytest.raises(NotImplementedError, match="float8_e5m2"):
        LLMEngine(Config(**ENGINE_KW), model_cfg=cfg, params=params, num_kv_pages=8,
                  kv_dtype=torch.float8_e5m2, device="cpu")


@pytest.mark.parametrize("kind,row_bytes", [("", 2 * 16), ("fp8", 16 + 4), ("int8", 16 + 4),
                                            ("bf16", 2 * 16)])
def test_kv_pool_sizing_counts_the_narrow_type_and_its_scales(monkeypatch, kind, row_bytes):
    """Pages from free memory: element size of the storage type, plus 4 bytes
    per row and KV head for each scale plane."""
    cfg = tq.ModelConfig.tiny(dtype=torch.bfloat16)
    eng = object.__new__(LLMEngine)
    eng.device, eng.model_cfg = torch.device("cuda"), cfg
    eng.config = Config(hbm_utilization=0.5, **ENGINE_KW)
    total = 1 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (total, total))
    from jacobiforcing_tpu_torch.engine.llm_engine import KV_DTYPES as ENGINE_KV_DTYPES

    npages = eng._pages_from_memory(PAGE, ENGINE_KV_DTYPES.get(kind, cfg.dtype))
    per_token = 2 * cfg.num_layers * cfg.num_kv_heads * row_bytes
    assert npages == min((total // 2) // (per_token * PAGE), 40_000)


def test_bench_generate_serves_quantized_from_the_shell(monkeypatch):
    """`--quantization` / `--kv-cache-dtype` of the port's bench_generate reach
    the engine's configuration; a string the engine does not serve is refused
    by the parser."""
    from jacobiforcing_tpu_torch.apps import bench_generate
    from jacobiforcing_tpu_torch.engine import llm as llm_mod

    seen = {}

    class Recorder:
        def __init__(self, **kw):
            seen.update(kw)
            raise KeyboardInterrupt  # the engine itself is covered above

    monkeypatch.setattr(llm_mod, "LLM", Recorder)
    args = bench_generate.make_parser().parse_args([
        "--model", "ckpt", "--device", "cpu", "--quantization", "w8a8", "--kv-cache-dtype", "fp8"])
    with pytest.raises(KeyboardInterrupt):
        bench_generate.run(args)
    assert seen["quantization"] == "w8a8" and seen["kv_cache_dtype"] == "fp8"
    assert seen["device"] == "cpu" and seen["model"] == "ckpt"
    Config(quantization=seen["quantization"], kv_cache_dtype=seen["kv_cache_dtype"])
    defaults = bench_generate.make_parser().parse_args([])
    assert defaults.quantization == "" and defaults.kv_cache_dtype == ""
    for bad in (["--quantization", "int4"], ["--kv-cache-dtype", "fp4"]):
        with pytest.raises(SystemExit):
            bench_generate.make_parser().parse_args(bad)
