"""A float8_e5m2 KV cache in the port against the JAX package.

The JAX engine serves e5m2 through `kv_dtype=` (`ops/kv_cache.quantize_rows`
with the e4m3 maximum of 448 as the row target, then a cast).  The same numpy
inputs go through both packages:
  * `quantize_rows` / `write_kv_scaled`: stored bytes and float32 scales equal
    the jitted JAX functions' (XLA multiplies by 1/448 there, as the port does);
  * the plain paged and speculative attention on an e5m2 cache, quantized once
    by the JAX package, against JAX's references: 1e-6 of max|ref| in float32,
    1e-10 in float64;
  * the tiny fp64 engine with `kv_dtype=float8_e5m2` against the JAX engine
    with `kv_dtype=jnp.float8_e5m2`, token for token under AR, Jacobi and MR.
e5m2 keeps two mantissa bits, so a difference in rounding would show at once:
the bytes are compared before the tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jacobiforcing_tpu.config import Config as JConfig
from jacobiforcing_tpu.config import SamplingParams as JSamplingParams
from jacobiforcing_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from jacobiforcing_tpu.models import qwen as jq
from jacobiforcing_tpu.ops import kv_cache as jkv
from jacobiforcing_tpu.ops.attention import paged_attention_with_block as j_with_block
from jacobiforcing_tpu.ops.attention import paged_attention_xla
from jacobiforcing_tpu_torch.config import Config, SamplingParams
from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine
from jacobiforcing_tpu_torch.models import qwen as tq
from jacobiforcing_tpu_torch.ops import kv_cache as tkv
from jacobiforcing_tpu_torch.ops import paged_attention_cuda as pac
from jacobiforcing_tpu_torch.ops.attention import (
    paged_attention_ref, paged_attention_with_block_ref)
from jacobiforcing_tpu_torch.utils.loader import params_from_numpy
from tests import test_engine as jtests
from tests.test_torch_attention import _inputs
from tests.test_torch_spec_attention import _case

PAGE = 16
MR = "jacobi_multiblock_rejection_recycling"
E5M2 = (torch.float8_e5m2, jnp.float8_e5m2)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Several test workers share the CPU; two torch threads each keep the
    engines' many small ops from oversubscribing it (results do not depend
    on it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bytes(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _rel_err(out, ref):
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def test_quantize_rows_equals_jax():
    r = np.random.RandomState(5)
    x = (r.randn(3, 7, 2, 16) * r.choice([1e-3, 1.0, 700.0], size=(3, 7, 2, 1))).astype(np.float64)
    x[0, 0] = 0.0  # all-zero rows: scale floor 1e-12, zeros stored
    jq_, js = jax.jit(jkv.quantize_rows, static_argnums=1)(jnp.asarray(x), E5M2[1])
    q, s = tkv.quantize_rows(torch.from_numpy(x), E5M2[0])
    assert q.dtype == torch.float8_e5m2 and s.dtype == torch.float32
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(_bytes(q), _bytes(jq_))
    # the row's amax maps onto 448 (the e4m3 target), well inside e5m2's range
    assert float(q.to(torch.float32).abs().max()) == tkv.FP8_MAX
    assert torch.isfinite(q.to(torch.float32)).all() and not _bytes(q)[0, 0].any()


def test_write_kv_scaled_equals_jax():
    """Bytes and scales of an in-place scaled write, out-of-range slots dropped."""
    r = np.random.RandomState(6)
    KH, D, slots = 2, 16, 4 * PAGE
    k_new, v_new = r.randn(2, 5, KH, D) * 700, r.randn(2, 5, KH, D) * 3
    dest = np.asarray([[3, 17, slots, 62, slots + 7], [slots, 0, 1, slots, 40]], np.int32)
    jc = jkv.alloc_kv_cache(1, 4, PAGE, KH, D, E5M2[1])
    tc = tkv.alloc_kv_cache(1, 4, PAGE, KH, D, E5M2[0])
    assert tc.scaled and tc.k.dtype == torch.float8_e5m2
    jout = jax.jit(jkv.write_kv_scaled)(jc.k[0], jc.v[0], jc.k_scale[0], jc.v_scale[0],
                                        jnp.asarray(k_new), jnp.asarray(v_new), jnp.asarray(dest))
    tout = tkv.write_kv_scaled(tc.k[0], tc.v[0], tc.k_scale[0], tc.v_scale[0],
                               torch.from_numpy(k_new), torch.from_numpy(v_new),
                               torch.from_numpy(dest))
    for got, want in zip(tout[:2], jout[:2]):
        np.testing.assert_array_equal(_bytes(got), _bytes(want))
    for got, want in zip(tout[2:], jout[2:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _e5m2_cache(x):
    """x [KH, slots, D] quantized by the JAX package: (jax q, jax scale) and the
    same bytes and scales as torch tensors."""
    jq_, js = jax.jit(jkv.quantize_rows, static_argnums=1)(jnp.asarray(x), E5M2[1])
    tq_ = torch.from_numpy(np.asarray(jq_).view(np.uint8).copy()).view(torch.float8_e5m2)
    return (jq_, js), (tq_, torch.from_numpy(np.asarray(js).copy()))


@pytest.mark.parametrize("L,lens,start", [
    (4, (37, 80), None), (1, (17, 65), None), (8, (40, 56), (32, 48)),
])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-6)])
def test_paged_ref_on_e5m2_matches_jax(L, lens, start, dtype, tol):
    q, k, v, bt = _inputs(L=L, dtype=np.float32)
    q = (q / 600.0).astype(dtype)  # scores stay O(1): the softmax is smooth
    (jk, jks), (tk, tks) = _e5m2_cache(k * 600)
    (jv, jvs), (tv, tvs) = _e5m2_cache(v * 600)
    lens = np.asarray(lens, np.int32)
    first = np.asarray(start, np.int32) if start is not None else lens - L
    pos = first[:, None] + np.arange(L, dtype=np.int32)[None, :]
    scale = 1.0 / np.sqrt(q.shape[-1])
    ref = np.asarray(paged_attention_xla(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(pos), scale,
        page_size=PAGE, k_scale_l=jks, v_scale_l=jvs))
    out = paged_attention_ref(
        torch.from_numpy(q), tk, tv, torch.from_numpy(bt), torch.from_numpy(lens),
        torch.from_numpy(pos), scale, page_size=PAGE, k_scale_l=tks, v_scale_l=tvs).numpy()
    assert out.dtype == dtype and np.isfinite(out).all()
    assert _rel_err(out, ref) <= tol


@pytest.mark.parametrize("G,mask_kind", [(1, "tree"), (2, "random"), (7, "tree")])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-6)])
def test_spec_ref_on_e5m2_matches_jax(G, mask_kind, dtype, tol):
    q, k, v, bt, lens, k_new, v_new, mask = _case(G, mask_kind, np.float32, 40 + G)
    q = (q / 600.0).astype(dtype)
    k_new, v_new = (k_new * 600).astype(dtype), (v_new * 600).astype(dtype)
    (jk, jks), (tk, tks) = _e5m2_cache(k * 600)
    (jv, jvs), (tv, tvs) = _e5m2_cache(v * 600)
    scale = 1.0 / np.sqrt(q.shape[-1])
    rest = (bt, lens, k_new, v_new, mask)
    ref = np.asarray(j_with_block(jnp.asarray(q), jk, jv, *[jnp.asarray(a) for a in rest], scale,
                                  page_size=PAGE, k_scale_l=jks, v_scale_l=jvs))
    out = paged_attention_with_block_ref(
        torch.from_numpy(q), tk, tv, *[torch.from_numpy(a) for a in rest], scale,
        page_size=PAGE, k_scale_l=tks, v_scale_l=tvs).numpy()
    assert out.dtype == dtype and np.isfinite(out).all()
    assert _rel_err(out, ref) <= tol


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_kernel_wrapper_serves_e5m2_with_scales_only(q_dtype):
    """e5m2 is a served storage type of both kernels (code 4), with scales."""
    assert (q_dtype, torch.float8_e5m2) in pac.SUPPORTED_PAIRS
    assert pac._CACHE_CODES[torch.float8_e5m2] == 4
    q = torch.zeros(1, 2, 4, 64, dtype=q_dtype)
    k = torch.zeros(2, 64, 64, dtype=torch.float8_e5m2)
    s = torch.ones(2, 64, dtype=torch.float32)
    rest = (torch.zeros(1, 4, dtype=torch.int32), torch.ones(1, dtype=torch.int32),
            torch.zeros(1, 2, dtype=torch.int32), 16)
    with pytest.raises(ValueError, match="CUDA"):
        pac.check_inputs(q, k, k, *rest, s, s)
    with pytest.raises(ValueError, match="needs k_scale_l"):
        pac.check_inputs(q, k, k, *rest)


def _sps(cls, max_tokens):
    return {
        "ar": cls(temperature=0.0, max_tokens=max_tokens),
        "jacobi": cls(temperature=0.0, max_tokens=max_tokens, decode_strategy="jacobi",
                      jacobi_block_len=8, jacobi_max_blocks=1),
        "mr": cls(temperature=0.0, max_tokens=max_tokens, decode_strategy=MR,
                  jacobi_block_len=8, jacobi_max_blocks=2),
    }


ENGINE_KW = dict(kvcache_page_size=PAGE, max_model_len=256, jacobi_chunk_tokens=32,
                 prefill_token_buckets=(32, 64, 128, 256), eos=-1)


def test_e5m2_engine_equals_jax_engine():
    """AR == Jacobi == MR inside the e5m2 engine, and each stream equals the
    JAX engine's with `kv_dtype=jnp.float8_e5m2`, token for token; the pool
    is stored as e5m2 with scales, and its first prompt's bytes equal."""
    jcfg = jq.ModelConfig.tiny()
    jparams = jq.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    cfg = tq.ModelConfig.tiny()
    prompts = jtests.make_prompts(256)[:2]
    want, got = {}, {}
    for name, sp in _sps(JSamplingParams, 16).items():
        jeng = JLLMEngine(JConfig(**ENGINE_KW), model_cfg=jcfg, params=jparams, num_kv_pages=64,
                          kv_dtype=jnp.float8_e5m2)
        want[name] = [o["token_ids"] for o in jeng.generate(prompts, sp)]
    for name, sp in _sps(SamplingParams, 16).items():
        eng = LLMEngine(Config(**ENGINE_KW), model_cfg=cfg, params=params, num_kv_pages=64,
                        kv_dtype=torch.float8_e5m2, device="cpu")
        assert eng.kv.k.dtype == torch.float8_e5m2 and eng.kv.scaled
        got[name] = [o["token_ids"] for o in eng.generate(prompts, sp)]
    # the last engines' pools hold the same bytes and scales for the first
    # prompt's rows (its 5 tokens, on page 0, the first page both allocators
    # hand out)
    rows = slice(0, 5)
    np.testing.assert_array_equal(_bytes(eng.kv.k[0, :, rows]), _bytes(jeng.kv.k[0, :, rows]))
    np.testing.assert_array_equal(eng.kv.k_scale[0, :, rows].numpy(),
                                  np.asarray(jeng.kv.k_scale[0, :, rows]))
    assert want["ar"] == want["jacobi"] == want["mr"]
    for name in want:
        assert got[name] == want[name], name
        assert all(len(s) == 16 and all(0 <= t < 256 for t in s) for s in got[name])


def test_kv_pool_sizing_counts_one_byte_and_the_scales(monkeypatch):
    """Pages from free memory for an e5m2 pool: 1 byte per element plus 4
    bytes per row and KV head for each of the two scale planes."""
    cfg = tq.ModelConfig.tiny(dtype=torch.bfloat16)
    eng = object.__new__(LLMEngine)
    eng.device, eng.model_cfg = torch.device("cuda"), cfg
    eng.config = Config(hbm_utilization=0.5, enforce_eager=True, **ENGINE_KW)
    eng.group = None
    total = 1 << 30
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda dev=None: (total, total))
    npages = eng._pages_from_memory(PAGE, torch.float8_e5m2)
    per_token = 2 * cfg.num_layers * cfg.num_kv_heads * (cfg.head_dim + 4)
    assert npages == min((total // 2) // (per_token * PAGE), 40_000)
