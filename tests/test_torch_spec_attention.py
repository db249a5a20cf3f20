"""The port's speculative (MR) attention against the JAX package.

The same numpy inputs go through `jacobiforcing_tpu.ops.attention.
paged_attention_with_block` (its dense XLA path, which the CPU backend
takes), through the TPU kernel `spec_attention_pallas` in interpret mode with
the exact online softmax, and through the port's plain version
`paged_attention_with_block_ref`.  Tolerances, relative to max|ref|: fp64
1e-9 (the same masked softmax, only the summation order differs), f32 1e-5.
Rows with no visible key at all are left out of the comparison with the TPU
kernel: it writes zeros there, the dense versions a uniform average, and the
decoder discards such rows.

With a narrow committed cache (fp8 e4m3 / int8 with per-row scales, K/V
magnitudes ~600) both packages read the bytes and scales the JAX package
quantized; the in-flight block stays in the query dtype.  Same tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jacobiforcing_tpu.ops import kv_cache as jkv
from jacobiforcing_tpu.ops.attention import paged_attention_with_block as j_with_block
from jacobiforcing_tpu.ops.pallas.spec_attention import spec_attention_pallas
from jacobiforcing_tpu_torch.engine.multiblock import tree_mask
from jacobiforcing_tpu_torch.ops import spec_attention_cuda as sac
from jacobiforcing_tpu_torch.ops.attention import (
    paged_attention_with_block,
    paged_attention_with_block_ref,
)

PAGE = 16
KV_KINDS = {"fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn), "int8": (torch.int8, jnp.int8)}


def scaled_cache(x, kind):
    """x [KH, slots, D] float32 quantized row by row by the JAX package:
    ((jax q, jax scale), (torch q, torch scale)) over the same bytes."""
    tdt, jdt = KV_KINDS[kind]
    jq_, js = jax.jit(jkv.quantize_rows, static_argnums=1)(jnp.asarray(x), jdt)
    tq_ = torch.from_numpy(np.asarray(jq_).view(np.uint8).copy()).view(tdt)
    return (jq_, js), (tq_, torch.from_numpy(np.asarray(js).copy()))


def _case(G, mask_kind, dtype, seed, D=128, KH=2, N=4, K=2, C=2, lens=(37, 0, 80, 1)):
    """Four sequences: ragged committed lengths including 0, row 3 a
    batch-bucket padding row (all -1 table, length 1, all-false mask)."""
    r = np.random.RandomState(seed)
    B = len(lens)
    S = 1 + C + (K - 1)
    T = S * N
    pages_per_seq, num_pages = 6, 6 * B + 3
    q = r.randn(B, T, KH * G, D).astype(dtype)
    k = r.randn(KH, num_pages * PAGE, D).astype(dtype)
    v = r.randn(KH, num_pages * PAGE, D).astype(dtype)
    k_new = r.randn(B, T, KH, D).astype(dtype)
    v_new = r.randn(B, T, KH, D).astype(dtype)
    perm = r.permutation(num_pages)
    bt = np.full((B, pages_per_seq), -1, np.int32)
    for b in range(B - 1):
        n = -(-lens[b] // PAGE)
        bt[b, :n] = perm[b * pages_per_seq : b * pages_per_seq + n]
    if mask_kind == "tree":
        sees = tree_mask(N, K, C, "cpu").numpy()
        tok_valid = r.rand(B, T) < 0.8  # holes, as inactive segments and short drafts leave
        tok_valid[:, 0] = True
        mask = sees[None] & tok_valid[:, :, None] & tok_valid[:, None, :]
    else:
        mask = r.rand(B, T, T) < 0.4
    mask[B - 1] = False
    return q, k, v, bt, np.asarray(lens, np.int32), k_new, v_new, mask


def _port(args, scale):
    return paged_attention_with_block_ref(
        *[torch.from_numpy(a) for a in args], scale, page_size=PAGE).numpy()


def _rel_err(out, ref):
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("G", [1, 2, 7])
@pytest.mark.parametrize("mask_kind", ["tree", "random"])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9), (np.float32, 1e-5)])
def test_ref_matches_jax_dense(G, mask_kind, dtype, tol):
    args = _case(G, mask_kind, dtype, seed=G)
    scale = 1.0 / np.sqrt(args[0].shape[-1])
    ref = np.asarray(j_with_block(*[jnp.asarray(a) for a in args], scale, page_size=PAGE))
    out = _port(args, scale)
    assert out.dtype == dtype and np.isfinite(out).all()
    assert _rel_err(out, ref) <= tol


@pytest.mark.parametrize("G", [1, 2, 7])
@pytest.mark.parametrize("mask_kind", ["tree", "random"])
def test_ref_matches_pallas_interpret(G, mask_kind):
    """Against the TPU kernel itself (interpret mode, online softmax), f32."""
    args = _case(G, mask_kind, np.float32, seed=10 + G)
    scale = 1.0 / np.sqrt(args[0].shape[-1])
    pallas = np.asarray(spec_attention_pallas(
        *[jnp.asarray(a) for a in args], scale, page_size=PAGE, interpret=True,
        softmax="online"))
    out = _port(args, scale)
    assert np.isfinite(pallas).all()
    lens, mask = args[4], args[7]
    # rows with a visible key; the padding row counts (length 1: the TPU kernel
    # and the dense versions all clamp its -1 pages onto page 0)
    seen = (lens[:, None] > 0) | mask.any(-1)  # [B, T]
    assert seen.any()
    assert _rel_err(out[seen], pallas[seen]) <= 1e-5


def _scaled_case(kind, G, mask_kind, dtype, seed):
    q, k, v, bt, lens, k_new, v_new, mask = _case(G, mask_kind, np.float32, seed)
    q = (q / 600.0).astype(dtype)  # scores stay O(1): the softmax is smooth
    k_new, v_new = (k_new * 600).astype(dtype), (v_new * 600).astype(dtype)
    (jk, jks), (tk, tks) = scaled_cache(k * 600, kind)
    (jv, jvs), (tv, tvs) = scaled_cache(v * 600, kind)
    scale = 1.0 / np.sqrt(q.shape[-1])
    rest = (bt, lens, k_new, v_new, mask)
    jargs = (jnp.asarray(q), jk, jv) + tuple(jnp.asarray(a) for a in rest) + (scale,)
    targs = (torch.from_numpy(q), tk, tv) + tuple(torch.from_numpy(a) for a in rest) + (scale,)
    return (jargs, dict(k_scale_l=jks, v_scale_l=jvs), targs, dict(k_scale_l=tks, v_scale_l=tvs),
            (lens[:, None] > 0) | mask.any(-1))


@pytest.mark.parametrize("kind", ["fp8", "int8"])
@pytest.mark.parametrize("G,mask_kind", [(1, "tree"), (2, "random"), (7, "tree")])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9), (np.float32, 1e-5)])
def test_scaled_ref_matches_jax_dense(kind, G, mask_kind, dtype, tol):
    jargs, jscales, targs, tscales, _ = _scaled_case(kind, G, mask_kind, dtype, seed=20 + G)
    ref = np.asarray(j_with_block(*jargs, page_size=PAGE, **jscales))
    out = paged_attention_with_block_ref(*targs, page_size=PAGE, **tscales)
    assert out.numpy().dtype == dtype and np.isfinite(out.numpy()).all()
    assert _rel_err(out.numpy(), ref) <= tol
    # the dispatcher hands the scales through (CPU tensors: the plain version)
    assert torch.equal(paged_attention_with_block(*targs, page_size=PAGE, **tscales), out)


@pytest.mark.parametrize("kind", ["fp8", "int8"])
@pytest.mark.parametrize("G,mask_kind", [(1, "tree"), (2, "random"), (7, "tree")])
def test_scaled_ref_matches_pallas_interpret(kind, G, mask_kind):
    """Against the TPU kernel, which folds the committed keys' scales into the
    scores and the probabilities (interpret mode, online softmax, f32)."""
    jargs, jscales, targs, tscales, seen = _scaled_case(kind, G, mask_kind, np.float32, 30 + G)
    pallas = np.asarray(spec_attention_pallas(
        *jargs, page_size=PAGE, interpret=True, softmax="online", **jscales))
    out = paged_attention_with_block_ref(*targs, page_size=PAGE, **tscales).numpy()
    assert seen.any() and np.isfinite(pallas).all()
    assert _rel_err(out[seen], pallas[seen]) <= 2e-5


@pytest.mark.parametrize("q_dtype,cache_dtype,scales,match", [
    (torch.float32, torch.float8_e4m3fn, True, "CUDA"),
    (torch.bfloat16, torch.int8, True, "CUDA"),
    (torch.float32, torch.bfloat16, False, "CUDA"),
    (torch.bfloat16, torch.float32, False, "not supported"),
    (torch.float32, torch.int8, False, "needs k_scale_l"),
    (torch.bfloat16, torch.bfloat16, True, "takes no k_scale_l"),
])
def test_kernel_wrapper_cache_dtypes_and_scales(q_dtype, cache_dtype, scales, match):
    """Served (query, cache) pairs end at the device check (CPU tensors); the
    rest, and scale planes that are missing or uncalled for, are refused.  The
    in-flight block must come in the query dtype."""
    T = 4
    q = torch.zeros(1, T, 4, 64, dtype=q_dtype)
    k = torch.zeros(2, 64, 64, dtype=cache_dtype)
    k_new = torch.zeros(1, T, 2, 64, dtype=q_dtype)
    sc = torch.ones(2, 64) if scales else None
    rest = (torch.zeros(1, 4, dtype=torch.int32), torch.ones(1, dtype=torch.int32))
    mask = torch.zeros(1, T, T, dtype=torch.bool)
    with pytest.raises(ValueError, match=match):
        sac.check_inputs(q, k, k, *rest, k_new, k_new, mask, 16, sc, sc)
    if match == "CUDA":
        with pytest.raises(ValueError, match="in-flight"):
            sac.check_inputs(q, k, k, *rest, k_new.to(torch.float16), k_new, mask, 16, sc, sc)


def test_dispatch_cpu_takes_plain_version():
    args = [torch.from_numpy(a) for a in _case(2, "tree", np.float32, seed=3)]
    before = sac.spec_attention_cuda.launches
    out = paged_attention_with_block(*args, 0.2, page_size=PAGE)
    assert torch.equal(out, paged_attention_with_block_ref(*args, 0.2, page_size=PAGE))
    assert sac.spec_attention_cuda.launches == before


@pytest.mark.parametrize("change,match", [
    (dict(D=48), "head_dim"),
    (dict(dtype=torch.float16), "dtype"),
    (dict(page=8), "page_size"),
    (dict(mask_dtype=torch.uint8), "bool"),
    (dict(new_T=3), "k_new"),
    (dict(), "CUDA"),
])
def test_kernel_wrapper_rejects_unsupported_inputs(change, match):
    """check_inputs raises on what the kernel does not take (it runs before
    any launch, so this holds without a card; valid CPU tensors end at the
    device check)."""
    D = change.get("D", 64)
    dtype = change.get("dtype", torch.float32)
    page = change.get("page", 16)
    T = 4
    q = torch.zeros(1, T, 4, D, dtype=dtype)
    k = torch.zeros(2, 4 * page, D, dtype=dtype)
    k_new = torch.zeros(1, change.get("new_T", T), 2, D, dtype=dtype)
    mask = torch.zeros(1, T, T, dtype=change.get("mask_dtype", torch.bool))
    bt = torch.zeros(1, 4, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        sac.check_inputs(q, k, k, bt, lens, k_new, k_new, mask, page)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_cuda(cuda, dtype):
    """Hand-written kernel vs the plain version on the card, real rows only
    (the padding row has to be finite).  f32: |err| <= 1e-5 * max|ref|; bf16:
    per element |err| <= 2^-5 * |ref| + 2^-7 * max|ref| of its row."""
    args = _case(7, "tree", np.float32, seed=5, N=32)
    args = [torch.from_numpy(a).cuda() for a in args]
    args = [a.to(dtype) if a.is_floating_point() else a for a in args]
    out = paged_attention_with_block(*args, 1.0 / np.sqrt(128), page_size=PAGE)
    ref = paged_attention_with_block_ref(*args, 1.0 / np.sqrt(128), page_size=PAGE)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    seen = ((args[4][:, None] > 0) | args[7].any(-1))[:3]
    out, ref = out[:3][seen].float(), ref[:3][seen].float()
    if dtype == torch.float32:
        limit = 1e-5 * ref.abs().max()
    else:
        limit = ref.abs() * 2.0**-5 + ref.abs().amax(-1, keepdim=True) * 2.0**-7
    assert ((out - ref).abs() <= limit).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp8", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scaled_kernel_matches_plain_on_cuda(cuda, kind, dtype):
    """The kernel on a narrow committed cache with per-row scales vs the plain
    version on the card (both dequantize in the query dtype)."""
    from jacobiforcing_tpu_torch.ops.kv_cache import quantize_rows

    q, k, v, bt, lens, k_new, v_new, mask = [
        torch.from_numpy(a).cuda() for a in _case(7, "tree", np.float32, seed=5, N=32)]
    tk, tks = quantize_rows(k * 600, KV_KINDS[kind][0])
    tv, tvs = quantize_rows(v * 600, KV_KINDS[kind][0])
    args = ((q / 600).to(dtype), tk, tv, bt, lens, (k_new * 600).to(dtype),
            (v_new * 600).to(dtype), mask, 1.0 / np.sqrt(128))
    kw = dict(page_size=PAGE, k_scale_l=tks, v_scale_l=tvs)
    out = paged_attention_with_block(*args, **kw)
    ref = paged_attention_with_block_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    seen = ((lens[:, None] > 0) | mask.any(-1))[:3]
    out, ref = out[:3][seen].float(), ref[:3][seen].float()
    if dtype == torch.float32:
        limit = 1e-5 * ref.abs().max()
    else:
        limit = ref.abs() * 2.0**-5 + ref.abs().amax(-1, keepdim=True) * 2.0**-7
    assert ((out - ref).abs() <= limit).all()


def _long_context_case(KH, G, D, kind, N, K, C, lens, seed):
    """bf16 queries over committed keys up to ctx 1024 (page 16, shuffled
    pages) and an in-flight block of T = (1+C+K-1)*N tokens under the
    decoder's tree mask with holes.  With `kind` the committed cache is stored
    narrow at magnitudes ~600 with row scales, and the in-flight block is
    fake-quantized in bf16 as `forward_spec` does it."""
    from jacobiforcing_tpu_torch.ops.kv_cache import dequantize_rows, quantize_rows

    r = np.random.RandomState(seed)
    B, T = len(lens), (1 + C + K - 1) * N
    pages = [-(-n // PAGE) for n in lens]
    num_pages = sum(pages) + 3
    perm, o = r.permutation(num_pages), 0
    bt = np.full((B, max(max(pages), 1)), -1, np.int32)
    for b, n in enumerate(pages):
        bt[b, :n], o = perm[o:o + n], o + n
    f = lambda *shape: torch.from_numpy(r.randn(*shape).astype(np.float32))
    q, k, v, k_new, v_new = (f(B, T, KH * G, D), f(KH, num_pages * PAGE, D),
                             f(KH, num_pages * PAGE, D), f(B, T, KH, D), f(B, T, KH, D))
    tok_valid = r.rand(B, T) < 0.8
    tok_valid[:, 0] = True
    mask = tree_mask(N, K, C, "cpu")[None] & torch.from_numpy(
        tok_valid[:, :, None] & tok_valid[:, None, :])
    ks = vs = None
    if kind is None:
        k, v, k_new, v_new = k.bfloat16(), v.bfloat16(), k_new.bfloat16(), v_new.bfloat16()
    else:
        q = q / 600.0
        store = KV_KINDS[kind][0]
        k, ks = quantize_rows(k * 600.0, store)
        v, vs = quantize_rows(v * 600.0, store)
        k_new = dequantize_rows(*quantize_rows(k_new * 600.0, store), torch.bfloat16)
        v_new = dequantize_rows(*quantize_rows(v_new * 600.0, store), torch.bfloat16)
    return (q.bfloat16(), k, v, torch.from_numpy(bt), torch.tensor(lens, dtype=torch.int32),
            k_new, v_new, mask), dict(page_size=PAGE, k_scale_l=ks, v_scale_l=vs)


@pytest.mark.parametrize("KH,G,D", [(2, 2, 64), (4, 7, 128)])  # demo heads, Qwen2.5-7B heads
@pytest.mark.parametrize("kind", [None, "fp8"])
def test_tensor_core_tile_numerics_within_the_bf16_rule(KH, G, D, kind):
    """The bf16-query kernel's arithmetic (tests/test_torch_attention.py::
    tc_tile_emulation: the committed keys in 64-key tiles, then the in-flight
    block in 64-key tiles, one online softmax, P rounded to bf16 before P.V)
    within chip_smoke.check's bf16 rule of `paged_attention_with_block_ref`,
    committed lengths up to 1024, bf16 and fp8 caches; rows that see a key."""
    from jacobiforcing_tpu_torch.ops.attention import gather_dequant
    from tests.test_torch_attention import bf16_rule, tc_tile_emulation

    args, kw = _long_context_case(KH, G, D, kind, 16, 2, 4, (1024, 0, 517), seed=D)
    q, k, v, bt, lens, k_new, v_new, mask = args
    scale = 1.0 / np.sqrt(D)
    ref = paged_attention_with_block_ref(*args, scale, **kw)
    kd = gather_dequant(k, kw["k_scale_l"], bt, PAGE, torch.bfloat16)
    vd = gather_dequant(v, kw["v_scale_l"], bt, PAGE, torch.bfloat16)
    committed = (torch.arange(kd.shape[1])[None, :] < lens[:, None])[:, None, :]
    out = tc_tile_emulation(q, [(kd, vd, committed.expand(-1, q.shape[1], -1)),
                                (k_new, v_new, mask)], scale)
    seen = (lens[:, None] > 0) | mask.any(-1)
    assert bf16_rule(out[seen], ref[seen])


@pytest.mark.cuda
def test_bf16_ra_rows_of_6n_equal_n_bitwise_on_cuda(cuda):
    """The tensor-core tile: the RA rows of a T=6N call equal, bit for bit,
    the rows of a T=N call on the same sequences (Qwen2.5-7B heads, N 32)."""
    args, kw = _long_context_case(4, 7, 128, None, 32, 2, 4, (1000, 0, 300), seed=11)
    args = [a.cuda() for a in args]
    q, k, v, bt, lens, k_new, v_new, mask = args
    scale = 1.0 / np.sqrt(128)
    big = paged_attention_with_block(*args, scale, **kw)
    n = 32
    ra = paged_attention_with_block(q[:, :n].contiguous(), k, v, bt, lens,
                                    k_new[:, :n].contiguous(), v_new[:, :n].contiguous(),
                                    mask[:, :n, :n].contiguous(), scale, **kw)
    assert torch.equal(big[:, :n].view(torch.int16), ra.view(torch.int16))
