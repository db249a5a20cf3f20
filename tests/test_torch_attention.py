"""The port's paged attention and KV cache against the JAX package.

The same numpy inputs go through `jacobiforcing_tpu` (XLA reference and the
Pallas kernel in interpret mode) and `jacobiforcing_tpu_torch` (the plain
PyTorch version), in fp64 unless stated.  Tolerance for fp64: 1e-10 abs and
rel (the two compute the same masked softmax; only summation order differs).
The Pallas kernel runs in f32 (its supported input types): 2e-5, as in
tests/test_pallas_attention.py.

A narrow cache (fp8 e4m3 / int8 with per-row scales, K/V magnitudes ~600 so
that the scales matter) is quantized once by the JAX package; both packages
then read the same bytes and scales.  Same tolerances, relative to max|ref|.
"""

import jax
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jacobiforcing_tpu.ops import kv_cache as jkv
from jacobiforcing_tpu.ops.attention import paged_attention_xla
from jacobiforcing_tpu.ops.pallas.paged_attention import paged_attention_pallas
from jacobiforcing_tpu_torch.ops import kv_cache as tkv
from jacobiforcing_tpu_torch.ops import paged_attention_cuda as pac
from jacobiforcing_tpu_torch.ops.attention import (
    gather_dequant,
    paged_attention,
    paged_attention_ref,
)

PAGE = 16
TOL64 = dict(rtol=1e-10, atol=1e-10)


def _inputs(B=2, L=4, NH=4, KH=2, D=32, pages_per_seq=6, num_pages=None, seed=0,
            dtype=np.float64):
    r = np.random.RandomState(seed)
    num_pages = num_pages or B * pages_per_seq + 4
    q = r.randn(B, L, NH, D).astype(dtype)
    k = r.randn(KH, num_pages * PAGE, D).astype(dtype)
    v = r.randn(KH, num_pages * PAGE, D).astype(dtype)
    bt = np.full((B, pages_per_seq), -1, np.int32)
    perm = r.permutation(num_pages)  # shuffled, non-contiguous pages
    for b in range(B):
        bt[b] = perm[b * pages_per_seq : (b + 1) * pages_per_seq]
    return q, k, v, bt


def _both(q, k, v, bt, lens, pos, scale, page=PAGE):
    ref = paged_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt),
        jnp.asarray(lens), jnp.asarray(pos), scale, page_size=page,
    )
    out = paged_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(bt),
        torch.from_numpy(lens), torch.from_numpy(pos), scale, page_size=page,
    )
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("L,lens", [
    (4, (37, 80)),   # jacobi block, ragged tails
    (1, (17, 65)),   # AR decode
    (8, (9, 96)),    # block crossing pages, full table
])
def test_ref_matches_xla(L, lens):
    q, k, v, bt = _inputs(L=L)
    lens = np.asarray(lens, np.int32)
    pos = (lens - L)[:, None] + np.arange(L, dtype=np.int32)[None, :]
    ref, out = _both(q, k, v, bt, lens, pos, 1.0 / np.sqrt(q.shape[-1]))
    np.testing.assert_allclose(out, ref, **TOL64)


def test_ref_prefill_with_prefix_offset_and_clamped_positions():
    """Prefill from a prefix-cache offset; the last positions repeat, as
    runner.prefill clamps them at max_position - 1."""
    q, k, v, bt = _inputs(L=40)
    start = np.asarray([32, 48], np.int32)
    lens = start + 40
    pos = start[:, None] + np.arange(40, dtype=np.int32)[None, :]
    pos = np.minimum(pos, 80).astype(np.int32)
    ref, out = _both(q, k, v, bt, lens, pos, 0.125)
    np.testing.assert_allclose(out, ref, **TOL64)


def test_ref_padding_rows_and_minus_one_pages():
    """Batch-bucket padding rows (all -1 table, cache_lens 1) and -1 table
    tails of live rows: same values as the JAX reference, all finite."""
    q, k, v, bt = _inputs(B=3, L=4)
    bt[1, :] = -1
    bt[0, 4:] = -1
    lens = np.asarray([37, 1, 50], np.int32)
    pos = (np.maximum(lens, 4) - 4)[:, None] + np.arange(4, dtype=np.int32)[None, :]
    ref, out = _both(q, k, v, bt, lens, pos, 1.0 / np.sqrt(q.shape[-1]))
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL64)


@pytest.mark.parametrize("L,lens,start", [
    (4, (37, 80), None),
    (1, (17, 65), None),
    (8, (40, 56), (32, 48)),  # prefill at a prefix offset
])
def test_ref_matches_pallas_interpret(L, lens, start):
    """Against the TPU kernel itself (interpret mode, exact online softmax)."""
    q, k, v, bt = _inputs(L=L, dtype=np.float32)
    lens = np.asarray(lens, np.int32)
    first = np.asarray(start, np.int32) if start is not None else lens - L
    pos = first[:, None] + np.arange(L, dtype=np.int32)[None, :]
    scale = 1.0 / np.sqrt(q.shape[-1])
    pallas = paged_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bt), jnp.asarray(lens),
        jnp.asarray(pos), scale, page_size=PAGE, interpret=True, softmax="online",
    )
    out = paged_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(bt),
        torch.from_numpy(lens), torch.from_numpy(pos), scale, page_size=PAGE,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=2e-5, atol=2e-5)


def test_gather_pages_matches_jax():
    _, k, _, bt = _inputs()
    bt[1, 3:] = -1
    ref = np.asarray(jkv.gather_pages(jnp.asarray(k), jnp.asarray(bt), PAGE))
    out = tkv.gather_pages(torch.from_numpy(k), torch.from_numpy(bt), PAGE).numpy()
    np.testing.assert_array_equal(out, ref)


def test_write_kv_drop_semantics():
    """Slots >= num_slots (masked tokens, -1 pages) are skipped, never
    clamped onto a real slot; the port writes in place (the skipped tokens
    land in the layer's trash row, which only `alloc_kv_cache` lays out)."""
    r = np.random.RandomState(3)
    KH, D, slots = 2, 8, 4 * PAGE
    k0 = r.randn(KH, slots, D)
    v0 = r.randn(KH, slots, D)
    k_new = r.randn(2, 5, KH, D)
    v_new = r.randn(2, 5, KH, D)
    dest = np.asarray([[3, 17, slots, 62, slots + 7], [slots, 0, 1, slots, 40]], np.int32)
    jk, jv = jkv.write_kv(jnp.asarray(k0), jnp.asarray(v0), jnp.asarray(k_new),
                          jnp.asarray(v_new), jnp.asarray(dest))
    pool = tkv.alloc_kv_cache(1, 4, PAGE, KH, D, torch.float64)
    tk, tv = pool.k[0], pool.v[0]
    tk.copy_(torch.from_numpy(k0))
    tv.copy_(torch.from_numpy(v0))
    ok, ov = tkv.write_kv(tk, tv, torch.from_numpy(k_new), torch.from_numpy(v_new),
                          torch.from_numpy(dest))
    assert ok is tk and ov is tv
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # the last slot was not written by the out-of-range tokens
    np.testing.assert_array_equal(tk.numpy()[:, slots - 1], k0[:, slots - 1])


def test_dispatch_cpu_takes_plain_version():
    q, k, v, bt = _inputs(L=4, dtype=np.float32)
    lens = np.asarray([37, 80], np.int32)
    pos = (lens - 4)[:, None] + np.arange(4, dtype=np.int32)[None, :]
    args = [torch.from_numpy(a) for a in (q, k, v, bt, lens, pos)]
    before = pac.paged_attention_cuda.launches
    out = paged_attention(*args, 0.2, page_size=PAGE)
    ref = paged_attention_ref(*args, 0.2, page_size=PAGE)
    assert torch.equal(out, ref)
    assert pac.paged_attention_cuda.launches == before


@pytest.mark.parametrize("change,match", [
    (dict(D=48), "head_dim"),
    (dict(dtype=torch.float16), "dtype"),
    (dict(page=8), "page_size"),
    (dict(bt_dtype=torch.int64), "int32"),
    (dict(device="cpu"), "CUDA"),
])
def test_kernel_wrapper_rejects_unsupported_inputs(change, match):
    """check_inputs raises on what the kernel does not take (it runs before
    any launch, so this holds without a card)."""
    D = change.get("D", 64)
    dtype = change.get("dtype", torch.float32)
    page = change.get("page", 16)
    q = torch.zeros(1, 2, 4, D, dtype=dtype)
    k = torch.zeros(2, 4 * page, D, dtype=dtype)
    bt = torch.zeros(1, 4, dtype=change.get("bt_dtype", torch.int32))
    lens = torch.ones(1, dtype=torch.int32)
    pos = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        pac.check_inputs(q, k, k, bt, lens, pos, page)


def test_kernel_wrapper_rejects_cpu_tensors():
    q, k, v, bt = _inputs(L=1, D=64, dtype=np.float32)
    args = [torch.from_numpy(a) for a in (q, k, v, bt)]
    lens = torch.tensor([5, 9], dtype=torch.int32)
    pos = torch.tensor([[4], [8]], dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pac.paged_attention_cuda(*args, lens, pos, 0.125, page_size=PAGE)


KV_KINDS = {"fp8": (torch.float8_e4m3fn, jnp.float8_e4m3fn), "int8": (torch.int8, jnp.int8)}


def scaled_cache(x, kind):
    """x [KH, slots, D] float32 quantized row by row by the JAX package:
    ((jax q, jax scale), (torch q, torch scale)) over the same bytes."""
    tdt, jdt = KV_KINDS[kind]
    jq_, js = jax.jit(jkv.quantize_rows, static_argnums=1)(jnp.asarray(x), jdt)
    tq_ = torch.from_numpy(np.asarray(jq_).view(np.uint8).copy()).view(tdt)
    return (jq_, js), (tq_, torch.from_numpy(np.asarray(js).copy()))


def _scaled_inputs(kind, L, lens, dtype, start=None):
    q, k, v, bt = _inputs(L=L, dtype=np.float32)
    q = (q / 600.0).astype(dtype)  # scores stay O(1): the softmax is smooth
    (jk, jks), (tk, tks) = scaled_cache(k * 600, kind)
    (jv, jvs), (tv, tvs) = scaled_cache(v * 600, kind)
    lens = np.asarray(lens, np.int32)
    first = np.asarray(start, np.int32) if start is not None else lens - L
    pos = first[:, None] + np.arange(L, dtype=np.int32)[None, :]
    scale = 1.0 / np.sqrt(q.shape[-1])
    jargs = (jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(pos), scale)
    targs = (torch.from_numpy(q), tk, tv, torch.from_numpy(bt), torch.from_numpy(lens),
             torch.from_numpy(pos), scale)
    return jargs, dict(k_scale_l=jks, v_scale_l=jvs), targs, dict(k_scale_l=tks, v_scale_l=tvs)


@pytest.mark.parametrize("kind", ["fp8", "int8"])
@pytest.mark.parametrize("L,lens,start", [
    (4, (37, 80), None), (1, (17, 65), None), (8, (40, 56), (32, 48)),
])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 2e-5)])
def test_scaled_ref_matches_xla(kind, L, lens, start, dtype, tol):
    jargs, jscales, targs, tscales = _scaled_inputs(kind, L, lens, dtype, start)
    ref = np.asarray(paged_attention_xla(*jargs, page_size=PAGE, **jscales))
    out = paged_attention_ref(*targs, page_size=PAGE, **tscales).numpy()
    assert out.dtype == dtype and np.isfinite(out).all()
    assert np.abs(out - ref).max() <= tol * np.abs(ref).max()
    # the dispatcher hands the scales through (CPU tensors: the plain version)
    assert torch.equal(paged_attention(*targs, page_size=PAGE, **tscales),
                       paged_attention_ref(*targs, page_size=PAGE, **tscales))


@pytest.mark.parametrize("kind", ["fp8", "int8"])
@pytest.mark.parametrize("L,lens,start", [
    (4, (37, 80), None), (1, (17, 65), None), (8, (40, 56), (32, 48)),
])
def test_scaled_ref_matches_pallas_interpret(kind, L, lens, start):
    """Against the TPU kernel itself, which folds the K scale into the scores
    and the V scale into the probabilities (interpret mode, f32): 2e-5."""
    jargs, jscales, targs, tscales = _scaled_inputs(kind, L, lens, np.float32, start)
    pallas = np.asarray(paged_attention_pallas(
        *jargs, page_size=PAGE, interpret=True, softmax="online", **jscales))
    out = paged_attention_ref(*targs, page_size=PAGE, **tscales).numpy()
    assert np.abs(out - pallas).max() <= 2e-5 * np.abs(pallas).max()


def _wrapper_case(q_dtype, cache_dtype, scales):
    q = torch.zeros(1, 2, 4, 64, dtype=q_dtype)
    k = torch.zeros(2, 64, 64, dtype=cache_dtype)
    s = torch.ones(2, 64, dtype=torch.float32) if scales else None
    return q, k, k, torch.zeros(1, 4, dtype=torch.int32), torch.ones(1, dtype=torch.int32), \
        torch.zeros(1, 2, dtype=torch.int32), 16, s, s


@pytest.mark.parametrize("q_dtype,cache_dtype", sorted(pac.SUPPORTED_PAIRS, key=str))
def test_kernel_wrapper_accepts_the_served_dtype_pairs(q_dtype, cache_dtype):
    """Every served (query, cache) pair passes the dtype and scale checks and
    ends at the device check (these are CPU tensors)."""
    scaled = cache_dtype in pac.SCALED_CACHE_DTYPES
    with pytest.raises(ValueError, match="CUDA"):
        pac.check_inputs(*_wrapper_case(q_dtype, cache_dtype, scaled))


@pytest.mark.parametrize("q_dtype,cache_dtype,scales,match", [
    (torch.bfloat16, torch.float32, False, "not supported"),
    (torch.float32, torch.float8_e4m3fnuz, True, "not supported"),
    (torch.float32, torch.float16, False, "not supported"),
    (torch.float32, torch.int8, False, "needs k_scale_l"),
    (torch.bfloat16, torch.float8_e4m3fn, False, "needs k_scale_l"),
    (torch.float32, torch.float32, True, "takes no k_scale_l"),
    (torch.float32, torch.bfloat16, True, "takes no k_scale_l"),
])
def test_kernel_wrapper_rejects_cache_dtypes_and_scales(q_dtype, cache_dtype, scales, match):
    with pytest.raises(ValueError, match=match):
        pac.check_inputs(*_wrapper_case(q_dtype, cache_dtype, scales))


def test_kernel_wrapper_rejects_malformed_scales():
    args = list(_wrapper_case(torch.float32, torch.int8, True))
    with pytest.raises(ValueError, match="together"):
        pac.check_inputs(*args[:8], None)
    with pytest.raises(ValueError, match=r"float32 \[KH, num_slots\]"):
        pac.check_inputs(*args[:7], args[7].double(), args[8])
    with pytest.raises(ValueError, match=r"float32 \[KH, num_slots\]"):
        pac.check_inputs(*args[:7], args[7], args[8][:, :32])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_on_cuda(cuda, dtype):
    """Hand-written kernel vs the plain version on the card; padding row 1
    only has to be finite (the kernel never reads a -1 page).  f32: |err| <=
    1e-5 * max|ref|; bf16: per element |err| <= 2^-5 * |ref| + 2^-7 * max|ref|
    of its row (a few bf16 ulps)."""
    q, k, v, bt = _inputs(B=3, L=8, NH=14, KH=2, D=128, num_pages=24, dtype=np.float32)
    bt[1, :] = -1
    lens = np.asarray([37, 8, 90], np.int32)
    pos = (lens - 8)[:, None] + np.arange(8, dtype=np.int32)[None, :]
    args = [torch.from_numpy(a).cuda() for a in (q, k, v)]
    args = [a.to(dtype) for a in args] + [torch.from_numpy(a).cuda() for a in (bt, lens, pos)]
    out = paged_attention(*args, 1.0 / np.sqrt(128), page_size=PAGE)
    ref = paged_attention_ref(*args, 1.0 / np.sqrt(128), page_size=PAGE)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    keep = [0, 2]
    out, ref = out[keep].float(), ref[keep].float()
    if dtype == torch.float32:
        limit = 1e-5 * ref.abs().max()
    else:
        limit = ref.abs() * 2.0**-5 + ref.abs().amax(-1, keepdim=True) * 2.0**-7
    assert ((out - ref).abs() <= limit).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fp8", "int8"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scaled_kernel_matches_plain_on_cuda(cuda, kind, dtype):
    """The kernel on a narrow cache with per-row scales vs the plain version
    on the card (both dequantize in the query dtype); tolerances as above."""
    q, k, v, bt = _inputs(B=3, L=8, NH=14, KH=2, D=128, num_pages=24, dtype=np.float32)
    bt[1, :] = -1
    lens = np.asarray([37, 8, 90], np.int32)
    pos = (lens - 8)[:, None] + np.arange(8, dtype=np.int32)[None, :]
    tk, tks = tkv.quantize_rows(torch.from_numpy(k * 600).cuda(), KV_KINDS[kind][0])
    tv, tvs = tkv.quantize_rows(torch.from_numpy(v * 600).cuda(), KV_KINDS[kind][0])
    args = [torch.from_numpy(q / 600).cuda().to(dtype), tk, tv]
    args += [torch.from_numpy(a).cuda() for a in (bt, lens, pos)]
    kw = dict(page_size=PAGE, k_scale_l=tks, v_scale_l=tvs)
    before = pac.paged_attention_cuda.launches
    out = paged_attention(*args, 1.0 / np.sqrt(128), **kw)
    ref = paged_attention_ref(*args, 1.0 / np.sqrt(128), **kw)
    torch.cuda.synchronize()
    assert pac.paged_attention_cuda.launches == before + 1 and torch.isfinite(out).all()
    out, ref = out[[0, 2]].float(), ref[[0, 2]].float()
    if dtype == torch.float32:
        limit = 1e-5 * ref.abs().max()
    else:
        limit = ref.abs() * 2.0**-5 + ref.abs().amax(-1, keepdim=True) * 2.0**-7
    assert ((out - ref).abs() <= limit).all()


# ---------------------------------------------------------------------------
# The tensor-core tile's numerics (csrc/attention_tile.cuh, namespace tc),
# emulated tile by tile on the CPU and held to the plain version under
# chip_smoke.check's bf16 rule before any card time is spent on them.
# ---------------------------------------------------------------------------


def tc_tile_emulation(q, segments, scale, keep_f32=False):
    """The bf16-query kernels' arithmetic in plain torch: q [B, T, NH, D]
    bf16; `segments` is a list of (k, v [B, S, KH, D] bf16, vis [B, T, S]
    bool) walked in order, each in 64-key tiles from its key 0 (the paged
    kernel has one segment, the speculative kernel the committed keys then
    the in-flight block).  Per tile: bf16 Q.K products summed in float32,
    the row max over the raw scores, scaled into the log2 domain, an online
    softmax with exp2 (of one fused multiply-add on the card), the
    probabilities rounded to bf16 before P.V, float32 accumulation; rows that
    see no key give zeros.  The output is rounded to bf16 unless `keep_f32`."""
    B, T, NH, D = q.shape
    KH = segments[0][0].shape[2]
    qf = q.float().reshape(B, T, KH, NH // KH, D).permute(0, 2, 3, 1, 4)  # [B,KH,G,T,D]
    m = torch.full(qf.shape[:-1], -float("inf"))
    l = torch.zeros(qf.shape[:-1])
    o = torch.zeros(qf.shape)
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(1.4426950408889634,
                                                                  dtype=torch.float32)
    for k, v, vis in segments:
        for j0 in range(0, k.shape[1], 64):
            kt = k[:, j0:j0 + 64].float().permute(0, 2, 1, 3)[:, :, None]  # [B,KH,1,t,D]
            vt = v[:, j0:j0 + 64].float().permute(0, 2, 1, 3)[:, :, None]
            s = qf @ kt.transpose(-1, -2)
            s = torch.where(vis[:, None, None, :, j0:j0 + 64], s, -float("inf"))
            m_new = torch.maximum(m, s.amax(-1) * c)
            base = torch.where(m_new == -float("inf"), torch.zeros(()), m_new)
            alpha = torch.exp2(m - base)
            p = torch.exp2(s * c - base[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + p.bfloat16().float() @ vt
            m = m_new
    out = torch.where(l[..., None] > 0, o / l.clamp(min=1e-30)[..., None], torch.zeros(()))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, T, NH, D)
    return out if keep_f32 else out.bfloat16()


def bf16_rule(out, ref):
    """chip_smoke.check's bf16 rule: per element |err| <= 2^-5 |ref| +
    2^-7 max|ref| of its row."""
    out, ref = out.float(), ref.float()
    tol = ref.abs() * 2.0**-5 + ref.abs().amax(-1, keepdim=True) * 2.0**-7
    return bool(torch.isfinite(out).all()) and bool(((out - ref).abs() <= tol).all())


def _long_context_case(KH, G, D, kind, L, lens, seed):
    """bf16 queries over a paged cache of ctx up to 1024 (page 16, shuffled
    pages): (q, k, v, bt, lens, pos, k_scale, v_scale) as torch tensors; with
    `kind` the cache is stored narrow at magnitudes ~600 with row scales."""
    r = np.random.RandomState(seed)
    B = len(lens)
    pages = [-(-n // PAGE) for n in lens]
    num_pages = sum(pages) + 3
    perm, o = r.permutation(num_pages), 0
    bt = np.full((B, max(pages)), -1, np.int32)
    for b, n in enumerate(pages):
        bt[b, :n], o = perm[o:o + n], o + n
    q = torch.from_numpy(r.randn(B, L, KH * G, D).astype(np.float32))
    k = torch.from_numpy(r.randn(KH, num_pages * PAGE, D).astype(np.float32))
    v = torch.from_numpy(r.randn(KH, num_pages * PAGE, D).astype(np.float32))
    ks = vs = None
    if kind is None:
        k, v = k.bfloat16(), v.bfloat16()
    else:
        q = q / 600.0
        k, ks = tkv.quantize_rows(k * 600.0, KV_KINDS[kind][0])
        v, vs = tkv.quantize_rows(v * 600.0, KV_KINDS[kind][0])
    lens = np.asarray(lens, np.int32)
    pos = (lens - L)[:, None] + np.arange(L, dtype=np.int32)[None, :]
    return (q.bfloat16(), k, v, torch.from_numpy(bt), torch.from_numpy(lens),
            torch.from_numpy(pos), ks, vs)


@pytest.mark.parametrize("KH,G,D", [(2, 2, 64), (4, 7, 128)])  # demo heads, Qwen2.5-7B heads
@pytest.mark.parametrize("kind", [None, "fp8"])
def test_tensor_core_tile_numerics_within_the_bf16_rule(KH, G, D, kind):
    """64-key tiles, bf16 products summed in f32, P rounded to bf16 before
    P.V, f32 accumulation: within chip_smoke.check's bf16 rule of
    `paged_attention_ref` at ctx up to 1024, bf16 and fp8 caches."""
    q, k, v, bt, lens, pos, ks, vs = _long_context_case(KH, G, D, kind, 4, (1024, 300), seed=D)
    scale = 1.0 / np.sqrt(D)
    ref = paged_attention_ref(q, k, v, bt, lens, pos, scale, page_size=PAGE, k_scale_l=ks,
                              v_scale_l=vs)
    kd = gather_dequant(k, ks, bt, PAGE, torch.bfloat16)
    vd = gather_dequant(v, vs, bt, PAGE, torch.bfloat16)
    key = torch.arange(kd.shape[1])
    vis = (key[None, None, :] <= pos[:, :, None]) & (key[None, None, :] < lens[:, None, None])
    out = tc_tile_emulation(q, [(kd, vd, vis)], scale)
    assert bf16_rule(out, ref)


@pytest.mark.cuda
def test_bf16_ar_row_equals_jacobi_row_bitwise_on_cuda(cuda):
    """The tensor-core tile: a query's row from an L=1 call equals, bit for
    bit, its row inside an L=64 block (Qwen2.5-7B heads, bf16 cache)."""
    q, k, v, bt, lens, pos, _, _ = _long_context_case(4, 7, 128, None, 64, (1000, 700), seed=7)
    q, k, v, bt, lens, pos = [t.cuda() for t in (q, k, v, bt, lens, pos)]
    scale = 1.0 / np.sqrt(128)
    block = paged_attention(q, k, v, bt, lens, pos, scale, page_size=PAGE)
    for b, t in ((0, 0), (0, 33), (1, 63)):
        p = int(pos[b, t])
        row = paged_attention(q[b:b + 1, t:t + 1].contiguous(), k, v, bt[b:b + 1].contiguous(),
                              torch.tensor([p + 1], dtype=torch.int32, device="cuda"),
                              torch.tensor([[p]], dtype=torch.int32, device="cuda"), scale,
                              page_size=PAGE)
        assert torch.equal(row[0, 0].view(torch.int16), block[b, t].view(torch.int16))
