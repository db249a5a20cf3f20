"""The port's int4 dequant-matmul against the JAX package.

`pack_int4` bytes must equal; `int4_matmul_ref` (the plain version, which CPU
tensors take) is held to the TPU kernel `int4_matmul(..., interpret=True)`
within 2e-3, the tolerance of tests/test_quant.py::
test_int4_matmul_kernel_correct (float32 sums in another order), and to a
float64 product.  The CUDA kernel's wrapper is checked for what it refuses
(that runs before any launch, so it holds without a card); `cuda`-marked cases
hold the kernel to the plain version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jacobiforcing_tpu.ops.pallas import int4_matmul as ji4
from jacobiforcing_tpu_torch.ops import int4_matmul_cuda as i4c
from jacobiforcing_tpu_torch.ops.int4_matmul import (
    int4_matmul,
    int4_matmul_ref,
    pack_int4,
    unpack_int4,
)


def _case(M, K, N, seed=0, dtype=np.float32):
    r = np.random.RandomState(seed)
    wq = r.randint(-8, 8, (K, N)).astype(np.int8)
    scale = (np.abs(r.randn(N)) * 0.01).astype(np.float32)
    x = r.randn(M, K).astype(dtype)
    return x, wq, scale


@pytest.mark.parametrize("shape", [(256, 1024), (3, 7, 64), (5, 2)])
def test_pack_int4_bytes_equal_jax(shape):
    wq = np.random.RandomState(1).randint(-8, 8, shape).astype(np.int8)
    wq.flat[:4] = [-8, 7, 0, -1]
    want = np.asarray(ji4.pack_int4(jnp.asarray(wq)))
    got = pack_int4(torch.from_numpy(wq))
    assert got.dtype == torch.int8 and tuple(got.shape) == shape[:-1] + (shape[-1] // 2,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(unpack_int4(got).numpy(), wq)


@pytest.mark.parametrize("M,K,N,tile_n", [(16, 256, 1024, 256), (1, 64, 512, 512), (40, 96, 256, 128)])
def test_ref_matches_pallas_interpret(M, K, N, tile_n):
    """Against the TPU kernel itself (interpret mode): 2e-3, as the JAX test."""
    x, wq, scale = _case(M, K, N)
    wp = ji4.pack_int4(jnp.asarray(wq))
    want = np.asarray(ji4.int4_matmul(jnp.asarray(x), wp, jnp.asarray(scale), tile_n=tile_n,
                                      interpret=True))
    got = int4_matmul_ref(torch.from_numpy(x), pack_int4(torch.from_numpy(wq)),
                          torch.from_numpy(scale))
    assert got.dtype == torch.float32 and tuple(got.shape) == (M, N)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    exact = (x.astype(np.float64) @ wq.astype(np.float64)) * scale
    np.testing.assert_allclose(got.numpy(), exact, rtol=2e-3, atol=2e-3)


def test_int4_matmul_kernel_correct():
    """The shape of tests/test_quant.py::test_int4_matmul_kernel_correct
    through the dispatcher: CPU tensors take the plain version and launch
    nothing."""
    x, wq, scale = _case(16, 256, 1024)
    wp = pack_int4(torch.from_numpy(wq))
    assert tuple(wp.shape) == (256, 512)
    before = i4c.int4_matmul_cuda.launches
    out = int4_matmul(torch.from_numpy(x), wp, torch.from_numpy(scale))
    assert i4c.int4_matmul_cuda.launches == before
    ref = (x @ wq.astype(np.float32)) * scale
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.bfloat16, 2.0**-7)])
def test_ref_output_type_follows_x(dtype, tol):
    """float64 inputs accumulate in float64; bfloat16 inputs accumulate in
    float32 and round once at the end (a bf16 ulp of the output)."""
    x, wq, scale = _case(4, 128, 64, seed=2, dtype=np.float64)
    xt = torch.from_numpy(x).to(dtype)
    out = int4_matmul_ref(xt, pack_int4(torch.from_numpy(wq)), torch.from_numpy(scale))
    assert out.dtype == dtype
    exact = (xt.double().numpy() @ wq.astype(np.float64)) * scale.astype(np.float64)
    assert np.abs(out.double().numpy() - exact).max() <= tol * np.abs(exact).max()


@pytest.mark.parametrize("change,match", [
    (dict(x_dtype=torch.float16), "dtype"),
    (dict(N=48), "multiple"),              # N/2 = 24 is no multiple of 16
    (dict(w_dtype=torch.uint8), "int8"),
    (dict(scale_dtype=torch.float64), "float32"),
    (dict(scale_len=30), r"\[K, N/2\]"),
    (dict(), "CUDA"),                      # all well-formed, but on the CPU
])
def test_kernel_wrapper_rejects_unsupported_inputs(change, match):
    N = change.get("N", 64)
    x = torch.zeros(4, 32, dtype=change.get("x_dtype", torch.float32))
    wp = torch.zeros(32, N // 2, dtype=change.get("w_dtype", torch.int8))
    scale = torch.zeros(change.get("scale_len", N), dtype=change.get("scale_dtype", torch.float32))
    with pytest.raises(ValueError, match=match):
        i4c.check_inputs(x, wp, scale)
    with pytest.raises(ValueError):
        i4c.int4_matmul_cuda(x, wp, scale)


# (K, N): Qwen2.5-7B's four linear shapes, a few small and ragged ones
PLAN_SHAPES = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584), (100, 96), (37, 160),
               (520, 32), (300, 64)]


@pytest.mark.parametrize("K,N", PLAN_SHAPES)
def test_chunk_plan_depends_on_K_and_N_only_and_covers_K_once(K, N):
    """The bf16 kernel's K chunks: multiples of the stage, ascending, covering
    [0, K) exactly once, and the same whatever M (only the route and the x
    rows per instruction follow M)."""
    chunk, n = i4c.chunk_plan(K, N)
    assert chunk > 0 and chunk % i4c.STAGE_K == 0 and n >= 1
    bounds = [(i * chunk, min((i + 1) * chunk, K)) for i in range(n)]
    assert bounds[0][0] == 0 and bounds[-1][1] == K
    assert all(a < b for a, b in bounds) and all(b == c for (_, b), (c, _) in zip(bounds, bounds[1:]))
    for M in (1, 4, 8, 9, 64, 256, 1536):
        bn, c, m, _ = i4c.plan(M, K, N)
        assert (c, m) == (chunk, n) and bn == (8 if M <= 8 else 128)


def test_bitwise_rows_shape_takes_both_routes():
    """chip_smoke's bitwise-rows check (rows 700..703 of M 1536 against M 4 at
    K 3584, N 512) compares the split route (n8, partials summed by the
    reduce kernel) with the unsplit one (n128, chunks summed in registers)."""
    small, large = i4c.plan(4, 3584, 512), i4c.plan(1536, 3584, 512)
    assert small[2] > 1 and small[3] and not large[3]
    assert (small[0], large[0]) == (8, 128)


def tc_int4_emulation(x, w_packed, scale):
    """The bf16 tensor-core kernel's arithmetic on CPU tensors: per K chunk of
    `chunk_plan`, the chunk's sum from zero in float32 (the products of bf16
    x and int4 weights summed exactly in float64 and rounded once, so a row's
    chunk sum cannot depend on the other rows), the chunks added in ascending
    order in float32, times the float32 scale, rounded to bf16.  Returns
    (the float32 result before the rounding, the bf16 output)."""
    M, K = x.shape
    N = scale.shape[0]
    chunk, n = i4c.chunk_plan(K, N)
    w = unpack_int4(w_packed).double()
    xd = x.double()
    total = None
    for i in range(n):
        part = (xd[:, i * chunk : (i + 1) * chunk] @ w[i * chunk : (i + 1) * chunk]).float()
        total = part if total is None else total + part
    y = total * scale[None, :]
    return y, y.bfloat16()


@pytest.mark.parametrize("M,K,N", [(16, 256, 1024), (3, 100, 96), (70, 37, 160), (130, 520, 32),
                                   (5, 300, 64)])
def test_tensor_core_emulation_matches_pallas_interpret(M, K, N):
    """The emulated bf16 kernel against the TPU kernel in interpret mode on
    the same bf16-valued x (as float32): the float32 result within 2e-3 (the
    JAX test's tolerance), the bf16 output within one more rounding (2^-7
    relative, as test_ref_output_type_follows_x); ragged M and K, and K in
    one to three chunks."""
    x, wq, scale = _case(M, K, N, seed=M + K)
    xb = torch.from_numpy(x).bfloat16()
    wp = pack_int4(torch.from_numpy(wq))
    want = np.asarray(ji4.int4_matmul(jnp.asarray(xb.float().numpy()), jnp.asarray(wp.numpy()),
                                      jnp.asarray(scale), tile_n=N, interpret=True))
    y, out = tc_int4_emulation(xb, wp, torch.from_numpy(scale))
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (M, N)
    np.testing.assert_allclose(y.numpy(), want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(out.float().numpy(), want, rtol=2.0**-7, atol=2e-3)


@pytest.mark.parametrize("K,N", [(520, 32), (3584, 512)])
def test_tensor_core_emulation_rows_do_not_depend_on_M(K, N):
    """An emulated row has the same bits at M 4 and at M 64."""
    x, wq, scale = _case(64, K, N, seed=K)
    xb = torch.from_numpy(x).bfloat16()
    wp = pack_int4(torch.from_numpy(wq))
    st = torch.from_numpy(scale)
    full = tc_int4_emulation(xb, wp, st)[1]
    few = tc_int4_emulation(xb[40:44].contiguous(), wp, st)[1]
    assert torch.equal(full[40:44].view(torch.int16), few.view(torch.int16))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [(16, 256, 1024), (3, 100, 96), (70, 37, 160), (130, 520, 32)])
def test_kernel_matches_plain_on_cuda(cuda, dtype, M, K, N):
    """Hand-written kernel vs the plain version on the card, ragged M and K
    edges included.  f32: |err| <= 1e-5 * max|ref| (float32 sums in another
    order); bf16: within 2^-7 * max|ref| of the float32 plain version (one
    rounding of the output)."""
    x, wq, scale = _case(M, K, N)
    xt = torch.from_numpy(x).cuda().to(dtype)
    wp = pack_int4(torch.from_numpy(wq)).cuda()
    st = torch.from_numpy(scale).cuda()
    before = i4c.int4_matmul_cuda.launches
    out = int4_matmul(xt, wp, st)
    torch.cuda.synchronize()
    assert i4c.int4_matmul_cuda.launches == before + 1 and out.dtype == dtype
    ref = int4_matmul_ref(xt.float(), wp, st)
    limit = (1e-5 if dtype == torch.float32 else 2.0**-7) * ref.abs().max()
    assert ((out.float() - ref).abs() <= limit).all()
