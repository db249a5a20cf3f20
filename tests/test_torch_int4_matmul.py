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
