"""The port's training attention against the JAX package.

The same numpy inputs go through the JAX dense path (the masked einsum
softmax of `jacobiforcing_tpu/models/qwen.py::forward_dense` under
`build_train_mask`), through the TPU kernel `splash_train_attention` in
interpret mode, and through the port's plain version `train_attention_ref`,
which is what CPU tensors take.  Tolerances: fp64 1e-9 relative to max|ref|
(the same masked softmax, another summation order); against the splash kernel
in f32 the JAX test's own (2e-4 forward, rtol 5e-3 / atol 5e-4 gradients),
on the rows that take part.  The mask and the tile classes are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jacobiforcing_tpu.ops.pallas.train_attention import JacobiTrainingMask, splash_train_attention
from jacobiforcing_tpu.train.consistency import build_train_mask as j_build_train_mask
from jacobiforcing_tpu_torch.ops import train_attention as ta
from jacobiforcing_tpu_torch.ops import train_attention_cuda as tac
from jacobiforcing_tpu_torch.train.consistency import build_train_mask

VARIANTS = [("single", 4), ("multiblock", 4), ("window", 2)]
# (L, prompt_len, T, seq_len, N): the JAX test's row; a row padded to its
# bucket; T below the pairs the row holds, an odd prompt length
LAYOUTS = [(128, 32, 3, 128, 16), (128, 21, 3, 117, 16), (160, 37, 5, 37 + 2 * 7 * 8, 8)]


def _dense_mask(L, P, T, S, N, variant, window):
    return np.asarray(j_build_train_mask(L, jnp.int32(P), jnp.int32(T), jnp.int32(S), N, variant,
                                         window))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "L%d-P%d-T%d-S%d-N%d" % l)
@pytest.mark.parametrize("variant,window", VARIANTS)
def test_train_mask_equals_jax_masks(layout, variant, window):
    L, P, T, S, N = layout
    dense = _dense_mask(L, P, T, S, N, variant, window)
    idx = np.arange(L)
    q_ids, k_ids = np.broadcast_to(idx[:, None], (L, L)), np.broadcast_to(idx[None, :], (L, L))
    splash = JacobiTrainingMask(L, P, T, S, N, variant, window).mask_function(q_ids, k_ids)
    np.testing.assert_array_equal(splash, dense)
    np.testing.assert_array_equal(ta.train_mask(q_ids, k_ids, P, T, S, N, variant, window), dense)
    # on tensors, with the scalars as 0-d tensors as the trainer's batch holds them
    port = build_train_mask(L, torch.tensor(P, dtype=torch.int32), torch.tensor(T, dtype=torch.int32),
                            torch.tensor(S, dtype=torch.int32), N, variant, window)
    np.testing.assert_array_equal(port.numpy(), dense)


def test_train_mask_rejects_unknown_variant():
    with pytest.raises(ValueError, match="variant"):
        ta.train_mask(np.arange(4)[:, None], np.arange(4)[None, :], 1, 1, 4, 2, "causal")


@pytest.mark.parametrize("layout", LAYOUTS + [(97, 97, 0, 97, 8), (130, 0, 4, 128, 16)],
                         ids=lambda l: "L%d-P%d-T%d-S%d-N%d" % l)
@pytest.mark.parametrize("variant,window", VARIANTS)
@pytest.mark.parametrize("groups", [1, 2, 7])
def test_classify_tiles_agrees_with_dense_mask(layout, variant, window, groups):
    L, P, T, S, N = layout
    dense = _dense_mask(L, P, T, S, N, variant, window)
    tm = ta.classify_tiles(L, P, T, S, N, variant, window, groups)
    n_qt, n_kt = tm.classes.shape
    assert (n_qt, n_kt) == (-(-L * groups // ta.Q_ROWS), -(-L // ta.KEY_TILE))
    assert tm.visible_pairs == int(dense.sum())
    for i in range(n_qt):
        t0 = i * ta.Q_ROWS // groups
        t1 = min((i * ta.Q_ROWS + ta.Q_ROWS - 1) // groups, L - 1)
        for j in range(n_kt):
            sub = dense[t0 : t1 + 1, j * ta.KEY_TILE : (j + 1) * ta.KEY_TILE]
            want = ta.EMPTY if not sub.any() else (
                ta.FULL if sub.all() and sub.shape[1] == ta.KEY_TILE else ta.PARTIAL)
            assert tm.classes[i, j] == want, (i, j)
    # the lists and the transposed lists are complete, ascending, and flag the full tiles
    for i in range(n_qt):
        ent = tm.q_ent[tm.q_ptr[i] : tm.q_ptr[i + 1]]
        cols = np.flatnonzero(tm.classes[i])
        np.testing.assert_array_equal(ent >> 1, cols)
        np.testing.assert_array_equal(ent & 1, tm.classes[i, cols] == ta.FULL)
    for j in range(n_kt):
        ent = tm.k_ent[tm.k_ptr[j] : tm.k_ptr[j + 1]]
        rows = np.flatnonzero(tm.classes[:, j])
        np.testing.assert_array_equal(ent >> 1, rows)
        np.testing.assert_array_equal(ent & 1, tm.classes[rows, j] == ta.FULL)
    assert tm.q_ptr[-1] == tm.k_ptr[-1] == np.count_nonzero(tm.classes)


def _inputs(L, NH, KH, D, dtype, seed):
    r = np.random.RandomState(seed)
    return (r.randn(L, NH, D).astype(dtype), r.randn(L, KH, D).astype(dtype),
            r.randn(L, KH, D).astype(dtype), r.randn(L, NH, D).astype(dtype))


def _live_rows(L, P, T, S, N):
    tok = np.arange(L)
    return (tok < S) & ((tok < P) | ((tok - P) // N < 2 * T))


def _jax_dense(q, k, v, mask):
    """The dense attention of the JAX `forward_dense` (models/qwen.py), one row."""
    L, NH, D = q.shape
    KH = k.shape[1]
    qg = q.reshape(L, KH, NH // KH, D)
    scores = jnp.einsum("thgd,shd->hgts", qg, k, preferred_element_type=q.dtype) / np.sqrt(D)
    scores = jnp.where(mask[None, None], scores, -1e30)
    probs = jax.nn.softmax(scores, axis=-1).astype(q.dtype)
    return jnp.einsum("hgts,shd->thgd", probs, v).reshape(L, NH, D)


def _port_grads(fn, q, k, v, dout, **layout):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fn(tq, tk, tv, **layout)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "L%d-P%d-T%d-S%d-N%d" % l)
@pytest.mark.parametrize("variant,window", VARIANTS)
def test_ref_matches_jax_dense_fp64(layout, variant, window):
    """Output and dq, dk, dv, GQA 4 query heads on 2 KV heads, fp64."""
    L, P, T, S, N = layout
    q, k, v, dout = _inputs(L, 4, 2, 16, np.float64, seed=L + P)
    live = _live_rows(L, P, T, S, N)
    dout = dout * live[:, None, None]  # the trainer gathers no dead row
    mask = jnp.asarray(_dense_mask(L, P, T, S, N, variant, window))
    want_out, vjp = jax.vjp(lambda a, b, c: _jax_dense(a, b, c, mask), *map(jnp.asarray, (q, k, v)))
    want = [want_out] + list(vjp(jnp.asarray(dout)))
    got = _port_grads(ta.train_attention_ref, q, k, v, dout, prompt_len=P, T_pairs=T, seq_len=S,
                      N=N, variant=variant, window_size=window)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert g.dtype == np.float64 and np.isfinite(g).all(), name
        assert np.abs(g - w).max() <= 1e-9 * np.abs(w).max(), name


@pytest.mark.parametrize("layout,variant,window", [
    ((128, 32, 3, 128, 16), "single", 4),
    ((128, 32, 2, 96, 16), "multiblock", 4),
    ((128, 21, 3, 117, 16), "window", 2),
])
def test_ref_matches_splash_interpret(layout, variant, window):
    """Against the TPU kernel itself (jax's splash kernel in interpret mode,
    forward and its custom VJP), f32, the rows that take part."""
    L, P, T, S, N = layout
    q, k, v, dout = _inputs(L, 4, 2, 32, np.float32, seed=3)
    live = _live_rows(L, P, T, S, N)
    dout = dout * live[:, None, None]
    kw = dict(prompt_len=P, T_pairs=T, seq_len=S, N=N, variant=variant, window_size=window)
    want_out, vjp = jax.vjp(lambda a, b, c: splash_train_attention(a, b, c, interpret=True, **kw),
                            *map(jnp.asarray, (q, k, v)))
    want = [want_out] + list(vjp(jnp.asarray(dout)))
    got = _port_grads(ta.train_attention_ref, q, k, v, dout, **kw)
    np.testing.assert_allclose(got[0][live], np.asarray(want[0])[live], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got[1][live], np.asarray(want[1])[live], rtol=5e-3, atol=5e-4)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=5e-3, atol=5e-4)


def test_dead_rows_stay_finite():
    """Rows at or past seq_len see nothing: finite outputs and gradients."""
    L, P, T, S, N = 128, 21, 3, 117, 16
    q, k, v, dout = _inputs(L, 4, 2, 16, np.float32, seed=5)
    got = _port_grads(ta.train_attention_ref, q, k, v, dout, prompt_len=P, T_pairs=T, seq_len=S,
                      N=N)
    assert all(np.isfinite(g).all() for g in got)


def test_dispatch_cpu_takes_plain_version():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(64, 4, 2, 16, np.float32, seed=1))
    kw = dict(prompt_len=16, T_pairs=3, seq_len=64, N=8, variant="multiblock", window_size=4)
    before = tac.train_attention_fwd_cuda.launches
    assert torch.equal(ta.train_attention(q, k, v, **kw), ta.train_attention_ref(q, k, v, **kw))
    assert tac.train_attention_fwd_cuda.launches == before


@pytest.mark.parametrize("change,match", [
    (dict(D=48), "head_dim"),
    (dict(dtype=torch.float16), "dtype"),
    (dict(variant="causal"), "variant"),
    (dict(seq_len=300), "layout"),
    (dict(KH=3), "multiple"),
    (dict(), "CUDA"),
])
def test_kernel_wrapper_rejects_unsupported_inputs(change, match):
    """check_inputs raises on what the kernels do not take (it runs before any
    launch, so this holds without a card; valid CPU tensors end at the device
    check)."""
    D, dtype, KH = change.get("D", 64), change.get("dtype", torch.float32), change.get("KH", 2)
    q = torch.zeros(256, 4, D, dtype=dtype)
    k = torch.zeros(256, KH, D, dtype=dtype)
    layout = (32, 3, change.get("seq_len", 224), 32, change.get("variant", "single"), 4)
    with pytest.raises(ValueError, match=match):
        tac.check_inputs(q, k, k, layout)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


def _cuda_case(dtype):
    L, P, T, S, N = 1024, 100, 14, 996, 32
    q, k, v, dout = (torch.from_numpy(a).cuda().to(dtype)
                     for a in _inputs(L, 28, 4, 128, np.float32, seed=9))
    live = torch.from_numpy(_live_rows(L, P, T, S, N)).cuda()
    kw = dict(prompt_len=P, T_pairs=T, seq_len=S, N=N, variant="window", window_size=2)
    return q, k, v, dout * live[:, None, None].to(dtype), live, kw


def _within(out, ref, scale=1e-5):
    """f32: |err| <= scale * max|ref|; bf16: per element 2^-5 * |ref| + 2^-7 *
    max|ref| of its row (the kernels round once, from a float32 sum) + 2^-9 *
    max|ref| (the backward reads the saved output rounded to bf16, which shows
    where the reference's dP - delta cancels exactly)."""
    bf16 = out.dtype == torch.bfloat16
    out, ref = out.float(), ref.float()
    if bf16:
        limit = (ref.abs() * 2.0**-5 + ref.abs().amax(-1, keepdim=True) * 2.0**-7
                 + ref.abs().max() * 2.0**-9)
    else:
        limit = scale * ref.abs().max()
    return bool(torch.isfinite(out).all()) and bool(((out - ref).abs() <= limit).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_forward_matches_plain_on_cuda(cuda, dtype):
    """Hand-written forward kernel vs the plain version in float32 on the
    card, the rows that take part; dead rows are zero."""
    q, k, v, _, live, kw = _cuda_case(dtype)
    out = ta.train_attention(q, k, v, **kw)
    ref = ta.train_attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    assert _within(out[live], ref[live])
    assert not bool(out[~live].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_backward_matches_plain_on_cuda(cuda, dtype):
    """dq, dk, dv of the hand-written kernels vs autograd of the plain version
    in float32 (f32: 2e-5 * max|ref|, sums of G * L products in another order),
    and bitwise equal across two runs."""
    q, k, v, dout, _, kw = _cuda_case(dtype)

    def grads(fn, cast):
        a, b, c = (t.to(cast).detach().requires_grad_() for t in (q, k, v))
        return torch.autograd.grad(fn(a, b, c, **kw), (a, b, c), dout.to(cast))

    got, again = grads(ta.train_attention, dtype), grads(ta.train_attention, dtype)
    ref = grads(ta.train_attention_ref, torch.float32)
    torch.cuda.synchronize()
    for g, g2, r in zip(got, again, ref):
        assert torch.equal(g, g2)
        assert _within(g, r, scale=2e-5)
