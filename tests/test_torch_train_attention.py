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
@pytest.mark.parametrize("key_tile", [ta.KEY_TILE, ta.TC_KEY_TILE])
def test_classify_tiles_agrees_with_dense_mask(layout, variant, window, groups, key_tile):
    L, P, T, S, N = layout
    KT = key_tile
    dense = _dense_mask(L, P, T, S, N, variant, window)
    tm = ta.classify_tiles(L, P, T, S, N, variant, window, groups, key_tile=KT)
    n_qt, n_kt = tm.classes.shape
    assert (n_qt, n_kt, tm.key_tile) == (-(-L * groups // ta.Q_ROWS), -(-L // KT), KT)
    assert tm.visible_pairs == int(dense.sum())
    for i in range(n_qt):
        t0 = i * ta.Q_ROWS // groups
        t1 = min((i * ta.Q_ROWS + ta.Q_ROWS - 1) // groups, L - 1)
        for j in range(n_kt):
            sub = dense[t0 : t1 + 1, j * KT : (j + 1) * KT]
            want = ta.EMPTY if not sub.any() else (
                ta.FULL if sub.all() and sub.shape[1] == KT else ta.PARTIAL)
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


# (L, prompt_len, T, seq_len, N, groups): the trainer's row at Qwen2.5-7B's
# G = 7; chip_smoke's first case; small rows with a short and with no body
CHUNK_LAYOUTS = [(4096, 512, 56, 4096, 32, 7), (1024, 100, 14, 996, 32, 7),
                 (160, 37, 5, 149, 8, 2), (97, 97, 0, 97, 8, 1)]


@pytest.mark.parametrize("layout", CHUNK_LAYOUTS, ids=lambda l: "L%d-P%d-T%d-S%d-N%d-G%d" % l)
@pytest.mark.parametrize("variant,window", VARIANTS)
def test_dkdv_chunks_cover_every_pair_once(layout, variant, window):
    """The bf16 dK/dV schedule: every non-empty (key tile, query tile) pair in
    exactly one chunk, each key tile's chunks in ascending order and back to
    back, none longer than C, C as DKDV_CHUNKS says; a key tile no query sees
    has one empty chunk; partial slots are used once each, in chunk order,
    and named by the reduce list; the chunks are launched longest first."""
    L, P, T, S, N, G = layout
    tm = ta.classify_tiles(L, P, T, S, N, variant, window, G, key_tile=ta.TC_KEY_TILE)
    n_kt = tm.classes.shape[1]
    E = int(tm.k_ptr[-1])
    assert tm.chunk == max(ta.DKDV_MIN_CHUNK, -(-E // ta.DKDV_CHUNKS))
    kt, e0, e1, slot = tm.chunks.T
    lens = e1 - e0
    assert (lens >= 0).all() and (lens <= tm.chunk).all()
    assert (np.diff(lens) <= 0).all()  # longest first
    seen = []
    reduce = {int(r[0]): (int(r[1]), int(r[2])) for r in tm.reduce}
    assert len(reduce) == len(tm.reduce)
    for j in range(n_kt):
        mine = tm.chunks[kt == j]
        mine = mine[np.argsort(mine[:, 1])]
        assert len(mine) >= 1
        np.testing.assert_array_equal(mine[:, 1], np.r_[tm.k_ptr[j], mine[:-1, 2]])
        assert mine[-1, 2] == tm.k_ptr[j + 1]
        q_tiles = np.concatenate([tm.k_ent[a:b] >> 1 for _, a, b, _ in mine])
        assert (np.diff(q_tiles) > 0).all()
        seen += [(j, int(i)) for i in q_tiles]
        if len(mine) == 1:
            assert mine[0, 3] == -1 and j not in reduce
        else:
            first, m = reduce[j]
            np.testing.assert_array_equal(mine[:, 3], first + np.arange(m))
    assert sorted(seen) == sorted(zip(*np.nonzero(tm.classes.T)))
    assert len(seen) == len(set(seen)) == E
    np.testing.assert_array_equal(np.sort(slot[slot >= 0]), np.arange(tm.n_slots))


@pytest.mark.parametrize("layout", CHUNK_LAYOUTS, ids=lambda l: "L%d-P%d-T%d-S%d-N%d-G%d" % l)
@pytest.mark.parametrize("variant,window", VARIANTS)
def test_forward_pair_lists_match_the_classes(layout, variant, window):
    """The bf16 forward's lists: per pair of query tiles, every key tile
    either sees, ascending, with each tile's class for each warpgroup; the
    pairs are launched longest list first."""
    L, P, T, S, N, G = layout
    tm = ta.classify_tiles(L, P, T, S, N, variant, window, G, key_tile=ta.TC_KEY_TILE)
    n_qt = tm.classes.shape[0]
    assert len(tm.pair_ptr) == -(-n_qt // 2) + 1
    np.testing.assert_array_equal(np.sort(tm.pair_order), np.arange(len(tm.pair_ptr) - 1))
    assert (np.diff(np.diff(tm.pair_ptr)[tm.pair_order]) <= 0).all()
    for p in range(len(tm.pair_ptr) - 1):
        ent = tm.pair_ent[tm.pair_ptr[p] : tm.pair_ptr[p + 1]]
        c0 = tm.classes[2 * p]
        c1 = tm.classes[2 * p + 1] if 2 * p + 1 < n_qt else np.zeros_like(c0)
        np.testing.assert_array_equal(ent >> 4, np.flatnonzero((c0 > 0) | (c1 > 0)))
        np.testing.assert_array_equal(ent & 3, c0[ent >> 4])
        np.testing.assert_array_equal((ent >> 2) & 3, c1[ent >> 4])


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


# (L, prompt_len, T, seq_len, N, variant, window) of the cuda-marked cases: a
# windowed row padded past seq_len; a long prompt, whose key tiles each span
# several bf16 dK/dV chunks
CUDA_LAYOUTS = [(1024, 100, 14, 996, 32, "window", 2), (1024, 400, 9, 976, 32, "single", 4)]


def _cuda_case(dtype, layout=CUDA_LAYOUTS[0]):
    L, P, T, S, N, variant, window = layout
    q, k, v, dout = (torch.from_numpy(a).cuda().to(dtype)
                     for a in _inputs(L, 28, 4, 128, np.float32, seed=9))
    live = torch.from_numpy(_live_rows(L, P, T, S, N)).cuda()
    kw = dict(prompt_len=P, T_pairs=T, seq_len=S, N=N, variant=variant, window_size=window)
    return q, k, v, dout * live[:, None, None].to(dtype), live, kw


def _within(out, ref, scale=1e-5):
    """f32: |err| <= scale * max|ref|; bf16: per element 2^-5 * |ref| + 2^-7 *
    max|ref| of its row (the kernels round once, from a float32 sum) + 2^-9 *
    max|ref| (the backward rounds dS to bf16 before dS.K and dS^T.Q, which
    shows where the reference's dP - delta cancels exactly)."""
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
@pytest.mark.parametrize("layout", CUDA_LAYOUTS, ids=lambda l: "%s-P%d" % (l[5], l[1]))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_backward_matches_plain_on_cuda(cuda, dtype, layout):
    """dq, dk, dv of the hand-written kernels vs autograd of the plain version
    in float32 (f32: 2e-5 * max|ref|, sums of G * L products in another order),
    and bitwise equal across two runs."""
    q, k, v, dout, _, kw = _cuda_case(dtype, layout)
    L, P, T, S, N, variant, window = layout
    if layout[1] >= 4 * ta.TC_KEY_TILE:  # the bf16 dK/dV sums chunk partials here
        tm = ta.classify_tiles(L, P, T, S, N, variant, window, 7, key_tile=ta.TC_KEY_TILE)
        assert all((tm.chunks[:, 0] == j).sum() >= 2 for j in range(P // ta.TC_KEY_TILE))

    def grads(fn, cast):
        a, b, c = (t.to(cast).detach().requires_grad_() for t in (q, k, v))
        return torch.autograd.grad(fn(a, b, c, **kw), (a, b, c), dout.to(cast))

    got, again = grads(ta.train_attention, dtype), grads(ta.train_attention, dtype)
    ref = grads(ta.train_attention_ref, torch.float32)
    torch.cuda.synchronize()
    for g, g2, r in zip(got, again, ref):
        assert torch.equal(g, g2)
        assert _within(g, r, scale=2e-5)


def tc_train_emulation(q, k, v, dout, layout, with_dq=False):
    """The bf16 tensor-core kernels' arithmetic in plain torch on CPU tensors
    q [L, NH, D], k/v [L, KH, D], dout [L, NH, D] (bf16): (out, dk, dv), and
    with `with_dq` (out, dk, dv, dq).
    Forward: `tc_tile_emulation` (64-key tiles, online softmax in the log2
    domain, P rounded to bf16 before P.V), and the log-sum-exp of the scaled
    scores; O rounded to bf16 and its residual O_lo = bf16(O - bf16(O)).
    dK/dV: delta = rowsum(dO * (O + O_lo)) in float32; per chunk of a 64-key
    tile's query tiles (TileMap.chunks), per query tile of 64 token-major
    rows, S^T = K.Q^T and dP^T = V.dO^T from bf16 products in float32,
    P^T = exp2(scale_log2 S^T - lse log2 e) on the visible elements,
    dS^T = P^T (dP^T - delta), then dV += bf16(P^T).dO and dK += bf16(dS^T).Q
    in float32; a key tile's chunk partials summed in chunk order, dK scaled
    once, both rounded to bf16.  dQ: per pair of query tiles over its
    pair_ent key tiles, ascending, a tile that is empty for a query tile
    skipped; S = Q.K^T and dP = dO.V^T, P from the lse as above, dS = P (dP -
    delta) with that delta, dQ += bf16(dS).K in float32, scaled
    once, rounded to bf16."""
    from tests.test_torch_attention import tc_tile_emulation

    L, NH, D = q.shape
    KH = k.shape[1]
    G = NH // KH
    P, T, S, N, variant, window = layout
    scale = 1.0 / np.sqrt(D)
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(1.4426950408889634,
                                                                dtype=torch.float32)
    idx = torch.arange(L)
    mask = ta.train_mask(idx[:, None], idx[None, :], P, T, S, N, variant, window)
    out32 = tc_tile_emulation(q[None], [(k[None], v[None], mask[None])], scale, keep_f32=True)[0]
    out = out32.bfloat16()
    out_lo = (out32 - out.float()).bfloat16()

    # token-major rows per KV head: row r = token r // G, query head h * G + r % G
    rows = lambda x: x.float().reshape(L, KH, G, -1).permute(1, 0, 2, 3).reshape(KH, L * G, -1)
    qr, dor = rows(q), rows(dout)
    s_all = torch.einsum("hrd,jhd->hrj", qr, k.float())  # [KH, rows, keys]
    vis = mask[torch.arange(L * G) // G][None]  # [1, rows, keys]
    m = torch.where(vis, s_all * scale, torch.tensor(-float("inf"))).amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros(()), m)
    lse_sum = torch.where(vis, torch.exp(s_all * scale - m), torch.zeros(())).sum(-1)
    lse = torch.where(lse_sum > 0, m[..., 0] + torch.log(lse_sum), torch.zeros(()))
    delta = (dor * (rows(out) + rows(out_lo))).sum(-1)  # [KH, rows]

    tm = ta.classify_tiles(L, P, T, S, N, variant, window, G, key_tile=ta.TC_KEY_TILE)
    kf, vf = k.float().permute(1, 0, 2), v.float().permute(1, 0, 2)  # [KH, L, D]
    partial = {}
    for kt, e0, e1, slot in tm.chunks.tolist():
        keys = slice(kt * 64, min(kt * 64 + 64, L))
        acc_k = torch.zeros(KH, keys.stop - keys.start, D)
        acc_v = torch.zeros_like(acc_k)
        for ent in tm.k_ent[e0:e1].tolist():
            r = slice((ent >> 1) * 64, min((ent >> 1) * 64 + 64, L * G))
            st = kf[:, keys] @ qr[:, r].transpose(1, 2)  # S^T [KH, keys, rows]
            dpt = vf[:, keys] @ dor[:, r].transpose(1, 2)
            ok = vis[:, r, keys].transpose(1, 2)
            p = torch.where(ok, torch.exp2(st * c - lse[:, None, r] * 1.4426950408889634),
                            torch.zeros(()))
            ds = p * (dpt - delta[:, None, r])
            acc_v += p.bfloat16().float() @ dor[:, r]
            acc_k += ds.bfloat16().float() @ qr[:, r]
        partial[(kt, e0)] = (acc_k, acc_v)
    dk = torch.zeros(KH, L, D)
    dv = torch.zeros(KH, L, D)
    for kt in range(tm.classes.shape[1]):
        parts = [partial[key] for key in sorted(x for x in partial if x[0] == kt)]
        sk, sv = parts[0]
        for pk, pv in parts[1:]:
            sk, sv = sk + pk, sv + pv
        dk[:, kt * 64 : kt * 64 + sk.shape[1]] = sk * scale
        dv[:, kt * 64 : kt * 64 + sv.shape[1]] = sv
    dk, dv = dk.permute(1, 0, 2).bfloat16(), dv.permute(1, 0, 2).bfloat16()
    if not with_dq:
        return out, dk, dv
    dq = torch.zeros(KH, L * G, D)
    for p in range(len(tm.pair_ptr) - 1):
        for ent in tm.pair_ent[tm.pair_ptr[p] : tm.pair_ptr[p + 1]].tolist():
            keys = slice((ent >> 4) * 64, min((ent >> 4) * 64 + 64, L))
            for wg in range(2):
                qt = 2 * p + wg
                if (ent >> (2 * wg)) & 3 == ta.EMPTY or qt * 64 >= L * G:
                    continue
                r = slice(qt * 64, min(qt * 64 + 64, L * G))
                st = qr[:, r] @ kf[:, keys].transpose(1, 2)  # S [KH, rows, keys]
                dpt = dor[:, r] @ vf[:, keys].transpose(1, 2)
                p_ = torch.where(vis[:, r, keys],
                                 torch.exp2(st * c - lse[:, r, None] * 1.4426950408889634),
                                 torch.zeros(()))
                ds = p_ * (dpt - delta[:, r, None])
                dq[:, r] += ds.bfloat16().float() @ kf[:, keys]
    dq = (dq * scale).reshape(KH, L, G, D).permute(1, 0, 2, 3).reshape(L, NH, D)
    return out, dk, dv, dq.bfloat16()


# (L, prompt_len, T, seq_len, N, KH, G, D): prompt key tiles that span two and
# three dK/dV chunks, a row padded past seq_len, demo-like and 7B-like heads
EMULATED = [(256, 40, 3, 232, 32, 2, 4, 64), (320, 100, 6, 292, 16, 1, 7, 128)]


@pytest.mark.parametrize("case", EMULATED, ids=lambda c: "L%d-P%d-T%d-S%d-N%d-KH%d-G%d-D%d" % c)
@pytest.mark.parametrize("variant,window", VARIANTS)
def test_tensor_core_training_numerics_within_the_bf16_rule(case, variant, window):
    """The emulated tensor-core forward and dK/dV held to autograd of the
    plain version in float32 on the same bf16 inputs, under chip_smoke's bf16
    rules (`check` for the output on the rows that take part, `check_grad` for
    dk and dv); rows that see nothing give zeros."""
    L, P, T, S, N, KH, G, D = case
    q, k, v, dout = (torch.from_numpy(a).bfloat16()
                     for a in _inputs(L, KH * G, KH, D, np.float32, seed=L + D))
    live = torch.from_numpy(_live_rows(L, P, T, S, N))
    dout = dout * live[:, None, None].bfloat16()
    layout = (P, T, S, N, variant, window)
    tm = ta.classify_tiles(L, P, T, S, N, variant, window, G, key_tile=ta.TC_KEY_TILE)
    assert (tm.chunks[:, 0] == 0).sum() >= 2  # the prompt's first key tile is split
    out, dk, dv = tc_train_emulation(q, k, v, dout, layout)
    kw = dict(prompt_len=P, T_pairs=T, seq_len=S, N=N, variant=variant, window_size=window)
    ref = _port_grads(ta.train_attention_ref, q.float().numpy(), k.float().numpy(),
                      v.float().numpy(), dout.float().numpy(), **kw)
    ref = [torch.from_numpy(r) for r in ref]
    assert _within(out[live], ref[0][live])
    assert not bool(out[~live].any())
    assert _within(dk, ref[2]) and _within(dv, ref[3])


@pytest.mark.parametrize("case", EMULATED, ids=lambda c: "L%d-P%d-T%d-S%d-N%d-KH%d-G%d-D%d" % c)
@pytest.mark.parametrize("variant,window", VARIANTS)
def test_tensor_core_dq_numerics_within_the_bf16_rule(case, variant, window):
    """The emulated tensor-core dQ (the forward's pair lists, delta from the
    bf16 O and its residual, dS rounded to bf16 before dS.K) held to autograd of the plain
    version in float32 on the same bf16 inputs under chip_smoke's bf16 rule
    (`check_grad`); rows that see nothing get zero dq."""
    L, P, T, S, N, KH, G, D = case
    q, k, v, dout = (torch.from_numpy(a).bfloat16()
                     for a in _inputs(L, KH * G, KH, D, np.float32, seed=L + D))
    live = torch.from_numpy(_live_rows(L, P, T, S, N))
    dout = dout * live[:, None, None].bfloat16()
    dq = tc_train_emulation(q, k, v, dout, (P, T, S, N, variant, window), with_dq=True)[3]
    kw = dict(prompt_len=P, T_pairs=T, seq_len=S, N=N, variant=variant, window_size=window)
    ref = _port_grads(ta.train_attention_ref, q.float().numpy(), k.float().numpy(),
                      v.float().numpy(), dout.float().numpy(), **kw)
    assert dq.dtype == torch.bfloat16 and tuple(dq.shape) == tuple(q.shape)
    assert _within(dq, torch.from_numpy(ref[1]))
    assert not bool(dq[~live].any())


def test_tensor_core_dq_at_one_kv_head_within_the_bf16_rule():
    """One KV head of two query heads, D 64 (the demo model's heads at TP 2):
    the inputs chip_smoke.make_train_case draws for seed 9000 on a 1024-token
    row.  With delta from the bf16 O alone the emulated dQ (and the kernel's,
    on an H100) missed the bf16 rule at token 1, a row that sees two keys,
    whose exact dP - delta terms cancel; delta from O + O_lo keeps it within
    the rule."""
    L, P, T, S, N, KH, G, D = 1024, 100, 14, 996, 32, 1, 2, 64
    r = np.random.RandomState(9000)
    f = lambda *shape: torch.from_numpy(r.randn(*shape).astype(np.float32)).bfloat16()
    live = torch.from_numpy(_live_rows(L, P, T, S, N))
    dout = f(L, KH * G, D) * live[:, None, None].bfloat16()
    q, k, v = f(L, KH * G, D), f(L, KH, D), f(L, KH, D)
    dq = tc_train_emulation(q, k, v, dout, (P, T, S, N, "single", 4), with_dq=True)[3]
    ref = _port_grads(ta.train_attention_ref, q.float().numpy(), k.float().numpy(),
                      v.float().numpy(), dout.float().numpy(), prompt_len=P, T_pairs=T,
                      seq_len=S, N=N, variant="single", window_size=4)
    assert _within(dq, torch.from_numpy(ref[1]))
