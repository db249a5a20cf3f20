"""The decoder layer's fused pointwise kernels (csrc/decoder_pointwise.cu) and
the routing of `models/qwen.py` between them and the plain functions.

On the CPU: the routing keeps the plain path, with every wrapper's launch
count unchanged, for CPU tensors, float32 / float64 models and inputs under
autograd; the wrappers raise on CPU and wrong-dtype input and on shapes
their kernels do not take; and the residual carried from each layer's MLP
into the next layer's norm gives the hidden states of the loop that added
it at the end of the layer.  The `cuda`-marked tests hold each kernel to its
plain version at the served widths (bitwise where the plain path has no
reduction, within one bf16 ulp where it has), a few full-width layers
fused against the plain loop, and the launch counts of a captured graph.  This file
imports only the port, so the card's test run collects it.
"""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jacobiforcing_tpu_torch.config import Config, SamplingParams
from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine
from jacobiforcing_tpu_torch.models import qwen as tq
from jacobiforcing_tpu_torch.ops import decoder_pointwise_cuda as dpc
from jacobiforcing_tpu_torch.ops import paged_attention_cuda as pac
from jacobiforcing_tpu_torch.ops.attention import paged_attention
from jacobiforcing_tpu_torch.ops.kv_cache import alloc_kv_cache, write_kv, write_plan

WRAPPERS = (dpc.add_rms_norm_cuda, dpc.qkv_rope_cuda, dpc.silu_mul_cuda)


def _launches():
    return [f.launches for f in WRAPPERS]


def _tiny(dtype, qk_norm=False, **kw):
    cfg = tq.ModelConfig.tiny(dtype=dtype, qkv_bias=not qk_norm, qk_norm=qk_norm, **kw)
    return cfg, tq.init_params(cfg, 0, device="cpu")


def _todays_forward(params, cfg, input_ids, positions, kv, block_tables, cache_lens, rope):
    """`forward` as it was before the fold: every residual added at the end
    of its sub-layer, the plain functions only, on any device."""
    B, T = input_ids.shape
    page, num_slots = kv.page_size, kv.num_slots
    pos_l = positions.long()
    cos, sin = rope[0][pos_l], rope[1][pos_l]
    page_idx = torch.gather(block_tables, 1, (pos_l // page).clamp(0, block_tables.shape[1] - 1))
    slots = page_idx.long() * page + pos_l % page
    slots = torch.where(page_idx < 0, num_slots, slots)
    plan = write_plan(slots, num_slots, kv.k.shape[1])
    eps = cfg.rms_norm_eps
    h = tq.embed(params, cfg, input_ids)
    for i in range(cfg.num_layers):
        w = tq._layer_weights(params["layers"], i)
        hn = tq.rms_norm(h, w["ln1"], eps)
        q, kk, vv = hn @ w["wq"], hn @ w["wk"], hn @ w["wv"]
        if cfg.qkv_bias:
            q, kk, vv = q + w["bq"], kk + w["bk"], vv + w["bv"]
        q, kk, vv = (t.reshape(B, T, -1, cfg.head_dim) for t in (q, kk, vv))
        if cfg.qk_norm:
            q, kk = tq.rms_norm(q, w["q_norm"], eps), tq.rms_norm(kk, w["k_norm"], eps)
        q, kk = tq.apply_rope(q, cos, sin), tq.apply_rope(kk, cos, sin)
        write_kv(kv.k[i], kv.v[i], kk, vv, slots, plan)
        o = paged_attention(q, kv.k[i], kv.v[i], block_tables, cache_lens,
                            positions.to(torch.int32), 1.0 / math.sqrt(cfg.head_dim),
                            page_size=page)
        h = h + o.reshape(B, T, -1) @ w["wo"]
        hn = tq.rms_norm(h, w["ln2"], eps)
        g, u = hn @ w["w_gate"], hn @ w["w_up"]
        h = h + (F.silu(g.to(tq.acc_dtype(cfg.dtype))).to(u.dtype) * u) @ w["w_down"]
    return tq.rms_norm(h, params["final_norm"], eps)


def _cache_inputs(cfg, B=2, T=12, page=8, seed=1):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (B, T), generator=g)
    positions = torch.arange(T)[None].expand(B, T).contiguous()
    pages = -(-T // page)
    block_tables = torch.arange(B * pages, dtype=torch.int32).reshape(B, pages)
    cache_lens = torch.full((B,), T, dtype=torch.int32)

    def kv():
        return alloc_kv_cache(cfg.num_layers, B * pages, page, cfg.num_kv_heads, cfg.head_dim,
                              dtype=cfg.dtype)

    return ids, positions, block_tables, cache_lens, kv


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16],
                         ids=["f64", "f32", "bf16"])
@pytest.mark.parametrize("qk_norm", [False, True], ids=["bias", "qk_norm"])
def test_carried_residual_gives_todays_hidden_states(dtype, qk_norm):
    """The MLP output carried into the next layer's norm (and the last one
    into the final norm) is the same addition in the same place: `forward`'s
    hidden states and KV writes equal the old loop's bit for bit, and no
    fused kernel runs on the CPU."""
    cfg, params = _tiny(dtype, qk_norm, num_layers=3)
    rope = tq.rope_table(cfg)
    ids, positions, block_tables, cache_lens, kv = _cache_inputs(cfg)
    before = _launches()
    kv_new, kv_old = kv(), kv()
    h_new, _ = tq.forward(params, cfg, ids, positions, kv_new, block_tables, cache_lens, rope)
    h_old = _todays_forward(params, cfg, ids, positions, kv_old, block_tables, cache_lens, rope)
    assert torch.equal(h_new, h_old)
    assert torch.equal(kv_new.k, kv_old.k) and torch.equal(kv_new.v, kv_old.v)
    assert _launches() == before


def test_dense_forward_under_autograd_stays_plain():
    """Training's `forward_dense` under autograd: gradients flow through the
    plain functions and no wrapper counts a launch."""
    cfg, params = _tiny(torch.float32, num_layers=2)
    for leaf in params["layers"].values():
        leaf.requires_grad_(True)
    ids = torch.randint(0, cfg.vocab_size, (1, 10), generator=torch.Generator().manual_seed(2))
    before = _launches()
    h = tq.forward_dense(params, cfg, ids, torch.arange(10)[None], tq.rope_table(cfg))
    h.square().sum().backward()
    assert all(leaf.grad is not None for leaf in params["layers"].values())
    assert _launches() == before


def _fake(is_cuda=True, dtype=torch.bfloat16, requires_grad=False):
    """What `_fuse` reads of a tensor, for a card this machine may not have."""
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype, requires_grad=requires_grad)


@pytest.mark.parametrize("case,fused", [
    ("bf16_cuda", True),
    ("cpu", False),
    ("f32", False),
    ("f64", False),
    ("grad_input", False),
    ("grad_weight", False),
    ("grad_but_no_grad_mode", True),
    ("grad_mode_but_no_grad_input", True),
])
def test_fuse_rule(case, fused):
    """bfloat16 on the card outside autograd takes the kernels; the CPU,
    float32 / float64 and an input that requires grad under grad mode do not."""
    x, w = _fake(), _fake()
    grad_mode = False
    if case == "cpu":
        x = _fake(is_cuda=False)
    elif case == "f32":
        x = _fake(dtype=torch.float32)
    elif case == "f64":
        x = _fake(dtype=torch.float64)
    elif case == "grad_input":
        x, grad_mode = _fake(requires_grad=True), True
    elif case == "grad_weight":
        w, grad_mode = _fake(requires_grad=True), True
    elif case == "grad_but_no_grad_mode":
        w = _fake(requires_grad=True)
    elif case == "grad_mode_but_no_grad_input":
        grad_mode = True
    with torch.set_grad_enabled(grad_mode):
        assert tq._fuse(x, None, w) is fused


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_routing_keeps_the_plain_functions_on_cpu(dtype):
    """Each routed chain on CPU tensors gives its plain function's result,
    and no wrapper counts a launch."""
    g = torch.Generator().manual_seed(3)
    h, d = (torch.randn(5, 7, 64, generator=g).to(dtype) for _ in range(2))
    w = torch.randn(64, generator=g).to(dtype)
    before = _launches()
    s, n = tq.add_rms_norm(h, d, w, 1e-6)
    assert torch.equal(s, h + d) and torch.equal(n, tq.rms_norm(h + d, w, 1e-6))
    s, n = tq.add_rms_norm(h, None, w, 1e-6)
    assert s is h and torch.equal(n, tq.rms_norm(h, w, 1e-6))
    gt, ut = (torch.randn(5, 7, 96, generator=g).to(dtype) for _ in range(2))
    assert torch.equal(tq.silu_mul(gt, ut),
                       F.silu(gt.to(tq.acc_dtype(dtype))).to(dtype) * ut)
    assert _launches() == before


def _bf16(*shape, device="cpu"):
    return torch.randn(*shape).to(torch.bfloat16).to(device)


@pytest.mark.parametrize("case", ["odd_hidden", "wide_hidden", "delta_shape", "weight_shape"])
def test_norm_refuses_shapes_it_does_not_take(case):
    """A hidden width that is not a multiple of 8 or is wider than a CTA
    holds, or mismatched shapes: the wrapper raises ValueError on the shape
    before any device check, so on the card such a model fails instead of
    running the plain chain unseen."""
    x, w, d = _bf16(4, 64), _bf16(64), None
    if case == "odd_hidden":
        x, w = _bf16(4, 60), _bf16(60)
    elif case == "wide_hidden":
        x, w = _bf16(2, dpc.MAX_HIDDEN + 8), _bf16(dpc.MAX_HIDDEN + 8)
    elif case == "delta_shape":
        d = _bf16(4, 32)
    elif case == "weight_shape":
        w = _bf16(32)
    with pytest.raises(ValueError) as err:
        dpc.add_rms_norm_cuda(x, w, 1e-6, d)
    assert "CUDA" not in str(err.value)


@pytest.mark.parametrize("case", ["head_dim", "cos_shape", "bias_alone", "norm_alone"])
def test_qkv_rope_refuses_shapes_it_does_not_take(case):
    """The q/k/v kernel's shape rules (head_dim 64 or 128, as kernel 1's)
    raise ValueError before any device check; so does silu_mul's width
    rule."""
    B, T, NH, KH, D = 2, 3, 4, 2, 64
    q, k, v = _bf16(B, T, NH, D), _bf16(B, T, KH, D), _bf16(B, T, KH, D)
    cos = sin = torch.ones(B, T, D // 2)
    extra = {}
    if case == "head_dim":
        q, k, v = _bf16(B, T, NH, 32), _bf16(B, T, KH, 32), _bf16(B, T, KH, 32)
        cos = sin = torch.ones(B, T, 16)
    elif case == "cos_shape":
        cos = sin = torch.ones(B, T, D)
    elif case == "bias_alone":
        extra = dict(bq=_bf16(NH * D))
    elif case == "norm_alone":
        extra = dict(q_norm=_bf16(D))
    with pytest.raises(ValueError) as err:
        dpc.qkv_rope_cuda(q, k, v, cos, sin, 1e-6, **extra)
    assert "CUDA" not in str(err.value)
    with pytest.raises(ValueError, match="multiple of 8"):
        dpc.silu_mul_cuda(_bf16(4, 12), _bf16(4, 12))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wrappers_raise_on_cpu_or_wrong_dtype(dtype):
    """The wrappers take bfloat16 CUDA tensors only; anything else raises
    ValueError before a kernel is built or launched."""
    before = _launches()
    x, w = torch.randn(4, 64).to(dtype), torch.randn(64).to(dtype)
    with pytest.raises(ValueError, match="CUDA"):
        dpc.add_rms_norm_cuda(x, w, 1e-6, x)
    q, k = torch.randn(1, 2, 4, 64).to(dtype), torch.randn(1, 2, 2, 64).to(dtype)
    cos = torch.ones(1, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        dpc.qkv_rope_cuda(q, k, k, cos, cos, 1e-6)
    with pytest.raises(ValueError, match="CUDA"):
        dpc.silu_mul_cuda(x, x)
    assert _launches() == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fused kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The most bf16 steps between a and b, element by element (the same
    sign on both sides, or zero on one)."""
    ai, bi = (t.view(torch.int16).int() for t in (a, b))
    zero = (a == 0) | (b == 0)
    assert bool((((ai < 0) == (bi < 0)) | zero).all()), "a sign differs"
    return int(torch.where(zero, 0, (ai - bi).abs()).max())


ROWS = (2048, 1152, 37)  # a trip (B 32 x L 64), a prefill bucket, a ragged count


@pytest.mark.cuda
@pytest.mark.parametrize("H", [3584, 4096])
@pytest.mark.parametrize("rows", ROWS)
def test_add_rms_norm_matches_plain_on_cuda(cuda, H, rows):
    torch.manual_seed(H + rows)
    h, d = _bf16(rows, H, device="cuda"), _bf16(rows, H, device="cuda")
    w = (1 + 0.1 * torch.randn(H)).to(torch.bfloat16).cuda()
    before = dpc.add_rms_norm_cuda.launches
    s, n = dpc.add_rms_norm_cuda(h, w, 1e-6, d)
    s0, n0 = dpc.add_rms_norm_cuda(h, w, 1e-6)
    torch.cuda.synchronize()
    assert dpc.add_rms_norm_cuda.launches == before + 2
    assert torch.equal(s, h + d) and s0 is h
    assert _ulps(n, tq.rms_norm(h + d, w, 1e-6)) <= 1
    assert _ulps(n0, tq.rms_norm(h, w, 1e-6)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("I", [18944, 12288])
@pytest.mark.parametrize("rows", ROWS)
def test_silu_mul_matches_plain_on_cuda(cuda, I, rows):
    torch.manual_seed(I + rows)
    g, u = 3 * _bf16(rows, I, device="cuda"), _bf16(rows, I, device="cuda")
    out = dpc.silu_mul_cuda(g, u)
    torch.cuda.synchronize()
    assert torch.equal(out, F.silu(g.float()).to(torch.bfloat16) * u)


HEADS = {  # (NH, KH, D, qkv bias, qk norm)
    "coder7b": (28, 4, 128, True, False),
    "qwen3_8b": (32, 8, 128, False, True),
    "d64_bias": (16, 2, 64, True, False),
    "d64_norm": (16, 2, 64, False, True),
    "tp2_coder7b": (14, 2, 128, True, False),
}


def _qkv_case(name, rows, identity_rope=False):
    NH, KH, D, bias, norm = HEADS[name]
    torch.manual_seed(rows * 7 + NH)
    B, T = (rows // 64, 64) if rows % 64 == 0 else (1, rows)
    q, k, v = (4 * _bf16(B, T, n, D, device="cuda") for n in (NH, KH, KH))
    cfg = tq.ModelConfig(num_heads=NH, num_kv_heads=KH, head_dim=D, max_position=4096)
    cos_t, sin_t = tq.rope_table(cfg, device="cuda")
    pos = torch.randint(0, 4096, (B, T), device="cuda")
    cos, sin = cos_t[pos], sin_t[pos]
    if identity_rope:
        cos, sin = torch.ones_like(cos), torch.zeros_like(sin)
    w = {}
    if bias:
        w = {n: _bf16(t.shape[2] * D, device="cuda") for n, t in (("bq", q), ("bk", k), ("bv", v))}
    if norm:
        w.update({n: (1 + 0.1 * torch.randn(D)).to(torch.bfloat16).cuda()
                  for n in ("q_norm", "k_norm")})
    return q, k, v, cos, sin, w, bias, norm


def _qkv_plain(q, k, v, cos, sin, w, bias, norm):
    if bias:
        q, k, v = (t + w[n].reshape(-1, t.shape[-1]) for t, n in ((q, "bq"), (k, "bk"), (v, "bv")))
    if norm:
        q, k = tq.rms_norm(q, w["q_norm"], 1e-6), tq.rms_norm(k, w["k_norm"], 1e-6)
    return tq.apply_rope(q, cos, sin), tq.apply_rope(k, cos, sin), v


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(HEADS))
@pytest.mark.parametrize("rows", ROWS)
def test_qkv_rope_matches_plain_on_cuda(cuda, name, rows):
    """Bias + RoPE bit for bit; with the q/k norm, the norm alone (RoPE at
    angle 0) within one ulp and the rotated values within two ulps of the
    pair's magnitude."""
    q, k, v, cos, sin, w, bias, norm = _qkv_case(name, rows)
    before = dpc.qkv_rope_cuda.launches
    out = dpc.qkv_rope_cuda(q, k, v, cos, sin, 1e-6, **w)
    torch.cuda.synchronize()
    assert dpc.qkv_rope_cuda.launches == before + 1
    ref = _qkv_plain(q, k, v, cos, sin, w, bias, norm)
    assert torch.equal(out[2], ref[2]) and (bias or out[2] is v)
    if not norm:
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
        return
    q, k, v, cos1, sin0, w, bias, norm = _qkv_case(name, rows, identity_rope=True)
    normed = dpc.qkv_rope_cuda(q, k, v, cos1, sin0, 1e-6, **w)
    ref_normed = _qkv_plain(q, k, v, cos1, sin0, w, bias, norm)
    assert _ulps(normed[0], ref_normed[0]) <= 1 and _ulps(normed[1], ref_normed[1]) <= 1
    for o, r, x in zip(out[:2], ref[:2], ref_normed[:2]):
        half = x.shape[-1] // 2
        pair = (x[..., :half].float().abs() + x[..., half:].float().abs()).repeat(1, 1, 1, 2)
        assert bool(((o.float() - r.float()).abs() <= 2.0 ** -6 * pair).all())


def _full_width(name, layers=2):
    NH, KH, D, bias, norm = HEADS[name]
    H, I = {"coder7b": (3584, 18944), "qwen3_8b": (4096, 12288)}[name]
    return tq.ModelConfig(vocab_size=32768, hidden_size=H, intermediate_size=I,
                          num_layers=layers, num_heads=NH, num_kv_heads=KH, head_dim=D,
                          qkv_bias=bias, qk_norm=norm, max_position=4096)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["coder7b", "qwen3_8b"])
def test_full_width_layers_fused_against_plain_on_cuda(cuda, name):
    """Two layers at a served configuration's widths: a prefill, then a
    Jacobi trip (B 4 x L 64) over it, by `forward` (fused), by the plain
    loop, and by the plain loop in float32 as the reference, in one process.
    The fused run launches 4 kernels a layer plus the final norm.  A norm's
    sum of squares is added in another order than aten's, so a hidden state
    may differ in its last bf16 bit, and over two layers such bits spread to
    ~0.4% of the hidden states (as any other reordering would): the fused
    run is no farther from the float32 reference than the plain one, and
    its greedy tokens equal the plain run's except at near-ties, at most 2%
    of the rows, each with a float32 top-two logit margin below the plain
    run's own largest logit error."""
    cfg = _full_width(name)
    params = tq.init_params(cfg, 0, device="cuda")
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict) else v.float())
                for k, v in params.items()}
    rope = tq.rope_table(cfg, device="cuda")
    B, P, L, page = 4, 448, 64, 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device="cuda")
    draft = torch.randint(0, cfg.vocab_size, (B, L), generator=gen, device="cuda")
    pages = -(-(P + L) // page)
    tables = torch.arange(B * pages, dtype=torch.int32, device="cuda").reshape(B, pages)

    def run(c, p, fused):
        fwd = tq.forward if fused else (lambda *a: (_todays_forward(*a), None))
        kv = alloc_kv_cache(c.num_layers, B * pages, page, c.num_kv_heads, c.head_dim,
                            dtype=c.dtype, device="cuda")
        with torch.no_grad():
            pos = torch.arange(P, device="cuda")[None].expand(B, P).contiguous()
            lens = torch.full((B,), P, dtype=torch.int32, device="cuda")
            fwd(p, c, prompt, pos, kv, tables, lens, rope)
            pos = (P - 1 + torch.arange(L, device="cuda"))[None].expand(B, L).contiguous()
            before = _launches()
            h, _ = fwd(p, c, draft, pos, kv, tables, lens + L - 1, rope)
            counts = [a - b for a, b in zip(_launches(), before)]
            return h.float(), tq.logits_at(p, c, h), counts

    h_f, logits_f, counts_f = run(cfg, params, True)
    h_p, logits_p, counts_p = run(cfg, params, False)
    h_32, logits_32, _ = run(cfg32, params32, False)
    torch.cuda.synchronize()
    n = cfg.num_layers
    assert counts_f == [2 * n + 1, n, n] and counts_p == [0, 0, 0]

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    assert rel(h_f, h_32) <= 1.05 * rel(h_p, h_32)
    err_f, err_p = ((x - logits_32).abs().max().item() for x in (logits_f, logits_p))
    assert err_f <= 1.25 * err_p, (err_f, err_p)
    top2 = logits_32.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    flipped = logits_f.argmax(-1) != logits_p.argmax(-1)
    assert int(flipped.sum()) <= 0.02 * flipped.numel()
    assert bool((margin[flipped] < err_p).all()), (margin[flipped].tolist(), err_p)


@pytest.mark.cuda
def test_graph_replays_count_the_captured_launches(cuda):
    """A bf16 engine on graphs: each Jacobi graph holds the fused kernels'
    launches of one forward (2 norms a layer plus the final one, one
    qkv_rope and one silu_mul a layer), and every forward, eager or
    replayed, adds them beside kernel 1's one launch a layer."""
    mc = tq.ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=64, max_position=1024)
    params = tq.init_params(mc, 0, device="cuda")
    cfg = Config(kvcache_page_size=16, max_model_len=256, jacobi_chunk_tokens=32,
                 prefill_token_buckets=(32, 64, 128, 256), eos=-1, batch_buckets=(1, 2, 4),
                 jacobi_async_host=False)
    eng = LLMEngine(cfg, model_cfg=mc, params=params, num_kv_pages=128, device="cuda")
    r = np.random.RandomState(0)
    prompts = [r.randint(1, 512, size=s).tolist() for s in (5, 9, 17)]
    k1, before = pac.paged_attention_cuda.launches, _launches()
    eng.generate(prompts, SamplingParams(temperature=0.0, max_tokens=24,
                                         decode_strategy="jacobi", jacobi_block_len=8,
                                         jacobi_max_iterations=256))
    n = mc.num_layers
    assert eng.programs.num_graphs > 0
    for key, captured in eng.programs.launches.items():
        assert captured == [n, 2 * n + 1, n, n, n], (key, captured)
    forwards = (pac.paged_attention_cuda.launches - k1) // n
    assert forwards > eng.programs.num_graphs
    assert [a - b for a, b in zip(_launches(), before)] == [(2 * n + 1) * forwards,
                                                              forwards * n, forwards * n]
