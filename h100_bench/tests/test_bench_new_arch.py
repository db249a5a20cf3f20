"""A second architecture added as new files only, in a copy of the benchmark
folder: a toy with a routed-expert MLP (E 8, k 2, one shared expert), a
windowed layer beside a full one, and its own tensor names drawn one piece
a layer.  Its layout's `port_params` returns the tensors as they are; its
reference is plain float32 torch.  The harness's shared code draws it,
loads it, counts it and checks against it without an edit."""

import json
import weakref
from types import SimpleNamespace

import pytest
import torch

from h100_bench.lib import weights
from h100_bench.lib.registry import Registry
from test_bench_layouts import observe_script

TOY = {
    "name": "toy-moe", "source": "a CPU test model", "reference": "toy",
    "torch_dtype": "float32", "hidden_size": 32, "num_attention_heads": 4,
    "num_key_value_heads": 2, "head_dim": 8, "vocab_size": 64, "num_experts": 8,
    "num_experts_per_tok": 2, "num_shared_experts": 1, "moe_intermediate_size": 16,
    "layer_types": ["sliding_attention", "full_attention"], "sliding_window": 64,
    "rms_norm_eps": 1e-6,
}

LAYOUT = '''
from h100_bench.lib.weights import NORM, SMALL, Draw


def dims(cfg):
    return dict(H=cfg["hidden_size"], V=cfg["vocab_size"], NL=len(cfg["layer_types"]))


def _sizes(cfg):
    D = cfg["head_dim"]
    return (cfg["hidden_size"], cfg["num_attention_heads"] * D, cfg["num_key_value_heads"] * D,
            cfg["num_experts"], cfg["moe_intermediate_size"])


def draws(cfg):
    H, q, kv, E, I = _sizes(cfg)
    out = [Draw([("tok_emb", (cfg["vocab_size"], H), SMALL), ("final_norm", (H,), NORM)])]
    for i in range(len(cfg["layer_types"])):
        p = f"blocks.{i}."
        out.append(Draw([(p + "attn_norm", (H,), NORM), (p + "mlp_norm", (H,), NORM),
                         (p + "wqkv", (q + 2 * kv, H), H), (p + "router", (E, H), H),
                         (p + "experts.w_in", (E, 2 * I, H), H),
                         (p + "shared.w_in", (2 * I, H), H), (p + "wo", (H, q), q),
                         (p + "experts.w_out", (E, H, I), I), (p + "shared.w_out", (H, I), I)]))
    return out


def port_params(cfg, pieces, dtype, device):
    params = {}
    for piece in pieces:
        params.update(piece)
    return cfg, params


def row_linear_flops(cfg):
    H, q, kv, E, I = _sizes(cfg)
    k, S = cfg["num_experts_per_tok"], cfg["num_shared_experts"]
    return 2 * (H * (q + 2 * kv) + q * H + E * H + (k + S) * 3 * H * I) * len(cfg["layer_types"])


def attention_layers(cfg):
    return [(cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"],
             cfg["sliding_window"] if kind == "sliding_attention" else None)
            for kind in cfg["layer_types"]]
'''

REFERENCE = '''
import torch
from torch.nn.functional import silu


class Reference:
    def __init__(self, cfg, tensors, fp8=False):
        self.c, self.t = cfg, {k: v.float() for k, v in tensors.items()}

    def rms(self, x, w):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.c["rms_norm_eps"]) * w

    @torch.no_grad()
    def logits_at(self, seqs, positions):
        c, t = self.c, self.t
        NH, KH, D, k = (c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"],
                        c["num_experts_per_tok"])
        out = []
        for s, pos in zip(seqs, positions):
            T, i = len(s), torch.arange(len(s))
            h = t["tok_emb"][torch.as_tensor(list(s))]
            for n, kind in enumerate(c["layer_types"]):
                p = f"blocks.{n}."
                W = c["sliding_window"] if kind == "sliding_attention" else T
                see = (i[None] <= i[:, None]) & (i[:, None] - i[None] < W)
                q, kk, v = (self.rms(h, t[p + "attn_norm"]) @ t[p + "wqkv"].T).split(
                    [NH * D, KH * D, KH * D], -1)
                kk, v = (z.view(T, KH, D).repeat_interleave(NH // KH, 1) for z in (kk, v))
                a = torch.einsum("qhd,khd->hqk", q.view(T, NH, D), kk) / D ** 0.5
                a = a.masked_fill(~see, float("-inf")).softmax(-1)
                h = h + torch.einsum("hqk,khd->qhd", a, v).reshape(T, NH * D) @ t[p + "wo"].T
                x = self.rms(h, t[p + "mlp_norm"])
                top = torch.sigmoid(x @ t[p + "router"].T).topk(k, -1)
                gate = top.values / top.values.sum(-1, keepdim=True)
                g, u = (x @ t[p + "shared.w_in"].T).chunk(2, -1)
                y = (silu(g) * u) @ t[p + "shared.w_out"].T
                for j in range(k):
                    e = top.indices[:, j]
                    g, u = (t[p + "experts.w_in"][e] @ x[:, :, None])[..., 0].chunk(2, -1)
                    y = y + gate[:, j:j + 1] * (t[p + "experts.w_out"][e] @ (silu(g) * u)[:, :, None])[..., 0]
                h = h + y
            x = self.rms(h[torch.as_tensor(list(pos))], t["final_norm"])
            out.append(x @ t["tok_emb"].T)
        return out
'''


@pytest.fixture
def toy(tiny_root):
    """(registry, configuration) of a copy of the benchmark folder with the
    toy architecture and its configuration added as files."""
    (tiny_root / "layouts" / "toy.py").write_text(LAYOUT)
    (tiny_root / "reference" / "toy.py").write_text(REFERENCE)
    (tiny_root / "configs" / "toy-moe.json").write_text(json.dumps(TOY))
    reg = Registry(tiny_root)
    return reg, reg.config("toy-moe")


def test_the_draw_follows_the_seed_a_piece_a_layer(toy):
    reg, cfg = toy
    layout = reg.layout("toy")
    assert len(layout.draws(cfg)) == 3  # the embedding and final norm, then one per layer
    a = weights.make_hf_tensors(layout, cfg, 2_147_483_659, "cpu")
    b = weights.make_hf_tensors(layout, cfg, 2_147_483_659, "cpu")
    c = weights.make_hf_tensors(layout, cfg, 5, "cpu")
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.1.experts.w_in"], c["blocks.1.experts.w_in"])
    assert a["blocks.0.experts.w_out"].shape == (8, 32, 16)
    assert a["blocks.0.attn_norm"].sub(1).abs().max() < 1.0  # 1 + N(0, 1) * 0.1
    _, params = weights.port_params(layout, cfg, 2_147_483_659, "cpu")
    assert list(params) == list(a) and all(torch.equal(params[k], a[k]) for k in a)


def test_no_piece_is_held_after_the_port_takes_it(toy, monkeypatch):
    """A port that builds its own tensors from each piece and lets the piece
    go: no tensor of an earlier piece is alive when the next piece arrives,
    nor once loading ends, so the harness holds at most the piece in hand."""
    reg, cfg = toy
    layout = reg.layout("toy")
    drawn, alive_at_next = [], []

    def port(cfg, pieces, dtype, device):
        params = {}
        for piece in pieces:
            alive_at_next.append(sum(r() is not None for r in drawn))
            drawn.extend(weakref.ref(t if t._base is None else t._base) for t in piece.values())
            params.update({k: v.clone() for k, v in piece.items()})
            del piece
        return cfg, params

    monkeypatch.setattr(layout, "port_params", port)
    _, params = weights.port_params(layout, cfg, 77, "cpu")
    assert alive_at_next == [0, 0, 0]
    assert drawn and all(r() is None for r in drawn)
    assert len(params) == 2 + 2 * 9


def test_the_check_finds_its_reference(toy):
    """`sample_gaps` draws the toy's tensors, builds its reference by the
    shared name and judges served tokens: the reference's own arg-max
    tokens (a Jacobi fixed point over prompt and output, past the window)
    lie 0 below its best; an altered token does not."""
    from h100_bench.tasks.serve import sample_gaps

    reg, cfg = toy
    ctx = SimpleNamespace(cfg=cfg, seed=2_600_000_021, device=torch.device("cpu"),
                          arch=reg.arch(cfg))
    ref = ctx.arch.Reference(cfg, weights.make_hf_tensors(ctx.arch.layout, cfg, ctx.seed, "cpu"))
    g = torch.Generator().manual_seed(3)
    prompts = [[int(i) for i in torch.randint(1, 64, (n,), generator=g)] for n in (70, 40)]
    sample = []
    for prompt, n_out in zip(prompts, (30, 12)):
        out = [0] * n_out
        pos = list(range(len(prompt) - 1, len(prompt) + n_out - 1))
        for _ in range(n_out + 1):
            out = ref.logits_at([prompt + out], [pos])[0].argmax(-1).tolist()
        sample.append({"prompt": prompt, "output": out})
    gaps = sample_gaps(ctx, sample)
    assert [len(x) for x in gaps] == [30, 12]
    assert max(max(x) for x in gaps) == 0.0
    sample[0]["output"][5] = (sample[0]["output"][5] + 1) % 64
    assert sample_gaps(ctx, sample)[0][5] > 0.0


def test_its_rows_count_k_of_e_experts(toy):
    reg, cfg = toy
    arch = reg.arch(cfg)
    rows = reg.counts("serve_rows")
    # per layer: q/k/v 32 x 64, o 32 x 32, router 32 x 8, 2 routed + 1 shared experts of
    # 3 x 32 x 16; two operations a multiply-add, two layers
    per_layer = 32 * 64 + 32 * 32 + 32 * 8 + 3 * 3 * 32 * 16
    assert rows.linear_flops(arch) == 2 * 2 * per_layer
    assert rows.rows_flops(arch, 1, 1) == 2 * 2 * per_layer + 2 * 32 * 64
    all_experts = 32 * 64 + 32 * 32 + 32 * 8 + 9 * 3 * 32 * 16
    assert rows.linear_flops(arch) < 2 * 2 * all_experts


def test_a_windowed_layer_counts_its_window(toy):
    """One prompt of 100 tokens: its prefill forwards 164 rows (prompt and a
    64-token draft) from position 0, then one trip forwards queries
    100..163.  The windowed layer (W 64) sees at most 64 keys a query and
    reads keys 37..163 in the trip; the full layer sees every earlier key."""
    reg, cfg = toy
    arch = reg.arch(cfg)
    win, full = (4, 2, 8, 64), (4, 2, 8, None)
    assert arch.attention == [(win, 1), (full, 1)]
    w = observe_script(arch, (100,), [[("p", 0)], [("t", 0, 1, 0)]])
    assert w.prefill_pairs == {win: sum(range(1, 64)) + 101 * 64, full: 164 * 165 // 2}
    assert w.trip_pairs == {win: 64 * 64, full: 64 * 100 + 64 * 65 // 2}
    q_bytes = 2 * 164 * 4 * 8 * 2 + 2 * 64 * 4 * 8 * 2  # queries in, outputs out
    kv_bytes = 2 * 2 * 8 * 2 * (164 + 164) + 2 * 2 * 8 * 2 * (127 + 164)
    assert w.k1_bytes == q_bytes * 2 + kv_bytes
    pairs = (w.prefill_pairs[win] + w.trip_pairs[win] + w.prefill_pairs[full]
             + w.trip_pairs[full])
    assert w.k1_ops == 4 * 8 * 4 * pairs
    assert reg.counts("serve_rows").attention_flops(arch, w.trip_pairs, w.prefill_pairs) \
        == 4 * 8 * 4 * pairs
