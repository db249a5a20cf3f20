"""The plain reference against the port's own forward, at a tiny size on the
CPU: Qwen2 (qkv bias) and Qwen3 (per-head q/k norm), on the weights the
benchmark makes from a seed."""

import pytest
import torch

from conftest import TINY_QWEN2, TINY_QWEN3
from h100_bench.lib.registry import Registry
from h100_bench.lib.weights import make_hf_tensors, port_params

QWEN = Registry().layout("qwen")
Reference = Registry().reference("qwen").Reference


def port_logits(cfg, seed, ids):
    from jacobiforcing_tpu_torch.models.qwen import forward_dense, logits_at, rope_table

    mc, params = port_params(QWEN, cfg, seed, "cpu")
    x = torch.as_tensor([ids])
    pos = torch.arange(len(ids))[None]
    h = forward_dense(params, mc, x, pos, rope_table(mc, "cpu"))
    return logits_at(params, mc, h)[0]


@pytest.mark.parametrize("base", [TINY_QWEN2, TINY_QWEN3], ids=["qwen2", "qwen3"])
def test_reference_matches_the_port(base):
    cfg = dict(base, torch_dtype="float64")
    ids = list(torch.randint(1, cfg["vocab_size"], (37,), generator=torch.Generator().manual_seed(5)))
    ids = [int(i) for i in ids]
    ref = Reference(cfg, make_hf_tensors(QWEN, cfg, 9, "cpu"))
    got = ref.logits_at([ids], [list(range(len(ids)))])[0].double()
    want = port_logits(cfg, 9, ids)
    assert got.shape == want.shape
    assert (got - want).abs().max().item() < 1e-4 * want.abs().max().item()


def test_weights_follow_the_seed():
    a = make_hf_tensors(QWEN, TINY_QWEN2, 1, "cpu")
    b = make_hf_tensors(QWEN, TINY_QWEN2, 1, "cpu")
    c = make_hf_tensors(QWEN, TINY_QWEN2, 2, "cpu")
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm_head.weight"], c["lm_head.weight"])
    assert "model.layers.1.self_attn.q_proj.bias" in a


def test_fp8_control_departs_further_than_float32():
    cfg = dict(TINY_QWEN3, torch_dtype="float64")
    t = make_hf_tensors(QWEN, cfg, 4, "cpu")
    ids = [int(i) for i in torch.randint(1, 256, (24,), generator=torch.Generator().manual_seed(1))]
    pos = [list(range(24))]
    exact = port_logits(cfg, 4, ids)
    f32 = Reference(cfg, t).logits_at([ids], pos)[0].double()
    fp8 = Reference(cfg, t, fp8=True).logits_at([ids], pos)[0].double()
    assert (fp8 - exact).abs().max() > 100 * (f32 - exact).abs().max()
