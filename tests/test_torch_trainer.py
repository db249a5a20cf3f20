"""The port's consistency trainer against the JAX package.

A tiny model in fp64 (as `tests/conftest.py` runs JAX), weights carried over by
`params_from_numpy`, rows made from a numpy seed.  `forward_dense`, the losses,
every gradient leaf and three optimizer updates must agree within 1e-9 relative
to the largest value of each array (the same arithmetic, another summation
order); index arrays and schedule values must be equal.  On the CPU the
port's `attn_impl="splash"` runs the plain version of the training attention,
so it is held to the JAX dense-mask path; the JAX splash kernel itself is
compared in `tests/test_torch_train_attention.py`.  The counterparts of
`tests/test_trainer.py` run in f32 like the originals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jacobiforcing_tpu.models import qwen as jq
from jacobiforcing_tpu.train import consistency as jc
from jacobiforcing_tpu.train import sft as jsft
from jacobiforcing_tpu.utils import loader as jloader
from jacobiforcing_tpu_torch.models import qwen as tq
from jacobiforcing_tpu_torch.train import consistency as tc
from jacobiforcing_tpu_torch.train import optim as toptim
from jacobiforcing_tpu_torch.train import sft as tsft
from jacobiforcing_tpu_torch.train import trainer as ttrainer
from jacobiforcing_tpu_torch.utils import loader as tloader

P, N, T = 6, 4, 3  # prompt len, block len, pairs: the row of tests/test_trainer.py
L = P + 2 * T * N


def _pair(vocab=64, seed=0, **kw):
    jcfg = jq.ModelConfig.tiny(vocab_size=vocab, **kw)
    tcfg = tq.ModelConfig.tiny(vocab_size=vocab, **{
        k: (getattr(torch, jnp.dtype(v).name) if k == "dtype" else v) for k, v in kw.items()})
    jparams = jq.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = tloader.params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _ropes(jcfg):
    jrope = jq.rope_table(jcfg)
    return jrope, tuple(torch.from_numpy(np.array(a)) for a in jrope)


def _make_row(rng, vocab=64, noisy_tail=2, n_pairs=T):
    """A packed row as tests/test_trainer.py makes it: k_j = last_j with the
    last `noisy_tail` tokens randomized."""
    seq = rng.randint(1, vocab, P).tolist()
    target = rng.randint(1, vocab, n_pairs * N)
    for j in range(n_pairs):
        last = target[j * N : (j + 1) * N].tolist()
        k = list(last)
        for t in range(N - noisy_tail, N):
            k[t] = int(rng.randint(1, vocab))
        seq.extend(k)
        seq.extend(last)
    return seq


def _configs(**kw):
    d = dict(N=N, max_pairs=T, seq_bucket=40, ar_pair_bucket=48, cons_pair_bucket=48)
    d.update(kw)
    return jc.TrainConfig(**d), tc.TrainConfig(**d)


def _batches(row, n_pairs, jtc, ttc, **kw):
    jb = jc.prepare_sample(row, P, n_pairs, jtc, **kw)
    tb = tc.prepare_sample(row, P, n_pairs, ttc, **kw)
    return ({k: jnp.asarray(v) for k, v in jb.items()},
            {k: torch.as_tensor(v) for k, v in tb.items()}, jb, tb)


def _close(got, want, tol=1e-9):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _leaves_close(got, want, tol=1e-9):
    """Every leaf of two parameter-shaped dicts (the port's as tensors)."""
    got = tloader.params_to_numpy(got)
    want = jax.tree.map(np.asarray, want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, dict):
            assert sorted(got[k]) == sorted(w)
            for kk in w:
                _close(got[k][kk], w[kk], tol)
        else:
            _close(got[k], w, tol)


# ---------------------------------------------------------------------------
# positions, sample preparation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Lp,prompt_len,n", [(L, P, N), (64, 0, 8), (50, 50, 4), (100, 17, 16)])
def test_shared_position_ids_equal(Lp, prompt_len, n):
    want = np.asarray(jc.shared_position_ids(Lp, jnp.int32(prompt_len), n))
    got = tc.shared_position_ids(Lp, torch.tensor(prompt_len, dtype=torch.int32), n)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tc.shared_position_ids(Lp, prompt_len, n).numpy(), want)


@pytest.mark.parametrize("case", ["plain", "eos", "identical", "pads", "truncated"])
def test_prepare_sample_every_key_equal(case):
    rng = np.random.RandomState(11)
    kw = {}
    row = _make_row(rng, noisy_tail=0 if case == "identical" else 2)
    cfg_kw = {}
    if case == "eos":  # an EOS inside the final last block and one inside last_0
        row[P + N + 1] = 7
        row[-2] = 7
        kw = dict(eos_id=7, pad_id=0)
    if case == "pads":
        row[P + 2] = 0
        row[P + N + 3] = 0
    if case == "truncated":  # pair buckets shorter than the pairs: cut silently, as the original
        cfg_kw = dict(ar_pair_bucket=9, cons_pair_bucket=3)
    jtc, ttc = _configs(**cfg_kw)
    _, _, jb, tb = _batches(row, T, jtc, ttc, **kw)
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert jb[k].dtype == tb[k].dtype, k
        np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)


# ---------------------------------------------------------------------------
# forward_dense
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["mask", "splash", "splash_remat", "mask_remat", "causal"])
@pytest.mark.parametrize("kw", [{}, dict(qkv_bias=False, qk_norm=True)],
                         ids=["qwen2", "qwen3"])
def test_forward_dense_matches_jax(mode, kw):
    """Hidden states and the gradient of sum(h^2) w.r.t. every parameter."""
    jcfg, jp, tcfg, tp = _pair(**kw)
    jrope, trope = _ropes(jcfg)
    Lp, S, n_pairs = 40, L, T  # a row padded to its bucket
    ids = np.random.RandomState(2).randint(1, 64, (1, Lp)).astype(np.int32)
    if mode == "causal":
        pos = np.arange(Lp, dtype=np.int32)[None]
        jkw, tkw = {}, {}
    else:
        pos = np.array(jc.shared_position_ids(Lp, jnp.int32(P), N))[None]
        jmask = jc.build_train_mask(Lp, jnp.int32(P), jnp.int32(n_pairs), jnp.int32(S), N)[None]
        jkw = dict(attn_mask=jmask, remat=mode.endswith("remat"))
        if mode.startswith("splash"):
            tkw = dict(splash_spec=(P, n_pairs, S, N, "single", 4), remat=mode.endswith("remat"))
        else:
            tkw = dict(attn_mask=torch.from_numpy(np.array(jmask)), remat=mode.endswith("remat"))

    def jloss(p):
        h = jq.forward_dense(p, jcfg, jnp.asarray(ids), jnp.asarray(pos), jrope, **jkw)
        return jnp.sum(h[:, :S] ** 2), h

    (_, jh), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = {k: ({kk: vv.requires_grad_() for kk, vv in v.items()} if isinstance(v, dict)
                  else v.requires_grad_()) for k, v in tp.items()}
    th = tq.forward_dense(leaves, tcfg, torch.from_numpy(ids), torch.from_numpy(pos), trope, **tkw)
    assert th.dtype == torch.float64
    _close(th[:, :S].detach(), np.asarray(jh)[:, :S])
    assert torch.isfinite(th).all()  # rows past seq_len see nothing and stay finite
    flat = toptim.param_leaves(leaves)
    grads = torch.autograd.grad((th[:, :S] ** 2).sum(), flat, allow_unused=True)
    for p, g in zip(flat, grads):
        p.grad = torch.zeros_like(p) if g is None else g  # the LM head is not on this path
    _leaves_close({k: ({kk: vv.grad for kk, vv in v.items()} if isinstance(v, dict) else v.grad)
                   for k, v in leaves.items()}, jg)


def test_forward_dense_splash_needs_batch_one():
    _, _, tcfg, tp = _pair()
    ids = torch.zeros((2, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="one sequence"):
        tq.forward_dense(tp, tcfg, ids, ids, tq.rope_table(tcfg), splash_spec=(4, 1, 12, 4, "single", 4))


# ---------------------------------------------------------------------------
# losses, gradients, optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant,impl", [("single", "dense"), ("single", "splash"),
                                          ("multiblock", "dense"), ("window", "splash")])
def test_consistency_losses_and_gradients_match_jax(variant, impl):
    jcfg, jp, tcfg, tp = _pair()
    jrope, trope = _ropes(jcfg)
    common = dict(variant=variant, window_size=2, ar_weight=10.0 if variant == "single" else 1.0,
                  distill_temperature=1.5)
    jtc, _ = _configs(**common)
    _, ttc = _configs(attn_impl=impl, **common)
    row = _make_row(np.random.RandomState(4))
    row[P + 1] = 0  # a PAD on the student side
    jb, tb, jb_np, _ = _batches(row, T, jtc, ttc, eos_id=-1, pad_id=0)
    layout = (P, T, int(jb_np["seq_len"])) if impl == "splash" else None

    (jl, jm), jg = jax.value_and_grad(
        lambda p: jc.consistency_losses(p, jcfg, jtc, jrope, jb), has_aux=True)(jp)
    flat = toptim.param_leaves(tp)
    for p in flat:
        p.requires_grad_()
    tl, tm = tc.consistency_losses(tp, tcfg, ttc, trope, tb, layout)
    _close(tl.detach(), jl)
    for k in ("loss_ar", "loss_consistency"):
        assert float(jm[k]) > 0
        _close(tm[k].detach(), jm[k])
    for p, g in zip(flat, torch.autograd.grad(tl, flat)):
        p.grad = g
    _leaves_close({k: ({kk: vv.grad for kk, vv in v.items()} if isinstance(v, dict) else v.grad)
                   for k, v in tp.items()}, jg)


def test_splash_needs_a_static_layout():
    _, _, tcfg, tp = _pair()
    _, ttc = _configs(attn_impl="splash")
    _, tb, _, _ = _batches(_make_row(np.random.RandomState(4)), T, *_configs())
    with pytest.raises(ValueError, match="static layout"):
        tc.consistency_losses(tp, tcfg, ttc, tq.rope_table(tcfg), tb)


@pytest.mark.parametrize("n_total,warmup,lr", [(6, 10, 3e-3), (40, 3, 1e-5), (100, 10, 1e-4)])
def test_schedule_equals_optax(n_total, warmup, lr):
    kw = dict(init_value=0.0, peak_value=lr, warmup_steps=min(warmup, max(n_total // 10, 1)),
              decay_steps=max(n_total, 1), end_value=lr * 0.05)
    want, got = optax.warmup_cosine_decay_schedule(**kw), toptim.warmup_cosine_schedule(**kw)
    for count in range(n_total + 3):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-12, abs=0.0), count
        # handed its own int32 count, optax evaluates the schedule in float32
        # whatever the parameters' dtype: the same value to float32 rounding
        assert got(count) == pytest.approx(float(want(jnp.int32(count))), rel=1e-6, abs=0.0)
    assert got(0) == 0.0


def test_schedule_rejects_what_optax_rejects():
    """One total step leaves the cosine no step, in both packages."""
    kw = dict(init_value=0.0, peak_value=1e-3, warmup_steps=1, decay_steps=1, end_value=0.0)
    with pytest.raises(ValueError):
        optax.warmup_cosine_decay_schedule(**kw)
    with pytest.raises(ValueError):
        toptim.warmup_cosine_schedule(**kw)


def test_three_train_steps_match_optax():
    """Three updates of the trainer's AdamW (b1 0.9, b2 0.95, optax's eps and
    its weight decay of 1e-4 on every leaf) under its schedule: the first
    runs at learning rate 0 and moves nothing but the moments."""
    jcfg, jp, tcfg, tp = _pair()
    jrope, trope = _ropes(jcfg)
    jtc, ttc = _configs()
    sched = dict(init_value=0.0, peak_value=3e-3, warmup_steps=1, decay_steps=6, end_value=1.5e-4)
    # optax would evaluate the schedule in float32 from its int32 count; hand it
    # the count in float64, so that fp64 compares the optimizers' arithmetic and
    # not a learning rate rounded to float32
    jsched = optax.warmup_cosine_decay_schedule(**sched)
    jopt = optax.adamw(lambda count: jsched(jnp.asarray(count, jnp.float64)), b1=0.9, b2=0.95)
    topt = toptim.AdamW(toptim.warmup_cosine_schedule(**sched), b1=0.9, b2=0.95)
    jstep, tstep = jc.make_train_step(jcfg, jtc, jopt), tc.make_train_step(tcfg, ttc, topt)
    jstate, tstate = jopt.init(jp), topt.init(tp)
    before = jax.tree.map(np.copy, tloader.params_to_numpy(tp))  # numpy views follow in-place updates
    rng = np.random.RandomState(6)
    for i in range(3):
        jb, tb, _, _ = _batches(_make_row(rng), T, jtc, ttc)
        jp, jstate, jm = jstep(jp, jstate, jrope, jb)
        tp2, tstate, tm = tstep(tp, tstate, trope, tb)
        assert tp2 is tp and tstate.count == i + 1  # in place
        for k in ("loss", "loss_ar", "loss_consistency"):
            _close(tm[k], jm[k])
        _leaves_close(tp, jp)
        if i == 0:
            _leaves_close(tp, before, tol=0.0)
    moved = np.abs(tloader.params_to_numpy(tp)["layers"]["ln1"] - before["layers"]["ln1"]).max()
    assert moved > 1e-4  # norms decay and learn like every other leaf
    # the moments have the parameters' dtype
    assert all(s["exp_avg"].dtype == torch.float64 for s in tstate.opt.state.values())


def test_make_train_step_with_a_mesh_raises():
    _, _, tcfg, _ = _pair()
    with pytest.raises(NotImplementedError, match="mesh"):
        tc.make_train_step(tcfg, tc.TrainConfig(), toptim.AdamW(1e-3), mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        tsft.make_sft_train_step(tcfg, mesh=object())
    with pytest.raises(NotImplementedError, match="mesh"):
        ttrainer.train(ttrainer.TrainerArgs(), model_cfg=tcfg, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="mesh"):
        ttrainer.train(ttrainer.TrainerArgs(global_batch=4), model_cfg=tcfg, device="cpu")


# ---------------------------------------------------------------------------
# counterparts of tests/test_trainer.py (f32, like the originals)
# ---------------------------------------------------------------------------


def _f32_model(seed=0):
    cfg = tq.ModelConfig.tiny(dtype=torch.float32)
    return cfg, tq.init_params(cfg, seed, device="cpu"), tq.rope_table(cfg)


def _tc64(**kw):
    d = dict(N=N, max_pairs=T, seq_bucket=64, ar_pair_bucket=64, cons_pair_bucket=64)
    d.update(kw)
    return tc.TrainConfig(**d)


def _batch(row, cfg_tc):
    return {k: torch.as_tensor(v) for k, v in tc.prepare_sample(row, P, T, cfg_tc).items()}


@pytest.mark.parametrize("impl", ["dense", "splash"])
def test_loss_runs_and_decreases(impl):
    cfg, params, rope = _f32_model()
    ttc = _tc64(attn_impl=impl)
    batch = _batch(_make_row(np.random.RandomState(0), vocab=256), ttc)
    opt = toptim.AdamW(1e-3)
    step = tc.make_train_step(cfg, ttc, opt)
    state = opt.init(params)
    layout = (P, T, L) if impl == "splash" else None
    losses = []
    for _ in range(8):
        params, state, metrics = step(params, state, rope, batch, layout)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses


def test_consistency_zero_when_identical():
    cfg, params, rope = _f32_model()
    ttc = _tc64()
    batch = _batch(_make_row(np.random.RandomState(1), vocab=256, noisy_tail=0), ttc)
    _, metrics = tc.consistency_losses(params, cfg, ttc, rope, batch)
    assert float(metrics["loss_consistency"]) == 0.0
    assert float(metrics["loss_ar"]) > 0.0


def test_teacher_detached():
    """The consistency gradient flows through the student (k_j) branch only:
    with the student's hidden rows cut off, nothing is left."""
    cfg, params, rope = _f32_model()
    ttc = _tc64(ar_weight=0.0)
    batch = _batch(_make_row(np.random.RandomState(2), vocab=256), ttc)
    flat = toptim.param_leaves(params)
    for p in flat:
        p.requires_grad_()
    loss, _ = tc.consistency_losses(params, cfg, ttc, rope, batch)
    norm = sum(float(g.abs().sum()) for g in torch.autograd.grad(loss, flat))
    assert norm > 0
    # the same loss with the student rows pointing at the teacher's rows and
    # marked invalid has no path to the parameters but through the teacher
    cut = dict(batch, cons_s=batch["cons_t"], cons_valid=torch.zeros_like(batch["cons_valid"]))
    loss, _ = tc.consistency_losses(params, cfg, ttc, rope, cut)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    assert all(g is None or not bool(g.any()) for g in grads)


class _Rows:
    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def test_trainer_loop_and_resume(tmp_path):
    cfg = tq.ModelConfig.tiny(dtype=torch.float32)
    rng = np.random.RandomState(3)
    ds = _Rows([{"input_ids": _make_row(rng, vocab=256), "prompt_len": P, "T": T}
                for _ in range(4)])
    common = dict(output_dir=str(tmp_path / "out"), max_new_tokens=N, seq_bucket=64, log_steps=2,
                  learning_rate=1e-4)
    res = ttrainer.train(ttrainer.TrainerArgs(max_steps=4, save_steps=2, **common), model_cfg=cfg,
                         dataset=ds, device="cpu", log_fn=lambda *_: None)
    assert res["step"] == 4
    assert ttrainer.latest_checkpoint(str(tmp_path / "out")).endswith("checkpoint-4")
    # resume: max_steps=6 continues from step 4, with the saved moments and count
    logs = []
    res2 = ttrainer.train(ttrainer.TrainerArgs(max_steps=6, save_steps=10, **common),
                          model_cfg=cfg, dataset=ds, device="cpu", log_fn=logs.append)
    assert res2["step"] == 6
    assert any("resumed from" in m and "step 4" in m for m in logs)
    _, state, step = ttrainer.load_train_checkpoint(
        str(tmp_path / "out" / "checkpoint-6"), cfg, toptim.AdamW(1e-4, b1=0.9, b2=0.95), "cpu")
    assert (step, state.count) == (6, 6)
    assert all(float(s["step"]) == 6 for s in state.opt.state.values())


def test_trainer_variants_e2e(tmp_path):
    """multiblock and window variants run through the full train() loop
    (ar_weight switching, mask wiring) and decrease loss, through the
    block-sparse attention path as well as the dense mask."""
    cfg = tq.ModelConfig.tiny(dtype=torch.float32)
    rng = np.random.RandomState(5)
    ds = _Rows([{"input_ids": _make_row(rng, vocab=256), "prompt_len": P, "T": T}
                for _ in range(3)])
    for variant, impl in (("multiblock", "dense"), ("window", "splash")):
        args = ttrainer.TrainerArgs(
            output_dir=str(tmp_path / variant), max_new_tokens=N, seq_bucket=64, variant=variant,
            window_size=2, attn_impl=impl, remat=impl == "splash", max_steps=6, save_steps=100,
            log_steps=1, learning_rate=3e-4, resume=False)
        res = ttrainer.train(args, model_cfg=cfg, dataset=ds, device="cpu", log_fn=lambda *_: None)
        losses = [h["loss"] for h in res["history"]]
        assert np.isfinite(losses).all()
        assert losses[-1] < losses[0], (variant, losses)


def test_train_defaults_to_the_card():
    cfg = tq.ModelConfig.tiny(dtype=torch.float32)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrainer.train(ttrainer.TrainerArgs(output_dir=""), model_cfg=cfg, dataset=_Rows([]))


# ---------------------------------------------------------------------------
# checkpoints cross the packages; SFT
# ---------------------------------------------------------------------------


def _logits(j_or_t, cfg, params, ids):
    if j_or_t == "jax":
        pos = jnp.arange(ids.shape[1], dtype=jnp.int32)[None]
        h = jq.forward_dense(params, cfg, jnp.asarray(ids), pos, jq.rope_table(cfg))
        return np.asarray(jq.logits_at(params, cfg, h))
    pos = torch.arange(ids.shape[1], dtype=torch.int32)[None]
    h = tq.forward_dense(params, cfg, torch.from_numpy(ids), pos, tq.rope_table(cfg))
    return tq.logits_at(params, cfg, h).numpy()


@pytest.mark.parametrize("kw", [{}, dict(qkv_bias=False, qk_norm=True, tie_word_embeddings=True)],
                         ids=["qwen2", "qwen3-tied"])
def test_checkpoints_cross_the_packages(tmp_path, kw):
    """A checkpoint saved by the port loads in the JAX loader with equal
    logits, and the reverse; the files hold float32."""
    jcfg, jp, tcfg, tp = _pair(dtype=jnp.float32, **kw)
    ids = np.random.RandomState(8).randint(0, 64, (1, 12)).astype(np.int32)
    want = _logits("jax", jcfg, jp, ids)

    tloader.save_checkpoint(str(tmp_path / "port"), tcfg, tp)
    jcfg2, jp2 = jloader.load_checkpoint(str(tmp_path / "port"), dtype=jnp.float32)
    assert jcfg2 == jcfg
    for a, b in zip(jax.tree.leaves(jp2), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(_logits("jax", jcfg2, jp2, ids), want)

    jloader.save_checkpoint(str(tmp_path / "jax"), jcfg, jp)
    tcfg2, tp2 = tloader.load_checkpoint(str(tmp_path / "jax"), dtype=torch.float32, device="cpu")
    assert tcfg2 == tcfg
    got = _logits("torch", tcfg2, tp2, ids)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)  # f32, two frameworks' sums
    # and the port reads its own file back bit for bit
    _, tp3 = tloader.load_checkpoint(str(tmp_path / "port"), dtype=torch.float32, device="cpu")
    for a, b in zip(toptim.param_leaves(tp3), toptim.param_leaves(tp)):
        assert torch.equal(a, b)
    assert all(t.dtype == torch.float32 for t in tloader.read_safetensors(
        str(tmp_path / "port" / "model.safetensors")).values())


def test_sft_loss_and_step_match_jax():
    jcfg, jp, tcfg, tp = _pair()
    jrope, trope = _ropes(jcfg)
    r = np.random.RandomState(9)
    ids = r.randint(1, 64, (2, 12)).astype(np.int32)
    mask = (r.rand(2, 12) < 0.7).astype(np.float64)
    jl, jg = jax.value_and_grad(jsft.sft_loss)(jp, jcfg, jrope, jnp.asarray(ids), jnp.asarray(mask))
    _close(tsft.sft_loss(tp, tcfg, trope, torch.from_numpy(ids), torch.from_numpy(mask)), jl)

    jopt, topt = jsft.make_optimizer(1e-3, 0.01), tsft.make_optimizer(1e-3, 0.01)
    upd, _ = jopt.update(jg, jopt.init(jp), jp)
    want = optax.apply_updates(jp, upd)
    init_fn, step_fn = tsft.make_sft_train_step(tcfg, optimizer=topt)
    tp, state = init_fn(tp)
    tp, state, loss = step_fn(tp, state, trope, torch.from_numpy(ids), torch.from_numpy(mask))
    _close(loss, jl)
    _leaves_close(tp, want)
