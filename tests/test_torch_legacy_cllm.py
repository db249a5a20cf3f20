"""The port's legacy CLLM-v1 trainer against the JAX package's.

  * `prepare_legacy_sample` gives the same arrays for the same rows and
    `RandomState`;
  * `legacy_losses` and its gradients equal JAX's leaf for leaf within 1e-9
    (tiny model in fp64, the same weights);
  * three `make_legacy_train_step` steps with `AdamW(1e-4)` equal the JAX
    step under `optax.adamw(1e-4)` (weight decay 1e-4, optax's default) within
    1e-9: losses and weights;
  * the counterpart of tests/test_modeling_and_legacy.py::
    test_legacy_cllm_trainer: trajectories collected by the port's engine,
    three f32 epochs, the loss falls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jacobiforcing_tpu.models import qwen as jq
from jacobiforcing_tpu.train import legacy_cllm as jlegacy
from jacobiforcing_tpu_torch.config import Config
from jacobiforcing_tpu_torch.data.collect import collect_trajectories
from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine
from jacobiforcing_tpu_torch.models import qwen as tq
from jacobiforcing_tpu_torch.train import legacy_cllm as tlegacy
from jacobiforcing_tpu_torch.train.optim import AdamW
from jacobiforcing_tpu_torch.utils.loader import params_from_numpy, params_to_numpy
from tests import test_engine as jtests

TOL = dict(rtol=1e-9, atol=1e-9)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rows():
    """Rows in both stage-1 formats: block-local states (the prompt prefix is
    added) and full-prefix states (masking format), one trajectory of a
    single state, and a teacher output longer than the bucket."""
    r = np.random.RandomState(3)
    rows = []
    for n_states, n, full_prefix, teacher_len in ((4, 8, False, 30), (3, 8, True, 24),
                                                   (1, 8, False, 20), (5, 8, False, 90)):
        prompt = r.randint(3, 250, size=int(r.randint(3, 9))).tolist()
        pre = prompt if full_prefix else []
        traj = [pre + r.randint(3, 250, size=n).tolist() for _ in range(n_states)]
        rows.append({"prompt_ids": prompt, "answer_trajectory_ids": traj,
                     "teacher_output_ids": prompt + r.randint(3, 250, size=teacher_len).tolist()})
    return rows


def test_prepare_legacy_sample_equals_jax():
    rows = _rows()
    rj, rt = np.random.RandomState(0), np.random.RandomState(0)
    for _ in range(3):
        for row in rows:
            want = jlegacy.prepare_legacy_sample(row, rj, seq_bucket=64)
            got = tlegacy.prepare_legacy_sample(row, rt, seq_bucket=64)
            assert sorted(got) == sorted(want)
            for k in want:
                assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _pair():
    jcfg = jq.ModelConfig.tiny()
    jparams = jq.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = tq.ModelConfig.tiny()
    return jcfg, jparams, cfg, params_from_numpy(jax.tree.map(np.asarray, jparams))


def _ropes(jcfg):
    """The JAX RoPE table and the same table for the port: XLA's and
    PyTorch's f32 cos / sin differ in the last bit, so both forwards share one."""
    jrope = jq.rope_table(jcfg)
    return jrope, tuple(torch.from_numpy(np.array(a)) for a in jrope)


def _batches(n=3):
    rng = np.random.RandomState(1)
    return [jlegacy.prepare_legacy_sample(row, rng, seq_bucket=48) for row in _rows()[:n]]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_losses_and_gradients_equal_jax():
    jcfg, jparams, cfg, params = _pair()
    batch = _batches(1)[0]
    jrope, rope = _ropes(jcfg)
    (jtotal, jm), jgrads = jax.value_and_grad(
        lambda p: jlegacy.legacy_losses(p, jcfg, jrope, {k: jnp.asarray(v) for k, v in
                                                         batch.items()}), has_aux=True)(jparams)
    leaves = [t for v in params.values() for t in (v.values() if isinstance(v, dict) else [v])]
    for t in leaves:
        t.requires_grad_()
    total, m = tlegacy.legacy_losses(params, cfg, rope,
                                     {k: torch.as_tensor(v) for k, v in batch.items()})
    total.backward()
    for k in ("loss_ar", "loss_consistency", "loss"):
        np.testing.assert_allclose(float(m[k].detach()), float(jm[k]), **TOL)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), **TOL)
    want = _flat(jgrads)
    grads = {k: ({kk: t.grad for kk, t in v.items()} if isinstance(v, dict) else v.grad)
             for k, v in params.items()}
    got = _flat(params_to_numpy(grads))
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k] / scale, want[k] / scale, **TOL, err_msg=k)


def test_three_adamw_steps_equal_optax():
    jcfg, jparams, cfg, params = _pair()
    batches = _batches(3)
    jopt = optax.adamw(1e-4)
    jstep = jlegacy.make_legacy_train_step(jcfg, jopt)
    jstate = jopt.init(jparams)
    jrope, rope = _ropes(jcfg)
    opt = AdamW(1e-4)
    step = tlegacy.make_legacy_train_step(cfg, opt)
    state = opt.init(params)
    for b in batches:
        jparams, jstate, jm = jstep(jparams, jstate, jrope, {k: jnp.asarray(v) for k, v in
                                                              b.items()})
        params, state, m = step(params, state, rope, b)
        for k in ("loss_ar", "loss_consistency", "loss"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **TOL)
    want, got = _flat(jparams), _flat(params_to_numpy(params))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL, err_msg=k)
    assert state.count == 3


def test_legacy_cllm_trainer():
    """tests/test_modeling_and_legacy.py::test_legacy_cllm_trainer on the port:
    rows collected by the port's engine, f32 training, the loss falls."""
    eng = LLMEngine(Config(kvcache_page_size=16, max_model_len=256, jacobi_chunk_tokens=32,
                           prefill_token_buckets=(32, 64, 128, 256), eos=-1),
                    model_cfg=tq.ModelConfig.tiny(), params=_pair()[3], num_kv_pages=256,
                    device="cpu")
    rows = collect_trajectories(eng, jtests.make_prompts(256)[:2], block_len=8, max_tokens=16,
                                temperature=0.0)
    cfg = tq.ModelConfig.tiny(dtype=torch.float32)
    params = tq.init_params(cfg, 0, "cpu")
    rope = tq.rope_table(cfg)
    opt = AdamW(1e-4)
    step = tlegacy.make_legacy_train_step(cfg, opt)
    state = opt.init(params)
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(3):
        for row in rows:
            params, state, m = step(params, state, rope,
                                    tlegacy.prepare_legacy_sample(row, rng, seq_bucket=64))
            losses.append(float(m["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
