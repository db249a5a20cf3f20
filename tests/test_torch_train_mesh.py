"""Data-parallel and fsdp training over a mesh in the port against the JAX
package's mesh trainer.

The port runs in one 4-process gloo world, spawned once for this module:
every rank runs this file as a script (`child_main`), which imports only the
port, runs its parts in one go on sub-meshes (`make_mesh(ranks=...)`) and
writes what it computed for the parent to compare.  The JAX side runs in the
test process on the 8-device virtual CPU mesh of tests/conftest.py, while the
ranks work.  The tiny model's weights are the JAX tests' own, carried over as
numpy arrays, and so is the RoPE table; fp64 unless stated.  Rows differ in
prompt length and pairs, and the ranks of a data group get different ones.

  * `make_train_step` at (dp, tp) = (2, 2) (global batch 4) and (2, 1)
    (global batch 2), fsdp: every rank's blocks of the parameters and of both
    AdamW moments after 3 steps, and the metrics of each step, == the JAX
    `dp_step` on the same mesh shape and == the port's one process with a
    (1, 1) mesh on the same global batch, within 1e-9 of each array's
    largest value (fp64: only the summation order differs);
  * (1, 2) splash on a Qwen3-style tied model (per-head q/k norms, the head
    tied to the vocab-parallel embedding): == the single-device splash step,
    which tests/test_torch_trainer.py holds to JAX;
  * `train()` at dp 2 with global batch 4: step count and history == JAX
    `train(mesh=)`; its checkpoint, written by rank 0 from the gathered
    weights, loads in both packages; in f32, a run stopped at step 2 and
    resumed on the mesh == the uninterrupted run bit for bit, and resumed in
    one process (1, 1) within f32 rounding;
  * SFT at (2, 2) on rows with unequal masks, B = 4 (split over "data") and
    B = 3 (replicated): loss, parameters and moments after one step == JAX
    `make_sft_train_step`;
  * the refusals: a global batch that does not divide by dp, splash with a
    global batch above 1, a rank outside the mesh, a mesh that leaves ranks
    of the world out, and `global_batch > 1` without a mesh.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9  # fp64, relative to the largest value of each array
N, VOCAB = 4, 64
# (prompt_len, pairs) of the rows: the samples of one batch differ in layout
SHAPES = [(6, 3), (5, 2), (7, 3), (4, 3), (6, 2), (5, 3)]
STEPS = 3
QWEN3 = dict(qkv_bias=False, qk_norm=True, tie_word_embeddings=True)
TC = dict(N=N, max_pairs=3, seq_bucket=40, ar_pair_bucket=48, cons_pair_bucket=48)
LR = 1e-3
TRAIN_ARGS = dict(max_new_tokens=N, seq_bucket=40, log_steps=1, learning_rate=3e-4,
                  global_batch=4, resume=False)


def _make_row(rng, P, T, noisy_tail=2):
    """A packed row: k_j = last_j with its last `noisy_tail` tokens redrawn."""
    seq = rng.randint(1, VOCAB, P).tolist()
    for _ in range(T):
        last = rng.randint(1, VOCAB, N).tolist()
        k = list(last)
        for t in range(N - noisy_tail, N):
            k[t] = int(rng.randint(1, VOCAB))
        seq += k + last
    return {"input_ids": seq, "prompt_len": P, "T": T}


def _rows(n, seed):
    rng = np.random.RandomState(seed)
    return [_make_row(rng, *SHAPES[i % len(SHAPES)]) for i in range(n)]


def _sft_inputs():
    """ids [4, 12], and masks whose rows keep 3 / 7 / 10 / 5 tokens."""
    r = np.random.RandomState(9)
    ids = r.randint(1, VOCAB, (4, 12)).astype(np.int32)
    mask = np.zeros((4, 12))
    for i, keep in enumerate((3, 7, 10, 5)):
        mask[i, r.choice(12, keep, replace=False)] = 1.0
    return ids, mask


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (v.detach().numpy() if isinstance(v, torch.Tensor)
                               else np.asarray(v))
    return out


def _unflat(flat):
    tree = {}
    for k, v in flat.items():
        *path, leaf = k.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# ---------------------------------------------------------------------------
# The port's side (the ranks and the test process)
# ---------------------------------------------------------------------------


def _moments(params, state):
    """{"mu": tree, "nu": tree} of an AdamW state, laid out as `params`."""
    out = {"mu": {}, "nu": {}}
    for name in sorted(params):
        v = params[name]
        for key, t in ([(f"{name}/{k}", v[k]) for k in sorted(v)] if isinstance(v, dict)
                       else [(name, v)]):
            s = state.opt.state[t]
            out["mu"][key], out["nu"][key] = s["exp_avg"], s["exp_avg_sq"]
    return out


def _samples(rows, ttc):
    from jacobiforcing_tpu_torch.train.consistency import prepare_sample

    return [prepare_sample(r["input_ids"], r["prompt_len"], r["T"], ttc) for r in rows]


def port_steps(cfg, full, rope, rows, gb, mesh, impl="dense", remat=False):
    """STEPS steps of `make_train_step` on global batches of `gb` rows (one
    sample, no batch dim, for mesh=None): (params, moments, metrics)."""
    from jacobiforcing_tpu_torch.parallel.sharding import shard_params
    from jacobiforcing_tpu_torch.train.consistency import TrainConfig, make_train_step
    from jacobiforcing_tpu_torch.train.optim import AdamW

    ttc = TrainConfig(attn_impl=impl, remat=remat, **TC)
    opt = AdamW(LR, b1=0.9, b2=0.95)
    params = full if mesh is None else shard_params(full, cfg, mesh, fsdp=True)
    state = opt.init(params)
    step = make_train_step(cfg, ttc, opt, mesh)
    metrics = []
    for i in range(STEPS):
        samples = _samples(rows[i * gb:(i + 1) * gb], ttc)
        if mesh is None:
            batch = {k: torch.as_tensor(v) for k, v in samples[0].items()}
        else:
            batch = {k: torch.as_tensor(np.stack([s[k] for s in samples])) for k in samples[0]}
        s0 = samples[0]
        layout = (int(s0["prompt_len"]), int(s0["T"]), int(s0["seq_len"]))
        params, state, m = step(params, state, rope, batch, layout if impl == "splash" else None)
        metrics.append([float(m[k]) for k in ("loss", "loss_ar", "loss_consistency")])
    return params, _moments(params, state), np.asarray(metrics)


class _Rows:
    def __init__(self, rows):
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


def _raises(fn, match):
    try:
        fn()
    except ValueError as e:
        return match in str(e)
    return False


def _port_train(cfg, full, mesh, out_dir, **kw):
    from jacobiforcing_tpu_torch.train.trainer import TrainerArgs, train

    args = TrainerArgs(output_dir=out_dir, **{**TRAIN_ARGS, **kw})
    return train(args, model_cfg=cfg, params=full, dataset=_Rows(_rows(8, 21)), mesh=mesh,
                 device="cpu", log_fn=lambda *_: None)


def child_main(rank, world, port, workdir):
    sys.path.insert(0, ROOT)
    torch.set_num_threads(2)
    import torch.distributed as dist

    from jacobiforcing_tpu_torch.models.qwen import ModelConfig
    from jacobiforcing_tpu_torch.parallel.mesh import make_mesh
    from jacobiforcing_tpu_torch.parallel.multihost import initialize_multihost
    from jacobiforcing_tpu_torch.parallel.sharding import param_specs, unshard_array
    from jacobiforcing_tpu_torch.train.consistency import TrainConfig, make_train_step
    from jacobiforcing_tpu_torch.train.optim import AdamW
    from jacobiforcing_tpu_torch.train.sft import make_sft_train_step
    from jacobiforcing_tpu_torch.train.trainer import TrainerArgs, train
    from jacobiforcing_tpu_torch.utils.loader import params_from_numpy

    initialize_multihost(f"localhost:{port}", world, rank, backend="gloo")
    out, arrays = {"rank": rank}, {}

    def load(name, **kw):
        return params_from_numpy(_unflat(dict(np.load(os.path.join(workdir, name)))), **kw)

    def keep(tag, tree):
        arrays.update({f"{tag}/{k}": v for k, v in _flat(tree).items()})

    cfg, cfg3 = ModelConfig.tiny(vocab_size=VOCAB), ModelConfig.tiny(vocab_size=VOCAB, **QWEN3)
    rope = tuple(torch.tensor(a) for a in np.load(os.path.join(workdir, "rope.npz")).values())
    rows = _rows(12, 11)

    # (2, 2) fsdp over the world, global batch 4
    mesh22 = make_mesh(tensor_parallel_size=2, data_parallel_size=2)
    out["coords22"] = list(mesh22.coords)
    p, mom, met = port_steps(cfg, load("params.npz"), rope, rows, 4, mesh22)
    keep("fsdp22/params", p)
    keep("fsdp22/moments", mom)
    arrays["fsdp22/metrics"] = met

    # sub-meshes: (2, 1) over ranks 0 and 1, (1, 2) and (2, 1) over 2 and 3
    mesh21 = make_mesh(tensor_parallel_size=1, data_parallel_size=2, ranks=[0, 1])
    mesh12 = make_mesh(tensor_parallel_size=2, ranks=[2, 3])
    mesh21b = make_mesh(tensor_parallel_size=1, data_parallel_size=2, ranks=[2, 3])
    if rank < 2:
        out["coords21"] = list(mesh21.coords)
        p, mom, met = port_steps(cfg, load("params.npz"), rope, rows, 2, mesh21)
        keep("fsdp21/params", p)
        keep("fsdp21/moments", mom)
        arrays["fsdp21/metrics"] = met

        # train() at dp 2, global batch 4: history and the checkpoint (fp64)
        res = _port_train(cfg, load("params.npz"), mesh21, os.path.join(workdir, "run64"),
                          max_steps=4, save_steps=100)
        out["history"] = [{k: v for k, v in h.items() if k != "steps_per_s"}
                          for h in res["history"]]
        out["step"] = res["step"]
        specs = param_specs(cfg, fsdp=True)
        final = {k: ({n: unshard_array(t, specs[k][n], mesh21) for n, t in v.items()}
                     if isinstance(v, dict) else unshard_array(v, specs[k], mesh21))
                 for k, v in res["params"].items()}
        keep("train64/final", final)
        # in f32: the uninterrupted run, and one stopped at step 2 and resumed
        cfg32 = ModelConfig.tiny(vocab_size=VOCAB, dtype=torch.float32)
        for tag, cuts in (("whole", (4,)), ("resumed", (2, 4))):
            for max_steps in cuts:
                res = _port_train(cfg32, load("params.npz", dtype=torch.float32), mesh21,
                                  os.path.join(workdir, f"run32-{tag}"), max_steps=max_steps,
                                  save_steps=2, resume=True)
            keep(f"train32/{tag}", {k: ({n: unshard_array(t, specs[k][n], mesh21)
                                         for n, t in v.items()} if isinstance(v, dict)
                                        else unshard_array(v, specs[k], mesh21))
                                    for k, v in res["params"].items()})
            out[f"train32_{tag}_step"] = res["step"]
    else:
        out["coords12"] = list(mesh12.coords)
        p, mom, met = port_steps(cfg3, load("params3.npz"), rope, rows, 1, mesh12, "splash",
                                 remat=True)
        keep("splash12/params", p)
        keep("splash12/moments", mom)
        arrays["splash12/metrics"] = met
        full = load("params.npz")
        out["refuse_indivisible"] = _raises(lambda: train(
            TrainerArgs(global_batch=3), model_cfg=cfg, params=full, mesh=mesh21b, device="cpu"),
            "does not divide by dp=2")
        out["refuse_splash_batch"] = _raises(lambda: train(
            TrainerArgs(global_batch=2, attn_impl="splash"), model_cfg=cfg, params=full,
            mesh=mesh21b, device="cpu"), "attn_impl='dense'")
        outside = "outside the mesh"
        out["refuse_outside"] = [
            _raises(lambda: make_train_step(cfg, TrainConfig(**TC), AdamW(LR), mesh21), outside),
            _raises(lambda: make_sft_train_step(cfg, mesh21), outside),
            _raises(lambda: train(TrainerArgs(), model_cfg=cfg, params=full, mesh=mesh21,
                                  device="cpu"), outside)]

    # SFT at (2, 2): B = 4 splits over "data", B = 3 stays whole on every rank
    ids, mask = _sft_inputs()
    for B in (4, 3):
        init_fn, step_fn = make_sft_train_step(cfg, mesh22)
        params, state = init_fn(load("params.npz"))
        params, state, loss = step_fn(params, state, rope, torch.from_numpy(ids[:B]),
                                      torch.from_numpy(mask[:B]))
        keep(f"sft{B}/params", params)
        keep(f"sft{B}/moments", _moments(params, state))
        arrays[f"sft{B}/loss"] = loss.numpy()

    # a (2, 1) mesh over a world of 4 leaves two ranks out
    out["refuse_world"] = _raises(
        lambda: make_mesh(tensor_parallel_size=1, data_parallel_size=2), "needs 2 ranks")
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The parent's side: JAX on the virtual mesh, the port in one process
# ---------------------------------------------------------------------------


def _jax_mesh(dp, tp):
    from jacobiforcing_tpu.parallel.mesh import make_mesh

    return make_mesh(tensor_parallel_size=tp, data_parallel_size=dp)


def _jax_moments(state):
    mu, nu = state[0].mu, state[0].nu
    return {"mu": _flat(_to_np(mu)), "nu": _flat(_to_np(nu))}


def _to_np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def jax_dp_steps(jparams, dp, tp, gb):
    """The JAX mesh step (`make_train_step(mesh=)`), STEPS global batches."""
    import jax.numpy as jnp
    import optax

    from jacobiforcing_tpu.models import qwen as jq
    from jacobiforcing_tpu.parallel.sharding import shard_params
    from jacobiforcing_tpu.train import consistency as jc

    cfg = jq.ModelConfig.tiny(vocab_size=VOCAB)
    jtc = jc.TrainConfig(**TC)
    opt = optax.adamw(LR, b1=0.9, b2=0.95)
    mesh = _jax_mesh(dp, tp)
    params = shard_params(jparams, cfg, mesh, fsdp=True)
    state = opt.init(params)
    step = jc.make_train_step(cfg, jtc, opt, mesh)
    rope = jq.rope_table(cfg)
    rows = _rows(12, 11)
    metrics = []
    for i in range(STEPS):
        samples = [jc.prepare_sample(r["input_ids"], r["prompt_len"], r["T"], jtc)
                   for r in rows[i * gb:(i + 1) * gb]]
        batch = {k: jnp.asarray(np.stack([s[k] for s in samples])) for k in samples[0]}
        params, state, m = step(params, state, rope, batch)
        metrics.append([float(m[k]) for k in ("loss", "loss_ar", "loss_consistency")])
    return _flat(_to_np(params)), _jax_moments(state), np.asarray(metrics)


def jax_train(jparams, out_dir):
    """JAX `train(mesh=)` at dp 2 (tests/test_trainer.py:259), global batch 4."""
    from jacobiforcing_tpu.models import qwen as jq
    from jacobiforcing_tpu.train.trainer import TrainerArgs, train

    args = TrainerArgs(output_dir=out_dir, max_steps=4, save_steps=100, **TRAIN_ARGS)
    res = train(args, model_cfg=jq.ModelConfig.tiny(vocab_size=VOCAB), params=jparams,
                dataset=_Rows(_rows(8, 21)), mesh=_jax_mesh(2, 1), log_fn=lambda *_: None)
    return res


def jax_sft(jparams, B):
    import jax.numpy as jnp

    from jacobiforcing_tpu.models import qwen as jq
    from jacobiforcing_tpu.train.sft import make_sft_train_step

    cfg = jq.ModelConfig.tiny(vocab_size=VOCAB)
    mesh = _jax_mesh(2, 2)
    init_fn, step = make_sft_train_step(cfg, mesh)
    params, state = init_fn(jparams)
    ids, mask = _sft_inputs()
    with mesh:
        params, state, loss = step(params, state, jq.rope_table(cfg), jnp.asarray(ids[:B]),
                                   jnp.asarray(mask[:B]))
    return _flat(_to_np(params)), _jax_moments(state), float(loss)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Start the 4-rank world, compute the JAX and one-process references
    while it runs, then collect the ranks' results."""
    import jax

    from jacobiforcing_tpu.models import qwen as jq
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig
    from jacobiforcing_tpu_torch.parallel.mesh import make_mesh
    from jacobiforcing_tpu_torch.utils.loader import params_from_numpy

    d = tmp_path_factory.mktemp("train_mesh")
    # numpy trees: each JAX step donates (deletes) the arrays it is handed
    jparams = _to_np(jq.init_params(jq.ModelConfig.tiny(vocab_size=VOCAB),
                                    jax.random.PRNGKey(0)))
    jparams3 = _to_np(jq.init_params(jq.ModelConfig.tiny(vocab_size=VOCAB, **QWEN3),
                                     jax.random.PRNGKey(1)))
    np.savez(d / "params.npz", **_flat(jparams))
    np.savez(d / "params3.npz", **_flat(jparams3))
    cos, sin = jq.rope_table(jq.ModelConfig.tiny(vocab_size=VOCAB))
    np.savez(d / "rope.npz", cos=np.asarray(cos), sin=np.asarray(sin))

    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), "4",
                               str(port), str(d)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(4)]
    try:
        rope = (torch.tensor(np.asarray(cos)), torch.tensor(np.asarray(sin)))
        cfg = ModelConfig.tiny(vocab_size=VOCAB)
        cfg3 = ModelConfig.tiny(vocab_size=VOCAB, **QWEN3)
        rows = _rows(12, 11)
        ref = {"jax22": jax_dp_steps(jparams, 2, 2, 4), "jax21": jax_dp_steps(jparams, 2, 1, 2)}
        for tag, gb in (("one22", 4), ("one21", 2)):
            p, mom, met = port_steps(cfg, params_from_numpy(jparams), rope, rows, gb,
                                     make_mesh(1, 1))
            ref[tag] = (_flat(p), {k: _flat(v) for k, v in mom.items()}, met)
        p, mom, met = port_steps(cfg3, params_from_numpy(jparams3), rope, rows, 1, None,
                                 "splash", remat=True)
        ref["single_splash"] = (_flat(p), {k: _flat(v) for k, v in mom.items()}, met)
        ref["jax_train"] = jax_train(jparams, str(d / "jax_run"))
        ref["sft"] = {B: jax_sft(jparams, B) for B in (4, 3)}
        logs = [p_.communicate(timeout=300)[0] for p_ in procs]
    finally:
        for p_ in procs:
            p_.kill()
    for p_, log in zip(procs, logs):
        assert p_.returncode == 0, f"a rank failed:\n{log[-4000:]}"
    ranks = []
    for r in range(4):
        with open(d / f"rank{r}.json") as f:
            res = json.load(f)
        res.update(dict(np.load(d / f"rank{r}.npz")))
        ranks.append(res)
    return ranks, ref, d


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * max(np.abs(want).max(), 1e-30), (what, err)


def _check_blocks(res, tag, params, moments, cfg, shape, coords, fsdp=True):
    """The rank's blocks under `tag` == the blocks at `coords` of a (dp, tp)
    = `shape` mesh of whole parameter and moment trees (flat numpy dicts)."""
    from jacobiforcing_tpu_torch.parallel.mesh import Mesh
    from jacobiforcing_tpu_torch.parallel.sharding import param_specs, shard_array

    table = param_specs(cfg, fsdp=fsdp)
    mesh = Mesh(np.zeros(shape), tuple(coords), {"data": None, "model": None})
    assert sorted(params) == sorted(moments["mu"]) == sorted(moments["nu"])
    for name in params:
        *layer, leaf = name.split("/")
        spec = table["layers"][leaf] if layer else table[leaf]
        for kind, tree in (("params", params), ("moments/mu", moments["mu"]),
                           ("moments/nu", moments["nu"])):
            want = shard_array(np.asarray(tree[name]), spec, mesh)
            _close(res[f"{tag}/{kind}/{name}"], want, what=f"{tag} {kind} {name}")


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["22", "21"])
def test_fsdp_step_equals_jax_and_one_process(results, shape):
    """(2, 2) on the world and (2, 1) on ranks 0 and 1: each rank's blocks
    of the parameters and moments after 3 steps, and the metrics.  The data
    ranks take different rows (of different layouts), so a leaf whose
    gradient is not summed over the data group would differ."""
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig

    ranks, ref, _ = results
    cfg = ModelConfig.tiny(vocab_size=VOCAB)
    members = ranks if shape == "22" else ranks[:2]
    dp_tp = (2, 2) if shape == "22" else (2, 1)
    want_coords = [[d, m] for d in range(dp_tp[0]) for m in range(dp_tp[1])]
    assert [res[f"coords{shape}"] for res in members] == want_coords
    for params, moments, metrics in (ref[f"jax{shape}"], ref[f"one{shape}"]):
        for res in members:
            _check_blocks(res, f"fsdp{shape}", params, moments, cfg, dp_tp, res[f"coords{shape}"])
            _close(res[f"fsdp{shape}/metrics"], metrics, what="metrics")
    metrics = ref[f"jax{shape}"][2]
    assert metrics[-1, 0] < metrics[0, 0]  # the loss descends
    assert (metrics[:, 1:] > 0).all()  # both losses take part


def test_tp2_splash_step_equals_single_device(results):
    """(1, 2) splash, Qwen3-style and tied: each rank runs the plain training
    attention on its heads (kernel 3 on the card); its TP blocks == the
    single-device step's."""
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig

    ranks, ref, _ = results
    cfg3 = ModelConfig.tiny(vocab_size=VOCAB, **QWEN3)
    params, moments, metrics = ref["single_splash"]
    for res in ranks[2:]:
        assert res["coords12"][0] == 0
        _check_blocks(res, "splash12", params, moments, cfg3, (1, 2), res["coords12"])
        _close(res["splash12/metrics"], metrics, what="metrics")


def test_train_on_the_mesh_equals_jax_train(results):
    """`train()` at dp 2, global batch 4, 8 rows: 4 steps over two epochs,
    the history == JAX `train(mesh=)`.  The JAX schedule is evaluated in
    float32 from its int32 count, so the learning rates differ in the 8th
    digit: losses within 1e-7."""
    ranks, ref, _ = results
    jres = ref["jax_train"]
    for res in ranks[:2]:
        assert res["step"] == jres["step"] == 4
        assert len(res["history"]) == len(jres["history"]) == 4
        for got, want in zip(res["history"], jres["history"]):
            assert got["step"] == want["step"]
            for k in ("loss", "loss_ar", "loss_consistency"):
                assert got[k] == pytest.approx(want[k], rel=1e-7, abs=0), k


def test_mesh_checkpoint_loads_in_both_packages(results):
    """rank 0 writes the gathered weights: the file (float32) == the trained
    weights rounded to float32, read by the JAX and the port loaders."""
    import jax.numpy as jnp

    from jacobiforcing_tpu.utils import loader as jloader
    from jacobiforcing_tpu_torch.utils import loader as tloader

    ranks, ref, d = results
    path = str(d / "run64" / "checkpoint-4")
    final = {k[len("train64/final/"):]: v for k, v in ranks[0].items()
             if k.startswith("train64/final/")}
    _, jp = jloader.load_checkpoint(path, dtype=jnp.float64)
    _, tp = tloader.load_checkpoint(path, dtype=torch.float64, device="cpu")
    for got in (_flat(_to_np(jp)), _flat(tp)):
        assert sorted(got) == sorted(final)
        for k, v in final.items():
            np.testing.assert_array_equal(got[k], v.astype(np.float32).astype(np.float64), k)
    for k, v in final.items():  # both ranks gathered the same weights
        np.testing.assert_array_equal(ranks[1][f"train64/final/{k}"], v)
    assert sorted(os.listdir(path)) == ["config.json", "model.safetensors", "opt_state.pt",
                                        "trainer_state.json"]


def test_mesh_run_resumes_exactly(results, tmp_path):
    """f32: stopped at step 2 and resumed on the mesh == uninterrupted, bit
    for bit (the checkpoint holds the weights and moments whole, and the
    resumed run takes up the data order at step 3); resumed from the same
    checkpoint in one process at (1, 1) == within f32 rounding of other
    summation orders."""
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig
    from jacobiforcing_tpu_torch.parallel.mesh import make_mesh
    from jacobiforcing_tpu_torch.utils.loader import params_from_numpy

    ranks, _, d = results
    whole = {k: v for k, v in ranks[0].items() if k.startswith("train32/whole/")}
    assert ranks[0]["train32_whole_step"] == ranks[0]["train32_resumed_step"] == 4
    for k, v in whole.items():
        np.testing.assert_array_equal(ranks[0][k.replace("/whole/", "/resumed/")], v, k)
    shutil.copytree(d / "run32-resumed" / "checkpoint-2", tmp_path / "checkpoint-2")
    cfg32 = ModelConfig.tiny(vocab_size=VOCAB, dtype=torch.float32)
    full = params_from_numpy(_unflat(dict(np.load(d / "params.npz"))), dtype=torch.float32)
    res = _port_train(cfg32, full, make_mesh(1, 1), str(tmp_path), max_steps=4, save_steps=2,
                      resume=True)
    got = _flat(res["params"])
    for k, v in whole.items():
        err = np.abs(got[k[len("train32/whole/"):]] - v).max()
        if k.endswith("/bk"):
            # bk starts at 0 and its gradient nearly cancels (a bias on the
            # keys shifts every score of a query alike but for RoPE's turn,
            # and softmax ignores a common shift): Adam turns the f32
            # rounding of such entries into steps of up to the learning rate
            assert err <= 3 * TRAIN_ARGS["learning_rate"], (k, err)
        else:  # f32 sums in another order: a few units in the 7th digit
            assert err <= 1e-6 * np.abs(v).max(), (k, err)


@pytest.mark.parametrize("B", [4, 3])
def test_sft_on_the_mesh_equals_jax(results, B):
    """B = 4 splits over the data ranks, B = 3 runs whole on each; the rows'
    masks keep 3 / 7 / 10 / 5 tokens, so a loss normalized by each rank's own
    count would differ.  Loss, TP blocks of the parameters and moments (the
    first moment is a tenth of the gradient)."""
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig

    ranks, ref, _ = results
    params, moments, loss = ref["sft"][B]
    cfg = ModelConfig.tiny(vocab_size=VOCAB)
    for res in ranks:
        _close(res[f"sft{B}/loss"], loss, what="loss")
        _check_blocks(res, f"sft{B}", params, moments, cfg, (2, 2), res["coords22"], fsdp=False)


def test_refusals_on_the_mesh(results):
    ranks, _, _ = results
    for res in ranks[2:]:
        assert res["refuse_indivisible"] and res["refuse_splash_batch"]
        assert res["refuse_outside"] == [True, True, True]
    assert all(res["refuse_world"] for res in ranks)


def test_global_batch_without_a_mesh_raises():
    """JAX ignores global_batch without a mesh; the port refuses it."""
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig
    from jacobiforcing_tpu_torch.train.trainer import TrainerArgs, train

    with pytest.raises(ValueError, match="needs a mesh"):
        train(TrainerArgs(global_batch=4), model_cfg=ModelConfig.tiny(), device="cpu")


if __name__ == "__main__":
    child_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
