"""Tensor-parallel serving in the port against the JAX package's TP engine.

The JAX side runs on the 8-device virtual CPU mesh of tests/conftest.py, as
tests/test_parallel.py and tests/test_tp_kernel.py run it.  The port runs in
a 2-process and a 4-process gloo world, each spawned once for this module:
every rank runs this file as a script (`child_main`), which imports only the
port, runs all of its checks in one go and writes what it computed for the
parent to compare.  Inputs are seeded: the tiny model's weights are the JAX
tests' own (`init_params(ModelConfig.tiny(), PRNGKey(0))`), carried over as
numpy arrays.

  * `param_specs` == the JAX table name by name, with and without fsdp;
    `shard_params` blocks == the JAX `addressable_shards`, quantized leaves
    included, at every coordinate of (dp, tp) = (1, 2), (2, 2), (1, 4);
  * TP 2 and TP 4 `forward` / `forward_spec` hidden states, logits, the
    speculative K/V of the rank's heads, `greedy_tokens` (vocab chunks) and
    `chunked_token_logprob` against JAX TP and single-device, at fp64 within
    1e-12 (the all-reduce of the row-parallel layers adds in another order
    than one device's dot); `forward_dense` and its gradients at TP 2;
  * engine tokens at TP 2 == JAX TP 2 == JAX single for `ar`, `jacobi`,
    `mr` (policy off), `jacobi_nongreedy` at top_k=1, and greedy on-policy
    collection record for record;
  * W8A8 at TP 2: the int8 activations of a K-split row bit for bit, and the
    tokens;
  * the KV pool holds num_kv_heads / tp heads per rank; KH % tp != 0 raises;
    without a mesh the world must have tp ranks; an engine destroys the
    groups it built, not a mesh it was given; `load_checkpoint(mesh=)` ==
    `shard_params` of the whole checkpoint;
  * the MR auto-policy picks the same arms on two ranks whose clocks differ.

JAX is imported inside the parent's helpers: the ranks run this file as a
script and import nothing of it.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(ROOT, "assets", "tpf_demo_n32_v7")
PAGE = 16
TOL = 1e-12  # fp64: the row-parallel all-reduce reorders sums of ~1e0 terms
MR = "jacobi_multiblock_rejection_recycling"
ENGINE_KW = dict(kvcache_page_size=PAGE, max_model_len=256, jacobi_chunk_tokens=32,
                 prefill_token_buckets=(32, 64, 128, 256), eos=-1)
# the TP 4 forward's model: KV heads that divide over 4 ranks
TP4_MODEL = dict(num_heads=8, num_kv_heads=4)
VOCAB_CHUNK = 48  # < 256 / tp: the heads' chunked paths run, last chunk clamped
# seconds a chunk of each MR policy arm takes on each rank's fake clock
POLICY_WALL = ([1.0, 10.0, 10.0, 10.0], [10.0, 10.0, 10.0, 1.0])
POLICY_TOKENS = 96  # long enough for the probe window to close and lock


def _prompts(sizes=(5, 9, 17, 3), rng=0):
    r = np.random.RandomState(rng)
    return [r.randint(1, 256, size=n).tolist() for n in sizes]


def _strategy_sps(cls):
    """The five decode strategies' requests (on-policy runs by collection)."""
    return {
        "ar": cls(temperature=0.0, max_tokens=20),
        "jacobi": cls(temperature=0.0, max_tokens=20, decode_strategy="jacobi",
                      jacobi_block_len=8, jacobi_max_blocks=1),
        "mr": cls(temperature=0.0, max_tokens=20, decode_strategy=MR, jacobi_block_len=8,
                  jacobi_max_blocks=2, jacobi_n_gram_pool_size=4, jacobi_spawn_ratio=0.5),
        "nongreedy": cls(temperature=0.7, top_k=1, max_tokens=20,
                         decode_strategy="jacobi_nongreedy", jacobi_block_len=8,
                         jacobi_max_blocks=1, jacobi_max_iterations=256),
    }


def _forward_inputs(vocab=256, seed=3):
    """A prefill of 6 tokens per row, then a 4-token block reading it, and a
    speculative block of 5 tokens under a tree-like intra mask."""
    r = np.random.RandomState(seed)
    B = 2
    return dict(
        ids1=r.randint(0, vocab, (B, 6)).astype(np.int32),
        ids2=r.randint(0, vocab, (B, 4)).astype(np.int32),
        ids_spec=r.randint(0, vocab, (B, 5)).astype(np.int32),
        bt=np.asarray([[0, 1, -1], [3, 2, -1]], np.int32),
        intra=np.tril(r.rand(B, 5, 5) < 0.7) | np.eye(5, dtype=bool)[None],
        temps=(0.5 + r.rand(B, 4)).astype(np.float32),
        w_loss=r.randn(B, 6, 64),
    )


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        elif isinstance(v, torch.Tensor):
            out[prefix + k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        else:
            out[prefix + k] = np.asarray(v)
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
# The port's side: one rank of a gloo world
# ---------------------------------------------------------------------------


def _port_forwards(cfg, params, mesh, inp, rope):
    """The forward cases on this rank: prefill + block hidden states and
    logits, the speculative forward, the heads.  `rope` is the JAX package's
    table (its float32 cos / sin differ from torch's in the last bit)."""
    from jacobiforcing_tpu_torch.models import qwen
    from jacobiforcing_tpu_torch.ops.kv_cache import alloc_kv_cache

    g = mesh.model_group if mesh is not None else None
    tp = mesh.shape["model"] if mesh is not None else 1
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    kv = alloc_kv_cache(cfg.num_layers, 4, PAGE, cfg.num_kv_heads // tp, cfg.head_dim,
                        cfg.dtype, "cpu")
    B = t["ids1"].shape[0]
    pos1 = torch.arange(6)[None].repeat(B, 1)
    h1, _ = qwen.forward(params, cfg, t["ids1"], pos1, kv, t["bt"], torch.full((B,), 6), rope,
                         group=g)
    pos2 = 5 + torch.arange(4)[None].repeat(B, 1)
    h2, _ = qwen.forward(params, cfg, t["ids2"], pos2, kv, t["bt"], torch.full((B,), 9), rope,
                         group=g)
    pos_s = 9 + torch.arange(5)[None].repeat(B, 1)
    hs, k_new, v_new = qwen.forward_spec(params, cfg, t["ids_spec"], pos_s, kv, t["bt"],
                                         torch.full((B,), 9), t["intra"], rope, group=g)
    return dict(
        h1=h1, h2=h2, hs=hs, k_new=k_new, v_new=v_new,
        logits=qwen.logits_at(params, cfg, h2, g),
        greedy=qwen.greedy_tokens(params, cfg, h2, vocab_chunk=VOCAB_CHUNK, group=g),
        greedy_full=qwen.greedy_tokens(params, cfg, h2, group=g),
        logprob=qwen.chunked_token_logprob(params, cfg, h2, t["ids2"], t["temps"],
                                           vocab_chunk=VOCAB_CHUNK, group=g),
        logprob_full=qwen.chunked_token_logprob(params, cfg, h2, t["ids2"], t["temps"],
                                                group=g),
    )


def _port_dense(cfg, params, mesh, inp, rope):
    """forward_dense and the gradients of a fixed projection of its output."""
    from jacobiforcing_tpu_torch.models import qwen

    g = mesh.model_group if mesh is not None else None
    params = {k: v for k, v in params.items()}
    params["layers"] = {k: v.clone().requires_grad_(True) for k, v in params["layers"].items()}
    ids = torch.from_numpy(inp["ids1"])
    pos = torch.arange(ids.shape[1])[None].repeat(ids.shape[0], 1)
    h = qwen.forward_dense(params, cfg, ids, pos, rope, group=g)
    (h * torch.from_numpy(inp["w_loss"])).sum().backward()
    out = {"dense": h.detach()}
    for k in ("wq", "wo", "w_up", "w_down", "bq"):
        out[f"grad_{k}"] = params["layers"][k].grad
    return out


def _port_engine(cfg, params, tp, **kw):
    from jacobiforcing_tpu_torch.config import Config
    from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine

    pages = kw.pop("num_pages", 128)
    return LLMEngine(Config(**{**ENGINE_KW, **kw}, tensor_parallel_size=tp), model_cfg=cfg,
                     params=params, num_kv_pages=pages, device="cpu")


def _group_alive(group) -> bool:
    import torch.distributed as dist

    try:
        dist.get_process_group_ranks(group)
        return True
    except KeyError:  # destroyed
        return False


def _port_world2(cfg, params, mesh, workdir, rank, out, arrays):
    from jacobiforcing_tpu_torch.config import Config, SamplingParams
    from jacobiforcing_tpu_torch.data import collect_trajectories
    from jacobiforcing_tpu_torch.engine import llm_engine, mr_policy
    from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine
    from jacobiforcing_tpu_torch.ops.quant import act_quantize
    from jacobiforcing_tpu_torch.parallel.mesh import get_serving_mesh
    from jacobiforcing_tpu_torch.parallel.sharding import shard_params
    from jacobiforcing_tpu_torch.utils.loader import load_checkpoint

    prompts = _prompts()
    tokens = {}
    for name, sp in _strategy_sps(SamplingParams).items():
        eng = _port_engine(cfg, params, 2, jacobi_mr_auto_policy=False)
        tokens[name] = [o["token_ids"] for o in eng.generate(prompts, sp)]
        if name == "ar":
            out["kv_heads"] = int(eng.kv.k.shape[1])
            out["mesh_registered"] = get_serving_mesh() is eng.mesh
            own = eng.group
            eng.exit()
            out["mesh_cleared"] = get_serving_mesh() is None
            out["own_group_destroyed"] = not _group_alive(own)
    eng = LLMEngine(Config(**ENGINE_KW, tensor_parallel_size=2), model_cfg=cfg, params=params,
                    num_kv_pages=8, device="cpu", mesh=mesh)
    out["given_group_used"] = eng.group is mesh.model_group
    eng.exit()
    out["given_group_alive"] = _group_alive(mesh.model_group)

    # a checkpoint cut on the host == the whole checkpoint's shard_params
    _, whole = load_checkpoint(DEMO, dtype=torch.float32, device="cpu")
    demo_cfg, cut = load_checkpoint(DEMO, dtype=torch.float32, device="cpu", mesh=mesh)
    want = _flat(shard_params(whole, demo_cfg, mesh))
    got = _flat(cut)
    out["checkpoint_cut"] = set(got) == set(want) and all(
        np.array_equal(got[k], want[k]) for k in want)
    out["checkpoint_embed_rows"] = int(cut["embed"].shape[0])
    out["tokens"] = tokens
    rows = collect_trajectories(_port_engine(cfg, params, 2, num_pages=256), _prompts(
        sizes=(5, 9, 17, 3, 12)), block_len=8, max_tokens=19)
    out["collect"] = rows

    # W8A8: the K-split row's int8 activations, and the tokens
    x = np.load(os.path.join(workdir, "inputs.npz"))["act_x"]
    half = x.shape[-1] // 2
    xq, sx = act_quantize(torch.from_numpy(x[:, rank * half:(rank + 1) * half]),
                          mesh.model_group)
    arrays["act_xq"], arrays["act_sx"] = xq.numpy(), sx.numpy()
    eng = _port_engine(cfg, params, 2, quantization="w8a8", kv_cache_dtype="fp8")
    out["w8a8_kv_heads"] = [int(eng.kv.k.shape[1]), int(eng.kv.k_scale.shape[1])]
    out["w8a8"] = {name: [o["token_ids"] for o in eng.generate(prompts, _strategy_sps(
        SamplingParams)[name])] for name in ("ar", "jacobi")}

    # MR auto-policy under clocks that differ per rank: a chunk of arm a
    # takes WALL[rank][a] seconds, so rank 0 alone would lock arm 0 and rank
    # 1 alone arm 3; the arms follow rank 0's broadcast wall time
    clock = [0.0]
    picks = []

    def fake_clock():
        clock[0] += POLICY_WALL[rank][picks[-1] if picks else 0]
        return clock[0]

    real_pick = mr_policy.MRAutoPolicy.pick

    def logged_pick(self):
        arm = real_pick(self)
        picks.append(arm)
        return arm

    llm_engine.time.perf_counter, real_clock = fake_clock, llm_engine.time.perf_counter
    mr_policy.MRAutoPolicy.pick = logged_pick
    try:
        eng = _port_engine(cfg, params, 2, jacobi_mr_auto_policy=True,
                           jacobi_mr_probe_chunks=1, jacobi_mr_reprobe_every=64,
                           jacobi_chunk_tokens=4)
        sp = dataclasses.replace(_strategy_sps(SamplingParams)["mr"], max_tokens=POLICY_TOKENS)
        out["policy_tokens"] = [o["token_ids"] for o in eng.generate(_prompts(sizes=(5, 9)), sp)]
        out["ar_tokens"] = [o["token_ids"] for o in _port_engine(cfg, params, 2).generate(
            _prompts(sizes=(5, 9)), dataclasses.replace(sp, decode_strategy="autoregressive"))]
    finally:
        llm_engine.time.perf_counter = real_clock
        mr_policy.MRAutoPolicy.pick = real_pick
    out["policy_picks"] = picks

    # a gloo group asked to capture CUDA graphs raises before it captures
    from jacobiforcing_tpu_torch.engine.graphs import DecodePrograms

    try:
        DecodePrograms(params, cfg, None, None, torch.Generator(), pages_bucket=4, cap_tokens=64,
                       chunk_budget=4, chunk_iters=0, capture=True, group=mesh.model_group)
        out["gloo_capture_raises"] = False
    except ValueError as e:
        out["gloo_capture_raises"] = "enforce_eager=True" in str(e)


def child_main(rank, world, port, workdir):
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from jacobiforcing_tpu_torch.config import Config, SamplingParams
    from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig
    from jacobiforcing_tpu_torch.parallel.mesh import make_mesh
    from jacobiforcing_tpu_torch.parallel.multihost import initialize_multihost
    from jacobiforcing_tpu_torch.parallel.sharding import shard_params
    from jacobiforcing_tpu_torch.utils.loader import params_from_numpy

    initialize_multihost(f"localhost:{port}", world, rank, backend="gloo")
    mesh = make_mesh(tensor_parallel_size=world)
    out, arrays = {"rank": rank}, {}
    fwd_cfg = ModelConfig.tiny(**(TP4_MODEL if world == 4 else {}))
    full = params_from_numpy(_unflat(dict(np.load(os.path.join(workdir, f"params{world}.npz")))))
    inp = _forward_inputs()
    rope = tuple(torch.tensor(a) for a in np.load(os.path.join(workdir, "rope.npz")).values())
    local = shard_params(full, fwd_cfg, mesh)
    for k, v in {**_port_forwards(fwd_cfg, local, mesh, inp, rope),
                 **(_port_dense(fwd_cfg, local, mesh, inp, rope) if world == 2 else {})}.items():
        arrays[k] = v.detach().numpy()
    if world == 2:
        _port_world2(fwd_cfg, full, mesh, workdir, rank, out, arrays)
    else:
        out["tokens"] = {name: [o["token_ids"] for o in _port_engine(
            fwd_cfg, full, 4, jacobi_mr_auto_policy=False).generate(_prompts(), sp)]
            for name, sp in _strategy_sps(SamplingParams).items()}
        try:  # the tiny model's 2 KV heads do not split over 4 ranks
            LLMEngine(Config(**ENGINE_KW, tensor_parallel_size=4), model_cfg=ModelConfig.tiny(),
                      params=full, num_kv_pages=8, device="cpu")
            out["kh_raises"] = False
        except ValueError as e:
            out["kh_raises"] = "not divisible" in str(e)
        try:  # a world of 4 ranks has no meaning at TP 2 without a data axis
            _port_engine(fwd_cfg, full, 2)
            out["world_raises"] = False
        except ValueError as e:
            out["world_raises"] = "world of 2 ranks" in str(e)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


# ---------------------------------------------------------------------------
# The parent's side: JAX on the virtual mesh
# ---------------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(world, workdir):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                               str(port), str(workdir)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"a rank failed:\n{log[-4000:]}"
    ranks = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            res = json.load(f)
        res.update(dict(np.load(os.path.join(workdir, f"rank{r}.npz"))))
        ranks.append(res)
    return ranks


def _jax_params(cfg_kw=None):
    import jax

    from jacobiforcing_tpu.models import qwen as jq

    return jax.tree.map(np.asarray, jq.init_params(jq.ModelConfig.tiny(**(cfg_kw or {})),
                                                   jax.random.PRNGKey(0)))


def _jax_rope():
    """The tiny models' RoPE table (both forward models share it)."""
    from jacobiforcing_tpu.models import qwen as jq

    cos, sin = jq.rope_table(jq.ModelConfig.tiny())
    return {"cos": np.asarray(cos), "sin": np.asarray(sin)}


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp2")
    np.savez(d / "params2.npz", **_flat(_jax_params()))
    np.savez(d / "rope.npz", **_jax_rope())
    np.savez(d / "inputs.npz", act_x=np.random.RandomState(5).randn(6, 64) * 3)
    return _spawn(2, d)


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp4")
    np.savez(d / "params4.npz", **_flat(_jax_params(TP4_MODEL)))
    np.savez(d / "rope.npz", **_jax_rope())
    return _spawn(4, d)


def _jax_forwards(cfg_kw, tp):
    """JAX's forward cases on one device (tp None) or under a TP mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding

    from jacobiforcing_tpu.models import qwen as jq
    from jacobiforcing_tpu.ops.kv_cache import alloc_kv_cache
    from jacobiforcing_tpu.parallel.mesh import make_mesh
    from jacobiforcing_tpu.parallel.sharding import kv_cache_spec, shard_params

    cfg = jq.ModelConfig.tiny(**(cfg_kw or {}))
    params = jq.init_params(cfg, jax.random.PRNGKey(0))
    kv = alloc_kv_cache(cfg.num_layers, 4, PAGE, cfg.num_kv_heads, cfg.head_dim, cfg.dtype)
    if tp:
        mesh = make_mesh(tensor_parallel_size=tp)
        params = shard_params(params, cfg, mesh)
        spec = kv_cache_spec()
        kv = type(kv)(k=jax.device_put(kv.k, NamedSharding(mesh, spec.k)),
                      v=jax.device_put(kv.v, NamedSharding(mesh, spec.v)), page_size=PAGE)
    inp = {k: jnp.asarray(v) for k, v in _forward_inputs().items()}
    rope = jq.rope_table(cfg)
    B = inp["ids1"].shape[0]
    fwd = jax.jit(lambda p, kv, ids, pos, lens: jq.forward(p, cfg, ids, pos, kv, inp["bt"],
                                                           lens, rope))
    h1, kv = fwd(params, kv, inp["ids1"], jnp.tile(jnp.arange(6)[None], (B, 1)),
                 jnp.full((B,), 6))
    h2, kv = fwd(params, kv, inp["ids2"], 5 + jnp.tile(jnp.arange(4)[None], (B, 1)),
                 jnp.full((B,), 9))
    hs, k_new, v_new = jax.jit(lambda p, kv: jq.forward_spec(
        p, cfg, inp["ids_spec"], 9 + jnp.tile(jnp.arange(5)[None], (B, 1)), kv, inp["bt"],
        jnp.full((B,), 9), inp["intra"], rope))(params, kv)
    out = dict(
        h1=h1, h2=h2, hs=hs, k_new=k_new, v_new=v_new,
        logits=jax.jit(lambda p, h: jq.logits_at(p, cfg, h))(params, h2),
        greedy=jax.jit(lambda p, h: jq.greedy_tokens(p, cfg, h, vocab_chunk=VOCAB_CHUNK))(
            params, h2),
        logprob=jax.jit(lambda p, h: jq.chunked_token_logprob(
            p, cfg, h, inp["ids2"], inp["temps"], vocab_chunk=VOCAB_CHUNK))(params, h2),
    )
    return {k: np.asarray(v) for k, v in out.items()}


def _check_forwards(ranks, cfg_kw, tp):
    kh = (cfg_kw or {}).get("num_kv_heads", 2) // tp
    for ref in (_jax_forwards(cfg_kw, tp), _jax_forwards(cfg_kw, None)):
        for r, res in enumerate(ranks):
            for k in ("h1", "h2", "hs", "logits", "logprob"):
                np.testing.assert_allclose(res[k], ref[k], rtol=0, atol=TOL, err_msg=k)
            np.testing.assert_allclose(res["logprob_full"], ref["logprob"], rtol=0, atol=TOL)
            for k in ("k_new", "v_new"):  # [layers, B, T, KH, D]: this rank's heads
                np.testing.assert_allclose(res[k], ref[k][:, :, :, r * kh:(r + 1) * kh],
                                           rtol=0, atol=TOL, err_msg=k)
            np.testing.assert_array_equal(res["greedy"], ref["greedy"])
            np.testing.assert_array_equal(res["greedy_full"], ref["greedy"])
    for res in ranks[1:]:  # the replicated stream is the same on every rank
        for k in ("h1", "h2", "hs", "logits", "greedy", "logprob"):
            np.testing.assert_array_equal(res[k], ranks[0][k])


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fsdp", [False, True])
def test_param_specs_equal_jax(fsdp):
    from jacobiforcing_tpu.models.qwen import ModelConfig as JModelConfig
    from jacobiforcing_tpu.parallel import sharding as jsharding
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig
    from jacobiforcing_tpu_torch.parallel import sharding

    for kw in (dict(), dict(qkv_bias=False, qk_norm=True, tie_word_embeddings=True)):
        j = jsharding.param_specs(JModelConfig.tiny(**kw), fsdp=fsdp)
        t = sharding.param_specs(ModelConfig.tiny(**kw), fsdp=fsdp)
        assert set(t) == set(j) and set(t["layers"]) == set(j["layers"])
        for name in j:
            if name != "layers":
                assert t[name] == tuple(j[name]), name
        for name in j["layers"]:
            assert t["layers"][name] == tuple(j["layers"][name]), name
    jkv = jsharding.kv_cache_spec()
    for name, spec in sharding.kv_cache_spec().items():
        assert spec == tuple(getattr(jkv, name)), name
    jds = jsharding.decode_state_specs()
    assert {k: tuple(v) for k, v in jds.items()} == sharding.decode_state_specs()


@pytest.mark.parametrize("dp,tp,fsdp", [(1, 2, False), (2, 2, True), (1, 4, False)])
def test_shard_params_blocks_equal_jax_shards(dp, tp, fsdp):
    """Every coordinate's block == the JAX shard on the device at that
    coordinate, plain and int8 leaves (the scale follows the output axis)."""
    import jax

    from jacobiforcing_tpu.models import qwen as jq
    from jacobiforcing_tpu.ops.quant import quantize_params as jquantize
    from jacobiforcing_tpu.parallel.mesh import make_mesh as jmake_mesh
    from jacobiforcing_tpu.parallel.sharding import shard_params as jshard
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig
    from jacobiforcing_tpu_torch.parallel.mesh import Mesh
    from jacobiforcing_tpu_torch.parallel.sharding import shard_params
    from jacobiforcing_tpu_torch.utils.loader import params_from_numpy

    jcfg = jq.ModelConfig.tiny(**TP4_MODEL)
    jparams = jquantize(jq.init_params(jcfg, jax.random.PRNGKey(1)))
    jmesh = jmake_mesh(tensor_parallel_size=tp, data_parallel_size=dp)
    jsharded = jshard(jparams, jcfg, jmesh, fsdp=fsdp)
    full = params_from_numpy(jax.tree.map(np.asarray, jparams))
    devices = np.asarray(jmesh.devices)
    for d in range(dp):
        for m in range(tp):
            mesh = Mesh(np.arange(dp * tp).reshape(dp, tp), (d, m), {"data": None, "model": None})
            mine = _flat(shard_params(full, ModelConfig.tiny(**TP4_MODEL), mesh, fsdp=fsdp))
            dev = devices[d, m]

            def shard_on(x):
                return next(np.asarray(s.data) for s in x.addressable_shards if s.device == dev)

            theirs = _flat(jax.tree.map(shard_on, jsharded))
            assert set(mine) == set(theirs)
            for k in theirs:
                np.testing.assert_array_equal(mine[k], theirs[k].astype(mine[k].dtype), err_msg=k)


def test_tp2_forwards_equal_jax(world2):
    _check_forwards(world2, None, 2)


def test_tp4_forwards_equal_jax(world4):
    _check_forwards(world4, TP4_MODEL, 4)


def test_tp2_forward_dense_and_gradients_equal_single(world2):
    """forward_dense under the model group (Megatron's conjugate collectives)
    == one rank's, and each rank's gradient == its block of the full one."""
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig
    from jacobiforcing_tpu_torch.parallel.mesh import Mesh
    from jacobiforcing_tpu_torch.parallel.sharding import param_specs, shard_array
    from jacobiforcing_tpu_torch.utils.loader import params_from_numpy

    cfg = ModelConfig.tiny()
    rope = tuple(torch.tensor(a) for a in _jax_rope().values())
    ref = _port_dense(cfg, params_from_numpy(_jax_params()), None, _forward_inputs(), rope)
    specs = param_specs(cfg)["layers"]
    for r, res in enumerate(world2):
        np.testing.assert_allclose(res["dense"], ref["dense"].numpy(), rtol=0, atol=TOL)
        mesh = Mesh(np.arange(2)[None], (0, r), {"data": None, "model": None})
        for k in ("wq", "wo", "w_up", "w_down", "bq"):
            block = shard_array(ref[f"grad_{k}"], specs[k], mesh).numpy()
            np.testing.assert_allclose(res[f"grad_{k}"], block, rtol=0, atol=TOL, err_msg=k)


@pytest.fixture(scope="module")
def jax_tokens():
    """JAX single-device and TP 2 streams of the four strategies, and greedy
    on-policy collection."""
    from jacobiforcing_tpu.config import SamplingParams as JSamplingParams
    from jacobiforcing_tpu.data.collect import collect_trajectories as jcollect
    from tests import test_engine as jtests
    from tests.test_parallel import make_tp_engine

    prompts = _prompts()
    out = {}
    for tag, make in (("single", jtests.make_engine), ("tp2", make_tp_engine)):
        out[tag] = {name: [o["token_ids"] for o in make(jacobi_mr_auto_policy=False).generate(
            prompts, sp)] for name, sp in _strategy_sps(JSamplingParams).items()}
    out["collect"] = jcollect(make_tp_engine(num_pages=256), _prompts(sizes=(5, 9, 17, 3, 12)),
                              block_len=8, max_tokens=19)
    out["w8a8"] = {name: [o["token_ids"] for o in jtests.make_engine(
        quantization="w8a8", kv_cache_dtype="fp8").generate(prompts, sp)]
        for name, sp in _strategy_sps(JSamplingParams).items() if name in ("ar", "jacobi")}
    return out


@pytest.mark.parametrize("strategy", ["ar", "jacobi", "mr", "nongreedy"])
def test_tp2_engine_tokens_equal_jax_tp2_and_single(world2, jax_tokens, strategy):
    assert jax_tokens["tp2"][strategy] == jax_tokens["single"][strategy]
    for res in world2:
        assert res["tokens"][strategy] == jax_tokens["tp2"][strategy]
    assert jax_tokens["single"]["ar"] == jax_tokens["single"][strategy]


def test_tp2_greedy_collection_equals_jax(world2, jax_tokens):
    jrows = jax_tokens["collect"]
    for res in world2:
        rows = res["collect"]
        assert len(rows) == len(jrows)
        for r, j in zip(rows, jrows):
            for k in ("data_id", "diffusion_itr_id", "prompt_ids", "teacher_output_ids",
                      "answer_trajectory_ids"):
                assert r[k] == j[k], k


def test_tp2_w8a8_activations_and_tokens(world2, jax_tokens):
    """A row-parallel layer's input is split along K: its int8 activations
    and scales == JAX's under the mesh (a global amax), bit for bit."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from jacobiforcing_tpu.models.qwen import _act_quantize
    from jacobiforcing_tpu.parallel.mesh import make_mesh

    x = np.random.RandomState(5).randn(6, 64) * 3
    xs = jax.device_put(x, NamedSharding(make_mesh(tensor_parallel_size=2), P(None, "model")))
    jxq, jsx = (np.asarray(a) for a in jax.jit(_act_quantize)(xs))
    for r, res in enumerate(world2):
        np.testing.assert_array_equal(res["act_xq"], jxq[:, r * 32:(r + 1) * 32])
        np.testing.assert_array_equal(res["act_sx"], jsx)
        assert res["w8a8"] == jax_tokens["w8a8"]
        assert res["w8a8"]["ar"] == res["w8a8"]["jacobi"]


def test_tp2_kv_pool_holds_the_ranks_heads(world2):
    for res in world2:
        assert res["kv_heads"] == 1  # tiny: 2 KV heads over 2 ranks
        assert res["w8a8_kv_heads"] == [1, 1]  # fp8 rows and their scale planes
        assert res["mesh_registered"] and res["mesh_cleared"]


def test_kv_heads_that_do_not_divide_raise(world4):
    assert all(res["kh_raises"] for res in world4)


def test_tp_without_a_mesh_needs_a_world_of_tp_ranks(world4):
    assert all(res["world_raises"] for res in world4)


def test_engine_destroys_only_the_groups_it_built(world2):
    for res in world2:
        assert res["own_group_destroyed"]
        assert res["given_group_used"] and res["given_group_alive"]


def test_load_checkpoint_cuts_the_ranks_share_on_the_host(world2):
    for res in world2:
        assert res["checkpoint_cut"]
        assert res["checkpoint_embed_rows"] == 128  # the demo's 256 rows over 2 ranks


def test_shard_params_refuses_a_share():
    """A share cut again would still divide: shard_params takes only the
    full weights."""
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params
    from jacobiforcing_tpu_torch.parallel.mesh import Mesh
    from jacobiforcing_tpu_torch.parallel.sharding import shard_params

    cfg = ModelConfig.tiny(**TP4_MODEL)
    mesh = Mesh(np.arange(2)[None], (0, 1), {"data": None, "model": None})
    share = shard_params(init_params(cfg, 0, "cpu"), cfg, mesh)
    with pytest.raises(ValueError, match="full weights"):
        shard_params(share, cfg, mesh)


def test_tp4_engine_tokens_equal_one_rank(world4):
    """Each rank's 2 query heads and 1 KV head at TP 4 (8 and 4 in all):
    the four strategies' streams == one rank's, and == AR."""
    from jacobiforcing_tpu_torch.config import SamplingParams
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig
    from jacobiforcing_tpu_torch.utils.loader import params_from_numpy

    params = params_from_numpy(_jax_params(TP4_MODEL))
    single = {name: [o["token_ids"] for o in _port_engine(
        ModelConfig.tiny(**TP4_MODEL), params, 1, jacobi_mr_auto_policy=False).generate(
        _prompts(), sp)] for name, sp in _strategy_sps(SamplingParams).items()}
    for res in world4:
        assert res["tokens"] == single
    assert all(single[name] == single["ar"] for name in single)


def test_gloo_group_refuses_graph_capture(world2):
    assert all(res["gloo_capture_raises"] for res in world2)


def test_mr_policy_follows_the_first_rank_clock(world2):
    """On rank 0's clock arm 0 is the fastest, on rank 1's arm 3: alone they
    would lock different arms and run different programs.  The arms follow
    rank 0's broadcast wall time, so both ranks probe every arm, lock arm 0
    and serve the AR stream."""
    a, b = world2[0]["policy_picks"], world2[1]["policy_picks"]
    assert a == b
    assert set(a) == {0, 1, 2, 3} and a[-1] == 0 and a.count(0) > 4
    assert world2[0]["policy_tokens"] == world2[1]["policy_tokens"]
    assert world2[0]["policy_tokens"] == world2[0]["ar_tokens"]


if __name__ == "__main__":
    child_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
