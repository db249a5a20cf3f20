"""Joining a torch.distributed world through `parallel/multihost.py`, the
counterpart of tests/test_multihost.py.

Two processes get the environment `torchrun` sets (RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT, LOCAL_RANK, LOCAL_WORLD_SIZE) and join through
`initialize_multihost` with no arguments; `make_pod_mesh` keeps the model
axis inside the node and `is_primary` names rank 0, as in the JAX test.  One
tensor-parallel greedy generate (TP 2) on the tiny fp64 model equals the
single-process one, and so does one consistency training step on the pod
mesh (TP 2, dense attention), block for block.  The `cuda` test runs the
same two ranks on one card over gloo (NCCL refuses two ranks on one card),
eagerly, through the kernels.

Only the port is imported, so the card collects this file.  The ranks run
it as a script (`child_main`).
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENGINE_KW = dict(kvcache_page_size=16, max_model_len=256, jacobi_chunk_tokens=32,
                 prefill_token_buckets=(32, 64, 128, 256), eos=-1, num_kv_pages=64)


_BENCH_ARGS = ["--model", os.path.join(ROOT, "assets", "tpf_demo_n32_v7"), "--device", "cpu",
               "--tensor-parallel-size", "2", "--num-kv-pages", "64",
               "--limit", "2", "--max-new-tokens", "16", "--n-token-seq-len", "8",
               "--max-blocks", "1", "--dataset",
               os.path.join(ROOT, "assets", "tpf_demo_n32_v7", "heldout_prompts.jsonl")]


def _generations(out_dir):
    with open(os.path.join(out_dir, "generations_jacobi.jsonl")) as f:
        return [json.loads(line)["token_ids"] for line in f]


def _prompts():
    r = np.random.RandomState(0)
    return [r.randint(1, 256, size=n).tolist() for n in (5, 9, 17)]


def _model(device):
    """The tiny model: fp64 on the CPU; on the card f32 with head_dim 64 (the
    kernels take f32 / bf16 queries and D 64 / 128)."""
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params

    cfg = ModelConfig.tiny() if device == "cpu" else ModelConfig.tiny(
        head_dim=64, dtype=torch.float32)
    return cfg, init_params(cfg, 0, device=device)


def _generate(device, tp):
    from jacobiforcing_tpu_torch import LLM, SamplingParams

    cfg, params = _model(device)
    llm = LLM(device=device, model_cfg=cfg, params=params, tensor_parallel_size=tp,
              enforce_eager=True, **ENGINE_KW)
    out = {}
    for name, strategy in (("ar", "autoregressive"), ("jacobi", "jacobi")):
        sp = SamplingParams(temperature=0.0, max_tokens=16, decode_strategy=strategy,
                            jacobi_block_len=8)
        out[name] = [o["token_ids"] for o in llm.generate(_prompts(), sp)]
    llm.exit()
    return out


def _train_step(mesh):
    """One consistency step of the tiny fp64 model on a seeded packed row
    (P 6, T 3, N 4), at `mesh` (None: one process): the updated weights."""
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params, rope_table
    from jacobiforcing_tpu_torch.parallel.sharding import shard_params
    from jacobiforcing_tpu_torch.train.consistency import (
        TrainConfig, make_train_step, prepare_sample)
    from jacobiforcing_tpu_torch.train.optim import AdamW

    cfg = ModelConfig.tiny()
    params = init_params(cfg, 0, device="cpu")
    if mesh is not None:
        params = shard_params(params, cfg, mesh, fsdp=True)
    tc = TrainConfig(N=4, max_pairs=3, seq_bucket=32, ar_pair_bucket=32, cons_pair_bucket=32)
    ids = np.random.RandomState(4).randint(1, 256, 30).tolist()
    batch = {k: torch.as_tensor(v) for k, v in prepare_sample(ids, 6, 3, tc).items()}
    if mesh is not None:  # the mesh step takes a global batch
        batch = {k: v[None] for k, v in batch.items()}
    opt = AdamW(1e-3, b1=0.9, b2=0.95)
    state = opt.init(params)
    params, _, _ = make_train_step(cfg, tc, opt, mesh)(params, state, rope_table(cfg), batch)
    return params


def child_main(workdir, device):
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from jacobiforcing_tpu_torch.ops import paged_attention_cuda
    from jacobiforcing_tpu_torch.parallel.multihost import (
        initialize_multihost,
        is_primary,
        make_pod_mesh,
    )

    initialize_multihost(backend="gloo")  # everything from the torchrun environment
    res = {"world": dist.get_world_size(), "rank": dist.get_rank(), "primary": is_primary()}
    mesh = make_pod_mesh(tensor_parallel_size=2)
    res["shape"], res["coords"] = mesh.shape, list(mesh.coords)
    res["group_size"] = dist.get_world_size(mesh.model_group)
    try:
        make_pod_mesh(tensor_parallel_size=4)  # wider than the node's 2 ranks
        res["too_wide_raises"] = False
    except AssertionError:
        res["too_wide_raises"] = True
    if device == "cuda":
        res["device"] = torch.cuda.current_device()
    paged_attention_cuda.paged_attention_cuda.launches = 0
    res["tokens"] = _generate(device, 2)
    res["launches"] = paged_attention_cuda.paged_attention_cuda.launches
    if device == "cpu":
        # one training step on the pod mesh: the rank's blocks
        res["train_blocks"] = {name: t.tolist() for name, t in _train_step(mesh)["layers"].items()}
        # the app under torchrun: the demo checkpoint loaded in shares
        from jacobiforcing_tpu_torch.apps import bench_generate

        out_dir = os.path.join(workdir, f"bench{res['rank']}")
        agg, _ = bench_generate.run(bench_generate.make_parser().parse_args(_BENCH_ARGS + [
            "--output-dir", out_dir]))
        files = sorted(os.listdir(out_dir)) if os.path.isdir(out_dir) else []
        res["bench"] = dict(total_tokens=agg["total_tokens"], files=files,
                            generations=_generations(out_dir) if files else None)
    with open(os.path.join(workdir, f"rank{res['rank']}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def _spawn(workdir, device):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        # torchrun's environment; on the card both ranks share card 0
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", RANK=str(rank),
                   WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   LOCAL_RANK="0" if device == "cuda" else str(rank), LOCAL_WORLD_SIZE="2")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(workdir), device], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"a rank failed:\n{log[-4000:]}"
    ranks = []
    for rank in range(2):
        with open(os.path.join(workdir, f"rank{rank}.json")) as f:
            ranks.append(json.load(f))
    return ranks


@pytest.fixture(scope="module")
def joined(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("mh"), "cpu")


def test_world_joined_from_the_torchrun_environment(joined):
    assert [r["world"] for r in joined] == [2, 2]
    assert [r["rank"] for r in joined] == [0, 1]
    assert [r["primary"] for r in joined] == [True, False]


def test_pod_mesh_keeps_the_model_axis_in_the_node(joined):
    for rank, r in enumerate(joined):
        assert r["shape"] == {"data": 1, "model": 2}
        assert r["coords"] == [0, rank]
        assert r["group_size"] == 2
        assert r["too_wide_raises"]


def test_tp2_generate_equals_single_process(joined):
    single = _generate("cpu", 1)
    for r in joined:
        assert r["tokens"] == single
    assert single["ar"] == single["jacobi"]


def test_bench_generate_under_torchrun(joined, tmp_path):
    """`bench_generate --tensor-parallel-size 2`: both ranks serve the
    demo checkpoint (loaded in shares), the first alone writes its files,
    and the tokens equal a one-process run's."""
    from jacobiforcing_tpu_torch.apps import bench_generate

    args = list(_BENCH_ARGS)
    args[args.index("--tensor-parallel-size") + 1] = "1"
    agg, _ = bench_generate.run(bench_generate.make_parser().parse_args(
        args + ["--output-dir", str(tmp_path)]))
    assert [r["bench"]["total_tokens"] for r in joined] == [agg["total_tokens"]] * 2
    assert joined[0]["bench"]["files"] == sorted(os.listdir(tmp_path))
    assert joined[0]["bench"]["generations"] == _generations(tmp_path)
    assert joined[1]["bench"]["files"] == []


def test_train_step_under_torchrun(joined):
    """One consistency step on `make_pod_mesh(tensor_parallel_size=2)`:
    each rank's blocks of the layer weights == the single-process step's,
    within 1e-12 (fp64; the row-parallel sums add in another order)."""
    from jacobiforcing_tpu_torch.models.qwen import ModelConfig
    from jacobiforcing_tpu_torch.parallel.mesh import Mesh
    from jacobiforcing_tpu_torch.parallel.sharding import param_specs, shard_array

    single = _train_step(None)["layers"]
    specs = param_specs(ModelConfig.tiny(), fsdp=True)["layers"]
    for rank, r in enumerate(joined):
        mesh = Mesh(np.zeros((1, 2)), (0, rank), {"data": None, "model": None})
        assert sorted(r["train_blocks"]) == sorted(single)
        for name, t in single.items():
            want = shard_array(t, specs[name], mesh).numpy()
            np.testing.assert_allclose(np.asarray(r["train_blocks"][name]), want, rtol=0,
                                       atol=1e-12, err_msg=name)


def test_one_process_needs_no_world(monkeypatch):
    import torch.distributed as dist

    from jacobiforcing_tpu_torch.parallel.mesh import make_mesh
    from jacobiforcing_tpu_torch.parallel.multihost import initialize_multihost, is_primary

    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    initialize_multihost(backend="gloo")
    assert not dist.is_initialized() and is_primary()
    mesh = make_mesh(tensor_parallel_size=1)
    assert mesh.shape == {"data": 1, "model": 1} and mesh.model_group is None
    with pytest.raises(ValueError, match="torch.distributed world"):
        make_mesh(tensor_parallel_size=1, data_parallel_size=2, ranks=[0, 1])


@pytest.mark.cuda
def test_tp2_gloo_generate_on_one_card(tmp_path):
    """Two ranks share the one card over gloo, eagerly: the paged kernel runs
    on each rank's KV head, the ranks agree, and AR == Jacobi within TP 2."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    ranks = _spawn(tmp_path, "cuda")
    assert ranks[0]["tokens"] == ranks[1]["tokens"]
    assert ranks[0]["tokens"]["ar"] == ranks[0]["tokens"]["jacobi"]
    assert all(r["device"] == 0 and r["launches"] > 0 for r in ranks)


if __name__ == "__main__":
    child_main(sys.argv[1], sys.argv[2])
