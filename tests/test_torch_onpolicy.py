"""On-policy rollouts in the port against the JAX package.

  * the counterparts of tests/test_onpolicy.py on the tiny model: record
    structure, the block budget (8 + 8 + 3), stop-token truncation, and
    `jacobi_accept_threshold` 0.99 and 1.1 (exactly one token per iteration);
  * greedy on-policy collection (temperature 0) against the JAX engine, on
    the tiny model and on the demo checkpoint in f32 (8 prompts, N 32): the
    committed streams, record counts, prompts, first and final snapshots,
    teacher outputs and iteration counts are equal.  Greedy collection takes
    no device draw: its initial blocks are the host generator's, drawn in
    the JAX engine's order, and a position past a block's `remaining` rows,
    where the JAX version writes a random token, always takes the pad;
  * the whole JacobiForcing loop on the CPU: `collect_trajectories` ->
    `pack_trajectories` -> the port's train step, and `validate_learning`;
  * one engine serving AR, jacobi, non-greedy, MR and on-policy requests.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import torch

from jacobiforcing_tpu.config import Config as JConfig
from jacobiforcing_tpu.data.collect import collect_trajectories as jcollect
from jacobiforcing_tpu.engine.llm_engine import LLMEngine as JLLMEngine
from jacobiforcing_tpu.utils.loader import load_checkpoint as jload
from jacobiforcing_tpu_torch import LLM
from jacobiforcing_tpu_torch.apps import validate_learning
from jacobiforcing_tpu_torch.config import SamplingParams
from jacobiforcing_tpu_torch.data import collect_trajectories, pack_trajectories
from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params, rope_table
from jacobiforcing_tpu_torch.train.consistency import TrainConfig, make_train_step, prepare_sample
from jacobiforcing_tpu_torch.train.optim import AdamW
from tests import test_engine as jtests
from tests.test_torch_sampling import make_engine, one_torch_thread  # noqa: F401 (fixture)

DEMO = os.path.join(os.path.dirname(__file__), "..", "assets", "tpf_demo_n32_v7")
OP = "jacobi_on_policy"
make_prompts = jtests.make_prompts


def _sp(max_tokens=20, L=8, blocks=16, temperature=0.8, **kw):
    return SamplingParams(temperature=temperature, max_tokens=max_tokens, decode_strategy=OP,
                          jacobi_block_len=L, jacobi_max_blocks=1, jacobi_max_iterations=blocks,
                          **kw)


# ---- tests/test_onpolicy.py ------------------------------------------------------


def test_rollout_record_structure():
    prompts = make_prompts(256)[:2]
    outs = make_engine().generate(prompts, _sp(max_tokens=20, L=8))
    for p, o in zip(prompts, outs):
        recs = o["rollout_records"]
        assert len(recs) >= 1
        full = p + o["token_ids"]
        committed = len(p)
        for k, rec in enumerate(recs):
            assert rec["diffusion_itr_id"] == f"itr_{k}"
            assert rec["prompt_ids"] == full[:committed]  # everything before the block
            traj = rec["answer_trajectory_ids"]
            assert len(traj) >= 2  # init + >= 1 iteration
            assert all(len(v) == 8 for v in traj)
            n_blk = min(8, len(full) - committed)
            assert traj[-1][:n_blk] == full[committed : committed + n_blk]
            committed += n_blk
            assert rec["teacher_output_ids"] == full
            assert rec["num_iters"] >= 1


def test_rollout_block_progress_and_budget():
    o = make_engine().generate(make_prompts(256)[:1], _sp(max_tokens=19, L=8))[0]
    assert len(o["token_ids"]) == 19
    recs = o["rollout_records"]
    assert len(recs) == 3  # 8 + 8 + 3
    last = recs[-1]["answer_trajectory_ids"][-1]
    assert all(t == 0 for t in last[3:])  # the last block generates 3, the tail is pad 0


def test_rollout_stop_token_truncates():
    prompts = make_prompts(256)[:1]
    probe = make_engine().generate(prompts, _sp(max_tokens=24, L=8))[0]
    stop = probe["token_ids"][2]
    eng = make_engine(stop_token_ids=(stop,))
    ids = eng.generate(prompts, _sp(max_tokens=24, L=8))[0]["token_ids"]
    # the same seed gives the same draws up to the stop token, which ends the rollout
    k = probe["token_ids"].index(stop)
    assert ids == probe["token_ids"][: k + 1]
    assert ids[-1] == stop and stop not in ids[:-1]


def test_accept_threshold_collection():
    """Deterministic p(x) >= threshold acceptance: rollouts complete and
    records are well formed at 0.99; at 1.1 nothing passes, so every
    iteration commits exactly one sampled token."""
    prompts = make_prompts(256)[:2]
    rows = collect_trajectories(make_engine(num_pages=256), prompts, block_len=8, max_tokens=16,
                                temperature=1.0, accept_threshold=0.99)
    assert rows
    for r in rows:
        assert all(len(s) == 8 for s in r["answer_trajectory_ids"])
        assert len(r["answer_trajectory_ids"]) >= 2
    out = make_engine(num_pages=256).generate(
        prompts[:1], _sp(max_tokens=8, temperature=1.0, jacobi_accept_threshold=1.1))[0]
    rec = out["rollout_records"][0]
    assert rec["num_iters"] == 8 and len(rec["answer_trajectory_ids"]) == 9
    traj = rec["answer_trajectory_ids"]
    assert all(traj[i][:i] == out["token_ids"][:i] for i in range(9))


# ---- greedy collection against the JAX engine ---------------------------------------


def _same_rows(rows, jrows, n_prompts):
    assert len(rows) == len(jrows)
    for r, j in zip(rows, jrows):
        assert r["data_id"] == j["data_id"] and r["diffusion_itr_id"] == j["diffusion_itr_id"]
        assert r["prompt_ids"] == j["prompt_ids"]
        assert r["teacher_output_ids"] == j["teacher_output_ids"]
        t, jt = r["answer_trajectory_ids"], j["answer_trajectory_ids"]
        assert t[0] == jt[0]  # block_init: the host generator's draws
        assert t[-1] == jt[-1]
        assert len(t) == len(jt)  # iterations
    assert len({r["data_id"] for r in rows}) == n_prompts


def test_greedy_collection_equals_jax_engine_tiny():
    """Budget 19 with L=8 leaves a last block of 3 and a stop token caps rows:
    the ragged write masks of the L+1-row forward, and tail rows past
    cache_lens, in the fp64 tiny model."""
    prompts = make_prompts(256, sizes=(5, 9, 17, 3, 12))
    probe = make_engine().generate(prompts, SamplingParams(temperature=0.0, max_tokens=19))
    stop = probe[1]["token_ids"][6]
    kw = dict(num_pages=256, stop_token_ids=(stop,))
    rows = collect_trajectories(make_engine(**kw), prompts, block_len=8, max_tokens=19)
    jrows = jcollect(jtests.make_engine(**kw), prompts, block_len=8, max_tokens=19)
    _same_rows(rows, jrows, len(prompts))
    teacher = {r["data_id"]: r["teacher_output_ids"] for r in rows}
    for i, (p, o) in enumerate(zip(prompts, probe)):
        ids = o["token_ids"]
        if stop in ids:
            ids = ids[: ids.index(stop) + 1]
        assert teacher[f"data_{i}"] == p + ids  # greedy collection commits the AR stream


def test_greedy_collection_equals_jax_engine_demo():
    """The demo checkpoint in f32, 8 held-out prompts, N 32, max_tokens 96."""
    with open(os.path.join(DEMO, "tpf_demo.json")) as f:
        meta = json.load(f)
    with open(os.path.join(DEMO, "heldout_prompts.jsonl")) as f:
        prompts = [json.loads(line)["prompt_ids"] for line in f][:8]
    kw = dict(kvcache_page_size=16, max_model_len=512, jacobi_chunk_tokens=64,
              eos=int(meta["eos"]), prefill_token_buckets=(32, 64, 128, 256, 512))
    n, L = int(meta["max_tokens"]), int(meta["block_len"])
    llm = LLM(model=DEMO, device="cpu", dtype=torch.float32, num_kv_pages=1024, **kw)
    ar = llm.generate(prompts, SamplingParams(temperature=0.0, max_tokens=n))  # no host draw
    rows = collect_trajectories(llm.engine, prompts, block_len=L, max_tokens=n)
    mc, params = jload(DEMO, dtype=jnp.float32)
    jeng = JLLMEngine(JConfig(**kw), model_cfg=mc, params=params, num_kv_pages=1024)
    jrows = jcollect(jeng, prompts, block_len=L, max_tokens=n)
    _same_rows(rows, jrows, len(prompts))
    final = {r["data_id"]: r["teacher_output_ids"] for r in rows}
    assert [final[f"data_{i}"] for i in range(8)] == [p + o["token_ids"]
                                                      for p, o in zip(prompts, ar)]
    assert all(len(s) == L for r in rows for s in r["answer_trajectory_ids"])
    assert sum(len(r["answer_trajectory_ids"]) - 1 for r in rows) < sum(
        len(o["token_ids"]) for o in ar)  # the trained model commits > 1 token per iteration


# ---- the JacobiForcing loop ---------------------------------------------------------


def test_end_to_end_collect_pack_train():
    """Greedy trajectory collection on the tiny model -> noise-schedule packing
    -> the port's consistency train step (tests/test_data_pipeline.py)."""
    N = 8
    rows = collect_trajectories(make_engine(num_pages=256), make_prompts(256, sizes=(6, 9)),
                                block_len=N, max_tokens=2 * N, temperature=0.0)
    assert len(rows) >= 2
    for r in rows:
        assert set(r) >= {"data_id", "diffusion_itr_id", "prompt_ids",
                          "answer_trajectory_ids", "teacher_output_ids"}
        assert all(len(s) == N for s in r["answer_trajectory_ids"])
    packed = pack_trajectories(rows, N, window_size=4)
    assert packed
    cfg = ModelConfig.tiny(dtype=torch.float32)
    params = init_params(cfg, 0, device="cpu")
    tc = TrainConfig(N=N, seq_bucket=128, ar_pair_bucket=128, cons_pair_bucket=128)
    opt = AdamW(1e-4)
    step = make_train_step(cfg, tc, opt)
    opt_state = opt.init(params)
    rope = rope_table(cfg)
    for row in packed:
        T = len(row["traj_position_indices"])
        batch = {k: torch.as_tensor(v) for k, v in prepare_sample(
            row["complete_training_sequence_ids"], row["prompt_ids_len"], T, tc).items()}
        params, opt_state, metrics = step(params, opt_state, rope, batch)
        assert np.isfinite(float(metrics["loss"]))


def test_validate_learning_runs_on_the_cpu(capsys):
    args = validate_learning.make_parser().parse_args(
        ["--device", "cpu", "--rounds", "1", "--epochs", "2", "--n-prompts", "2"])
    res = validate_learning.run(args)
    assert len(res["history"]) == 2 and all(np.isfinite(res["history"]))
    assert res["tpf_before"] >= 1.0 and res["tpf_after"] >= 1.0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == res


# ---- tests/test_engine_stress.py ---------------------------------------------------


def test_mixed_all_strategies_one_engine():
    """AR + jacobi + non-greedy + MR + on-policy requests in one engine all
    complete with their budgets; the greedy rows equal dedicated engines'."""
    rng = np.random.RandomState(7)
    prompts = [rng.randint(1, 256, rng.randint(4, 20)).tolist() for _ in range(10)]
    kinds = [
        dict(temperature=0.0),
        dict(temperature=0.0, decode_strategy="jacobi", jacobi_block_len=8, jacobi_max_blocks=1),
        dict(temperature=0.8, decode_strategy="jacobi_nongreedy", jacobi_block_len=8,
             jacobi_max_blocks=1),
        dict(temperature=0.0, decode_strategy="jacobi_multiblock_rejection_recycling",
             jacobi_block_len=8, jacobi_max_blocks=2),
        dict(temperature=0.5, decode_strategy=OP, jacobi_block_len=8, jacobi_max_blocks=1,
             jacobi_max_iterations=8),
    ]
    sps = [SamplingParams(max_tokens=12, **kinds[i % 5]) for i in range(10)]
    outs = make_engine(num_pages=512).generate(prompts, sps)
    assert [len(o["token_ids"]) for o in outs] == [12] * 10
    assert all("rollout_records" in outs[i] for i in (4, 9))
    for i in (0, 1, 3):
        ref = make_engine(num_pages=512).generate([prompts[i]], sps[i])
        assert outs[i]["token_ids"] == ref[0]["token_ids"], i
