"""The port's data modules are its own copies of jax-free host code: the same
inputs and seeds must give rows equal to the originals', and the rows must
feed the port's trainer (`synthesize_trajectories_masking` ->
`pack_trajectories` -> `JacobianDataset` -> `train`)."""

import json
import random

import numpy as np
import pytest
import torch

from jacobiforcing_tpu.data import collect as jcollect
from jacobiforcing_tpu.data import filters as jfilters
from jacobiforcing_tpu.data import pack as jpack
from jacobiforcing_tpu.data import sft as jdsft
from jacobiforcing_tpu.data import tools as jtools
from jacobiforcing_tpu_torch import data as tdata
from jacobiforcing_tpu_torch.data import collect as tcollect
from jacobiforcing_tpu_torch.data import filters as tfilters
from jacobiforcing_tpu_torch.data import pack as tpack
from jacobiforcing_tpu_torch.data import sft as tdsft
from jacobiforcing_tpu_torch.data import tools as ttools
from jacobiforcing_tpu_torch.models.qwen import ModelConfig
from jacobiforcing_tpu_torch.train.trainer import JacobianDataset, TrainerArgs, train

N = 8


def _samples(seed, n=5, vocab=200):
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        p = r.randint(3, 12)
        resp = r.randint(1, 4 * N)
        ids = r.randint(1, vocab, p + resp).tolist()
        out.append({"prompt_ids": ids[:p], "full_ids": ids})
    out.append({"prompt_ids": [1, 2], "full_ids": [1, 2]})  # no response: skipped
    return out


@pytest.mark.parametrize("ratio", [1.0, 0.5])
def test_masking_synthesis_rows_equal(ratio):
    kw = dict(chunk_size=N, lookup_context_len=16, sequence_sampling_ratio=ratio, pad_id=0, seed=3)
    want = jcollect.synthesize_trajectories_masking(_samples(0), **kw)
    got = tcollect.synthesize_trajectories_masking(_samples(0), **kw)
    assert got == want and len(got) > 0
    assert tcollect.corrupt_chunk([5, 6, 7], 0, [1, 2, 5, 6, 7], 2, 4, 0, random.Random(1)) == \
        jcollect.corrupt_chunk([5, 6, 7], 0, [1, 2, 5, 6, 7], 2, 4, 0, random.Random(1))


@pytest.mark.parametrize("strategy", ["progressive", "random", "cyclic"])
def test_packed_rows_equal(strategy, tmp_path):
    traj = jcollect.synthesize_trajectories_masking(_samples(1), chunk_size=N, seed=0)
    kw = dict(window_size=4, min_noisy_ratio=0.0, max_noisy_ratio=1.0, strategy=strategy, seed=5)
    want = jpack.pack_trajectories(traj, N, **kw)
    got = tpack.pack_trajectories(traj, N, output_path=str(tmp_path / "p.jsonl"), **kw)
    assert got == want
    assert tdata.pack_trajectories is tpack.pack_trajectories
    assert [json.loads(line) for line in open(tmp_path / "p.jsonl")] == want
    for itr in range(6):
        assert tpack.select_noisy_state(traj[0]["answer_trajectory_ids"], itr, N, 4, 0.0, 1.0,
                                        "progressive") == \
            jpack.select_noisy_state(traj[0]["answer_trajectory_ids"], itr, N, 4, 0.0, 1.0,
                                     "progressive")
    with pytest.raises(ValueError):
        tpack.select_noisy_state(traj[0]["answer_trajectory_ids"], 0, N, 4, 0.0, 1.0, "other")


def test_filters_tools_and_sft_rows_equal(tmp_path):
    r = np.random.RandomState(2)
    rows = [{"average_test_score": float(r.rand() > 0.3), "llm_judgement_score": float(r.rand()),
             "complete_training_sequence_ids": list(range(r.randint(1, 40))), "i": i}
            for i in range(30)]
    length = lambda row: len(row["complete_training_sequence_ids"])
    assert tfilters.filter_by_quality(rows, top_n=7) == jfilters.filter_by_quality(rows, top_n=7)
    assert tfilters.bucket_by_length(rows, length, 8) == jfilters.bucket_by_length(rows, length, 8)
    assert tfilters.filter_by_token_length(rows, 20) == jfilters.filter_by_token_length(rows, 20)
    assert tfilters.reservoir_downsample(rows, 9, seed=4) == \
        jfilters.reservoir_downsample(rows, 9, seed=4)

    traj = jcollect.synthesize_trajectories_masking(_samples(3), chunk_size=N, seed=0)
    assert ttools.profile_trajectory_dataset(traj) == jtools.profile_trajectory_dataset(traj)
    packed = jpack.pack_trajectories(traj, N)
    assert ttools.debug_decode_packed_row(packed[0], N) == jtools.debug_decode_packed_row(packed[0], N)
    for i, part in enumerate((traj[:3], traj[3:])):
        with open(tmp_path / f"shard{i}.jsonl", "w") as f:
            f.writelines(json.dumps(row) + "\n" for row in part)
    n = ttools.merge_jsonl([str(tmp_path / "shard*.jsonl")], str(tmp_path / "merged.jsonl"))
    assert n == len(traj) and list(ttools.iter_jsonl(str(tmp_path / "merged.jsonl"))) == traj

    want = jdsft.make_sft_rows(traj)
    assert tdsft.make_sft_rows(traj) == want
    a, b = tdsft.sft_batch(want, 48, mask_prompt=True), jdsft.sft_batch(want, 48, mask_prompt=True)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_synthesize_pack_dataset_train(tmp_path):
    """The data path of the trainer end to end on the CPU, through the
    block-sparse attention path (its plain version here)."""
    traj = tcollect.synthesize_trajectories_masking(_samples(4, n=4), chunk_size=N, seed=1)
    tpack.pack_trajectories(traj, N, output_path=str(tmp_path / "rows.jsonl"))
    ds = JacobianDataset(str(tmp_path / "rows.jsonl"))
    assert len(ds) == 4
    row = ds[0]
    assert len(row["input_ids"]) == row["prompt_len"] + 2 * row["T"] * N
    # a JSON array is read as well as JSON lines
    with open(tmp_path / "rows.json", "w") as f:
        json.dump(ds.rows, f)
    assert JacobianDataset(str(tmp_path / "rows.json")).rows == ds.rows

    cfg = ModelConfig.tiny(dtype=torch.float32)
    args = TrainerArgs(data_path=str(tmp_path / "rows.jsonl"), output_dir=str(tmp_path / "out"),
                       max_new_tokens=N, seq_bucket=128, attn_impl="splash", max_steps=8,
                       save_steps=0, log_steps=1, learning_rate=1e-3, resume=False)
    res = train(args, model_cfg=cfg, device="cpu", log_fn=lambda *_: None)
    losses = [h["loss"] for h in res["history"]]
    assert res["step"] == 8 and np.isfinite(losses).all()
    assert min(losses[4:]) < losses[1]  # step 1 runs at learning rate 0
