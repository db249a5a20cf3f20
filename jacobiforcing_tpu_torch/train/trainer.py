"""Training loop: dataset, optimizer schedule, checkpoint and resume.

PyTorch port of `jacobiforcing_tpu/train/trainer.py`: one entry point for the
single / multiblock / window variants, AdamW (b1 0.9, b2 0.95) under a
warm-up + cosine schedule, a plain step loop over one packed row per step, or
over a (data, model) mesh `global_batch` rows per step, the rank's fsdp
blocks of the weights and moments in its memory (ZeRO-3; every rank of the
mesh calls `train` with the same arguments).

Checkpoint layout: <output_dir>/checkpoint-<step>/ with HF-format
model.safetensors + config.json (so the serving engine loads it directly) plus
the optimizer state (`opt_state.pt`, written by `torch.save`) and
`trainer_state.json`; resume picks the latest checkpoint-* and continues the
data order where it stopped.  From a mesh the whole weights and moments are
gathered and the rank at (0, 0) writes them, so a checkpoint is the same
files whatever mesh wrote it and resumes on any mesh (or none).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from jacobiforcing_tpu_torch.models.qwen import ModelConfig, init_params, rope_table
from jacobiforcing_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from jacobiforcing_tpu_torch.parallel.sharding import (
    is_full,
    param_specs,
    shard_array,
    shard_params,
    unshard_array,
)
from jacobiforcing_tpu_torch.train.consistency import (
    TrainConfig,
    make_train_step,
    prepare_sample,
)
from jacobiforcing_tpu_torch.train.optim import (
    AdamW,
    OptState,
    param_leaves,
    warmup_cosine_schedule,
)
from jacobiforcing_tpu_torch.utils.device import resolve_device
from jacobiforcing_tpu_torch.utils.loader import load_checkpoint, save_checkpoint


@dataclasses.dataclass
class TrainerArgs:
    target_model_path: str = ""
    data_path: str = ""
    output_dir: str = "out"
    max_new_tokens: int = 32  # N
    variant: str = "single"
    window_size: int = 4
    attn_impl: str = "dense"  # "splash" for block-sparse 16k-scale packs
    learning_rate: float = 1e-5
    min_lr_ratio: float = 0.05  # cosine floor (reference: 1e-5 -> 5e-7)
    warmup_steps: int = 10
    num_epochs: int = 1
    max_steps: int = -1
    save_steps: int = 500
    log_steps: int = 10
    seed: int = 0
    distill_temperature: float = 1.0
    seq_bucket: int = 4096
    resume: bool = True
    remat: bool = False  # gradient checkpointing over layers
    # Global batch: packed samples consumed per optimizer step.  With a mesh,
    # samples shard over the "data" axis (the reference's torchrun 4-8 rank
    # data parallelism); 0 = auto (one sample per data-axis row).  Without a
    # mesh more than one raises.
    global_batch: int = 0


class JacobianDataset:
    """Lazy JSONL rows: {prompt_ids, prompt_ids_len, complete_training_sequence_ids,
    traj_position_indices} (the packer's output, `data/pack.py`)."""

    def __init__(self, path: str):
        self.rows: List[dict] = []
        with open(path) as f:
            first = f.read(1)
            f.seek(0)
            if first == "[":
                self.rows = json.load(f)
            else:
                for line in f:
                    line = line.strip()
                    if line:
                        self.rows.append(json.loads(line))

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i) -> dict:
        r = self.rows[i]
        return {
            "input_ids": r["complete_training_sequence_ids"],
            "prompt_len": int(r["prompt_ids_len"]),
            "T": len(r["traj_position_indices"]),
        }


def _wandb_log(metrics: Dict[str, float]) -> None:
    """wandb train-loss logging when WANDB_PROJECT is set and wandb is
    installed; skipped otherwise."""
    if not os.environ.get("WANDB_PROJECT"):
        return
    try:
        import wandb
    except ImportError:
        return
    if wandb.run is None:
        wandb.init(project=os.environ["WANDB_PROJECT"])
    wandb.log(metrics)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    if not os.path.isdir(output_dir):
        return None
    cands = [
        d for d in os.listdir(output_dir)
        if d.startswith("checkpoint-") and os.path.isdir(os.path.join(output_dir, d))
    ]
    if not cands:
        return None
    latest = max(cands, key=lambda d: int(d.split("-")[1]))
    return os.path.join(output_dir, latest)


def save_train_checkpoint(path: str, cfg: ModelConfig, params, opt_state: OptState, step: int,
                          mesh: Optional[Mesh] = None):
    """Write a checkpoint.  From a mesh `params` and the moments are the
    rank's fsdp blocks: every rank gathers each whole leaf (collective), the
    rank at (0, 0) writes the files from host copies, and every rank returns
    once they are written."""
    if mesh is not None:
        params, state = _whole(params, opt_state, cfg, mesh)
        if mesh.coords == (0, 0):
            _write(path, cfg, params, state, step)
        mesh.barrier()
        return
    _write(path, cfg, params, opt_state.state_dict(), step)


def _write(path: str, cfg: ModelConfig, params, opt_state_dict, step: int):
    os.makedirs(path, exist_ok=True)
    save_checkpoint(path, cfg, params)
    torch.save(opt_state_dict, os.path.join(path, "opt_state.pt"))
    with open(os.path.join(path, "trainer_state.json"), "w") as f:
        json.dump({"step": step}, f)


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _whole(params, opt_state: OptState, cfg: ModelConfig, mesh: Mesh):
    """(whole params, whole optimizer state dict) from the rank's fsdp blocks,
    on the host at (0, 0) (None elsewhere); collective over the mesh."""
    writer = mesh.coords == (0, 0)
    specs = param_specs(cfg, fsdp=True)

    def whole(t, spec):
        t = unshard_array(t, spec, mesh)
        return t.cpu() if writer else None

    full = {k: ({n: whole(t, specs[k][n]) for n, t in v.items()} if isinstance(v, dict)
                else whole(v, specs[k])) for k, v in params.items()}
    sd = opt_state.state_dict()
    leaf_specs = param_leaves(specs)
    # the state dict holds the optimizer's live per-parameter dicts: copy them
    state = {i: {**s, **{m: whole(s[m], leaf_specs[i]) for m in _MOMENTS}}
             for i, s in sd["opt"]["state"].items()}
    return full, {"opt": {"state": state, "param_groups": sd["opt"]["param_groups"]},
                  "count": sd["count"]}


def load_train_checkpoint(path: str, cfg: ModelConfig, optimizer: AdamW, device="cuda",
                          mesh: Optional[Mesh] = None):
    """(params, opt_state, step) of a checkpoint this trainer wrote; over a
    mesh the weights and moments are cut to the rank's fsdp blocks on the
    host first."""
    dev = resolve_device(device)
    _, params = load_checkpoint(path, dtype=cfg.dtype, device=dev, mesh=mesh, fsdp=True)
    opt_state = optimizer.init(params)
    # the file holds tensors, numbers and containers only
    sd = torch.load(os.path.join(path, "opt_state.pt"),
                    map_location=dev if mesh is None else "cpu", weights_only=True)
    if mesh is not None:
        leaf_specs = param_leaves(param_specs(cfg, fsdp=True))
        for i, s in sd["opt"]["state"].items():
            for m in _MOMENTS:
                s[m] = shard_array(s[m], leaf_specs[i], mesh)
    opt_state.load_state_dict(sd)
    with open(os.path.join(path, "trainer_state.json")) as f:
        step = json.load(f)["step"]
    return params, opt_state, step


def train(
    args: TrainerArgs,
    *,
    model_cfg: Optional[ModelConfig] = None,
    params: Optional[Dict[str, Any]] = None,
    dataset: Optional[Any] = None,
    eos_id: int = -1,
    pad_id: int = 0,
    mesh: Optional[Mesh] = None,
    device="cuda",
    log_fn=print,
) -> Dict[str, Any]:
    """Run the training loop on `device`; returns {params, history, step}.

    Without a mesh `params` given are trained in place.  With a `mesh`
    (`parallel/mesh.py`; every rank of it calls `train` alike) each
    optimizer step consumes `global_batch` packed samples (default: one per
    data rank; it must divide by dp, and more than one needs dense
    attention, whose layout is per sample), sample i on data rank i // (gb /
    dp); the weights are the rank's fsdp blocks (`params` may be the whole
    weights, which are cut, or the blocks) and so are the returned ones
    (reference: torchrun ranks + DeepSpeed ZeRO-3,
    train_jacobi_forcing_coder_n32.sh:10-38)."""
    gb = 1
    if mesh is not None:
        if mesh.coords is None:
            raise ValueError("this rank lies outside the mesh")
        dp = mesh.shape[DATA_AXIS]
        gb = args.global_batch if args.global_batch > 0 else dp
        if gb % dp:
            raise ValueError(f"global_batch {gb} does not divide by dp={dp}")
        if gb > 1 and args.attn_impl != "dense":
            raise ValueError("a global batch of more than one row needs attn_impl='dense': "
                             "the block-sparse attention's layout is one row's")
    elif args.global_batch > 1:
        raise ValueError("global_batch > 1 needs a mesh (parallel.make_mesh)")
    dev = resolve_device(device)
    if params is None:
        if args.target_model_path:
            model_cfg, params = load_checkpoint(args.target_model_path, device=dev, mesh=mesh,
                                                fsdp=True)
        else:
            if model_cfg is None:
                raise ValueError("train() needs model_cfg, params or args.target_model_path")
            params = init_params(model_cfg, args.seed, device=dev)
    if mesh is not None and is_full(params, model_cfg):
        params = shard_params(params, model_cfg, mesh, fsdp=True)
    dataset = dataset if dataset is not None else JacobianDataset(args.data_path)
    rope = rope_table(model_cfg, device=dev)

    # max_steps (when set) is authoritative; otherwise num_epochs bounds
    steps_per_epoch = max(len(dataset) // gb, 1)
    if args.max_steps > 0:
        n_total = args.max_steps
        n_epochs = (args.max_steps + steps_per_epoch - 1) // steps_per_epoch + 1
    else:
        n_total = steps_per_epoch * args.num_epochs
        n_epochs = args.num_epochs
    schedule = warmup_cosine_schedule(
        init_value=0.0,
        peak_value=args.learning_rate,
        warmup_steps=min(args.warmup_steps, max(n_total // 10, 1)),
        decay_steps=max(n_total, 1),
        end_value=args.learning_rate * args.min_lr_ratio,
    )
    optimizer = AdamW(schedule, b1=0.9, b2=0.95)

    tc = TrainConfig(
        N=args.max_new_tokens,
        variant=args.variant,
        window_size=args.window_size,
        ar_weight=10.0 if args.variant == "single" else 1.0,
        distill_temperature=args.distill_temperature,
        seq_bucket=args.seq_bucket,
        attn_impl=args.attn_impl,
        remat=args.remat,
    )
    step_fn = make_train_step(model_cfg, tc, optimizer, mesh)

    start_step = 0
    opt_state = None
    if args.resume:
        ckpt = latest_checkpoint(args.output_dir)
        if ckpt:
            params, opt_state, start_step = load_train_checkpoint(ckpt, model_cfg, optimizer, dev,
                                                                  mesh)
            log_fn(f"[train] resumed from {ckpt} at step {start_step}")
    if opt_state is None:
        opt_state = optimizer.init(params)

    def save(step):
        save_train_checkpoint(os.path.join(args.output_dir, f"checkpoint-{step}"), model_cfg,
                              params, opt_state, step, mesh)

    history: List[Dict[str, float]] = []
    step = start_step
    t0 = time.perf_counter()
    order = np.arange(len(dataset))
    seen = 0  # batches walked, those consumed before the checkpoint included
    done = False
    for epoch in range(n_epochs):
        if done:
            break
        np.random.RandomState(args.seed + epoch).shuffle(order)
        for g in range(0, len(order) - gb + 1, gb):
            seen += 1
            if seen <= start_step:
                continue
            if step >= n_total:
                done = True
                break
            samples = [prepare_sample(r["input_ids"], r["prompt_len"], r["T"], tc, eos_id=eos_id,
                                      pad_id=pad_id)
                       for r in (dataset[int(i)] for i in order[g:g + gb])]
            if mesh is None:
                batch = {k: torch.as_tensor(v, device=dev) for k, v in samples[0].items()}
            else:
                batch = {k: torch.as_tensor(np.stack([s_[k] for s_ in samples]), device=dev)
                         for k in samples[0]}
            first = samples[0]
            layout = (
                (int(first["prompt_len"]), int(first["T"]), int(first["seq_len"]))
                if tc.attn_impl == "splash" else None
            )
            params, opt_state, metrics = step_fn(params, opt_state, rope, batch, layout)
            step += 1
            if step % args.log_steps == 0 or step == n_total:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["steps_per_s"] = step / max(time.perf_counter() - t0, 1e-9)
                history.append(m)
                log_fn(f"[train] {m}")
                if mesh is None or mesh.coords == (0, 0):
                    _wandb_log(m)
            if args.save_steps > 0 and step % args.save_steps == 0:
                save(step)
    if args.output_dir:
        save(step)
    return {"params": params, "history": history, "step": step}
