"""Training loop: dataset, optimizer schedule, checkpoint and resume.

PyTorch port of `jacobiforcing_tpu/train/trainer.py`: one entry point for the
single / multiblock / window variants, AdamW (b1 0.9, b2 0.95) under a
warm-up + cosine schedule, a plain step loop over one packed row per step.

Checkpoint layout: <output_dir>/checkpoint-<step>/ with HF-format
model.safetensors + config.json (so the serving engine loads it directly) plus
the optimizer state (`opt_state.pt`, written by `torch.save`) and
`trainer_state.json`; resume picks the latest checkpoint-*.
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
from jacobiforcing_tpu_torch.train.consistency import (
    TrainConfig,
    make_train_step,
    prepare_sample,
)
from jacobiforcing_tpu_torch.train.optim import AdamW, OptState, warmup_cosine_schedule
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
    # Packed samples per optimizer step; more than one needs a mesh, which the
    # port does not have yet.
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


def save_train_checkpoint(path: str, cfg: ModelConfig, params, opt_state: OptState, step: int):
    os.makedirs(path, exist_ok=True)
    save_checkpoint(path, cfg, params)
    torch.save(opt_state.state_dict(), os.path.join(path, "opt_state.pt"))
    with open(os.path.join(path, "trainer_state.json"), "w") as f:
        json.dump({"step": step}, f)


def load_train_checkpoint(path: str, cfg: ModelConfig, optimizer: AdamW, device="cuda"):
    """(params, opt_state, step) of a checkpoint this trainer wrote."""
    _, params = load_checkpoint(path, dtype=cfg.dtype, device=device)
    opt_state = optimizer.init(params)
    # the file holds tensors, numbers and containers only
    sd = torch.load(os.path.join(path, "opt_state.pt"), map_location=resolve_device(device),
                    weights_only=True)
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
    mesh=None,
    device="cuda",
    log_fn=print,
) -> Dict[str, Any]:
    """Run the training loop on `device`; returns {params, history, step}.

    `params` given are trained in place.  A `mesh` (data-parallel / fsdp
    training) is not ported yet and raises."""
    if mesh is not None or args.global_batch > 1:
        raise NotImplementedError("data-parallel / fsdp training over a mesh is not ported yet")
    dev = resolve_device(device)
    if params is None:
        if args.target_model_path:
            model_cfg, params = load_checkpoint(args.target_model_path, device=dev)
        else:
            if model_cfg is None:
                raise ValueError("train() needs model_cfg, params or args.target_model_path")
            params = init_params(model_cfg, args.seed, device=dev)
    dataset = dataset if dataset is not None else JacobianDataset(args.data_path)
    rope = rope_table(model_cfg, device=dev)

    # max_steps (when set) is authoritative; otherwise num_epochs bounds
    steps_per_epoch = max(len(dataset), 1)
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
    step_fn = make_train_step(model_cfg, tc, optimizer)

    start_step = 0
    opt_state = None
    if args.resume:
        ckpt = latest_checkpoint(args.output_dir)
        if ckpt:
            params, opt_state, start_step = load_train_checkpoint(ckpt, model_cfg, optimizer, dev)
            log_fn(f"[train] resumed from {ckpt} at step {start_step}")
    if opt_state is None:
        opt_state = optimizer.init(params)

    history: List[Dict[str, float]] = []
    step = start_step
    t0 = time.perf_counter()
    order = np.arange(len(dataset))
    done = False
    for epoch in range(n_epochs):
        if done:
            break
        np.random.RandomState(args.seed + epoch).shuffle(order)
        for i in order:
            if step >= n_total:
                done = True
                break
            r = dataset[int(i)]
            batch_np = prepare_sample(r["input_ids"], r["prompt_len"], r["T"], tc,
                                      eos_id=eos_id, pad_id=pad_id)
            batch = {k: torch.as_tensor(v, device=dev) for k, v in batch_np.items()}
            layout = (
                (int(batch_np["prompt_len"]), int(batch_np["T"]), int(batch_np["seq_len"]))
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
                _wandb_log(m)
            if args.save_steps > 0 and step % args.save_steps == 0:
                save_train_checkpoint(
                    os.path.join(args.output_dir, f"checkpoint-{step}"),
                    model_cfg, params, opt_state, step,
                )
    if args.output_dir:
        save_train_checkpoint(
            os.path.join(args.output_dir, f"checkpoint-{step}"),
            model_cfg, params, opt_state, step,
        )
    return {"params": params, "history": history, "step": step}
