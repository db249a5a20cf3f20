"""Jacobi-Forcing consistency trainer: AR + progressive-consistency loss over
packed noise-scheduled trajectory sequences.

PyTorch port of `jacobiforcing_tpu/train/consistency.py`:

  * packed layout `[prompt][k_0][last_0]...[k_{T-1}][last_{T-1}]`, each block of
    length N;
  * the visibility mask: prompt causal; k_j sees prompt + all previous last_* +
    itself causally; last_j likewise; the multiblock variant lets k_j also see
    previous k_*; the windowed variant restricts that to k_* within the same
    window of `window_size` pairs.  `attn_impl="dense"` builds it as an [L, L]
    tensor (research scale); `attn_impl="splash"` never builds it: the
    block-sparse kernels of `ops/train_attention.py` compute it from the layout;
  * shared RoPE positions: k_j and last_j occupy the same positions;
  * AR loss: next-token CE over prompt + each last_j with inter-block bridge
    pairs, EOS-truncated, PAD masked, x10 weight (x1 for the multiblock
    variants);
  * consistency loss: soft CE between student logits at k_j offsets and
    detached teacher logits at matching last_j offsets, keeping only offsets
    from the first k/l divergence on, scaled by T_soft^2 / T.

Host-side index preparation (`prepare_sample`, numpy only) produces
fixed-shape padded index arrays.  One packed sample per step (batch 1, as the
reference trains); data-parallel training over a mesh is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from jacobiforcing_tpu_torch.models.qwen import ModelConfig, forward_dense, logits_at
from jacobiforcing_tpu_torch.ops.train_attention import train_mask
from jacobiforcing_tpu_torch.train.optim import AdamW, OptState


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Static training hyper-parameters."""

    N: int = 32  # n_token_seq_len, block length
    variant: str = "single"  # "single" | "multiblock" | "window"
    window_size: int = 4
    ar_weight: float = 10.0  # reference uses x10 (single) / x1 (multiblock)
    distill_temperature: float = 1.0
    max_pairs: int = 32  # T bucket
    seq_bucket: int = 1024  # L bucket
    ar_pair_bucket: int = 1024
    cons_pair_bucket: int = 1024
    # "dense" = [L, L] mask attention (research scale);
    # "splash" = block-sparse attention kernels (16k production packs), which
    # take the layout (prompt_len, T, seq_len) of each row as host integers.
    attn_impl: str = "dense"
    remat: bool = False  # gradient checkpointing over layers


# ---------------------------------------------------------------------------
# Device-side mask + positions
# ---------------------------------------------------------------------------


def build_train_mask(L: int, prompt_len, T, seq_len, N: int, variant: str = "single",
                     window_size: int = 4, device="cpu") -> torch.Tensor:
    """[L, L] bool mask (True = attend); the scalars may be ints or 0-d tensors."""
    idx = torch.arange(L, dtype=torch.int32, device=device)
    return train_mask(idx[:, None], idx[None, :], prompt_len, T, seq_len, N, variant, window_size)


def shared_position_ids(L: int, prompt_len, N: int, device="cpu") -> torch.Tensor:
    """[L] RoPE positions; k_j and last_j share positions."""
    idx = torch.arange(L, dtype=torch.int32, device=device)
    rel = idx - prompt_len
    rel0 = rel.clamp(min=0)
    pos_pair = prompt_len + (rel0 // N // 2) * N + rel0 % N
    return torch.where(rel < 0, idx, pos_pair)


# ---------------------------------------------------------------------------
# Host-side sample preparation
# ---------------------------------------------------------------------------


def prepare_sample(
    input_ids: List[int],
    prompt_len: int,
    T: int,
    tc: TrainConfig,
    eos_id: int = -1,
    pad_id: int = 0,
) -> Dict[str, np.ndarray]:
    """Build fixed-shape index arrays for one packed row.

    Mirrors the reference's pair construction exactly:
      * METHOD 1 post-EOS PAD flip on the final last block
      * AR pairs: prompt, bridge (prompt/last_{j-1} -> last_j[0]), in-last-block
        pairs EOS-truncated
      * consistency pairs: k_j/last_j offsets from first divergence, with
        PAD + duplicate-prefix loss mask
    """
    N = tc.N
    ids = np.asarray(input_ids, np.int32).copy()
    L_actual = prompt_len + 2 * T * N
    assert len(ids) == L_actual, (len(ids), L_actual)
    k_starts = [prompt_len + 2 * j * N for j in range(T)]
    l_starts = [prompt_len + (2 * j + 1) * N for j in range(T)]

    # METHOD 1: PAD tokens after the first EOS in the FINAL last block
    if eos_id >= 0 and T > 0:
        blk = ids[l_starts[-1] : l_starts[-1] + N]
        epos = np.flatnonzero(blk == eos_id)
        if epos.size:
            blk[epos[0] + 1 :] = pad_id
            ids[l_starts[-1] : l_starts[-1] + N] = blk

    # ---- AR pairs ----
    ar_p: List[int] = []
    ar_t: List[int] = []

    def add_pairs(s: int, e: int):
        ar_p.extend(range(s, e - 1))
        ar_t.extend(range(s + 1, e))

    add_pairs(0, prompt_len)
    for j in range(T):
        ls = l_starts[j]
        logit_pos = prompt_len - 1 if j == 0 else l_starts[j - 1] + N - 1
        ar_p.append(logit_pos)
        ar_t.append(ls)
        block = ids[ls : ls + N]
        end = N
        if eos_id >= 0:
            epos = np.flatnonzero(block == eos_id)
            if epos.size:
                end = min(end, int(epos[0]) + 1)
        add_pairs(ls, ls + end)

    ar_targets = ids[ar_t]
    ar_valid = ar_targets != pad_id

    # ---- consistency pairs ----
    cons_s: List[int] = []
    cons_t: List[int] = []
    offs = np.arange(N - 1)
    for j in range(T):
        ks, ls = k_starts[j], l_starts[j]
        kb = ids[ks : ks + N]
        lb = ids[ls : ls + N]
        diff = kb[: N - 1] != lb[: N - 1]
        if diff.any():
            first_diff = int(np.flatnonzero(diff)[0])
            keep = offs >= first_diff
        else:
            keep = np.zeros(N - 1, bool)
        # PAD mask on the student side (dup-prefix already excluded by keep)
        keep &= ids[ks + offs] != pad_id
        cons_s.extend((ks + offs[keep]).tolist())
        cons_t.extend((ls + offs[keep]).tolist())

    def pad_to(arr, n, fill):
        out = np.full((n,), fill, np.int32)
        out[: min(len(arr), n)] = np.asarray(arr[:n], np.int32)
        return out

    ids_padded = np.full((tc.seq_bucket,), pad_id, np.int32)
    ids_padded[:L_actual] = ids
    Ka, Kc = tc.ar_pair_bucket, tc.cons_pair_bucket
    return {
        "input_ids": ids_padded,
        "prompt_len": np.int32(prompt_len),
        "T": np.int32(T),
        "seq_len": np.int32(L_actual),
        "ar_p": pad_to(ar_p, Ka, 0),
        "ar_t": pad_to(ar_targets, Ka, pad_id),
        "ar_valid": pad_to(ar_valid.astype(np.int32), Ka, 0),
        "cons_s": pad_to(cons_s, Kc, 0),
        "cons_t": pad_to(cons_t, Kc, 0),
        "cons_valid": pad_to(np.ones(len(cons_s), np.int32), Kc, 0),
    }


# ---------------------------------------------------------------------------
# Loss + train step
# ---------------------------------------------------------------------------


def consistency_losses(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tc: TrainConfig,
    rope,
    batch: Dict[str, torch.Tensor],
    static_layout: Optional[Tuple[int, int, int]] = None,  # (prompt_len, T, seq_len)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward one packed sample (bs=1 like the reference) and compute losses."""
    ids = batch["input_ids"][None, :]  # [1, L]
    L = ids.shape[1]
    dev = ids.device
    pos = shared_position_ids(L, batch["prompt_len"], tc.N, dev)[None]
    if tc.attn_impl == "splash":
        if static_layout is None:
            raise ValueError("splash attention needs a static layout (prompt_len, T, seq_len)")
        p_len, t_pairs, seq_len = static_layout
        spec = (p_len, t_pairs, seq_len, tc.N, tc.variant, tc.window_size)
        h = forward_dense(params, cfg, ids, pos, rope, splash_spec=spec, remat=tc.remat)[0]
    else:
        mask = build_train_mask(L, batch["prompt_len"], batch["T"], batch["seq_len"], tc.N,
                                tc.variant, tc.window_size, dev)[None]
        h = forward_dense(params, cfg, ids, pos, rope, mask, remat=tc.remat)[0]

    # AR loss (x ar_weight)
    h_ar = h[batch["ar_p"].long()]  # [Ka, H]
    ar_logits = logits_at(params, cfg, h_ar)
    logp = torch.log_softmax(ar_logits, dim=-1)
    nll = -torch.gather(logp, 1, batch["ar_t"].long()[:, None])[:, 0]
    w = batch["ar_valid"].to(nll.dtype)
    loss_ar = torch.sum(nll * w) / torch.clamp(torch.sum(w), min=1.0) * tc.ar_weight

    # consistency loss: student k_j offsets vs detached teacher last_j offsets
    Ts = tc.distill_temperature
    h_s = h[batch["cons_s"].long()]
    s_logits = logits_at(params, cfg, h_s) / Ts
    with torch.no_grad():
        t_logits = logits_at(params, cfg, h[batch["cons_t"].long()]) / Ts
        t_prob = torch.softmax(t_logits, dim=-1)
    s_logp = torch.log_softmax(s_logits, dim=-1)
    ent = -torch.sum(t_prob * s_logp, dim=-1)  # [Kc]
    cw = batch["cons_valid"].to(ent.dtype)
    n_cons = torch.sum(cw)
    loss_cons = torch.sum(ent * cw) / torch.clamp(n_cons, min=1.0)
    loss_cons = loss_cons * (Ts * Ts) / torch.clamp(batch["T"].to(ent.dtype), min=1.0)
    loss_cons = torch.where(n_cons > 0, loss_cons, torch.zeros_like(loss_cons))

    total = loss_ar + loss_cons
    return total, {"loss_ar": loss_ar, "loss_consistency": loss_cons}


def grad_views(params: Dict[str, Any], state: OptState) -> Dict[str, Any]:
    """The parameter dict as autograd leaves whose gradients accumulate straight
    into the optimizer state's buffers.  A layer-stacked tensor becomes a list
    of per-layer leaves (views of the same storage, `.grad` a view of the
    stacked buffer), so the backward of layer i writes slice i and never
    builds a zero tensor of the whole stack, as differentiating `stack[i]`
    would for every layer."""
    for p in state.leaves:
        p.grad.zero_()

    def leaf(x: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        y = x.detach().requires_grad_()
        y.grad = grad
        return y

    out: Dict[str, Any] = {}
    for name, v in params.items():
        if isinstance(v, dict):
            out[name] = {k: [leaf(t[i], t.grad[i]) for i in range(t.shape[0])]
                         for k, t in v.items()}
        else:
            out[name] = leaf(v, v.grad)
    return out


def make_train_step(cfg: ModelConfig, tc: TrainConfig, optimizer: AdamW, mesh=None) -> Callable:
    """(params, opt_state, rope, batch[, static_layout]) -> (params, opt_state,
    metrics) for ONE packed sample (`prepare_sample` output as tensors, no
    leading batch dim).  `static_layout` is required only with
    `tc.attn_impl == "splash"`.  The parameters and the optimizer state are
    updated in place (the JAX step donates its buffers) and returned; the
    metrics are 0-d tensors on the parameters' device."""
    if mesh is not None:
        raise NotImplementedError("data-parallel / fsdp training over a mesh is not ported yet")

    def step(params, opt_state, rope, batch, static_layout=None):
        leaves = grad_views(params, opt_state)
        loss, metrics = consistency_losses(leaves, cfg, tc, rope, batch, static_layout)
        loss.backward()
        optimizer.apply(opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return step
