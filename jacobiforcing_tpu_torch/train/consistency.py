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
fixed-shape padded index arrays.  Without a mesh a step takes one packed
sample (batch 1, as the reference trains).  Over a (data, model) mesh
(`parallel/mesh.py`) every rank runs the same step on a global batch of B
samples, SPMD: the rank takes its B / dp samples (sample i goes to data index
i // (B / dp), as the JAX "data" sharding places a stacked batch), the loss is
the mean over B of the per-sample losses, and the parameters are the rank's
fsdp blocks (`shard_params(..., fsdp=True)`): ZeRO-3, the reference's
torchrun ranks under DeepSpeed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from jacobiforcing_tpu_torch.models.qwen import ModelConfig, forward_dense, logits_at
from jacobiforcing_tpu_torch.ops.train_attention import train_mask
from jacobiforcing_tpu_torch.parallel.collectives import Group, reduce_sum
from jacobiforcing_tpu_torch.parallel.mesh import DATA_AXIS, Mesh
from jacobiforcing_tpu_torch.parallel.sharding import fsdp_gather, param_specs
from jacobiforcing_tpu_torch.train.optim import AdamW, OptState

Gather = Optional[Callable[[str, torch.Tensor], torch.Tensor]]


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
    """[L, L] bool mask (True = attend); the scalars may be ints or 0-d tensors,
    or [b, 1, 1] tensors for a [b, L, L] mask."""
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
    *,
    group: Group = None,
    gather: Gather = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Forward one packed sample (bs=1 like the reference) and compute losses."""
    totals, metrics = batch_losses(params, cfg, tc, rope, {k: v[None] for k, v in batch.items()},
                                   static_layout, group=group, gather=gather)
    return totals[0], {k: v[0] for k, v in metrics.items()}


def _head_params(params: Dict[str, Any], cfg: ModelConfig, gather: Gather) -> Dict[str, Any]:
    """The leaf `logits_at` reads, gathered whole under fsdp."""
    name = "embed" if cfg.tie_word_embeddings else "lm_head"
    return {name: params[name] if gather is None else gather(name, params[name])}


def batch_losses(
    params: Dict[str, Any],
    cfg: ModelConfig,
    tc: TrainConfig,
    rope,
    batch: Dict[str, torch.Tensor],  # prepare_sample outputs stacked: [b, ...]
    static_layout: Optional[Tuple[int, int, int]] = None,
    *,
    group: Group = None,  # the model group (tensor parallelism)
    gather: Gather = None,  # fsdp: a rank's block -> the whole weight
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Per-sample (total [b], {loss_ar, loss_consistency} [b]) of b packed
    samples in one forward (the JAX mesh step's `vmap`): each sample is
    normalized on its own.  Splash attention takes one sample."""
    ids = batch["input_ids"]  # [b, L]
    b, L = ids.shape
    dev = ids.device
    p_len = batch["prompt_len"][:, None]
    pos = shared_position_ids(L, p_len, tc.N, dev)
    if tc.attn_impl == "splash":
        if static_layout is None:
            raise ValueError("splash attention needs a static layout (prompt_len, T, seq_len)")
        p_len, t_pairs, seq_len = static_layout
        spec = (p_len, t_pairs, seq_len, tc.N, tc.variant, tc.window_size)
        h = forward_dense(params, cfg, ids, pos, rope, splash_spec=spec, remat=tc.remat,
                          group=group, gather=gather)
    else:
        lay = [batch[k][:, None, None] for k in ("prompt_len", "T", "seq_len")]
        mask = build_train_mask(L, *lay, tc.N, tc.variant, tc.window_size, dev)  # [b, L, L]
        h = forward_dense(params, cfg, ids, pos, rope, mask, remat=tc.remat, group=group,
                          gather=gather)
    head = _head_params(params, cfg, gather)
    rows = torch.arange(b, device=dev)[:, None]

    # AR loss (x ar_weight)
    h_ar = h[rows, batch["ar_p"].long()]  # [b, Ka, H]
    ar_logits = logits_at(head, cfg, h_ar, group)
    logp = torch.log_softmax(ar_logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["ar_t"].long()[..., None])[..., 0]
    w = batch["ar_valid"].to(nll.dtype)
    loss_ar = torch.sum(nll * w, -1) / torch.clamp(torch.sum(w, -1), min=1.0) * tc.ar_weight

    # consistency loss: student k_j offsets vs detached teacher last_j offsets
    Ts = tc.distill_temperature
    h_s = h[rows, batch["cons_s"].long()]
    s_logits = logits_at(head, cfg, h_s, group) / Ts
    with torch.no_grad():
        t_logits = logits_at(head, cfg, h[rows, batch["cons_t"].long()], group) / Ts
        t_prob = torch.softmax(t_logits, dim=-1)
    s_logp = torch.log_softmax(s_logits, dim=-1)
    ent = -torch.sum(t_prob * s_logp, dim=-1)  # [b, Kc]
    cw = batch["cons_valid"].to(ent.dtype)
    n_cons = torch.sum(cw, -1)
    loss_cons = torch.sum(ent * cw, -1) / torch.clamp(n_cons, min=1.0)
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


def reduce_grads(params: Dict[str, Any], cfg: ModelConfig, data: Group, model: Group, *,
                 fsdp: bool) -> None:
    """Complete each rank's gradients after a backward over a mesh, in place.
    A leaf split over "data" (fsdp) got its sum in the backward's
    reduce-scatter; every other leaf's gradient is summed over the `data`
    group here (DDP).  Under a `model` group the per-head norms `q_norm` /
    `k_norm` see only the rank's heads, so theirs is summed over the model
    group too; every other replicated leaf already holds the whole gradient
    (the `copy_in` before each column-parallel layer and the head sums the
    input gradient)."""
    specs = param_specs(cfg, fsdp=fsdp)
    for name in sorted(params):
        v = params[name]
        leaves = [(v[k], specs[name][k], k) for k in sorted(v)] if isinstance(v, dict) \
            else [(v, specs[name], name)]
        for t, spec, leaf in leaves:
            if DATA_AXIS not in spec:
                reduce_sum(t.grad, data)
            if leaf in ("q_norm", "k_norm"):
                reduce_sum(t.grad, model)


def data_slice(mesh: Optional[Mesh], B: int) -> slice:
    """This rank's samples of a global batch of B: sample i on data index
    i // (B / dp), as the JAX "data" sharding places a stacked batch."""
    dp = 1 if mesh is None else mesh.shape[DATA_AXIS]
    if B % dp:
        raise ValueError(f"a global batch of {B} does not split over {dp} data ranks")
    b = B // dp
    d = 0 if mesh is None else mesh.index(DATA_AXIS)
    return slice(d * b, (d + 1) * b)


def make_train_step(cfg: ModelConfig, tc: TrainConfig, optimizer: AdamW,
                    mesh: Optional[Mesh] = None) -> Callable:
    """(params, opt_state, rope, batch[, static_layout]) -> (params, opt_state,
    metrics).  `static_layout` is required only with
    `tc.attn_impl == "splash"`.  The parameters and the optimizer state are
    updated in place (the JAX step donates its buffers) and returned; the
    metrics are 0-d tensors on the parameters' device.

    With `mesh=None`, `batch` is ONE packed sample (`prepare_sample` output as
    tensors, no leading batch dim).  With a mesh every `batch` leaf carries a
    leading global batch dim B (B % dp == 0) on every rank, `params` and
    `opt_state` are this rank's fsdp blocks (`shard_params(..., fsdp=True)`,
    then `optimizer.init`), and the step is the JAX `dp_step`: the loss and
    the metrics are means over B.  The rank's loss is the sum of its samples'
    losses over B; the reduce-scatter of each gathered weight's gradient and
    the all-reduce of the others (`reduce_grads`) make its block gradient the
    global mean's.  AdamW is elementwise, so the blocks' update equals the
    whole weights'.  A model axis runs the layers tensor-parallel on the
    rank's heads; splash attention takes B = 1."""
    if mesh is not None and mesh.coords is None:
        raise ValueError("this rank lies outside the mesh")
    group = None if mesh is None else mesh.model_group
    gather = None if mesh is None else fsdp_gather(cfg, mesh.data_group)

    def step(params, opt_state, rope, batch, static_layout=None):
        if mesh is None:
            batch = {k: v[None] for k, v in batch.items()}
        B = batch["input_ids"].shape[0]
        mine = data_slice(mesh, B)
        leaves = grad_views(params, opt_state)
        totals, metrics = batch_losses(leaves, cfg, tc, rope,
                                       {k: v[mine] for k, v in batch.items()}, static_layout,
                                       group=group, gather=gather)
        (totals.sum() / B).backward()
        if mesh is not None:
            reduce_grads(params, cfg, mesh.data_group, group, fsdp=True)
        optimizer.apply(opt_state)
        means = torch.stack([totals.detach().sum(), metrics["loss_ar"].detach().sum(),
                             metrics["loss_consistency"].detach().sum()]) / B
        if mesh is not None:
            reduce_sum(means, mesh.data_group)
        return params, opt_state, dict(zip(("loss", "loss_ar", "loss_consistency"), means))

    return step
