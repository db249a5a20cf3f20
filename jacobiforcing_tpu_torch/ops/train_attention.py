"""Block-sparse attention over the consistency trainer's packed row.

PyTorch port of `jacobiforcing_tpu/ops/pallas/train_attention.py`.  One packed
row `[prompt][k_0][last_0]...[k_{T-1}][last_{T-1}]` (blocks of N tokens) is
attended under a visibility rule that is computed from indices, never stored
as an [L, L] mask: prompt causal; `k_j` sees the prompt, every previous
`last_*` and itself causally (plus previous `k_*` for "multiblock", those of
its own window of pairs only for "window"); `last_j` sees the prompt, every
previous `last_*` and itself causally; rows and keys at or past `seq_len` or
past pair `T` see and are seen by nothing.

  * `train_mask`: the rule, operator-only, on numpy arrays or torch tensors.
  * `masked_attention` / `train_attention_ref`: the plain version, a dense
    masked softmax in torch ops with autograd.  CPU tensors take it.
  * `classify_tiles`: which (query tile, key tile) pairs are empty, partial or
    full, worked out on the host from the layout scalars in O(L * L / key
    tile), for 32-key tiles (the fp32 kernels) or 64-key tiles (the bf16
    tensor-core kernels), with the lists each kernel walks.
  * `train_attention`: the dispatcher.  A CUDA tensor always takes the
    hand-written kernels (csrc/train_attention.cu: forward, dQ, dK/dV) through
    a `torch.autograd.Function`, and what they cannot serve raises.

Unlike the TPU kernel, which expands GQA by repeating K/V and stacks one mask
per head, the G query heads of a KV head share each K/V tile here, and dK/dV
are summed over the group inside the kernel.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

VARIANTS = ("single", "multiblock", "window")
Q_ROWS = 64  # query rows (token-major (token, head-in-group) pairs) per query tile
KEY_TILE = 32  # keys per key tile of the fp32 kernels
TC_KEY_TILE = 64  # keys per key tile of the bf16 tensor-core kernels
# The bf16 dK/dV kernel runs one CTA per (key tile, KV head, chunk of at most
# C query tiles).  C = max(DKDV_MIN_CHUNK, ceil(E / DKDV_CHUNKS)), E the
# non-empty (key tile, query tile) pairs of the layout: about DKDV_CHUNKS
# chunks per KV head, so the longest CTA does about the mean work whatever the
# layout (a prompt key tile is seen by every query tile, a k_j tile under
# `single` by the few of its own block).  256 chunks per head give 1024 CTAs
# at 4 KV heads, about four waves of the H100's 132 SMs at two CTAs each: the
# tail is a fraction of a wave, and each chunk runs enough query tiles to hide
# its K/V load and its fp32 partial write.  Cut into near-equal chunks and
# launched longest first, the trainer's `single` rows give a longest / mean
# chunk of 57 / 50.7 query tiles at L 4096 and 896 / 600 at L 16384 (where
# many key tiles have a single list shorter than C).  C depends on the layout
# only, so the summation order, and the gradients' bits, do not depend on the
# card.
DKDV_CHUNKS = 256
DKDV_MIN_CHUNK = 8
_NEG_INF = -1e30  # finite: a row that sees nothing stays finite


def train_mask(q, k, prompt_len, T, seq_len, N: int, variant: str = "single",
               window_size: int = 4):
    """Visibility of key index `k` for query index `q` (broadcasting integer
    arrays or tensors; `//` and `%` floor, so prompt positions get negative
    block numbers that the `is_*` flags gate).  True = attend."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    P = prompt_len
    bq = (q - P) // N
    bk = (k - P) // N
    is_p_q, is_p_k = q < P, k < P
    is_k_q = (~is_p_q) & (bq % 2 == 0)
    is_l_q = (~is_p_q) & (bq % 2 == 1)
    is_k_k = (~is_p_k) & (bk % 2 == 0)
    is_l_k = (~is_p_k) & (bk % 2 == 1)
    j_q = bq // 2
    j_k = bk // 2

    prev_last = is_l_k & (bk < 2 * j_q)
    mask_prompt = is_p_q & (k <= q)
    same_k = is_k_q & is_k_k & (bq == bk)
    same_l = is_l_q & is_l_k & (bq == bk)
    vis_k = is_p_k | prev_last | (same_k & (k <= q))
    if variant in ("multiblock", "window"):
        prev_k = is_k_k & (bk < 2 * j_q)
        if variant == "window":
            prev_k = prev_k & (j_k // window_size == j_q // window_size)
        vis_k = vis_k | prev_k
    mask_kj = is_k_q & vis_k
    mask_lj = is_l_q & (is_p_k | prev_last | (same_l & (k <= q)))
    valid = (q < seq_len) & (k < seq_len) & (bq < 2 * T) & ((bk < 2 * T) | is_p_k)
    return (mask_prompt | mask_kj | mask_lj) & valid


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Dense masked GQA attention, q [B,T,NH,D], k/v [B,T,KH,D], mask [B|1,T,T]
    bool: scores accumulated in float32 (float64 for float64 inputs), masked
    with a large finite negative, softmax, probabilities cast to `q.dtype`."""
    B, T, NH, D = q.shape
    KH = k.shape[2]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.reshape(B, T, KH, NH // KH, D)
    scores = torch.einsum("bthgd,bshd->bhgts", qg.to(acc), k.to(acc)) * scale
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.tensor(_NEG_INF, dtype=acc, device=q.device))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs, v)
    return out.reshape(B, T, NH, D)


def train_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, prompt_len: int,
                        T_pairs: int, seq_len: int, N: int, variant: str = "single",
                        window_size: int = 4) -> torch.Tensor:
    """The plain version: q [L,NH,D], k/v [L,KH,D] -> [L,NH,D], differentiable."""
    L, _, D = q.shape
    idx = torch.arange(L, device=q.device)
    mask = train_mask(idx[:, None], idx[None, :], prompt_len, T_pairs, seq_len, N, variant,
                      window_size)
    return masked_attention(q[None], k[None], v[None], mask[None], 1.0 / math.sqrt(D))[0]


# ---------------------------------------------------------------------------
# Tile classification
# ---------------------------------------------------------------------------

EMPTY, PARTIAL, FULL = 0, 1, 2


@dataclasses.dataclass(eq=False)
class TileMap:
    """Classes of the (query tile, key tile) pairs of one layout.

    A query tile is Q_ROWS consecutive rows of the token-major (token, head in
    group) order, so it spans tokens [64 i // G, (64 i + 63) // G]; a key tile
    is `key_tile` consecutive keys.  A list entry is `2 * tile + is_full`.

    The tensor-core kernels walk two further lists.  The forward and dQ run
    one CTA per pair of query tiles (2p, 2p + 1), one per warpgroup, over the key
    tiles either of them sees: `pair_ptr` / `pair_ent`, entry `16 * key tile
    + class of tile 2p + 4 * class of tile 2p + 1`, launched in `pair_order`.  dK/dV runs one CTA per
    chunk of a key tile's transposed list: `chunks` rows (key tile, first and
    end index into k_ent, partial slot or -1 where the key tile has one chunk
    and writes dK/dV itself), longest first; a key tile that no query sees has
    one empty chunk, which writes zeros.  `reduce` rows (key tile, first slot,
    chunks) name the key tiles whose fp32 partials a second kernel sums in
    chunk order."""

    classes: np.ndarray  # [n_q_tiles, n_k_tiles] int8: EMPTY / PARTIAL / FULL
    q_ptr: np.ndarray  # [n_q_tiles + 1] int32, CSR over q_ent
    q_ent: np.ndarray  # non-empty key tiles of each query tile, ascending
    k_ptr: np.ndarray  # [n_k_tiles + 1] int32, CSR over k_ent
    k_ent: np.ndarray  # non-empty query tiles of each key tile, ascending
    visible_pairs: int  # visible (query token, key) pairs of the layout
    key_tile: int
    pair_ptr: np.ndarray  # [n_pairs + 1] int32, CSR over pair_ent
    pair_ent: np.ndarray  # key tiles of each pair of query tiles, ascending
    pair_order: np.ndarray  # [n_pairs] int32: the pairs in launch order, longest list first
    chunk: int  # C: the most query tiles of one dK/dV chunk
    chunks: np.ndarray  # [n_chunks, 4] int32: key tile, e0, e1, slot
    reduce: np.ndarray  # [n_reduce, 3] int32: key tile, first slot, chunks
    n_slots: int  # partial slots (chunks of key tiles with more than one)
    _on_device: Dict[torch.device, Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict, repr=False)

    def device_lists(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The lists above (q_ptr, q_ent, k_ptr, k_ent, pair_ptr, pair_ent,
        pair_order, chunks, reduce) as int32 tensors on `device`, by name."""
        lists = self._on_device.get(device)
        if lists is None:
            names = ("q_ptr", "q_ent", "k_ptr", "k_ent", "pair_ptr", "pair_ent", "pair_order",
                     "chunks", "reduce")
            lists = {n: torch.from_numpy(np.ascontiguousarray(getattr(self, n))).to(device)
                     for n in names}
            self._on_device[device] = lists
        return lists


def _csr(classes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    rows, cols = np.nonzero(classes)
    ptr = np.zeros(classes.shape[0] + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=classes.shape[0]), out=ptr[1:])
    ent = 2 * cols + (classes[rows, cols] == FULL)
    return ptr, np.ascontiguousarray(ent, np.int32)


def _pair_lists(classes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The forward's lists over pairs of query tiles and their launch order
    (see TileMap)."""
    n_qt, n_kt = classes.shape
    padded = np.zeros((2 * (-(-n_qt // 2)), n_kt), np.int32)
    padded[:n_qt] = classes
    code = padded[0::2] + 4 * padded[1::2]
    rows, cols = np.nonzero(code)
    ptr = np.zeros(code.shape[0] + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=code.shape[0]), out=ptr[1:])
    order = np.argsort(-np.diff(ptr), kind="stable").astype(np.int32)
    return ptr, np.ascontiguousarray(16 * cols + code[rows, cols], np.int32), order


def _chunk_lists(k_ptr: np.ndarray) -> Tuple[int, np.ndarray, np.ndarray, int]:
    """(C, chunks, reduce, n_slots) of the dK/dV schedule (see TileMap and
    DKDV_CHUNKS): each key tile's list is cut into ceil(n / C) chunks of
    near-equal length."""
    n = np.diff(k_ptr).astype(np.int64)
    C = max(DKDV_MIN_CHUNK, -(-int(n.sum()) // DKDV_CHUNKS))
    chunks, reduce, slot = [], [], 0
    for kt, (start, count) in enumerate(zip(k_ptr[:-1].tolist(), n.tolist())):
        m = max(1, -(-count // C))
        bounds = [start + (count * i) // m for i in range(m + 1)]
        for i in range(m):
            chunks.append((kt, bounds[i], bounds[i + 1], slot + i if m > 1 else -1))
        if m > 1:
            reduce.append((kt, slot, m))
            slot += m
    chunks = np.asarray(chunks, np.int32).reshape(-1, 4)
    # longest first, so that the short chunks fill the last wave
    chunks = chunks[np.argsort(chunks[:, 1] - chunks[:, 2], kind="stable")]
    return C, chunks, np.asarray(reduce, np.int32).reshape(-1, 3), slot


@functools.lru_cache(maxsize=64)
def classify_tiles(L: int, prompt_len: int, T: int, seq_len: int, N: int,
                   variant: str = "single", window_size: int = 4, groups: int = 1,
                   key_tile: int = KEY_TILE) -> TileMap:
    """Classify every (query tile, key tile) pair without an [L, L] mask.

    Apart from its own block (or the prompt, for a prompt row), what a row sees
    depends only on its block, so one representative row per block is put
    through `train_mask`; its own block adds the causal interval that ends at
    the row.  That gives the number of visible keys of every (token, key tile),
    and a query tile is empty where no token of it sees a key of the tile and
    full where each sees all `key_tile` of them.  Cached per layout and key
    tile (a training run meets a new layout with nearly every row)."""
    P = prompt_len
    KT = key_tile
    n_kt = -(-L // KT)
    tok = np.arange(L, dtype=np.int64)
    blk = (tok - P) // N  # negative on the prompt
    in_prompt = tok < P
    row_valid = (tok < seq_len) & (blk < 2 * T)

    # keys outside a row's own block: one representative row per block
    n_blocks = max(-(-(L - P) // N), 0)
    counts = np.zeros((L, n_kt), np.int32)
    if n_blocks:
        b = np.arange(n_blocks, dtype=np.int64)
        rep = np.minimum(P + b * N, L - 1)  # first token of the block
        # judged as if nothing were cut by seq_len on the query side; the
        # row's own validity is applied below
        vis = train_mask(rep[:, None], tok[None, :], P, T, max(seq_len, L), N, variant,
                         window_size)
        vis &= (tok < seq_len)[None, :]
        vis &= ~((blk[None, :] == b[:, None]) & ~in_prompt[None, :])
        pad = n_kt * KT - L
        per_block = np.pad(vis, ((0, 0), (0, pad))).reshape(n_blocks, n_kt, KT).sum(-1)
        body = ~in_prompt
        counts[body] = per_block[blk[body]]
    # the causal interval [start, token] of the row's own block (or the prompt)
    start = np.where(in_prompt, 0, P + blk * N)
    k0 = np.arange(n_kt, dtype=np.int64)[None, :] * KT
    own = np.minimum(tok[:, None] + 1, k0 + KT) - np.maximum(start[:, None], k0)
    counts += np.clip(own, 0, KT).astype(np.int32)
    counts[~row_valid] = 0

    # aggregate tokens into query tiles (which may share a boundary token)
    n_qt = -(-(L * groups) // Q_ROWS)
    t0 = (np.arange(n_qt, dtype=np.int64) * Q_ROWS) // groups
    t1 = np.minimum((np.arange(n_qt, dtype=np.int64) * Q_ROWS + Q_ROWS - 1) // groups, L - 1)
    some = np.zeros((L + 1, n_kt), np.int32)
    np.cumsum(counts > 0, axis=0, out=some[1:])
    whole = np.zeros((L + 1, n_kt), np.int32)
    np.cumsum(counts == KT, axis=0, out=whole[1:])
    n_some = some[t1 + 1] - some[t0]
    n_whole = whole[t1 + 1] - whole[t0]
    classes = np.where(n_some > 0, PARTIAL, EMPTY).astype(np.int8)
    # a last query tile that runs past the last row is full all the same: its
    # missing rows are never stored
    classes[n_whole == (t1 - t0 + 1)[:, None]] = FULL
    q_ptr, q_ent = _csr(classes)
    k_ptr, k_ent = _csr(classes.T)
    pair_ptr, pair_ent, pair_order = _pair_lists(classes)
    chunk, chunks, reduce, n_slots = _chunk_lists(k_ptr)
    return TileMap(classes=classes, q_ptr=q_ptr, q_ent=q_ent, k_ptr=k_ptr,
                   k_ent=k_ent, visible_pairs=int(counts.sum()), key_tile=KT,
                   pair_ptr=pair_ptr, pair_ent=pair_ent, pair_order=pair_order,
                   chunk=chunk, chunks=chunks,
                   reduce=reduce, n_slots=n_slots)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


class _TrainAttentionCuda(torch.autograd.Function):
    """Forward and backward through the hand-written kernels."""

    @staticmethod
    def forward(ctx, q, k, v, layout):
        from jacobiforcing_tpu_torch.ops import train_attention_cuda as tac

        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse, out_lo = tac.train_attention_fwd_cuda(q, k, v, layout)
        ctx.save_for_backward(q, k, v, out, lse, out_lo)
        ctx.layout = layout
        return out

    @staticmethod
    def backward(ctx, dout):
        from jacobiforcing_tpu_torch.ops import train_attention_cuda as tac

        q, k, v, out, lse, out_lo = ctx.saved_tensors
        dout = dout.contiguous()
        dq, delta = tac.train_attention_dq_cuda(q, k, v, out, lse, dout, ctx.layout, out_lo)
        dk, dv = tac.train_attention_dkdv_cuda(q, k, v, lse, delta, dout, ctx.layout)
        return dq, dk, dv, None


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, prompt_len: int,
                    T_pairs: int, seq_len: int, N: int, variant: str = "single",
                    window_size: int = 4) -> torch.Tensor:
    """q [L,NH,D], k/v [L,KH,D] -> [L,NH,D], differentiable.  CUDA tensors go
    to the kernels (which raise on what they cannot serve); CPU tensors go to
    the plain version."""
    if q.is_cuda:
        layout = (int(prompt_len), int(T_pairs), int(seq_len), int(N), variant, int(window_size))
        return _TrainAttentionCuda.apply(q, k, v, layout)
    return train_attention_ref(q, k, v, prompt_len=prompt_len, T_pairs=T_pairs, seq_len=seq_len,
                               N=N, variant=variant, window_size=window_size)
