"""FCFS two-queue scheduler with prefill-first batching and preemption.

Copy of `jacobiforcing_tpu/engine/scheduler.py` (reference:
inference_engine/engine/scheduler.py:8-97).  Behavior preserved:
  * waiting/running deques, FCFS admission under a token budget
    (max_num_batched_tokens) and max_num_seqs;
  * prefill batch takes priority; otherwise a decode batch is formed;
  * if pages run out for a decode batch, the YOUNGEST running sequence is
    preempted (deallocated, re-queued at the front of waiting) —
    scheduler.py preempt();
  * postprocess marks EOS / max_tokens sequences FINISHED and frees pages
    (postprocess vs postprocess_jacobi: with Jacobi, tokens were already
    appended by the decoder, only the bound/EOS check remains).

Decode batches are grouped by (strategy, jacobi block_len L) by the engine.

Each admission to a prefill batch adds its wait in the queue to the engine's
`stats["queue_wait_s"]` and 1 to `stats["admissions"]` (a preempted sequence
waits and is admitted again).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from jacobiforcing_tpu_torch.config import Config
from jacobiforcing_tpu_torch.engine.block_manager import BlockManager
from jacobiforcing_tpu_torch.engine.sequence import Sequence, SequenceStatus


class Scheduler:
    def __init__(self, config: Config, block_manager: BlockManager, stats: Dict[str, float]):
        self.config = config
        self.block_manager = block_manager
        self.stats = stats
        self.waiting: deque[Sequence] = deque()
        self.running: deque[Sequence] = deque()
        self.num_preemptions = 0
        # called with a sequence about to be preempted (the engine lands its
        # pending device work there, so the requeued mirror is current)
        self.on_preempt: Optional[Callable[[Sequence], None]] = None

    def add(self, seq: Sequence) -> None:
        seq.t_queued = time.perf_counter()
        self.waiting.append(seq)

    @property
    def is_finished(self) -> bool:
        return not self.waiting and not self.running

    def _jacobi_margin(self, seq: Sequence) -> int:
        sp = seq.sampling_params
        if sp.decode_strategy.startswith("jacobi"):
            # room for the drafted block(s) beyond committed tokens
            return sp.jacobi_block_len * max(1, sp.jacobi_max_blocks)
        return 1

    def schedule(self) -> Tuple[List[Sequence], bool]:
        """Returns (batch, is_prefill)."""
        cfg = self.config
        # --- prefill batch (prefill-first, reference scheduler.py:28-47) ---
        batch: List[Sequence] = []
        budget = cfg.max_num_batched_tokens
        while self.waiting and len(batch) + len(self.running) < cfg.max_num_seqs:
            seq = self.waiting[0]
            need = len(seq) + self._jacobi_margin(seq)
            if need > budget:
                break
            if not self.block_manager.can_allocate(seq, self._jacobi_margin(seq)):
                break
            self.waiting.popleft()
            self.block_manager.allocate_prompt(seq, self._jacobi_margin(seq))
            seq.status = SequenceStatus.RUNNING
            seq.t_admitted = time.perf_counter()
            self.stats["queue_wait_s"] += seq.t_admitted - seq.t_queued
            self.stats["admissions"] += 1
            self.running.append(seq)
            batch.append(seq)
            budget -= need
        if batch:
            return batch, True

        # --- decode batch ---
        batch = []
        for seq in list(self.running):
            if seq.status is not SequenceStatus.RUNNING:
                continue  # preempted as a victim earlier in this pass
            margin = self._jacobi_margin(seq)
            min_need = len(seq) + margin  # enough for one Jacobi iteration
            ok = self.block_manager.ensure_capacity(seq, min_need)
            while not ok:
                victim = self._pick_victim(exclude=seq)
                if victim is None:
                    # nobody to evict: preempt seq itself, retry later
                    self.preempt(seq)
                    break
                self.preempt(victim)
                if victim in batch:
                    batch.remove(victim)
                ok = self.block_manager.ensure_capacity(seq, min_need)
            if ok:
                # best-effort headroom for a full chunk segment
                self.block_manager.ensure_capacity(
                    seq, min_need + self.config.jacobi_chunk_tokens
                )
                batch.append(seq)
        return batch, False

    def _pick_victim(self, exclude: Sequence):
        for cand in reversed(self.running):  # youngest first
            if cand is not exclude:
                return cand
        return None

    def preempt(self, seq: Sequence) -> None:
        if self.on_preempt is not None:
            self.on_preempt(seq)
        self.num_preemptions += 1
        self.running.remove(seq)
        self.block_manager.deallocate(seq)
        seq.status = SequenceStatus.WAITING
        seq.prefill_draft = None
        seq.draft = None
        seq.t_queued = time.perf_counter()
        self.waiting.appendleft(seq)

    def postprocess(self, seqs: List[Sequence]) -> None:
        """EOS / max_tokens retirement (reference scheduler.py:62-97)."""
        eos = self.config.eos
        for seq in seqs:
            sp = seq.sampling_params
            hit_eos = (
                not sp.ignore_eos
                and eos >= 0
                and seq.num_completion_tokens > 0
                and seq.token_ids[-1] == eos
            )
            out_of_iters = (
                sp.decode_strategy.startswith("jacobi")
                and seq.jacobi_iters >= sp.jacobi_max_iterations
            )
            # on-policy: a committed stop token ends the rollout (for on-policy
            # jacobi_max_iterations counts BLOCKS)
            op_done = sp.decode_strategy == "jacobi_on_policy" and seq.op_stopped
            hit_cap = len(seq) >= self.config.max_model_len  # context exhausted
            if (hit_eos or out_of_iters or op_done or hit_cap
                    or seq.num_completion_tokens >= sp.max_tokens):
                seq.truncate_completion()
                seq.status = SequenceStatus.FINISHED
                self.block_manager.deallocate(seq)
                if seq in self.running:
                    self.running.remove(seq)
