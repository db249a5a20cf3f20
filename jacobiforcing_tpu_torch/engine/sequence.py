"""Request state (copy of `jacobiforcing_tpu/engine/sequence.py`).

All host state lives in one process; device-side decode state lives in
fixed-shape tensors owned by the engine, not the Sequence.  The multiblock
(MR) decoder's per-sequence state is carried between chunks as `mb_state`;
the on-policy decoder's rollout records and counters live here too.
"""

from __future__ import annotations

import itertools
from enum import Enum, auto
from typing import List, Optional

import numpy as np

from jacobiforcing_tpu_torch.config import SamplingParams


class SequenceStatus(Enum):
    WAITING = auto()
    RUNNING = auto()
    FINISHED = auto()


class Sequence:
    _ids = itertools.count()

    def __init__(self, token_ids: List[int], sampling_params: Optional[SamplingParams] = None):
        self.seq_id = next(Sequence._ids)
        self.status = SequenceStatus.WAITING
        self.token_ids: List[int] = list(token_ids)
        self.num_prompt_tokens = len(token_ids)
        self.sampling_params = sampling_params or SamplingParams()
        # Paged-KV bookkeeping (reference sequence.py block_table/num_cached_tokens)
        self.block_table: List[int] = []
        self.num_cached_tokens = 0  # valid KV length (== len(self) - 1 while decoding)
        # Jacobi state carried between device chunks
        self.prefill_draft: Optional[np.ndarray] = None
        self.draft: Optional[np.ndarray] = None  # [L] int32, draft[0] = seed
        self.jacobi_iters = 0
        # on-policy rollout records (reference jacobi_decoding_nongreedy_on_policy.py)
        self.rollout_records: List[dict] = []
        self.op_stopped = False
        self.op_iters = 0
        self.op_fwds = 0
        # multiblock (MR) state carried between chunks (numpy arrays, the dict
        # of LLMEngine._mb_bootstrap); its positions are semantic, so it
        # survives a preemption and re-prefill
        self.mb_state: Optional[dict] = None
        # host-clock stamps (`time.perf_counter`): appended to the scheduler's
        # waiting queue (again at a preemption), admitted to a prefill batch,
        # that prefill's read-back, the first commit of an output token
        self.t_queued: Optional[float] = None
        self.t_admitted: Optional[float] = None
        self.t_prefilled: Optional[float] = None
        self.t_first: Optional[float] = None

    def __len__(self) -> int:
        return len(self.token_ids)

    @property
    def num_completion_tokens(self) -> int:
        return len(self.token_ids) - self.num_prompt_tokens

    @property
    def completion_token_ids(self) -> List[int]:
        return self.token_ids[self.num_prompt_tokens :]

    @property
    def is_finished(self) -> bool:
        return self.status == SequenceStatus.FINISHED

    @property
    def max_tokens(self) -> int:
        return self.sampling_params.max_tokens

    @property
    def last_token(self) -> int:
        return self.token_ids[-1]

    def extend_tokens(self, toks: List[int]) -> None:
        self.token_ids.extend(toks)

    def truncate_completion(self) -> None:
        """Clamp completion to max_tokens (Jacobi commits may overshoot by < L,
        as in the reference where postprocess only checks the bound —
        scheduler.py:80-97)."""
        sp = self.sampling_params
        excess = self.num_completion_tokens - sp.max_tokens
        if excess > 0:
            del self.token_ids[-excess:]
