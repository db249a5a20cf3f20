"""Engine core: request admission, batched prefill/decode dispatch, retirement.

PyTorch port of `jacobiforcing_tpu/engine/llm_engine.py`, all five decode
strategies:
  * AR sequences step one token per `ar_decode_step` call (batched, padded to
    the next batch bucket);
  * single-block Jacobi sequences run whole chunks of trips, greedy or
    rejection-sampling (strategy `jacobi_nongreedy`), grouped by (block_len
    L, ignore_eos, non-greedy, top_k, top-p on), through the JAX engine's
    one-chunk-lag speculative host pipeline (`Config.jacobi_async_host`):
    chunk k+1 is dispatched from chunk k's device outputs, and chunk k is
    read back and committed on the host while chunk k+1's first trip runs;
  * on-policy rollouts (`jacobi_on_policy`) run one block per step
    (`jacobi_onpolicy_block`), grouped by (L, top_k, top-p on, greedy mode,
    accept threshold), and append one rollout record per block;
  * multiblock (MR) sequences run `jacobi_chunk_multiblock` chunks, grouped
    by (L, K, C, ignore_eos), through the measured auto-policy of
    `engine/mr_policy.py`, with exact handoffs between the MR state machine
    and the single-block program.

Tensor parallelism (`Config.tensor_parallel_size`) is SPMD over the ranks of
a `torch.distributed` world: every rank runs this engine on the same
requests and makes the same scheduling decisions, holding its share of the
parameters (`parallel/sharding.py`) and `num_kv_heads / tp` heads of the KV
pool.  The collectives live inside the forward; the host values a rank
could see differently (the free device memory that sizes the pool, the MR
auto-policy's wall time) are reduced or broadcast from the group's first
rank, so every rank schedules, preempts and picks policy arms alike.

On a CUDA device the AR step and each Jacobi trip replay one CUDA graph per
shape bucket (`engine/graphs.py`; `Config.enforce_eager` turns them off);
prefill, MR chunks and on-policy blocks run eagerly.  `warmup` drives
synthetic requests through every bucket, which builds the kernels and
captures the graphs before serving.

KV pages come from the native C++ allocator (`engine/native_block_manager.py`,
built with the host compiler at first use) unless `JF_NATIVE_BM=0` selects
the Python one; a native library that cannot be built raises, where the JAX
engine falls back without a word.  The pool's storage type is the model's,
or `Config.kv_cache_dtype`, or `kv_dtype=` (which alone reaches
`torch.float8_e5m2`, as in the JAX engine).

Host randomness is the JAX engine's: a `np.random.RandomState(config.seed)`
draws the bootstrap draft appended at prefill, every random draft tail of the
MR arms and the prompt-sampled initial block of each on-policy rollout, so
with the MR program forced the port matches the JAX engine iteration for
iteration and greedy on-policy collection matches it record for record.
Device randomness (AR sampling, the random tail of single-block Jacobi
drafts, the rejection-sampling draws) comes from a `torch.Generator` seeded
from `config.seed`; it cannot reproduce `jax.random`'s bits, so greedy token
streams match the JAX engine exactly while iteration counts (and so tokens
per forward) move within the spread across seeds, and sampled streams agree
in distribution.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Dict, List, Optional, Sequence as PySeq

import numpy as np
import torch
import torch.distributed as dist

from jacobiforcing_tpu_torch.config import Config, SamplingParams
from jacobiforcing_tpu_torch.engine import runner
from jacobiforcing_tpu_torch.engine.block_manager import BlockManager
from jacobiforcing_tpu_torch.engine.graphs import DecodePrograms
from jacobiforcing_tpu_torch.engine.mr_policy import ARM_SINGLE, MRAutoPolicy
from jacobiforcing_tpu_torch.engine.multiblock import STATE_KEYS, jacobi_chunk_multiblock
from jacobiforcing_tpu_torch.engine.native_block_manager import NativeBlockManager
from jacobiforcing_tpu_torch.engine.scheduler import Scheduler
from jacobiforcing_tpu_torch.engine.sequence import Sequence, SequenceStatus
from jacobiforcing_tpu_torch.models.qwen import ModelConfig, rope_table
from jacobiforcing_tpu_torch.ops.kv_cache import alloc_kv_cache, needs_row_scales
from jacobiforcing_tpu_torch.ops.quant import int_mm_layout, quantize_params
from jacobiforcing_tpu_torch.parallel import collectives
from jacobiforcing_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, make_mesh, set_serving_mesh
from jacobiforcing_tpu_torch.parallel.sharding import shard_params
from jacobiforcing_tpu_torch.utils.device import resolve_device
from jacobiforcing_tpu_torch.utils.loader import load_checkpoint, move_params
from jacobiforcing_tpu_torch.utils.profiling import Spans


KV_DTYPES = {"fp8": torch.float8_e4m3fn, "int8": torch.int8, "bf16": torch.bfloat16}
# the outputs of a Jacobi chunk the next chunk of its group starts from
_HANDLES = ("tokens", "cur_len", "draft", "eos", "iters")
# what the host reads back of a chunk to commit it
_READBACK = ("new_tokens", "win_start", "cur_len", "iters", "draft", "generated")


class _HostCopy:
    """A chunk's read-back, queued right behind its last trip: copies into
    pinned host memory that do not block, so `get` waits for them alone and
    not for trips queued after them."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.event = None
        if next(iter(tensors.values())).is_cuda:
            self.host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                         .copy_(v, non_blocking=True) for k, v in tensors.items()}
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = tensors

    def get(self) -> Dict[str, np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return {k: v.numpy() for k, v in self.host.items()}


class _PendingChunk:
    """One dispatched Jacobi chunk whose tokens are not committed yet (the
    speculative host pipeline): its device outputs (`res`, the next chunk's
    starting state), their read-back, and what the commit checks."""

    __slots__ = ("res", "host", "seqs", "expected_lens", "iters0", "stat_key")

    def __init__(self, res, host, seqs, expected_lens, iters0, stat_key=None):
        self.res = res
        self.host = host
        self.seqs = seqs
        self.expected_lens = expected_lens
        self.iters0 = iters0
        # a stats counter credited with the chunk's iterations at commit time
        # ("mr_single" for MR groups served by the single arm)
        self.stat_key = stat_key


def _tp_mesh(tp: int) -> Mesh:
    """The serving mesh of `Config.tensor_parallel_size` over the joined
    world (`parallel/multihost.initialize_multihost`): one model group of
    every rank.  A larger world would need a data axis, which serving does
    not have (`Config.data_parallel_size`)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != tp:
        raise ValueError(
            f"tensor_parallel_size={tp} needs a torch.distributed world of {tp} ranks "
            f"(this one has {world}): join one with parallel.multihost.initialize_multihost, "
            "e.g. under torchrun, or pass a mesh")
    return make_mesh(tensor_parallel_size=tp)


def _bucket(n: int, buckets: PySeq[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class LLMEngine:
    MR = "jacobi_multiblock_rejection_recycling"
    NONGREEDY = "jacobi_nongreedy"
    ON_POLICY = "jacobi_on_policy"
    SUPPORTED_STRATEGIES = {"autoregressive", "jacobi", NONGREEDY, ON_POLICY, MR}
    # the serving mesh and its model group: None without tensor parallelism
    mesh: Optional[Mesh] = None
    group: Optional[dist.ProcessGroup] = None

    def __init__(
        self,
        config: Config,
        *,
        model_cfg: Optional[ModelConfig] = None,
        params: Optional[Dict[str, Any]] = None,
        tokenizer=None,
        num_kv_pages: Optional[int] = None,
        kv_dtype: Optional[torch.dtype] = None,
        dtype: torch.dtype = torch.bfloat16,
        device="cuda",
        mesh: Optional[Mesh] = None,
    ):
        self.config = config
        self.device = resolve_device(device)
        tp = config.tensor_parallel_size
        # groups the engine creates are its own to destroy at exit
        self._owns_mesh = mesh is None and tp > 1
        self.mesh = mesh if mesh is not None else (_tp_mesh(tp) if tp > 1 else None)
        if self.mesh is not None and self.mesh.shape[MODEL_AXIS] != tp:
            raise ValueError(f"the mesh's model axis has {self.mesh.shape[MODEL_AXIS]} ranks, "
                             f"tensor_parallel_size={tp}")
        if self.mesh is not None:
            self.group = self.mesh.model_group
        set_serving_mesh(self.mesh)
        quantize = config.quantization in ("int8", "w8a8")
        if params is None:
            # under tensor parallelism the checkpoint stays on the host until
            # it is cut: a rank's card never holds the full model
            model_cfg, params = load_checkpoint(config.model_path, dtype=dtype,
                                                device=self.device if tp == 1 else "cpu")
        assert model_cfg is not None
        if model_cfg.num_kv_heads % tp:
            raise ValueError(f"kv heads {model_cfg.num_kv_heads} not divisible by tp={tp}")
        if quantize:
            # leaves that are quantized already (`init_quantized_params`) stay;
            # a row-parallel weight's scales come from all of its rows, so
            # this runs on the full weights, before they are cut
            params = quantize_params(params)
        if tp > 1:
            params = move_params(shard_params(params, model_cfg, self.mesh), self.device)
        if config.quantization == "w8a8":
            # per-token activation quantization + int8 x int8 products
            model_cfg = dataclasses.replace(model_cfg, act_quant=True)
            if self.device.type == "cuda":
                params = int_mm_layout(params)  # the int8 GEMM's fast layout
        self.model_cfg = model_cfg
        self.params = params
        self.tokenizer = tokenizer
        if tokenizer is not None and config.eos < 0:
            config.eos = tokenizer.eos_token_id
        self.rope = rope_table(model_cfg, self.device)

        if kv_dtype is None and config.kv_cache_dtype:
            kv_dtype = KV_DTYPES[config.kv_cache_dtype]
        kv_dtype = kv_dtype or model_cfg.dtype
        page = config.kvcache_page_size
        npages = num_kv_pages or (config.num_kv_pages if config.num_kv_pages > 0 else None)
        if npages is None:
            npages = self._pages_from_memory(page, kv_dtype)
        self.kv = alloc_kv_cache(
            model_cfg.num_layers, npages, page, model_cfg.num_kv_heads // tp,
            model_cfg.head_dim, kv_dtype, self.device,
        )
        # the native C++ allocator unless JF_NATIVE_BM=0, as in the JAX engine;
        # unlike it, a native library that cannot be built raises
        if os.environ.get("JF_NATIVE_BM", "1") != "0":
            self.block_manager = NativeBlockManager(npages, page)
        else:
            self.block_manager = BlockManager(npages, page)
        # counters, and the spans' seconds (`utils/profiling.py`): the
        # scheduler adds each admission's queue wait, a commit the first
        # output token's wait since the request's prefill and, where a Jacobi
        # chunk ran, the rows its trips forwarded (`trip_slots`: bucket rows x
        # trips, of which `jacobi_iterations` were rows of running sequences)
        self.stats: Dict[str, float] = {
            "prefill_tokens": 0, "generated_tokens": 0, "jacobi_iterations": 0,
            "ar_steps": 0, "chunk_calls": 0, "chunk_forwards": 0, "trip_slots": 0,
            "admissions": 0, "queue_wait_s": 0.0, "first_commits": 0, "first_commit_s": 0.0,
        }
        self.spans = Spans(self.stats)
        self.scheduler = Scheduler(config, self.block_manager, self.stats)
        # a preempted sequence's mirrors must be current before it is requeued
        self.scheduler.on_preempt = lambda seq: self._land([seq])

        self.rng = np.random.RandomState(config.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(config.seed)
        max_margin = max(config.jacobi_block_len * config.jacobi_max_blocks, 256)
        self.pages_bucket = (config.max_model_len + max_margin + page - 1) // page
        self.cap_tokens = config.max_model_len + max_margin + 1
        self._mr_policies: Dict[tuple, MRAutoPolicy] = {}
        # the AR step and the Jacobi trips, one program per shape bucket:
        # CUDA graphs on the card unless enforce_eager
        self.programs = DecodePrograms(
            self.params, model_cfg, self.rope, self.kv, self.generator,
            pages_bucket=self.pages_bucket, cap_tokens=self.cap_tokens,
            chunk_budget=config.jacobi_chunk_tokens, chunk_iters=config.jacobi_chunk_iters,
            capture=self.device.type == "cuda" and not config.enforce_eager, group=self.group)
        # outstanding speculative Jacobi chunks by group signature
        self._pending: Dict[tuple, _PendingChunk] = {}

    # ------------------------------------------------------------------
    def _pages_from_memory(self, page: int, kv_dtype: torch.dtype) -> int:
        """Size the KV pool from free device memory (40k-page hard cap): the
        storage type's element size, plus 4 bytes per row and KV head for each
        scale plane of a narrow type, for this rank's KV heads.  With CUDA
        graphs, room for the graph pool is kept back first
        (`_graph_pool_estimate`).  Under tensor parallelism every rank takes
        the smallest count of the group: ranks that see different free memory
        (two sharing a card) would otherwise schedule and preempt apart."""
        if self.device.type != "cuda":
            raise ValueError("on the CPU pass num_kv_pages: there is no device memory to size "
                             "the KV pool from")
        mc = self.model_cfg
        kh = mc.num_kv_heads // self.config.tensor_parallel_size
        itemsize = torch.empty((), dtype=kv_dtype).element_size()
        bytes_per_tok = 2 * mc.num_layers * kh * mc.head_dim * itemsize
        if needs_row_scales(kv_dtype):
            bytes_per_tok += 2 * mc.num_layers * kh * 4
        free, total = torch.cuda.mem_get_info(self.device)
        avail = int(total * self.config.hbm_utilization) - (total - free)
        if not self.config.enforce_eager:
            avail -= self._graph_pool_estimate()
        avail = max(avail, 1 << 28)
        npages = int(avail // (bytes_per_tok * page))
        if self.group is not None:
            npages = int(collectives.reduce_min(torch.tensor([npages], device=self.device),
                                                self.group))
        return max(16, min(npages, 40_000))

    def _graph_pool_estimate(self) -> int:
        """Bytes the graphs' shared pool may hold: the transient tensors of
        the largest trip (largest batch bucket x block length rows): three
        float32 vocab chunks of the head (32,768 columns) and six MLP-wide
        activations per row, plus three [rows, V] float32 tensors for the
        top-k / top-p verify, at this rank's widths (the verify's logits
        are gathered whole).  The pool holds what its largest graph needs."""
        mc, cfg = self.model_cfg, self.config
        tp = cfg.tensor_parallel_size
        rows = cfg.batch_buckets[-1] * cfg.jacobi_block_len
        chunk = min(32768, mc.vocab_size // tp)
        return rows * 4 * (3 * chunk + 6 * mc.intermediate_size // tp + 3 * mc.vocab_size)

    # ------------------------------------------------------------------
    def add_request(self, token_ids: List[int], sampling_params: SamplingParams) -> Sequence:
        strat = sampling_params.decode_strategy
        if strat not in self.SUPPORTED_STRATEGIES:
            raise NotImplementedError(
                f"decode_strategy {strat!r} is not supported by the PyTorch port yet"
            )
        if strat in ("jacobi", self.MR) and sampling_params.temperature > 0:
            # the JAX engine would decode these greedily without saying so
            raise NotImplementedError(
                f"{strat!r} decodes greedily: a temperature > 0 request takes "
                f"{self.NONGREEDY!r} (LLM.generate routes 'jacobi' there)")
        if len(token_ids) >= self.config.max_model_len:
            raise ValueError(
                f"prompt ({len(token_ids)} tokens) exceeds max_model_len "
                f"{self.config.max_model_len}"
            )
        room = self.config.max_model_len - len(token_ids)
        if sampling_params.max_tokens > room:
            sampling_params = dataclasses.replace(sampling_params, max_tokens=room)
        seq = Sequence(token_ids, sampling_params)
        self.scheduler.add(seq)
        return seq

    # ------------------------------------------------------------------
    def step(self) -> List[Sequence]:
        with self.spans["step"]:
            with self.spans["schedule"]:
                seqs, is_prefill = self.scheduler.schedule()
            flushed: List[Sequence] = []
            if not seqs:
                if self._pending:
                    # drain: commit the outstanding chunks so that their sequences
                    # can retire (the scheduler sees a finish only once committed)
                    flushed = self._flush_pending()
                    self.scheduler.postprocess(flushed)
                    return [s for s in flushed if s.is_finished]
                return []
            if is_prefill:
                if self._pending:
                    # the decode groups change after this prefill: land their
                    # pending work first (and let any finish free its pages)
                    flushed = self._flush_pending()
                    self.scheduler.postprocess(flushed)
                max_b = self.config.batch_buckets[-1]
                with self.spans["prefill"]:
                    for i in range(0, len(seqs), max_b):
                        self._run_prefill(seqs[i : i + max_b])
            else:
                self._run_decode(seqs)
            self.scheduler.postprocess(seqs)
            # a pending chunk whose sequences all retired in this step is inert
            # (every finish condition is mirrored on the device): drop it
            for sig in [k for k, p in self._pending.items()
                        if all(s.status is not SequenceStatus.RUNNING for s in p.seqs)]:
                del self._pending[sig]
            finished = [s for s in seqs if s.is_finished]
            in_batch = set(map(id, seqs))
            return finished + [s for s in flushed if s.is_finished and id(s) not in in_batch]

    # ------------------------------------------------------------------
    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _host_block_table(self, seqs: List[Sequence], B: int) -> torch.Tensor:
        bt = np.full((B, self.pages_bucket), -1, np.int32)
        for i, s in enumerate(seqs):
            tab = s.block_table[: self.pages_bucket]
            bt[i, : len(tab)] = tab
        return torch.from_numpy(bt)

    def _pad_block_table(self, seqs: List[Sequence], B: int) -> torch.Tensor:
        return self._host_block_table(seqs, B).to(self.device)

    @staticmethod
    def _is_jacobi(s: Sequence) -> bool:
        return s.sampling_params.decode_strategy.startswith("jacobi")

    def _draft_len(self, s: Sequence) -> int:
        return s.sampling_params.jacobi_block_len if self._is_jacobi(s) else 0

    def _prefill_segment(self, seqs: List[Sequence], max_T: int) -> None:
        """Forward one bounded segment of each long uncached prompt suffix
        (chunked prefill); each segment leaves >= 1 uncached token so the final
        pass still gathers logits at prompt_len - 1."""
        B = _bucket(len(seqs), self.config.batch_buckets)
        seg_lens = [min(len(s) - s.num_cached_tokens - 1, max_T) for s in seqs]
        T = _bucket(max(seg_lens), self.config.prefill_token_buckets)
        ids = np.zeros((B, T), np.int32)
        starts = np.zeros((B,), np.int32)
        totals = np.ones((B,), np.int32)
        for i, s in enumerate(seqs):
            c = s.num_cached_tokens
            ids[i, : seg_lens[i]] = s.token_ids[c : c + seg_lens[i]]
            starts[i] = c
            totals[i] = c + seg_lens[i]
        bt = self._pad_block_table(seqs, B)
        self.kv, _, _ = runner.prefill(
            self.params, self.model_cfg, self.rope, self._tensor(ids),
            self._tensor(starts), self._tensor(totals), self._tensor(totals),
            self.kv, bt, n_out=1, group=self.group,
        )
        for i, s in enumerate(seqs):
            s.num_cached_tokens += seg_lens[i]
        self.stats["prefill_tokens"] += sum(seg_lens)

    def _run_prefill(self, seqs: List[Sequence]) -> None:
        max_T = self.config.prefill_token_buckets[-1]
        while True:
            todo = [
                s for s in seqs
                if len(s) - s.num_cached_tokens + self._draft_len(s) > max_T
            ]
            if not todo:
                break
            self._prefill_segment(todo, max_T)
        jac_Ls = [self._draft_len(s) for s in seqs if self._is_jacobi(s)]
        n_out = max(jac_Ls) if jac_Ls else 1
        B = _bucket(len(seqs), self.config.batch_buckets)

        suffixes, starts, totals, prompts_l = [], [], [], []
        for s in seqs:
            suffix = list(s.token_ids[s.num_cached_tokens:])
            L = self._draft_len(s)
            if L:
                suffix += self.rng.randint(0, self.model_cfg.vocab_size, L).tolist()
            suffixes.append(suffix)
            starts.append(s.num_cached_tokens)
            totals.append(len(s) + L)
            prompts_l.append(len(s))

        max_suffix = max(len(x) for x in suffixes)
        T = _bucket(max_suffix, self.config.prefill_token_buckets)
        assert max_suffix <= T, f"prefill suffix {max_suffix} > bucket {T}"
        ids = np.zeros((B, T), np.int32)
        for i, x in enumerate(suffixes):
            ids[i, : len(x)] = x
        starts_a = np.zeros((B,), np.int32)
        totals_a = np.ones((B,), np.int32)
        prompts_a = np.ones((B,), np.int32)
        starts_a[: len(seqs)] = starts
        totals_a[: len(seqs)] = totals
        prompts_a[: len(seqs)] = prompts_l

        bt = self._pad_block_table(seqs, B)
        self.kv, last_logits, draft = runner.prefill(
            self.params, self.model_cfg, self.rope, self._tensor(ids),
            self._tensor(starts_a), self._tensor(totals_a), self._tensor(prompts_a),
            self.kv, bt, n_out=n_out, group=self.group,
        )
        # only the AR rows read the [B, V] logits; Jacobi rows take the draft
        need_logits = any(not self._is_jacobi(s) for s in seqs)
        with self.spans["prefill.wait"]:
            if need_logits:
                last_logits = last_logits.float().cpu().numpy()
            draft = draft.cpu().numpy()
        now = time.perf_counter()
        self.stats["prefill_tokens"] += sum(len(x) for x in suffixes)

        for i, s in enumerate(seqs):
            sp = s.sampling_params
            s.t_prefilled = now
            if self._is_jacobi(s):
                s.prefill_draft = draft[i]  # [n_out] greedy continuation
            else:
                # commit the first token now
                if sp.temperature > 0:
                    logits = last_logits[i] / max(sp.temperature, 1e-6)
                    g = self.rng.gumbel(size=logits.shape)
                    tok = int(np.argmax(logits + g))
                else:
                    tok = int(np.argmax(last_logits[i]))
                self._extend(s, [tok])
                self.stats["generated_tokens"] += 1
            s.num_cached_tokens = len(s) - 1

    # ------------------------------------------------------------------
    def _run_decode(self, seqs: List[Sequence]) -> None:
        max_b = self.config.batch_buckets[-1]
        ar = [s for s in seqs if not self._is_jacobi(s)]
        for i in range(0, len(ar), max_b):
            self._ar_step(ar[i : i + max_b])
        mr_groups: Dict[tuple, List[Sequence]] = {}
        op_groups: Dict[tuple, List[Sequence]] = {}
        groups: Dict[tuple, List[Sequence]] = {}
        for s in seqs:
            sp = s.sampling_params
            use_top_p = 0.0 < sp.top_p < 1.0
            if sp.decode_strategy == self.MR:
                k = (sp.jacobi_block_len, max(1, sp.jacobi_max_blocks),
                     max(1, sp.jacobi_n_gram_pool_size), sp.ignore_eos)
                mr_groups.setdefault(k, []).append(s)
            elif sp.decode_strategy == self.ON_POLICY:
                # temperature 0 is the greedy trajectory collector
                k = (sp.jacobi_block_len, sp.top_k, use_top_p, sp.temperature == 0.0,
                     float(sp.jacobi_accept_threshold))
                op_groups.setdefault(k, []).append(s)
            elif self._is_jacobi(s):
                nongreedy = sp.decode_strategy == self.NONGREEDY
                k = (sp.jacobi_block_len, sp.ignore_eos, nongreedy,
                     sp.top_k if nongreedy else -1, use_top_p and nongreedy)
                groups.setdefault(k, []).append(s)
        for (L, K, C, ignore_eos), group in mr_groups.items():
            for i in range(0, len(group), max_b):
                self._mr_dispatch(
                    group[i : i + max_b], L, K, C, -1 if ignore_eos else self.config.eos)
        for (L, top_k, use_top_p, greedy_mode, thr), group in op_groups.items():
            for i in range(0, len(group), max_b):
                with self.spans["onpolicy"]:
                    self._onpolicy_block(group[i : i + max_b], L, top_k, use_top_p,
                                         greedy_mode, thr)
        for (L, ignore_eos, nongreedy, top_k, use_top_p), group in groups.items():
            for i in range(0, len(group), max_b):
                self._jacobi_chunk(group[i : i + max_b], L, -1 if ignore_eos else self.config.eos,
                                   nongreedy=nongreedy, top_k=top_k, use_top_p=use_top_p)

    def _ar_forward(self, seqs: List[Sequence], temps: np.ndarray) -> np.ndarray:
        """One AR decode step of `seqs` (padded to their batch bucket) through
        the bucket's program; returns the next token of every row."""
        B = _bucket(len(seqs), self.config.batch_buckets)
        last = np.zeros((B,), np.int32)
        lens = np.ones((B,), np.int32)
        active = np.zeros((B,), bool)
        for i, s in enumerate(seqs):
            last[i] = s.last_token
            lens[i] = len(s)
            active[i] = True
        with self.spans["ar"]:
            prog = self.programs.ar(B)
            prog.load(last_tokens=torch.from_numpy(last), seq_lens=torch.from_numpy(lens),
                      block_tables=self._host_block_table(seqs, B),
                      active=torch.from_numpy(active), temperature=torch.from_numpy(temps))
            out = prog.step()
            with self.spans["ar.wait"]:
                return out.cpu().numpy()

    def _ar_step(self, seqs: List[Sequence]) -> None:
        B = _bucket(len(seqs), self.config.batch_buckets)
        temps = np.zeros((B,), np.float32)
        for i, s in enumerate(seqs):
            temps[i] = s.sampling_params.temperature
        next_tokens = self._ar_forward(seqs, temps)
        for i, s in enumerate(seqs):
            self._extend(s, [int(next_tokens[i])])
            s.num_cached_tokens = len(s) - 1
            self.stats["generated_tokens"] += 1
        self.stats["ar_steps"] += 1

    # -- speculative host pipeline ------------------------------------------
    # A Jacobi chunk is a pure device-state transition: what it carries
    # (tokens, cur_len, draft, eos, iters; the KV pool) comes from the last
    # chunk's outputs, and the rest is invariant across chunks (len_limit =
    # prompt + max_tokens, absolute; max_iters; temperatures) or rebuilt on
    # the host from small tables (block tables, capacity).  So chunk k+1 can
    # be dispatched from chunk k's device outputs before chunk k is read back
    # (the JAX engine's one-chunk-lag host commit): here chunk k is committed
    # on the host while chunk k+1's first trip runs.  Every finish condition
    # (EOS, len_limit, max_iters, capacity) is mirrored on the device, so a
    # pending chunk's rows of sequences that finished meanwhile are inert; a
    # dropped pending chunk loses uncommitted work only, never correctness.

    def _chunk_sig(self, seqs, L, eos_id, nongreedy, top_k, use_top_p):
        return (tuple(s.seq_id for s in seqs), L, eos_id, nongreedy, top_k, use_top_p)

    def _dispatch_chunk(self, seqs: List[Sequence], L: int, eos_id: int, nongreedy: bool,
                        top_k: int, use_top_p: bool,
                        handles: Optional[Dict[str, torch.Tensor]] = None) -> runner.ChunkRun:
        """Load one Jacobi chunk into its bucket's program and launch its
        first trip.  The carried state comes from `handles` (the device
        outputs of the group's previous chunk) or is built on the host."""
        with self.spans["dispatch"]:
            B = _bucket(len(seqs), self.config.batch_buckets)
            capacity = np.zeros((B,), np.int32)
            len_limit = np.zeros((B,), np.int32)
            temps = np.ones((B,), np.float32)
            top_ps = np.ones((B,), np.float32)
            max_iters = np.ones((B,), np.int32)
            for i, s in enumerate(seqs):
                capacity[i] = min(self.block_manager.capacity_tokens(s), self.cap_tokens - 1)
                # absolute (prompt + max_tokens), so a chunk dispatched before the
                # previous one is committed needs no new budget
                len_limit[i] = len(s) + max(0, s.max_tokens - s.num_completion_tokens)
                max_iters[i] = min(s.sampling_params.jacobi_max_iterations, 2**30)
                temps[i] = s.sampling_params.temperature
                top_ps[i] = s.sampling_params.top_p
            if handles is None:
                tokens = np.zeros((B, self.cap_tokens), np.int32)
                cur_len = np.ones((B,), np.int32)
                eos = np.ones((B,), bool)  # padding rows inert
                iters = np.zeros((B,), np.int32)
                draft = np.zeros((B, L), np.int32)
                for i, s in enumerate(seqs):
                    tokens[i, : len(s)] = s.token_ids
                    cur_len[i] = len(s)
                    # a sequence whose EOS a flush just committed stays inert
                    # until the scheduler retires it
                    eos[i] = eos_id >= 0 and s.num_completion_tokens > 0 and s.last_token == eos_id
                    iters[i] = s.jacobi_iters
                    if s.draft is not None:
                        draft[i] = s.draft
                    else:
                        pf = s.prefill_draft
                        ncopy = 0
                        if pf is not None:
                            ncopy = min(len(pf), L - 1)
                            draft[i, 1 : 1 + ncopy] = pf[:ncopy]
                            s.prefill_draft = None
                        if ncopy < L - 1:
                            draft[i, 1 + ncopy :] = self.rng.randint(
                                0, self.model_cfg.vocab_size, L - 1 - ncopy
                            )
                    draft[i, 0] = s.last_token
                handles = {k: torch.from_numpy(v) for k, v in
                           zip(_HANDLES, (tokens, cur_len, draft, eos, iters))}
            prog = self.programs.jacobi(B, L, nongreedy, top_k, use_top_p)
            prog.buf.load(**handles, cur_len0=handles["cur_len"], iters0=handles["iters"],
                          generated=0, block_tables=self._host_block_table(seqs, B),
                          capacity=torch.from_numpy(capacity),
                          len_limit=torch.from_numpy(len_limit),
                          max_iters=torch.from_numpy(max_iters),
                          temperature=torch.from_numpy(temps),
                          top_p=torch.from_numpy(top_ps), eos_id=eos_id)
            chunk = runner.ChunkRun(prog.trip, prog.buf, self.config.jacobi_chunk_tokens,
                                    self.config.jacobi_chunk_iters, self.spans)
            return chunk.start()

    def _finish_chunk(self, chunk: runner.ChunkRun, seqs: List[Sequence], iters0: np.ndarray,
                      stat_key: Optional[str]) -> _PendingChunk:
        """Run the chunk's remaining trips and queue its read-back."""
        res = chunk.finish()
        return _PendingChunk(res, _HostCopy({k: res[k] for k in _READBACK}), list(seqs),
                             [len(s) for s in seqs], iters0, stat_key)

    def _commit_chunk(self, pending: _PendingChunk) -> None:
        """Commit one chunk's tokens to the host Sequence mirrors.  A row is
        committed while its sequence is still RUNNING with the committed
        length it had at dispatch; other rows were inert, or their work is
        discarded on purpose."""
        with self.spans["commit"]:
            with self.spans["commit.wait"]:
                host = pending.host.get()
            window, starts, cur_out, iters_out, draft_out, gen = (host[k] for k in _READBACK)
            iters0 = pending.iters0
            n = len(pending.seqs)
            for i, s in enumerate(pending.seqs):
                if s.status is not SequenceStatus.RUNNING or len(s) != pending.expected_lens[i]:
                    continue
                off = len(s) - starts[i]
                self._extend(s, window[i, off : off + (cur_out[i] - len(s))].tolist())
                s.num_cached_tokens = len(s) - 1
                s.draft = draft_out[i]
                s.jacobi_iters = int(iters_out[i])
                self.stats["generated_tokens"] += int(gen[i])
            it_delta = int(iters_out[:n].sum() - iters0[:n].sum())
            self.stats["jacobi_iterations"] += it_delta
            if pending.stat_key:
                self.stats[pending.stat_key] = self.stats.get(pending.stat_key, 0) + it_delta
            # loop trips this chunk = the slowest row's iterations
            self._count_trips(int((iters_out[:n] - iters0[:n]).max(initial=0)), len(iters0))

    def _flush_pending(self) -> List[Sequence]:
        """Commit every outstanding chunk; returns their sequences, whose
        state may have changed, for the caller to postprocess."""
        touched: List[Sequence] = []
        with self.spans["flush"]:
            for pending in self._pending.values():
                self._commit_chunk(pending)
                touched.extend(pending.seqs)
            self._pending.clear()
        return touched

    def _extend(self, s: Sequence, toks: List[int]) -> None:
        """Commit `toks` to `s`; the first output token it gets adds its wait
        since the request's prefill to `stats["first_commit_s"]`."""
        s.extend_tokens(toks)
        if s.t_first is None and s.num_completion_tokens:
            s.t_first = time.perf_counter()
            self.stats["first_commit_s"] += s.t_first - s.t_prefilled
            self.stats["first_commits"] += 1

    def _count_trips(self, trips: int, B: int) -> None:
        """One chunk or block of `trips` loop trips over a bucket of `B` rows."""
        self.stats["chunk_forwards"] += trips
        self.stats["trip_slots"] += B * trips
        self.stats["chunk_calls"] += 1

    def _land(self, seqs: List[Sequence]) -> None:
        """Flush before reading the mirrors of `seqs` (their length, draft,
        last token), which lag one chunk while one of them has work pending."""
        ids = set(map(id, seqs))
        if any(id(s) in ids for p in self._pending.values() for s in p.seqs):
            self._flush_pending()

    def _jacobi_chunk(self, seqs: List[Sequence], L: int, eos_id: int,
                      stat_key: Optional[str] = None, *, nongreedy: bool = False,
                      top_k: int = -1, use_top_p: bool = False) -> None:
        """Run one single-block Jacobi chunk for a group, greedy or
        rejection-sampling.  With `jacobi_async_host` its tokens are committed
        at the group's next chunk (or a flush); `stat_key` names a counter
        credited with the chunk's iterations at commit."""
        use_async = self.config.jacobi_async_host
        sig = self._chunk_sig(seqs, L, eos_id, nongreedy, top_k, use_top_p)
        pending = self._pending.pop(sig, None)
        valid = pending is not None and all(
            s.status is SequenceStatus.RUNNING and len(s) == el
            for s, el in zip(pending.seqs, pending.expected_lens)
        )
        if use_async and valid:
            # dispatch chunk k+1 from chunk k's outputs, then commit chunk k
            # on the host while k+1's first trip runs
            chunk = self._dispatch_chunk(seqs, L, eos_id, nongreedy, top_k, use_top_p,
                                         handles={k: pending.res[k] for k in _HANDLES})
            self._commit_chunk(pending)
            iters0 = np.zeros_like(pending.iters0)
            iters0[: len(seqs)] = [s.jacobi_iters for s in seqs]
            self._pending[sig] = self._finish_chunk(chunk, seqs, iters0, stat_key)
            return
        if pending is not None:
            self._commit_chunk(pending)
        if self._pending:
            # group membership changed (a finish without backfill, a
            # preemption, another strategy mix): land the other groups'
            # pending work before their mirrors drift
            self._flush_pending()
        iters0 = np.zeros((_bucket(len(seqs), self.config.batch_buckets),), np.int32)
        iters0[: len(seqs)] = [s.jacobi_iters for s in seqs]
        chunk = self._dispatch_chunk(seqs, L, eos_id, nongreedy, top_k, use_top_p)
        rec = self._finish_chunk(chunk, seqs, iters0, stat_key)
        if use_async:
            self._pending[sig] = rec  # the lag begins: committed at the next call
        else:
            self._commit_chunk(rec)

    # ------------------------------------------------------------------
    def _mr_dispatch(self, seqs: List[Sequence], N: int, K: int, C: int, eos_id: int) -> None:
        """Route one MR chunk through the measured auto-policy
        (engine/mr_policy.py): full MR / MR without candidates / RA-only /
        TRUE single-block.  All are greedy and commit identical tokens, so
        the arm only changes throughput, never output."""
        if not self.config.jacobi_mr_auto_policy or C < 1:
            self._multiblock_chunk(seqs, N, K, C, eos_id)
            return
        pol = self._mr_policies.get((N, K, C))
        if pol is None:
            pol = self._mr_policies[(N, K, C)] = MRAutoPolicy(
                probe_chunks=self.config.jacobi_mr_probe_chunks,
                reprobe_every=self.config.jacobi_mr_reprobe_every,
                n_arms=4 if self.config.jacobi_mr_single_arm else 3,
                # an arm's first call may pay one-time set-up (a kernel build):
                # keep it out of the probe window
                discard_first=True,
            )
        arm = pol.pick()
        force = os.environ.get("JF_MR_FORCE_ARM")
        if force:
            arm = int(force)
            if arm not in range(pol.n_arms):
                raise ValueError(
                    f"JF_MR_FORCE_ARM={force!r} names no arm: expected 0..{pol.n_arms - 1}")
        # Arm transitions happen OUTSIDE the timed window: they are one-time
        # costs of probe rotation, absent in the locked steady state the
        # measurement predicts.
        if arm == ARM_SINGLE:
            self._mr_to_single(seqs, N)
        else:
            self._mr_reenter(seqs, N, K, C)
        locked_async = (arm == ARM_SINGLE and pol.locked == ARM_SINGLE
                        and self.config.jacobi_async_host)
        if not locked_async:
            # a probing (or forced) single-arm chunk runs synchronously, so
            # the recorded wall maps to its own committed tokens; the flush of
            # pipeline state comes before gen0 / t0 (the JAX engine flushes
            # inside the window, `llm_engine.py:920-921`)
            self._land(seqs)
        gen0 = self.stats["generated_tokens"]
        t0 = time.perf_counter()
        if locked_async:
            # the LOCKED single arm rides the pipeline like any Jacobi group;
            # its commits (and `mr_single` credits) lag one chunk
            self._jacobi_chunk(seqs, N, eos_id, stat_key="mr_single")
        elif arm == ARM_SINGLE:
            # TRUE single-block: the sliding-window greedy chunk program
            iters0 = np.zeros((_bucket(len(seqs), self.config.batch_buckets),), np.int32)
            iters0[: len(seqs)] = [s.jacobi_iters for s in seqs]
            chunk = self._dispatch_chunk(seqs, N, eos_id, False, -1, False)
            self._commit_chunk(self._finish_chunk(chunk, seqs, iters0, "mr_single"))
        else:
            # The three MR arms run the SAME chunk program over the SAME
            # carried state; the knobs only gate which tiers can engage:
            #   arm 1 disables candidates: lookahead_start = N+1 can never be
            #     reached by block acceptance (<= N);
            #   arm 2 additionally stops pseudo spawning (spawn threshold
            #     N+1), draining to the RA-only tier (N-token forwards).
            self._multiblock_chunk(
                seqs, N, K, C, eos_id,
                la_override=(N + 1) if arm >= 1 else None,
                spawn_override=(N + 1) if arm == 2 else None,
            )
        # every chunk path ends with a host read-back, so this wall time is real
        dt = time.perf_counter() - t0
        if self.group is not None:
            # ranks' clocks differ: the arms are picked from the group's first
            # rank's wall time, or the ranks would part in their collectives
            dt = float(collectives.broadcast_first(
                torch.tensor([dt], dtype=torch.float64, device=self.device), self.group))
        toks = self.stats["generated_tokens"] - gen0
        # drain edge: some row hit its finish condition during this chunk; its
        # collapsed per-slot yield is batch structure, not workload drift
        drained = any(
            s.num_completion_tokens >= s.max_tokens
            or (eos_id >= 0 and len(s) > 0 and s.last_token == eos_id)
            for s in seqs
        )
        if os.environ.get("JF_MR_POLICY_LOG", "0") == "1":
            print(f"[mr_policy] arm={arm} B={len(seqs)} toks={toks} "
                  f"wall={dt*1e3:.1f}ms locked={pol.locked} "
                  f"drained={drained}", flush=True)
        pol.record(arm, toks, dt, slots=len(seqs), drained=drained)

    def _mr_to_single(self, seqs: List[Sequence], N: int) -> None:
        """Hand MR state off to the single-block program.  Exact at ANY chunk
        boundary: single-block's draft[0] is the last committed token (always
        known) and its verifier never pre-commits, so the speculative tail
        can be anything; it is seeded with the RA block's draft (whose
        position in the token stream is exactly the commit point) to carry
        the MR lookahead work across the handoff."""
        self._land([s for s in seqs if s.mb_state is not None])
        for s in seqs:
            st = s.mb_state
            if st is None:
                continue
            ra = int(st["ra"])
            dlen = int(st["blk_dlen"][ra])
            d = np.empty((N,), np.int32)
            d[0] = s.last_token
            take = min(max(dlen, 0), N - 1)
            if take:
                d[1 : 1 + take] = np.asarray(st["blk_draft"][ra][:take])
            if 1 + take < N:
                d[1 + take :] = self.rng.randint(0, self.model_cfg.vocab_size, N - 1 - take)
            s.draft = d
            s.mb_state = None

    def _mr_reenter(self, seqs: List[Sequence], N: int, K: int, C: int) -> None:
        """Re-enter the MR state machine from single-block state.  MR
        pre-commits RA draft[0] unconditionally (it is by invariant the
        model's greedy continuation, verified in the previous iteration), so
        the sliding draft's spec[0], which is UNVERIFIED after an AR
        fallback, cannot seed it directly.  One non-committing AR forward
        recomputes the verified continuation; the rest of the sliding draft
        carries over as the speculative tail."""
        need = [s for s in seqs if s.mb_state is None and s.draft is not None]
        if not need:
            return
        # leaving the single arm: its pipeline lands first (the draft and the
        # committed length read below lag one chunk while it is pending)
        self._land(need)
        # temperature 0 -> greedy argmax; the write re-writes the seed's own
        # KV slot with identical content (a deterministic function of the
        # prefix), so the cache is unchanged and nothing is committed
        B = _bucket(len(need), self.config.batch_buckets)
        nxt = self._ar_forward(need, np.zeros((B,), np.float32))
        for i, s in enumerate(need):
            old = np.asarray(s.draft)
            draft0 = np.empty((N,), np.int32)
            draft0[0] = int(nxt[i])
            # old = [seed, spec0, spec1, ...]; spec0 is superseded by the
            # verified continuation, the rest stays as the tail guess
            take = min(max(old.shape[0] - 2, 0), N - 1)
            if take:
                draft0[1 : 1 + take] = old[2 : 2 + take]
            if 1 + take < N:
                draft0[1 + take :] = self.rng.randint(
                    0, self.model_cfg.vocab_size, N - 1 - take)
            s.draft = None
            s.mb_state = self._mb_bootstrap(s, draft0, N, K, C)

    def mr_policy_snapshot(self) -> Dict[str, Any]:
        return {str(k): p.snapshot() for k, p in self._mr_policies.items()}

    def _mb_bootstrap(self, s: Sequence, draft0: np.ndarray, N: int, K: int, C: int) -> dict:
        """Fresh MR state with one RA block at the current commit point.
        `draft0[0]` MUST be the model's verified greedy continuation of the
        committed prefix (prefill bootstrap or the re-entry AR forward): the
        MR verifier pre-commits it unconditionally."""
        W = 2 * N
        bd = np.zeros((K, N), np.int32)
        bd[0] = draft0
        return {
            "blk_draft": bd,
            "blk_dlen": np.asarray([N] + [0] * (K - 1), np.int32),
            "blk_acc": np.zeros((K,), np.int32),
            "blk_acc_toks": np.zeros((K, N), np.int32),
            "blk_base": np.asarray([len(s)] + [0] * (K - 1), np.int32),
            "blk_active": np.asarray([True] + [False] * (K - 1), bool),
            "ra": np.int32(0),
            "n_active": np.int32(1),
            "pool": np.zeros((C, W), np.int32),
            "pool_len": np.zeros((C,), np.int32),
            "pool_next": np.int32(0),
            "last_next": np.int32(draft0[0]),
        }

    def _multiblock_chunk(
        self, seqs: List[Sequence], N: int, K: int, C: int, eos_id: int,
        la_override: Optional[int] = None,
        spawn_override: Optional[int] = None,
    ) -> None:
        """One BATCHED chunk of multiblock + rejection-recycling decoding."""
        with self.spans["mr"]:
            W = 2 * N
            pad_id = max(self.config.pad, 0)
            B = _bucket(len(seqs), self.config.batch_buckets)
            n = len(seqs)

            for s in seqs:
                if s.mb_state is None:
                    pf = s.prefill_draft if s.prefill_draft is not None else np.zeros(0, np.int32)
                    draft0 = np.full((N,), pad_id, np.int32)
                    m = min(len(pf), N)
                    draft0[:m] = pf[:m]
                    if m < N:
                        draft0[m:] = self.rng.randint(0, self.model_cfg.vocab_size, N - m)
                    s.prefill_draft = None
                    s.mb_state = self._mb_bootstrap(s, draft0, N, K, C)

            def stack(key):
                first = np.asarray(seqs[0].mb_state[key])
                out = np.zeros((B,) + first.shape, first.dtype)
                for i, s in enumerate(seqs):
                    out[i] = s.mb_state[key]
                return self._tensor(out)

            tokens = np.zeros((B, self.cap_tokens), np.int32)
            cur_len = np.ones((B,), np.int32)
            eos = np.ones((B,), bool)  # padding rows inert
            iters = np.zeros((B,), np.int32)
            capacity = np.zeros((B,), np.int32)
            max_new = np.zeros((B,), np.int32)
            max_iters = np.ones((B,), np.int32)
            spawn_thr = np.full((B,), N, np.int32)
            la_start = np.zeros((B,), np.int32)
            for i, s in enumerate(seqs):
                sp = s.sampling_params
                tokens[i, : len(s)] = s.token_ids
                cur_len[i] = len(s)
                # a sequence whose EOS a flush just committed stays inert
                eos[i] = eos_id >= 0 and s.num_completion_tokens > 0 and s.last_token == eos_id
                iters[i] = s.jacobi_iters
                capacity[i] = min(self.block_manager.capacity_tokens(s), self.cap_tokens - 1)
                max_new[i] = max(0, s.max_tokens - s.num_completion_tokens)
                max_iters[i] = min(sp.jacobi_max_iterations, 2**30)
                spawn_thr[i] = (
                    spawn_override if spawn_override is not None
                    else int(math.ceil(sp.jacobi_spawn_ratio * N))
                )
                la_start[i] = (
                    la_override if la_override is not None
                    else int(math.ceil(sp.jacobi_lookahead_start_ratio * N))
                )

            res = jacobi_chunk_multiblock(
                self.params, self.model_cfg, self.rope, self.kv,
                self._tensor(tokens), self._tensor(cur_len),
                *(stack(k) for k in STATE_KEYS),
                self._tensor(eos), self._tensor(iters), self._pad_block_table(seqs, B),
                self._tensor(capacity), self._tensor(max_new), eos_id, pad_id,
                self._tensor(spawn_thr), self._tensor(la_start), self._tensor(max_iters),
                N=N, K=K, C=C, W=W,
                chunk_budget=self.config.jacobi_chunk_tokens,
                chunk_iters=self.config.jacobi_chunk_iters, group=self.group,
            )
            host = {k: v.cpu().numpy() for k, v in res.items() if k != "kv"}
            toks, cur_out, iters_out, gen = (
                host[k] for k in ("tokens", "cur_len", "iters", "generated"))
            for i, s in enumerate(seqs):
                self._extend(s, toks[i, len(s) : cur_out[i]].tolist())
                s.num_cached_tokens = len(s) - 1
                s.jacobi_iters = int(iters_out[i])
                for k in STATE_KEYS:
                    s.mb_state[k] = host[k][i]
                self.stats["generated_tokens"] += int(gen[i])
            self.stats["jacobi_iterations"] += int(iters_out[:n].sum() - iters[:n].sum())
            # loop trips this chunk = the slowest row's iterations
            self._count_trips(int((iters_out[:n] - iters[:n]).max(initial=0)), B)
            for name, count in zip(("mr_full", "mr_nocand", "mr_ra_only"), host["tiers"].tolist()):
                self.stats[name] = self.stats.get(name, 0) + int(count)

    # ------------------------------------------------------------------
    def _onpolicy_block(self, seqs: List[Sequence], L: int, top_k: int, use_top_p: bool,
                        greedy_mode: bool, accept_threshold: float) -> None:
        """Run one on-policy rollout block per sequence and append its record
        (the reference's record format, jacobi_decoding_nongreedy_on_policy.py).
        The initial block is drawn from the prompt's tokens by the host
        generator, in the JAX engine's order."""
        B = _bucket(len(seqs), self.config.batch_buckets)
        tokens = np.zeros((B, self.cap_tokens), np.int32)
        cur_len = np.ones((B,), np.int32)
        block_init = np.zeros((B, L), np.int32)
        gen_len = np.zeros((B,), np.int32)
        active = np.zeros((B,), bool)
        capacity = np.zeros((B,), np.int32)
        temps = np.ones((B,), np.float32)
        top_ps = np.ones((B,), np.float32)
        pad_id = max(self.config.pad, 0)

        stops = list(self.config.stop_token_ids)
        if self.config.eos >= 0 and self.config.eos not in stops:
            stops.append(self.config.eos)
        stops_arr = np.full((max(4, len(stops)),), -1, np.int32)
        stops_arr[: len(stops)] = stops

        prefixes = []
        for i, s in enumerate(seqs):
            tokens[i, : len(s)] = s.token_ids
            cur_len[i] = len(s)
            gl = min(L, max(0, s.max_tokens - s.num_completion_tokens))
            gen_len[i] = gl
            active[i] = gl > 0 and not s.op_stopped
            capacity[i] = min(self.block_manager.capacity_tokens(s), self.cap_tokens - 1)
            temps[i] = s.sampling_params.temperature
            top_ps[i] = s.sampling_params.top_p
            prefixes.append(list(s.token_ids))
            # prompt-conditioned draft init (on_policy.py:254-265)
            choices = [t for t in s.token_ids if t != pad_id]
            if choices:
                block_init[i, :gl] = self.rng.choice(choices, size=gl)
            else:
                block_init[i, :gl] = self.rng.randint(0, self.model_cfg.vocab_size, gl)
            block_init[i, gl:] = pad_id

        res = runner.jacobi_onpolicy_block(
            self.params, self.model_cfg, self.rope, self.kv,
            self._tensor(tokens), self._tensor(cur_len), self._tensor(block_init),
            self._tensor(gen_len), self._tensor(active), self._pad_block_table(seqs, B),
            self._tensor(capacity), self._tensor(temps), self._tensor(top_ps), self.generator,
            self._tensor(stops_arr), pad_id, top_k=top_k, use_top_p=use_top_p,
            greedy_mode=greedy_mode, accept_threshold=accept_threshold, group=self.group,
        )
        self.kv = res["kv"]
        tokens_out, cur_out, iters_out, fwds_out, stopped_out, traj_out = (
            res[k].cpu().numpy() for k in ("tokens", "cur_len", "iters", "fwds", "stopped", "traj")
        )
        for i, s in enumerate(seqs):
            if not active[i]:
                continue
            new = tokens_out[i, len(s) : cur_out[i]].tolist()
            self._extend(s, new)
            s.num_cached_tokens = len(s) - 1
            s.op_iters += int(iters_out[i])
            s.op_fwds += int(fwds_out[i])
            s.op_stopped = bool(stopped_out[i])
            s.jacobi_iters += 1  # block count (on-policy max_iterations = blocks)
            n_it = int(iters_out[i])
            total_toks = s.num_completion_tokens
            s.rollout_records.append({
                "diffusion_itr_id": f"itr_{len(s.rollout_records)}",
                "prompt_ids": prefixes[i],
                "answer_trajectory_ids": traj_out[i, : n_it + 1].tolist(),
                "teacher_output_ids": None,  # max-filled at retirement
                "tokens_per_iter": total_toks / max(s.op_iters, 1),
                "tokens_per_forward": total_toks / max(s.op_fwds, 1),
                "num_iters": s.op_iters,
                "num_forwards": s.op_fwds,
            })
            self.stats["generated_tokens"] += len(new)
            self.stats["jacobi_iterations"] += n_it
        # loop trips of this block = the slowest row's iterations
        self._count_trips(int(iters_out[: len(seqs)].max(initial=0)), B)

    # ------------------------------------------------------------------
    def exit(self) -> None:
        """Release the pending chunks, the graphs, the KV pool and the
        weights' references, and clear the serving mesh.  The process groups
        of a mesh the engine built are destroyed; a mesh it was given, and
        the world, stay with their owner."""
        self._pending.clear()
        self.programs = None
        self.kv = None
        self.params = None
        set_serving_mesh(None)
        if self._owns_mesh and self.mesh is not None:
            self.mesh.destroy()
        self.mesh = self.group = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.exit()
        return False

    def generate_stream(self, prompt_token_ids: List[int], sampling_params: SamplingParams):
        """Yield lists of newly committed token ids, one per engine step."""
        seq = self.add_request(prompt_token_ids, sampling_params)
        emitted = 0
        while not seq.is_finished:
            self.step()
            # stream what is committed: land the chunk in flight
            self.scheduler.postprocess(self._flush_pending())
            new = seq.completion_token_ids[emitted:]
            if new:
                emitted += len(new)
                yield new

    def warmup(
        self,
        *,
        strategies: PySeq[str] = ("ar", "jacobi"),
        block_lens: Optional[PySeq[int]] = None,
        batch_buckets: Optional[PySeq[int]] = None,
        prefill_token_buckets: Optional[PySeq[int]] = None,
    ) -> Dict[str, float]:
        """Build the kernels and capture the graphs of the engine's shape
        buckets by driving synthetic requests through them.

        The JAX engine's `warmup` (its TPU analog of the reference's
        CUDA-graph capture at init, model_runner.py:1552-1658) with the same
        tags, arguments and return value.  On the card each warmed decode
        bucket's graph is captured here, the largest batch bucket first so
        that the smaller graphs reuse the pool it grew; the requests then run
        through the real scheduler, prefill and decode path, so warmed shapes
        are serving shapes.  Their tokens are discarded and their KV pages
        freed.  `strategies` may include "ar", "jacobi", "jacobi_nongreedy"
        and "mr".  Returns {warm_tag: seconds}.
        """
        cfg = self.config
        bbs = list(batch_buckets if batch_buckets is not None else cfg.batch_buckets)
        tbs = list(prefill_token_buckets if prefill_token_buckets is not None
                   else cfg.prefill_token_buckets)
        Ls = list(block_lens if block_lens is not None else [cfg.jacobi_block_len])
        V = self.model_cfg.vocab_size
        timings: Dict[str, float] = {}

        def sp_for(strategy: str, L: int) -> SamplingParams:
            if strategy == "ar":
                return SamplingParams(temperature=0.0, max_tokens=2)
            if strategy == "jacobi_nongreedy":
                return SamplingParams(temperature=0.7, max_tokens=2, decode_strategy=self.NONGREEDY,
                                      jacobi_block_len=L, jacobi_max_blocks=1)
            if strategy == "mr":
                return SamplingParams(temperature=0.0, max_tokens=2, decode_strategy=self.MR,
                                      jacobi_block_len=L, jacobi_max_blocks=cfg.jacobi_max_blocks,
                                      jacobi_n_gram_pool_size=cfg.jacobi_n_gram_pool_size)
            return SamplingParams(temperature=0.0, max_tokens=2, decode_strategy="jacobi",
                                  jacobi_block_len=L, jacobi_max_blocks=1)

        def run(tag: str, n_prompts: int, prompt_len: int, strategy: str, L: int):
            t0 = time.perf_counter()
            prompts = [self.rng.randint(1, V, prompt_len).tolist() for _ in range(n_prompts)]
            self.generate(prompts, sp_for(strategy, L))
            timings[tag] = round(time.perf_counter() - t0, 2)

        strategies = list(strategies)
        if "mr" in strategies and cfg.jacobi_mr_auto_policy and cfg.jacobi_mr_single_arm:
            # the auto-policy's single arm runs the Jacobi program and its
            # re-entry the AR step: warm both
            strategies += [x for x in ("jacobi", "ar") if x not in strategies]
        for strategy in strategies:
            for L in Ls if strategy != "ar" else [0]:
                if strategy in ("ar", "jacobi", "jacobi_nongreedy"):
                    for B in sorted(set(bbs), reverse=True):  # the largest graph first
                        if strategy == "ar":
                            self.programs.ar(B)
                        else:
                            self.programs.jacobi(B, L, strategy != "jacobi", -1, False)
                ltag = f"_L{L}" if L else ""
                for B in bbs:  # one decode program per batch bucket
                    run(f"{strategy}{ltag}_B{B}", B, 32, strategy, L)
                for T in tbs:  # one prefill shape per token bucket
                    plen = min(T - L, cfg.max_model_len - L - 8)
                    if plen <= 0:
                        continue
                    run(f"prefill_{strategy}{ltag}_T{T}", 1, plen, strategy, L)
        # warmup traffic (kernel builds, captures) must not seed the MR
        # auto-policy's measurements
        self._mr_policies.clear()
        return timings

    def generate(
        self,
        prompt_token_ids: List[List[int]],
        sampling_params: SamplingParams | List[SamplingParams],
        use_tqdm: bool = False,
    ) -> List[Dict[str, Any]]:
        """Blocking batch generation."""
        if isinstance(sampling_params, SamplingParams):
            sampling_params = [sampling_params] * len(prompt_token_ids)
        seqs = [self.add_request(p, sp) for p, sp in zip(prompt_token_ids, sampling_params)]
        t0 = time.perf_counter()
        pbar = None
        if use_tqdm:
            from tqdm import tqdm

            pbar = tqdm(total=len(seqs), desc="generate")
        while not self.scheduler.is_finished:
            finished = self.step()
            if pbar is not None:
                pbar.update(len(finished))
        if pbar is not None:
            pbar.close()
        self.stats["wall_s"] = time.perf_counter() - t0
        outs = []
        for s in seqs:
            out = {"token_ids": s.completion_token_ids}
            if self.tokenizer is not None:
                out["text"] = self.tokenizer.decode(s.completion_token_ids)
            if s.rollout_records:
                # max-fill teacher_output_ids with the final full sequence
                full = list(s.token_ids)
                for rec in s.rollout_records:
                    rec["teacher_output_ids"] = full
                out["rollout_records"] = s.rollout_records
            outs.append(out)
        return outs
