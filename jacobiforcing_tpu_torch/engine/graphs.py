"""Decode programs per shape bucket, replayed as CUDA graphs on the card.

The counterpart of the JAX package's one compiled executable per shape bucket
(its `config.py` calls them "the TPU analog of per-(B, L) CUDA graphs") and
of the reference engine's CUDA-graph capture at init (model_runner.py:
1552-1658).  One program per
  * batch bucket B for the AR step (`ar`);
  * (B, L) for a greedy Jacobi trip (`jacobi`);
  * (B, L, top_k, top-p on) for a rejection-sampling trip.
A program owns fixed buffers that the engine refills from the host once per
chunk (or AR step); a trip reads and writes only those, the KV pool and the
weights, whose addresses never change.  With `capture` (the card, unless
`Config.enforce_eager`) the first use of a program captures its trip:
  * the eager trip runs once on a side stream first, over the inert buffers
    (every row finished, every page -1, so the KV writes land in the trash
    rows): kernel builds, `cudaFuncSetAttribute`, cuBLAS workspaces;
  * every graph allocates from one memory pool (`LLMEngine.warmup` captures
    the largest bucket first, as the reference engine does, so the smaller
    graphs fit in what it grew);
  * the engine's `torch.Generator` is registered with the graph, so every
    replay draws fresh numbers from it; the eager run's draws are undone, so
    a replay draws what the eager trip would have.
The kernel wrappers count their launches at capture; each replay adds the
graph's launches to their counts instead (`paged_attention_cuda.launches`
and `.ws_launches` count kernel runs either way).  A capture that fails
raises; nothing falls back to eager.  Without `capture` (the CPU, or
`enforce_eager`) the same programs run their trips eagerly over the same
buffers.

Under tensor parallelism (`group`, the model group) a trip holds the
forward's collectives.  An NCCL group's collectives are captured into the
graph with the kernels; a gloo group cannot be captured, so capturing over
one raises (`Config.enforce_eager=True` runs such a world eagerly).
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from jacobiforcing_tpu_torch.engine import runner
from jacobiforcing_tpu_torch.parallel.collectives import Group


class ARProgram:
    """The AR decode step of one batch bucket over fixed input buffers."""

    def __init__(self, B: int, P: int, device):
        def i32(fill):
            return torch.full((B,), fill, dtype=torch.int32, device=device)

        self.last_tokens, self.seq_lens = i32(0), i32(1)
        self.block_tables = torch.full((B, P), -1, dtype=torch.int32, device=device)
        self.active = torch.zeros((B,), dtype=torch.bool, device=device)
        self.temperature = torch.zeros((B,), dtype=torch.float32, device=device)
        self.step: Callable[[], torch.Tensor] = None  # eager step or graph replay
        self.out: Optional[torch.Tensor] = None  # the graph's output buffer

    def load(self, **values: torch.Tensor) -> None:
        for name, v in values.items():
            getattr(self, name).copy_(v)


class ChunkProgram:
    """A Jacobi trip of one bucket over its `runner.ChunkBuffers`."""

    def __init__(self, buf: runner.ChunkBuffers):
        self.buf = buf
        self.trip: Callable[[], None] = None  # eager trip or graph replay


class DecodePrograms:
    def __init__(self, params, cfg, rope, kv, generator: torch.Generator, *, pages_bucket: int,
                 cap_tokens: int, chunk_budget: int, chunk_iters: int, capture: bool,
                 group: Group = None):
        if capture and group is not None and dist.get_backend(group) != "nccl":
            raise ValueError(
                f"a {dist.get_backend(group)} model group cannot be captured in CUDA graphs: "
                "run it with enforce_eager=True, or use NCCL")
        self.params, self.cfg, self.rope, self.kv = params, cfg, rope, kv
        self.group = group
        self.generator = generator
        self.device = generator.device
        self.pages_bucket, self.cap_tokens = pages_bucket, cap_tokens
        self.chunk_budget, self.chunk_iters = chunk_budget, chunk_iters
        self.capture = capture
        self.pool = torch.cuda.graph_pool_handle() if capture else None
        self.programs: Dict[tuple, object] = {}
        # per captured bucket: seconds (eager run + capture), bytes the graph
        # pool grew by, and the kernel launches inside the graph
        self.capture_s: Dict[tuple, float] = {}
        self.pool_bytes: Dict[tuple, int] = {}
        self.launches: Dict[tuple, list] = {}

    # ------------------------------------------------------------------
    def ar(self, B: int) -> ARProgram:
        key = ("ar", B)
        prog = self.programs.get(key)
        if prog is None:
            prog = ARProgram(B, self.pages_bucket, self.device)

            def step():
                return runner.ar_decode_step(
                    self.params, self.cfg, self.rope, self.kv, prog.last_tokens,
                    prog.seq_lens, prog.block_tables, prog.active, prog.temperature,
                    self.generator, self.group)[1]

            if self.capture:
                graph, prog.out = self._capture(key, step)
                prog.step = self._replay(key, graph, prog.out)
            else:
                prog.step = step
            self.programs[key] = prog
        return prog

    def jacobi(self, B: int, L: int, nongreedy: bool, top_k: int, use_top_p: bool
               ) -> ChunkProgram:
        key = ("jacobi_nongreedy", B, L, top_k, use_top_p) if nongreedy else ("jacobi", B, L)
        prog = self.programs.get(key)
        if prog is None:
            buf = runner.ChunkBuffers.alloc(B, L, self.cap_tokens, self.pages_bucket,
                                            self.device)
            prog = ChunkProgram(buf)
            if nongreedy:
                step = runner.nongreedy_step(self.params, self.cfg, self.rope, buf,
                                             self.generator, top_k, use_top_p, self.group)
            else:
                step = runner.greedy_step(self.params, self.cfg, self.rope, buf, self.generator,
                                          self.group)

            def trip():
                runner.chunk_trip(step, self.kv, buf, self.chunk_budget, self.chunk_iters)

            if self.capture:
                graph, _ = self._capture(key, trip)
                prog.trip = self._replay(key, graph, None)
            else:
                prog.trip = trip
            self.programs[key] = prog
        return prog

    @property
    def num_graphs(self) -> int:
        return len(self.capture_s)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _capture(self, key: tuple, fn: Callable) -> Tuple[torch.cuda.CUDAGraph, object]:
        t0 = time.perf_counter()
        rng_state = self.generator.get_state()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            fn()  # eager: kernel builds, cuBLAS handles and workspaces
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        # the eager run's draws are undone (the capture itself draws none), so
        # replays draw what eager trips would have
        self.generator.set_state(rng_state)
        gc.collect()  # what `torch.cuda.graph` frees on entry, freed before the count
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        counters = _kernel_counters()
        before = [getattr(f, name) for f, name in counters]
        with torch.cuda.graph(graph, pool=self.pool):
            out = fn()
        torch.cuda.synchronize(self.device)
        # a kernel's wrapper counted its launches into the graph, which ran
        # nothing: they count at each replay instead
        captured = []
        for (f, name), b in zip(counters, before):
            captured.append(getattr(f, name) - b)
            setattr(f, name, b)
        self.launches[key] = captured
        self.pool_bytes[key] = torch.cuda.memory_reserved(self.device) - reserved0
        self.capture_s[key] = time.perf_counter() - t0
        return graph, out

    def _replay(self, key: tuple, graph: torch.cuda.CUDAGraph, out):
        counted = [(f, name, n)
                   for (f, name), n in zip(_kernel_counters(), self.launches[key]) if n]

        def replay():
            graph.replay()
            for f, name, n in counted:
                setattr(f, name, getattr(f, name) + n)
            return out

        return replay


def _kernel_counters():
    """(wrapper, attribute) of every launch count a captured program can
    move: the wrappers of the kernels it can launch, each with its `launches`
    count, and kernel 1's count of its warp-specialised design."""
    from jacobiforcing_tpu_torch.ops import decoder_pointwise_cuda as dpc
    from jacobiforcing_tpu_torch.ops.paged_attention_cuda import paged_attention_cuda

    return ((paged_attention_cuda, "launches"), (dpc.add_rms_norm_cuda, "launches"),
            (dpc.qkv_rope_cuda, "launches"), (dpc.silu_mul_cuda, "launches"),
            (paged_attention_cuda, "ws_launches"))
