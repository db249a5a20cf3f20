"""Serving cells: requests into `LLMEngine.add_request`, `LLMEngine.step`
until the window closes, then the drain, then the check.

Set-up (counted in `setup_s`): the weights from the seed, the engine with the
traffic file's settings (`engine`), and `LLMEngine.warmup` over exactly the
cell's decode strategy, block length, batch buckets and prefill buckets, so
that every kernel is built and every decode graph captured before the window.

The window opens when the first request is sent and closes at the first step
that ends `--seconds` later.  Closed loop: every client sends a request when
the window opens and its next one when its last completes.  Open loop: each
request is sent when it is due, from the fixed schedule of `lib/traffic`.
A client sees a request's tokens when `step` returns with them committed.
After the window no closed-loop client sends again; the open loop goes on
arriving, so the requests of the window finish under the same load, and
the run waits up to the traffic's `drain_s` for them.  A request sent in the
window that has not finished then counts as failed.

Bookkeeping per step, for the metrics: each sequence's committed length and
Jacobi iterations (per-sequence trips) as the host sees them after `step`,
the prompts each prefill forwarded, the engine's counters and kernel 1's
launch counter.  The rows and pairs of a trip are counted from the
sequence's committed length at the start of the chunk and the tokens the
chunk committed (a linear rise over its trips: the count at the chunk's mean
length, exact for full causal layers).  Attention is counted per shape of
the architecture's layers (`lib/registry.Arch.attention`), each with its own
heads and window.

`memory_peak_bytes` is memory in use: the allocator's peak less the KV
pool's pages that no request held at once.  The engine reserves the pool
from 0.9 of free memory whatever the traffic needs; the pages beyond the
most the run held are reserved, not used.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

import numpy as np
import torch

from h100_bench.lib.trace import Tracer, span
from h100_bench.lib.traffic import Request, Traffic
from h100_bench.lib.weights import make_hf_tensors, port_params


@dataclass
class Live:
    req: Request
    seq: object
    due: float
    sent: float
    in_window: bool
    client: int = -1
    first: Optional[float] = None
    done: Optional[float] = None
    len0: int = 0
    it0: int = 0
    prefilled: bool = False


@dataclass
class Work:
    """Counts over a span of steps.  Pairs are kept per attention shape
    (NH, KH, D, window) of the architecture: {shape: visible (query, key)
    pairs of one layer and one query head of that shape}."""

    seq_trips: int = 0  # per-sequence Jacobi iterations
    trip_pairs: Dict[tuple, float] = field(default_factory=dict)  # of those trips
    prefill_rows: int = 0
    prefill_head_rows: int = 0
    prefill_pairs: Dict[tuple, int] = field(default_factory=dict)
    k1_ops: float = 0.0  # kernel 1's operations and bytes, as counts/paged_attention gives
    k1_bytes: float = 0.0
    k1_launches: int = 0
    stats: Dict[str, float] = field(default_factory=dict)


def _stats_delta(a: dict, b: dict) -> dict:
    return {k: b.get(k, 0) - a.get(k, 0) for k in b}


class ServeRun:
    def __init__(self, ctx):
        self.ctx = ctx
        self.cfg = ctx.cfg
        self.tr = ctx.traffic
        self.arch = ctx.arch
        self.L = int(self.tr["sampling"]["jacobi_block_len"])
        self.device = ctx.device

    # ------------------------------------------------------------------ set-up
    def setup(self):
        from jacobiforcing_tpu_torch.config import Config, SamplingParams
        from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine

        ctx, tr = self.ctx, self.tr
        t = time.perf_counter()
        mc, params = port_params(self.arch.layout, self.cfg, ctx.seed, self.device)
        self.setup_parts = {"weights": time.perf_counter() - t}
        t = time.perf_counter()
        eng_kw = {k: tuple(v) if isinstance(v, list) else v for k, v in tr["engine"].items()}
        config = Config(seed=ctx.seed % (1 << 32), eos=-1, **eng_kw)
        self.engine = LLMEngine(config, model_cfg=mc, params=params, device=self.device)
        del params
        self.setup_parts["engine"] = time.perf_counter() - t
        kv = self.engine.kv
        storages = {t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                    for t in (kv.k, kv.v, kv.k_scale, kv.v_scale) if t is not None}
        self.pool_bytes = sum(storages.values())
        t = time.perf_counter()
        self.sp = SamplingParams(**tr["sampling"])
        self.engine.warmup(strategies=tuple(tr["warmup"]["strategies"]), block_lens=(self.L,),
                           batch_buckets=config.batch_buckets,
                           prefill_token_buckets=config.prefill_token_buckets)
        self.setup_parts["warmup"] = time.perf_counter() - t
        self.traffic = Traffic(tr, ctx.seed, self.arch.dims["V"])
        self.k1 = ctx.registry.counts("paged_attention")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ window
    def _launches(self) -> int:
        from jacobiforcing_tpu_torch.ops.paged_attention_cuda import paged_attention_cuda

        return paged_attention_cuda.launches

    def _send(self, req: Request, due: float, now: float, in_window: bool, client=-1) -> Live:
        with span("bench.add_request", self.tracing):
            seq = self.engine.add_request(req.prompt, replace(self.sp, max_tokens=req.max_tokens))
        live = Live(req, seq, due, now, in_window, client)
        live.len0 = len(req.prompt)
        self.live.append(live)
        self.active.append(live)
        return live

    def _count_attention(self, work: Work, pairs: dict, first_pos, n: int, times: int = 1):
        """Add `times` launches of kernel 1 over `n` queries from `first_pos`
        in every layer: its operations and bytes, and the visible pairs per
        attention shape into `pairs`."""
        for shape, layers in self.arch.attention:
            NH, KH, D, W = shape
            pairs[shape] = pairs.get(shape, 0) + times * self.k1.pairs(first_pos, n, W)
            ops, nb = self.k1.launch(first_pos, n, NH, KH, D, window=W)
            work.k1_ops += times * ops * layers
            work.k1_bytes += times * nb * layers

    def _observe(self, t: float, work: Optional[Work]) -> List[Live]:
        """Read the host mirrors after a step; returns the requests that finished."""
        from jacobiforcing_tpu_torch.engine.sequence import SequenceStatus

        L = self.L
        finished, still = [], []
        for lv in self.active:
            s = lv.seq
            if not lv.prefilled and (s.prefill_draft is not None
                                     or s.status is SequenceStatus.FINISHED):
                lv.prefilled = True
                if work is not None:
                    n = len(s) + L  # the prompt and the bootstrap draft
                    work.prefill_rows += n
                    work.prefill_head_rows += L
                    self._count_attention(work, work.prefill_pairs, 0, n)
            if s.status is SequenceStatus.WAITING and lv.prefilled:  # preempted
                lv.prefilled = False
            n_out = s.num_completion_tokens
            if lv.first is None and n_out > 0:
                lv.first = t
            dit = s.jacobi_iters - lv.it0
            if dit > 0:
                dlen = max(len(s) - lv.len0, 0)
                if work is not None:
                    # trip j starts from len0 + j * dlen / dit committed
                    # tokens; a trip's counts are linear in that length
                    c_mean = lv.len0 + dlen * (dit - 1) / (2 * dit)
                    work.seq_trips += dit
                    self._count_attention(work, work.trip_pairs, c_mean, L, dit)
                lv.it0 = s.jacobi_iters
                lv.len0 = len(s)
            if s.is_finished:
                lv.done = t
                finished.append(lv)
            else:
                still.append(lv)
        self.active = still
        return finished

    def window(self):
        ctx, eng, traffic = self.ctx, self.engine, self.traffic
        seconds = float(ctx.seconds)
        drain_s = float(self.tr["drain_s"])
        self.live: List[Live] = []
        self.active: List[Live] = []
        self.tracing = False
        tracer = Tracer(self.device) if ctx.trace else None
        work = Work()
        if ctx.before_window is not None:
            ctx.before_window()  # the tests plant a fault in the timed path here
        if tracer:  # started before the window: starting it stalls the host
            tracer.start()
            self.tracing = True
        stats0 = dict(eng.stats)
        launches0 = self._launches()
        t0 = time.perf_counter()
        self.t0 = t0
        closed = traffic.closed
        if closed:
            for c in range(traffic.clients):
                self._send(traffic.next_request(), t0, t0, True, client=c)
            due = None
        else:
            due = t0 + traffic.arrival_times(seconds + drain_s + 1.0)
            nxt = 0
        t1 = None
        deadline = None
        self.in_flight_third = None
        self.peak_pages = 0
        while True:
            now = time.perf_counter()
            if not closed:
                while nxt < len(due) and due[nxt] <= now:
                    self._send(traffic.next_request(), due[nxt], now, t1 is None)
                    nxt += 1
            if eng.scheduler.is_finished and not eng._pending:
                if closed or nxt >= len(due):
                    break
                with span("bench.wait_arrival", self.tracing):
                    time.sleep(max(0.0, min(due[nxt] - time.perf_counter(), 0.05)))
                continue
            with span("bench.step", self.tracing):
                eng.step()
            t = time.perf_counter()
            bm = eng.block_manager
            self.peak_pages = max(self.peak_pages, bm.num_pages - bm.num_free_pages)
            finished = self._observe(t, work if t1 is None else None)
            if self.in_flight_third is None and t - t0 >= seconds / 3:
                self.in_flight_third = len(self.active)
            if closed and t1 is None:
                for lv in finished:
                    self._send(traffic.next_request(), t, t, True, client=lv.client)
            if t1 is None and t - t0 >= seconds:
                t1 = t
                self.in_flight_close = len(self.active)
                deadline = t1 + drain_s
                work.stats = _stats_delta(stats0, eng.stats)
                work.k1_launches = self._launches() - launches0
                self.visible_at_close = sum(min(lv.seq.num_completion_tokens, lv.req.max_tokens)
                                            for lv in self.live)
                if self.tracing:
                    self.tracing = False
                    tracer.stop()
                    deadline = time.perf_counter() + drain_s
            if t1 is not None:
                if all(lv.done is not None for lv in self.live if lv.in_window):
                    break
                if t >= deadline:
                    break
        self.t1 = t1
        self.work = work
        self.trace = tracer.read() if tracer else None
        self.trace_s = tracer.seconds if tracer else None
        # memory in use: the allocator's peak, less the KV pool's pages that
        # no request of the run held (the pool is reserved from 0.9 of free
        # memory whatever the traffic needs)
        self.alloc_peak = (torch.cuda.max_memory_allocated(self.device)
                           if self.device.type == "cuda" else 0)
        self.kv_pages = eng.block_manager.num_pages
        unused = self.pool_bytes * (self.kv_pages - self.peak_pages) / self.kv_pages
        self.mem_peak = int(self.alloc_peak - unused) if self.alloc_peak else 0
        self.graphs = eng.programs.num_graphs
        self.late_s = [lv.sent - lv.due for lv in self.live]

    # ------------------------------------------------------------------ results
    def results(self) -> dict:
        win = [lv for lv in self.live if lv.in_window]
        done = [lv for lv in win if lv.done is not None]
        ttft = [(lv.first - lv.due) * 1e3 for lv in done]
        tpot = [(lv.done - lv.first) * 1e3 / (lv.seq.num_completion_tokens - 1)
                for lv in done if lv.seq.num_completion_tokens > 1]
        return {
            "window_s": self.t1 - self.t0,
            "attempted": len(win),
            "failed": len(win) - len(done),
            "finished_in_window": sum(1 for lv in done if lv.done <= self.t1),
            "output_tokens": self.visible_at_close,
            "ttft_ms": ttft,
            "tpot_ms": tpot,
            "late_s": self.late_s,
            "in_flight": (self.in_flight_third, self.in_flight_close),
        }

    def finished_outputs(self) -> List[dict]:
        return [{"index": lv.req.index, "prompt": lv.req.prompt,
                 "output": list(lv.seq.completion_token_ids), "max_tokens": lv.req.max_tokens}
                for lv in self.live if lv.in_window and lv.done is not None]

    def free(self):
        """Release the engine (weights, KV pool, graphs) before the check."""
        self.engine.exit()
        self.engine = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


# ---------------------------------------------------------------------- check
def check(ctx, outputs: List[dict], failed: int) -> dict:
    """The comparison that decides `correct`: a sample drawn from the seed of
    the requests that finished, with the longest in it, run once through the
    plain reference over prompt and served tokens.  Returns the numbers
    compared, each with its limit.  With `ctx.control` the control takes the
    program's place: the tokens judged are those the reference in fp8 puts
    first at each position of the same prompts and served tokens, and the run
    must come out not correct; the benchmark's own runs never do this."""
    chk = ctx.traffic["check"]
    limit = float(chk["max_logit_gap"])
    wrong = sum(1 for o in outputs if len(o["output"]) != o["max_tokens"])
    if not outputs:
        return {"numbers": {"unfinished_requests": (failed, 0)}, "correct": False}
    rng = np.random.default_rng(ctx.seed + 1)
    longest = max(outputs, key=lambda o: (len(o["output"]), -o["index"]))
    rest = [o for o in outputs if o is not longest]
    k = min(int(chk["sample"]) - 1, len(rest))
    sample = [longest] + [rest[i] for i in sorted(rng.choice(len(rest), k, replace=False))]
    gaps = sample_gaps(ctx, sample, control=ctx.control)
    numbers = {"widest_logit_gap": (max(max(g) for g in gaps), limit),
               "wrong_lengths": (wrong, 0),
               "unfinished_requests": (failed, 0)}
    return {"numbers": numbers, "correct": all(v <= lim for v, lim in numbers.values()),
            "sampled_tokens": sum(len(o["output"]) for o in sample)}


def sample_gaps(ctx, sample: List[dict], control: bool = False) -> List[List[float]]:
    """For each sampled request, by how much the reference's logit of each
    judged token lies below the reference's best at its position.  The
    judged tokens are the served ones, or with `control` the tokens the fp8
    reference puts first at each position of the same prompt and served
    tokens."""
    Reference = ctx.arch.Reference
    tensors = make_hf_tensors(ctx.arch.layout, ctx.cfg, ctx.seed, ctx.device)
    seqs = [o["prompt"] + o["output"] for o in sample]
    pos = [list(range(len(o["prompt"]) - 1, len(o["prompt"]) + len(o["output"]) - 1))
           for o in sample]
    ref = Reference(ctx.cfg, tensors).logits_at(seqs, pos)
    if control:
        low = Reference(ctx.cfg, tensors, fp8=True).logits_at(seqs, pos)
        judged = [c.argmax(-1) for c in low]
    else:
        judged = [torch.as_tensor(o["output"], device=r.device) for o, r in zip(sample, ref)]
    out = []
    for r, tok in zip(ref, judged):
        best = r.max(-1).values
        out.append((best - r.gather(1, tok.long()[:, None])[:, 0]).tolist())
    return out


def run(ctx) -> dict:
    sr = ServeRun(ctx)
    sr.setup()
    ctx.mark_setup_done()
    sr.window()
    res = sr.results()
    outputs = sr.finished_outputs()
    data = ctx.run_data(window_s=res["window_s"], serve=res, work=sr.work, trace=sr.trace,
                        memory_peak_bytes=sr.mem_peak)
    if sr.trace is not None:
        busy = max(sr.trace.busy_s, 1e-12)
        notes_trace = ["device time by kind: " + ", ".join(
            f"{k} {v:.3f} s ({v / busy * 100:.1f}%)" for k, v in sr.trace.groups().items())
            + f"; busy {sr.trace.busy_s:.3f} s of {sr.trace.window_s:.3f} s; the profiler "
            f"stopped in {sr.trace_s[0]:.1f} s, its trace read in {sr.trace_s[1]:.1f} s"]
    else:
        notes_trace = []
    notes = _notes(res) + notes_trace + [
        "set-up: " + ", ".join(f"{k} {v:.2f} s" for k, v in sr.setup_parts.items())
        + f"; KV pool {sr.kv_pages} pages; decode graphs {sr.graphs}",
        f"memory: allocator peak {sr.alloc_peak} bytes, KV pool {sr.pool_bytes} bytes, at most "
        f"{sr.peak_pages} of its {sr.kv_pages} pages held at once; in use {sr.mem_peak} bytes"]
    sr.free()
    del sr
    t = time.perf_counter()
    chk = check(ctx, outputs, res["failed"])
    notes.append(f"check: {chk.get('sampled_tokens', 0)} served tokens against the reference "
                 f"in {time.perf_counter() - t:.2f} s")
    if ctx.control:
        notes.append("control: the fp8 reference's tokens were judged in the program's place")
    return {"data": data, "attempted": res["attempted"], "failed": res["failed"], "check": chk,
            "notes": notes}


def _notes(res: dict) -> List[str]:
    def q(v, p):
        return float(np.percentile(v, p)) if v else float("nan")

    return [f"requests sent in the window {res['attempted']}, finished {res['attempted'] - res['failed']}"
            f" ({res['finished_in_window']} before it closed), failed {res['failed']}",
            f"ttft median {q(res['ttft_ms'], 50):.1f} ms, p95 {q(res['ttft_ms'], 95):.1f} ms "
            f"over {len(res['ttft_ms'])} requests",
            f"tpot median {q(res['tpot_ms'], 50):.2f} ms, p95 {q(res['tpot_ms'], 95):.2f} ms",
            f"generator lateness median {q(res['late_s'], 50) * 1e3:.2f} ms, "
            f"max {max(res['late_s'], default=0) * 1e3:.2f} ms",
            f"completed {res['finished_in_window'] / res['window_s']:.3f} requests/s in the "
            f"window; in flight at its first third {res['in_flight'][0]}, at its close "
            f"{res['in_flight'][1]}"]
