"""The serving engine's spans and counters (`utils/profiling.py`), on a tiny
engine on the CPU:
  * span totals land in `stats` and nest: `step` holds its children, each
    `*.wait` lies inside its parent, self times add up to `step_s`, and a
    fake clock gives the exact arithmetic;
  * under a recording torch profiler the `engine.*` ranges appear in its
    events, inside the caller's range; without one, and without `PROFILE=1`,
    `record_function` is never entered;
  * greedy Jacobi outputs are the same with `PROFILE=1` and without;
  * each request's stamps come in order (queued, admitted, prefilled, first
    commit) and the counters count each admission and first commit once,
    preemptions included;
  * `trip_slots` (bucket rows x trips) is at least `jacobi_iterations`, and
    equal when every row of a full bucket runs every trip;
  * the `PROFILE=1` report lists every span that ran, its self times adding
    up to `step`'s total.
Imports only the port.
"""

import inspect
import re

import numpy as np
import pytest
import torch

from jacobiforcing_tpu_torch.config import Config, SamplingParams
from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine
from jacobiforcing_tpu_torch.models import qwen as tq
from jacobiforcing_tpu_torch.utils import profiling

WAITS = {"prefill.wait": "prefill", "ar.wait": "ar", "trips.wait": "trips",
         "commit.wait": "commit"}


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_profile_env(monkeypatch):
    monkeypatch.delenv("PROFILE", raising=False)


def make_engine(num_pages=128, **cfg_kw):
    mc = tq.ModelConfig.tiny()
    kw = dict(kvcache_page_size=16, max_model_len=256, jacobi_chunk_tokens=32,
              jacobi_chunk_iters=4, prefill_token_buckets=(32, 64, 128, 256), eos=-1)
    kw.update(cfg_kw)
    return LLMEngine(Config(**kw), model_cfg=mc, params=tq.init_params(mc, 0, device="cpu"),
                     num_kv_pages=num_pages, device="cpu")


def prompts(sizes=(5, 9, 17, 3), seed=0):
    r = np.random.RandomState(seed)
    return [r.randint(1, 256, size=n).tolist() for n in sizes]


def jacobi(max_tokens=20, max_iterations=256):
    return SamplingParams(temperature=0.0, max_tokens=max_tokens, decode_strategy="jacobi",
                          jacobi_block_len=8, jacobi_max_blocks=1,
                          jacobi_max_iterations=max_iterations)


def mixed_sps(n):
    """Jacobi requests of three lengths and one AR request."""
    sps = [jacobi(12 + 7 * (i % 3)) for i in range(n - 1)]
    return sps + [SamplingParams(temperature=0.0, max_tokens=9)]


def spans_seconds(stats):
    return {name: stats[name + "_s"] for name in profiling.SPANS}


def test_span_totals_land_in_stats_and_nest():
    eng = make_engine()
    eng.generate(prompts(), mixed_sps(4))
    st = eng.stats
    sec = spans_seconds(st)
    for name in ("step", "schedule", "flush", "prefill", "prefill.wait", "ar", "ar.wait",
                 "dispatch", "trips", "trips.wait", "commit", "commit.wait"):
        assert sec[name] > 0, name
    assert sec["mr"] == sec["onpolicy"] == 0
    # no preemption here, so no flush runs inside `schedule`; `commit` runs
    # inside `flush` or right inside `step`, so it is left out of the sum
    assert eng.scheduler.num_preemptions == 0
    children = ("schedule", "flush", "prefill", "dispatch", "trips", "ar")
    assert sec["step"] >= sum(sec[c] for c in children)
    for wait, parent in WAITS.items():
        assert sec[wait] <= sec[parent], wait
        assert st[wait + "_self_s"] == pytest.approx(sec[wait])  # no span inside a wait
    assert st["device_wait_s"] == pytest.approx(sum(sec[w] for w in WAITS))
    for name in profiling.SPANS:
        assert -1e-9 <= st[name + "_self_s"] <= sec[name] + 1e-9, name
    # every span ran inside a step: their self times add up to it
    assert sum(st[n + "_self_s"] for n in profiling.SPANS) == pytest.approx(sec["step"], abs=1e-6)
    assert eng.spans.depth == 0


def test_self_time_arithmetic_on_a_fake_clock(monkeypatch):
    """step [0, 100] holds flush [10, 40] (which holds commit [15, 35] and
    its wait [20, 30]) and commit [50, 70] (its wait [55, 65])."""
    ticks = iter([0, 10, 15, 20, 30, 35, 40, 50, 55, 65, 70, 100])
    monkeypatch.setattr(profiling, "perf_counter_ns", lambda: next(ticks) * 10**9)
    stats = {}
    sp = profiling.Spans(stats)
    with sp["step"]:
        with sp["flush"]:
            with sp["commit"]:
                with sp["commit.wait"]:
                    pass
        with sp["commit"]:
            with sp["commit.wait"]:
                pass
    got = {k: v for k, v in stats.items() if v}
    assert got == pytest.approx({
        "step_s": 100, "step_self_s": 100 - 30 - 20,
        "flush_s": 30, "flush_self_s": 30 - 20,
        "commit_s": 20 + 20, "commit_self_s": 10 + 10,
        "commit.wait_s": 20, "commit.wait_self_s": 20,
        "device_wait_s": 20,
    })


def _ranges(prof):
    """name -> [(start ns, end ns)] of the host ranges a profile recorded."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        out.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return out


def test_spans_appear_in_a_recording_profiler_inside_the_callers_range():
    from torch.profiler import ProfilerActivity, profile, record_function

    eng = make_engine()
    for p, sp in zip(prompts(), mixed_sps(4)):
        eng.add_request(p, sp)
    assert not eng.spans.requested
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            for _ in range(6):
                eng.step()
    r = _ranges(prof)
    (c0, c1), = r["caller"]
    steps = r["engine.step"]
    assert len(steps) == 6
    assert all(c0 <= a <= b <= c1 for a, b in steps)
    for name in ("schedule", "prefill", "prefill.wait", "dispatch", "trips", "trips.wait",
                 "commit", "commit.wait"):
        assert any(s0 <= a <= b <= s1 for a, b in r["engine." + name] for s0, s1 in steps), name
    for wait, parent in WAITS.items():
        for a, b in r.get("engine." + wait, []):
            assert any(p0 <= a <= b <= p1 for p0, p1 in r["engine." + parent]), wait
    # the trace's ranges and the stats describe the same steps
    assert eng.stats["step_s"] * 1e9 <= sum(b - a for a, b in steps)


def test_without_a_profiler_record_function_is_never_entered(monkeypatch):
    def boom(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler recording")

    monkeypatch.setattr(profiling, "record_function", boom)
    eng = make_engine()
    eng.generate(prompts(), mixed_sps(4))
    assert eng.stats["step_s"] > 0
    # and the module holds no device synchronisation
    assert "synchronize" not in inspect.getsource(profiling)


def test_profile_env_records_and_leaves_the_tokens_unchanged(monkeypatch):
    entered = []
    real = profiling.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    sps = [jacobi(10 + 7 * (i % 3)) for i in range(4)]
    plain = [o["token_ids"] for o in make_engine().generate(prompts(), sps)]
    monkeypatch.setenv("PROFILE", "1")
    monkeypatch.setattr(profiling, "record_function", counting)
    eng = make_engine()
    assert eng.spans.requested
    profiled = [o["token_ids"] for o in eng.generate(prompts(), sps)]
    assert profiled == plain
    assert entered.count("engine.step") >= 1 and "engine.trips.wait" in entered
    assert set(entered) <= {"engine." + n for n in profiling.SPANS}


@pytest.mark.parametrize("kw", [dict(), dict(num_pages=10, batch_buckets=(1, 2, 4))],
                         ids=["plain", "preemptions"])
def test_request_stamps_come_in_order_and_count_once(kw):
    eng = make_engine(**kw)
    sizes = (5, 9, 17, 3, 11, 7, 21, 4) if kw else (5, 9, 17, 3)
    max_tokens = 24 if kw else 14
    sps = [jacobi(max_tokens + 5 * (i % 3)) for i in range(len(sizes) - 1)]
    sps.append(SamplingParams(temperature=0.0, max_tokens=9))
    seqs = [eng.add_request(p, sp) for p, sp in zip(prompts(sizes), sps)]
    while not eng.scheduler.is_finished:
        eng.step()
    st = eng.stats
    for s in seqs:
        assert s.is_finished
        assert s.t_queued <= s.t_admitted <= s.t_prefilled
        # the stamps are those of the last admission; a request preempted
        # after its first commit was queued again after it
        assert s.t_prefilled <= s.t_first or s.t_first < s.t_queued
    preempted = eng.scheduler.num_preemptions
    assert (preempted > 0) == bool(kw)
    assert st["admissions"] == len(seqs) + preempted
    assert st["first_commits"] == len(seqs)
    # without preemptions each request waited once, from add to admission
    if not preempted:
        assert st["queue_wait_s"] == pytest.approx(sum(s.t_admitted - s.t_queued for s in seqs))
    assert st["queue_wait_s"] >= 0
    assert st["first_commit_s"] > 0


@pytest.mark.parametrize("case", ["full_bucket", "padded_bucket", "uneven_finish"])
def test_trip_slots_count_every_row_each_trip_forwarded(case):
    if case == "full_bucket":
        # one iteration budget for both rows: both run every trip, to its end
        sps, ps = [jacobi(200, max_iterations=12)] * 2, prompts((9, 9))
    elif case == "padded_bucket":
        sps, ps = [jacobi(16)] * 3, prompts((9, 6, 11))  # three rows in a bucket of 4
    else:
        sps, ps = [jacobi(10), jacobi(30)], prompts((9, 6))
    eng = make_engine(batch_buckets=(1, 2, 4))
    eng.generate(ps, sps)
    st = eng.stats
    assert st["jacobi_iterations"] > 0
    if case == "full_bucket":
        assert st["jacobi_iterations"] == 2 * 12
        assert st["trip_slots"] == st["jacobi_iterations"]
    else:
        assert st["trip_slots"] > st["jacobi_iterations"]
    assert st["trip_slots"] <= 4 * st["chunk_forwards"]


def _report_rows(rep):
    rows = {}
    for line in rep.splitlines():
        m = re.match(r"\s+(\S+)\s+([\d.]+)\s+([\d.]+)\s+[\d.]+%$", line)
        if m and m.group(1) in profiling.SPANS:
            rows[m.group(1)] = (float(m.group(2)), float(m.group(3)))
    return rows


def test_report_lists_each_span_that_ran_with_self_times_adding_up():
    eng = make_engine()
    eng.generate(prompts((7, 5)), [jacobi(8)] * 2)  # warm: the window below leaves it out
    before = dict(eng.stats)
    eng.generate(prompts(), mixed_sps(4))
    delta = profiling.stats_delta(before, eng.stats)
    rep = profiling.report(delta, 2.0, eng.programs)
    rows = _report_rows(rep)
    assert set(rows) == {n for n in profiling.SPANS if delta[n + "_s"] > 0}
    assert "mr" not in rows and "ar.wait" in rows
    step_ms = rows["step"][0]
    assert sum(own for _, own in rows.values()) == pytest.approx(step_ms, abs=0.05 * len(rows))
    assert rows["step"][0] == pytest.approx(delta["step_s"] * 1e3, abs=0.05)
    for key in ("generated_tokens", "jacobi_iterations", "trip_slots", "admissions",
                "first_commits"):
        assert f"  {key}: {delta[key]}" in rep
    assert "tokens_per_forward" in rep and "tokens_per_second" in rep
    assert "programs: " in rep and "CUDA graphs 0" in rep


def test_engine_bench_prints_the_report_of_its_measured_run(monkeypatch, capsys):
    """`apps/bench_engine` under PROFILE=1: the report of its measured run
    (warm-up left out) on standard error, the JSON line alone on standard
    output."""
    from jacobiforcing_tpu_torch.apps.bench_engine import run_engine_bench

    monkeypatch.setenv("PROFILE", "1")
    mc = tq.ModelConfig.tiny(vocab_size=128)
    out = run_engine_bench(B=2, prompt_len=24, max_tokens=16, L=8, chunk_iters=4, requests=5,
                           max_model_len=128, chunk_tokens=16, model_cfg=mc,
                           params=tq.init_params(mc, 0, device="cpu"), device="cpu")
    captured = capsys.readouterr()
    assert "engine profile" not in captured.out
    rows = _report_rows(captured.err)
    assert {"step", "schedule", "prefill", "dispatch", "trips", "commit"} <= set(rows)
    assert f"over {out['wall_s']:.3f} s" in captured.err
    assert "tokens_per_forward" in captured.err
