"""Find an open-loop cell's knee: the highest offered rate that it and every
lower rate sustain in every window.  A window sustains its rate when the
requests completed per second stay within 5% of the requests that arrived
per second, both over the window's last two thirds (the first fills the
empty system), and the requests in flight when the window closes are no
more than at its first third.  Each seed gets its own set-up (its weights
and request order), then one window per rate, each drained to empty.

    python3 h100_bench/sweep.py --workload <cell> --seeds <n> <m> --seconds <s> --rates 3 3.5 4

Prints one line per seed and rate, then the knee; the cell's traffic file
then takes 0.8 of it.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import h100_bench.run as runmod  # noqa: E402


def sweep_seed(seed: int, a) -> dict:
    """One set-up from `seed`, then one window per rate; returns whether
    each rate was sustained."""
    import torch

    from h100_bench.lib.registry import Registry, load_benchmark
    from h100_bench.lib.traffic import Traffic

    args = runmod.parse(["--workload", a.workload, "--seed", str(seed), "--seconds",
                         str(a.seconds), "--trace", "0"])
    ctx = runmod.Context(args, load_benchmark(runmod.ROOT), Registry(), torch.device("cuda", 0))
    serve = ctx.registry.task("serve")
    sr = serve.ServeRun(ctx)
    sr.setup()
    print(f"seed {seed}: set-up {sr.setup_parts}", flush=True)
    ok_by_rate = {}
    for rate in a.rates:
        sr.traffic = Traffic(ctx.traffic, ctx.seed, sr.arch.dims["V"], rate=rate)
        sr.window()
        while not sr.engine.scheduler.is_finished or sr.engine._pending:
            sr.engine.step()
        r = sr.results()
        span = sr.t1 - sr.t0
        lo = sr.t0 + span / 3
        done = sum(1 for lv in sr.live if lv.done is not None and lo <= lv.done <= sr.t1) \
            / (sr.t1 - lo)
        came = sum(1 for lv in sr.live if lo <= lv.due <= sr.t1) / (sr.t1 - lo)
        third, close = r["in_flight"]
        ok = abs(done - came) <= 0.05 * came and close <= third
        ok_by_rate[rate] = ok
        print(f"seed {seed} rate {rate} offered: arrived {r['attempted'] / span:.3f}/s over the "
              f"window, {came:.3f}/s over its last two thirds; completed {done:.3f}/s "
              f"({done / came * 100:.1f}%); in flight at 1/3 {third}, at close {close}; "
              f"failed {r['failed']}; output {r['output_tokens'] / span:.1f} tokens/s; "
              f"{'sustained' if ok else 'not sustained'}; "
              + "; ".join(serve._notes(r)[1:3]), flush=True)
    sr.free()
    return ok_by_rate


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="sweep an open loop's offered rate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    a = p.parse_args(argv)
    a.rates = sorted(a.rates)
    runmod.set_environment()
    import torch

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 2
    results = [sweep_seed(seed, a) for seed in a.seeds]
    knee = None
    for rate in a.rates:
        if not all(res[rate] for res in results):
            break
        knee = rate
    print(f"knee {knee} requests/s (every window sustained up to it); "
          f"0.8 of it {None if knee is None else round(0.8 * knee, 4)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
