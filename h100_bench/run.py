"""Run one cell of the port's benchmark once, on the card it is started on.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its metrics come from `BENCHMARK.json` at
the root of the checkout; the configuration, its architecture's layout and
reference, traffic, metric readers and count functions from the files named
after them under `h100_bench/` (`lib/registry.py`).  The run makes its weights and requests from the seed,
sets up (`setup_s`), measures `--seconds`, checks what the window produced
against the plain reference and prints, as the last line of standard
output, one JSON object: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer metrics),
`device`, with `--trace 1` `breakdown`, and last `checks`: each number
compared beside its limit (also the last lines of standard error).

It exits with another code than 0, and prints no result, without a CUDA
card or with fewer cards than the cell asks for, and if the process holds
`jax`, `jaxlib`, `flax` or `jacobiforcing_tpu` once the window has closed.
Kernel builds and caches stay inside the checkout (`build/`).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "jacobiforcing_tpu")


def set_environment() -> None:
    """Keep libraries off JAX and every cache inside the checkout, at fixed
    paths, so that only a checkout's first run builds."""
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What one run knows: its arguments, cell, files and clock marks."""

    def __init__(self, args, bench: dict, registry, device):
        self.args = args
        self.seed = int(args.seed)
        self.seconds = float(args.seconds)
        self.trace = bool(int(args.trace))
        self.control = bool(args.control)
        self.bench = bench
        self.registry = registry
        self.cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
        if self.cell is None:
            raise SystemExit(f"no workload named {args.workload!r} in BENCHMARK.json")
        self.cfg = registry.config(self.cell["config"])
        self.arch = registry.arch(self.cfg)
        self.traffic = registry.traffic(self.cell["name"])
        self.device = device
        self.before_window = None
        self.setup_s = None

    def mark_setup_done(self) -> None:
        self.setup_s = time.perf_counter() - T_START

    def run_data(self, **kw):
        data = RunData(**kw)
        data.setup_s = self.setup_s
        data.arch = self.arch
        data.cfg, data.traffic, data.cell = self.cfg, self.traffic, self.cell
        data.counts = self.registry.counts
        data.device_name = device_name(self.device)
        return data


class RunData:
    """Everything a metric reader may read; a reader returns None where the
    part it reads is absent."""

    def __init__(self, **kw):
        self.trace = None
        self.serve = None
        self.work = None
        self.__dict__.update(kw)

    def peaks(self):
        """The card's published peaks; None off the card, where no device
        number may be reported."""
        from h100_bench.lib.peaks import peaks

        return None if self.device_name == "cpu" else peaks(self.device_name)


def device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def parse(argv):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="judge the control instead of the program: the reference in fp8 takes "
                        "the program's place in the check, which must come out not correct; "
                        "the benchmark's own runs never pass this")
    return p.parse_args(argv)


def measure(ctx) -> dict:
    """Run the cell's task; returns its outcome with the metrics filled in."""
    from h100_bench.lib.registry import cell_metrics

    out = ctx.registry.task(ctx.traffic["task"]).run(ctx)
    data = out["data"]
    metrics = {}
    notes = out.setdefault("notes", [])
    for m in cell_metrics(ctx.bench, ctx.cell["name"], ctx.trace):
        reader = ctx.registry.metric(m["name"])
        value = reader.compute(data)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        note = reader.note(data) if hasattr(reader, "note") else None
        if note:
            notes.append(note)
    out["metrics"] = metrics
    return out


def result_line(ctx, out: dict) -> dict:
    data = out["data"]
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in out["check"]["numbers"].items()}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": data.device_name, "count": 1,
              "memory_peak_bytes": int(data.memory_peak_bytes)}
    line = {"correct": bool(out["check"]["correct"]), "attempted": int(out["attempted"]),
            "failed": int(out["failed"]), "metrics": out["metrics"], "device": device}
    if ctx.trace and data.trace is not None:
        device["busy_s"] = data.trace.busy_s
        device["window_s"] = data.trace.window_s
        line["breakdown"] = {"device_ops": [[k, v] for k, v in data.trace.top_ops(10)],
                             "idle_gaps": [[k, v] for k, v in data.trace.idle_gaps[:10]]}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    set_environment()
    args = parse(argv)
    import torch

    from h100_bench.lib.registry import Registry, load_benchmark

    bench = load_benchmark(ROOT)
    registry = Registry()
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    chips = int(cell["chips"]) if cell else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this run needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: "
              "the benchmark does not fall back to the CPU", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    ctx = Context(args, bench, registry, device)
    out = measure(ctx)
    found = forbidden_modules()  # after the window, the check and every reader, for any task
    if found:
        print(f"the process holds {', '.join(found)} once the window has closed: "
              "nothing that runs on the card may load JAX or the JAX package", file=sys.stderr)
        return 3
    line = result_line(ctx, out)
    limit = _power_limit()
    for note in out.get("notes", []):
        print(f"[{ctx.cell['name']}] {note}", file=sys.stderr)
    print(f"[{ctx.cell['name']}] card {line['device']['kind']}, power limit {limit}, "
          f"setup_s {ctx.setup_s:.3f}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def _power_limit() -> str:
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 and r.stdout else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


if __name__ == "__main__":
    sys.exit(main())
