"""Throughput-vs-accuracy baseline comparison chart.

Parity for the reference's `assets/baseline_comparison.py:1-219` (bubble chart
of delta-throughput vs delta-pass@1 across speculative/parallel decoding
methods, bubble area ~ sqrt(training tokens)).  Rebuilt rather than ported:
single-series scatter with direct labels (no legend), neutral ink for text,
recessive grid, zero-delta reference lines.

Input CSV columns (absolute form):
    technique,throughput_tps,pass1,train_tokens_B
The first row (or --baseline-throughput/--baseline-pass1) is the baseline.
Default data: the upstream JacobiForcing README's HumanEval table
(README.md:253-261; Qwen2.5-Coder-7B-Instruct on one GPU), the upstream's own
figures.

PyTorch port of `jacobiforcing_tpu/apps/baseline_chart.py` (matplotlib only,
imported when the chart is drawn).  The JAX copy's default data adds a point
measured on a TPU; the port states no TPU figure, so that row is gone.

Usage:
    python -m jacobiforcing_tpu_torch.apps.baseline_chart --out assets/baseline_comparison.png
"""

from __future__ import annotations

import argparse
import csv
import io
import math
import os

# The upstream JacobiForcing README.md:253-261 (HumanEval,
# Qwen2.5-Coder-7B-Instruct, one GPU): the upstream's figures, not this port's.
DEFAULT_CSV = """technique,throughput_tps,pass1,train_tokens_B
AR baseline,41.3,87.8,0
CLLM,103.3,88.0,1
EAGLE-3,120.7,86.0,8
HASS,138.7,86.6,1
dParallel,88.5,78.7,50
Jacobi Forcing,159.5,83.5,0.3
Jacobi Forcing (MR),163.9,83.5,0.3
"""

INK = "#3b3b3f"
MUTED = "#76767c"
GRID = "#e4e4e8"
POINT = "#5a6acf"  # single categorical hue; one series -> no legend


def load_rows(path: str | None):
    if path:
        with open(path) as f:
            return list(csv.DictReader(f))
    return list(csv.DictReader(io.StringIO(DEFAULT_CSV)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--csv", default=None, help="input CSV (default: built-in)")
    ap.add_argument("--out", default="assets/baseline_comparison.png")
    ap.add_argument("--baseline-throughput", type=float, default=None)
    ap.add_argument("--baseline-pass1", type=float, default=None)
    ap.add_argument("--title", default="HumanEval: throughput vs accuracy (deltas vs AR)")
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = load_rows(args.csv)
    base_tps = args.baseline_throughput
    base_p1 = args.baseline_pass1
    if base_tps is None or base_p1 is None:
        base_tps = float(rows[0]["throughput_tps"])
        base_p1 = float(rows[0]["pass1"])
        rows = rows[1:]

    fig, ax = plt.subplots(figsize=(8, 5.5), dpi=150)
    ax.axhline(0, color=GRID, lw=1, zorder=1)
    ax.axvline(0, color=GRID, lw=1, zorder=1)
    ax.grid(True, color=GRID, lw=0.6, zorder=0)

    pts = [
        (float(r["throughput_tps"]) - base_tps, float(r["pass1"]) - base_p1,
         float(r.get("train_tokens_B") or 0), r["technique"])
        for r in rows
    ]
    xspan = max(abs(p[0]) for p in pts) or 1.0
    yspan = max(abs(p[1]) for p in pts) or 1.0
    placed: list[tuple[float, float]] = []
    for dt, dp, tok, name in pts:
        size = 60 + 140 * math.sqrt(tok)  # bubble area ~ sqrt(train tokens)
        ax.scatter(dt, dp, s=size, color=POINT, alpha=0.75,
                   edgecolors="white", linewidths=1.5, zorder=3)
        # collision-aware label: drop below-left when a placed neighbor is near
        near = any(
            abs(dt - px) / xspan < 0.12 and abs(dp - py) / yspan < 0.06
            for px, py in placed
        )
        off, ha = ((8, 7), "left") if not near else ((-8, -16), "right")
        ax.annotate(
            name, (dt, dp), textcoords="offset points",
            xytext=off, ha=ha, fontsize=9, color=INK, zorder=4,
        )
        placed.append((dt, dp))

    ax.set_xlabel(f"Δ throughput (tok/s, vs AR {base_tps:g})", color=INK)
    ax.set_ylabel(f"Δ pass@1 (pp, vs AR {base_p1:g})", color=INK)
    ax.set_title(args.title, color=INK, fontsize=12)
    ax.tick_params(colors=MUTED)
    for spine in ax.spines.values():
        spine.set_color(GRID)
    # headroom so labels at the extremes stay inside the axes
    x0, x1 = ax.get_xlim()
    ax.set_xlim(x0, x1 + 0.12 * (x1 - x0))
    fig.text(
        0.99, 0.01, "bubble ~ sqrt(training tokens)", ha="right",
        fontsize=8, color=MUTED,
    )
    fig.tight_layout()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    fig.savefig(args.out)
    print(f"wrote {args.out} ({len(rows)} points, baseline {base_tps}/{base_p1})")


if __name__ == "__main__":
    main()
