"""Grid-sweep analysis: aggregate tables + quadratic TPS-surface fit.

Re-design of the reference's offline tooling
(JacobiForcing/scripts/tool/extract_inference_profiling_datapoints_from_log.py:9-30
and 3d_plot_inference_configuration_search_*.py): the sweep already writes
structured CSV (no log regex scraping needed); this tool aggregates it, fits
a least-squares quadratic surface TPS(n, r) per (K, pool) slice — the
reference's 3D poly-fit — reports the analytic optimum, and optionally renders
plots when matplotlib is available.

PyTorch port of `jacobiforcing_tpu/apps/analyze_grid.py` (numpy only; it
reads the CSV that the port's `apps/grid_search` writes).  Where matplotlib
is not installed the plots are skipped with a line that says so; the JAX
copy skips them without a word, and swallows any other plotting error too,
which here raises.

    python -m jacobiforcing_tpu_torch.apps.analyze_grid grid_out/grid_results.csv
"""

from __future__ import annotations

import argparse
import csv
import json
from typing import Dict, List

import numpy as np


def load_results(path: str) -> List[dict]:
    rows = []
    with open(path) as f:
        for r in csv.DictReader(f):
            if r.get("error"):
                continue
            rows.append({
                "n": int(r["n"]), "K": int(r["K"]), "r": float(r["r"]),
                "pool": int(r["pool"]),
                "tokens_per_forward": float(r["tokens_per_forward"]),
                "tokens_per_s": float(r["tokens_per_s"]),
            })
    return rows


def fit_quadratic_surface(xs, ys, zs):
    """z ~ a + b x + c y + d x^2 + e y^2 + f xy (least squares)."""
    X = np.stack([np.ones_like(xs), xs, ys, xs**2, ys**2, xs * ys], axis=1)
    coef, *_ = np.linalg.lstsq(X, zs, rcond=None)
    return coef


def surface_argmax(coef, x_range, y_range, n=101):
    xg, yg = np.meshgrid(
        np.linspace(*x_range, n), np.linspace(*y_range, n), indexing="ij"
    )
    z = (
        coef[0] + coef[1] * xg + coef[2] * yg + coef[3] * xg**2
        + coef[4] * yg**2 + coef[5] * xg * yg
    )
    i = np.unravel_index(np.argmax(z), z.shape)
    return float(xg[i]), float(yg[i]), float(z[i])


def _plot_surface(plot_dir, K, pool, xs, ys, zs, coef) -> None:
    """tps_surface_K{K}_p{pool}.png in plot_dir: the measured points and the
    fitted surface; skipped, with a line that says why, without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        print(f"[analyze_grid] plot of K={K} pool={pool} skipped: matplotlib is not installed")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure()
    ax = fig.add_subplot(projection="3d")
    ax.scatter(xs, ys, zs)
    xg, yg = np.meshgrid(
        np.linspace(xs.min(), xs.max(), 30),
        np.linspace(ys.min(), ys.max(), 30), indexing="ij",
    )
    zg = (coef[0] + coef[1]*xg + coef[2]*yg + coef[3]*xg**2
          + coef[4]*yg**2 + coef[5]*xg*yg)
    ax.plot_surface(xg, yg, zg, alpha=0.4)
    ax.set_xlabel("n"); ax.set_ylabel("r"); ax.set_zlabel("tok/s")
    fig.savefig(f"{plot_dir}/tps_surface_K{K}_p{pool}.png", dpi=120)
    plt.close(fig)


def analyze(path: str, plot: str = "") -> Dict:
    rows = load_results(path)
    if not rows:
        return {"error": "no successful grid points"}
    best = max(rows, key=lambda r: r["tokens_per_s"])
    out = {"best_measured": best, "fits": []}
    slices: Dict[tuple, List[dict]] = {}
    for r in rows:
        slices.setdefault((r["K"], r["pool"]), []).append(r)
    for (K, pool), rs in sorted(slices.items()):
        if len(rs) < 6:
            out["fits"].append({"K": K, "pool": pool, "note": "too few points for fit"})
            continue
        xs = np.array([r["n"] for r in rs], float)
        ys = np.array([r["r"] for r in rs], float)
        zs = np.array([r["tokens_per_s"] for r in rs], float)
        coef = fit_quadratic_surface(xs, ys, zs)
        nx, ry, z = surface_argmax(
            coef, (xs.min(), xs.max()), (ys.min(), ys.max())
        )
        out["fits"].append({
            "K": K, "pool": pool,
            "fit_optimum": {"n": round(nx, 1), "r": round(ry, 3), "tps": round(z, 2)},
        })
        if plot:
            _plot_surface(plot, K, pool, xs, ys, zs, coef)
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("results_csv")
    p.add_argument("--plot-dir", default="")
    args = p.parse_args()
    print(json.dumps(analyze(args.results_csv, args.plot_dir), indent=2))


if __name__ == "__main__":
    main()
