"""Find the benchmark's parts by name, under one root folder.

Everything that belongs to one configuration, one traffic mix, one metric or
one count function sits in a file of its own, named after it:

    configs/<config>.json      the configuration as it is run
    traffic/<cell>.json        the cell's traffic mix and engine settings
    metrics/<metric>.py        one reader per metric: compute(run) -> float | None
    counts/<kind>.py           operation and byte counts of one kernel or step kind
    reference/<name>.py        a configuration's plain reference
    tasks/<task>.py            the loop a traffic file names ("serve")

A new configuration, cell or metric is new files plus new entries in
`BENCHMARK.json`; nothing here changes.  Names may hold dots (`mfu_pct.serve`),
so modules are loaded from their path, not imported by name.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]


class Registry:
    def __init__(self, root: Path = BENCH_DIR):
        self.root = Path(root)
        self._modules: Dict[str, ModuleType] = {}

    def _json(self, sub: str, name: str) -> dict:
        path = self.root / sub / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {sub[:-1]} named {name!r}: {path} is missing")
        with open(path) as f:
            return json.load(f)

    def _module(self, sub: str, name: str) -> ModuleType:
        key = f"{sub}/{name}"
        if key not in self._modules:
            path = self.root / sub / f"{name}.py"
            if not path.is_file():
                raise FileNotFoundError(f"no {sub[:-1]} named {name!r}: {path} is missing")
            mod_name = "h100_bench_" + str(abs(hash(str(self.root))))[:8] + "_" + \
                key.replace("/", "_").replace(".", "_").replace("-", "_")
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = mod  # dataclasses look their module up there
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def _names(self, sub: str, suffix: str) -> List[str]:
        return sorted(p.name[: -len(suffix)] for p in (self.root / sub).glob(f"*{suffix}")
                      if not p.name.startswith("_"))

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, cell: str) -> dict:
        return self._json("traffic", cell)

    def metric(self, name: str) -> ModuleType:
        return self._module("metrics", name)

    def counts(self, kind: str) -> ModuleType:
        return self._module("counts", kind)

    def reference(self, name: str) -> ModuleType:
        return self._module("reference", name)

    def task(self, name: str) -> ModuleType:
        return self._module("tasks", name)

    def configs(self) -> List[str]:
        return self._names("configs", ".json")

    def traffics(self) -> List[str]:
        return self._names("traffic", ".json")

    def metrics(self) -> List[str]:
        return self._names("metrics", ".py")


def load_benchmark(repo_root: Path) -> dict:
    with open(Path(repo_root) / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metric entries a run of `cell` reports: its end-to-end metrics
    with --trace 0, its per-layer metrics with --trace 1.  An entry without
    `workloads` belongs to every cell that reports the end-to-end metric it
    moves (per-layer) or to every cell (end-to-end)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    e2e_names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in e2e_names else [])]
