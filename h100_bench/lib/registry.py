"""Find the benchmark's parts by name, under one root folder.

Everything that belongs to one configuration, one traffic mix, one metric,
one count function or one architecture sits in a file of its own, named
after it:

    configs/<config>.json      the configuration as it is run; its "reference"
                               value names its architecture, <arch>
    traffic/<cell>.json        the cell's traffic mix and engine settings
    metrics/<metric>.py        one reader per metric: compute(run) -> float | None
    counts/<kind>.py           operation and byte counts of one kernel or step kind
    tasks/<task>.py            the loop a traffic file names ("serve")
    reference/<arch>.py        the architecture's plain reference (below)
    layouts/<arch>.py          the architecture's checkpoint and shapes (below)

An architecture is two files, and the harness's shared code (`run.py`,
`lib/`, `tasks/`, `metrics/`) names none:

`reference/<arch>.py` imports nothing of the program and holds one class,
    `Reference(cfg, tensors, fp8=False)`: `tensors` is {checkpoint name:
    tensor} as `lib/weights.make_hf_tensors` makes it; `fp8=True` is the
    control, every linear product one precision below bfloat16.
    `.logits_at(seqs, positions)` returns, for each token list, the float32
    logits [len(positions), V] at the given positions.
`layouts/<arch>.py` holds five functions of the configuration dict:
    `dims(cfg)`: a dict with at least `H` (hidden size), `V` (vocabulary)
        and `NL` (layers); the logits' head costs 2 * H * V a row.
    `draws(cfg)`: the checkpoint's tensors as a list of `lib/weights.Draw`,
        (name, shape, scale) in draw order; one draw per piece the port
        takes at a time (say, one a layer).
    `port_params(cfg, pieces, dtype, device)`: the program's (model config,
        params) through its own loading path; `pieces` yields each draw's
        {name: tensor} in turn and is drawn lazily, so a port that builds
        its tensors from a piece and lets the piece go holds at most one
        piece beyond what it has built.
    `row_linear_flops(cfg)`: the operations of one token row through the
        linear layers of every layer (an expert layer: its router, the k
        experts a token is routed to and its shared experts, not all E).
    `attention_layers(cfg)`: per layer, (NH, KH, D, window) of its
        attention: query heads, KV heads, head size, and the keys a query
        sees back from its own position (None: every earlier key).

A new configuration, cell, metric or architecture is new files plus new
entries in `BENCHMARK.json`; nothing here changes.  Names may hold dots
(`mfu_pct.serve`), so modules are loaded from their path, not imported by
name.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from collections import Counter
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

    def layout(self, name: str) -> ModuleType:
        return self._module("layouts", name)

    def arch(self, cfg: dict) -> "Arch":
        return Arch(self, cfg)

    def configs(self) -> List[str]:
        return self._names("configs", ".json")

    def traffics(self) -> List[str]:
        return self._names("traffic", ".json")

    def metrics(self) -> List[str]:
        return self._names("metrics", ".py")


class Arch:
    """What the shared code knows of a configuration's architecture, from
    the two files its "reference" value names: the layout, the reference
    class, `dims`, the linear operations of a row (`linear_flops`) and
    `attention`, the layers grouped by attention shape: [((NH, KH, D,
    window), number of layers)] in the order each shape first appears."""

    def __init__(self, registry: Registry, cfg: dict):
        self.layout = registry.layout(cfg["reference"])
        self.Reference = registry.reference(cfg["reference"]).Reference
        self.dims = self.layout.dims(cfg)
        self.linear_flops = self.layout.row_linear_flops(cfg)
        self.attention = list(Counter(map(tuple, self.layout.attention_layers(cfg))).items())


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
