"""The Qwen configurations read the same through the architecture's files as
they did when the harness wrote the Qwen decoder out itself: the same
tensors from the same seed, the same checkpoint list in the same order, and
the same counts from the same host observations, float for float.  The
digests and values below were recorded with the harness before it read its
architectures from `layouts/` and `reference/`.  And the harness's shared
code names no architecture."""

import hashlib
import json
import re

import pytest
import torch

from conftest import BENCH, TINY_QWEN2, TINY_QWEN3
from h100_bench.lib.registry import Registry
from h100_bench.lib.weights import NORM, SMALL, make_hf_tensors
from h100_bench.tasks import serve

REG = Registry()
QWEN = REG.layout("qwen")

TENSORS = {
    ("tiny-qwen2", "float32", 9): "8c36f6c46e6fe51571a8eb48927793420ddc7b17d8b574f682e572fb33e22843",
    ("tiny-qwen2", "float32", 2_147_483_911):
        "af32b62123582b7a67c879eef9a5c5b36251a621b8eda6d1715253772b074ee0",
    ("tiny-qwen2", "bfloat16", 9): "b974fd871f3e67b1bda782615b8403b43a16aa31b6382adb5e238fcd406150c3",
    ("tiny-qwen2", "bfloat16", 2_147_483_911):
        "cdf91ac5b09923c9095ed15d0293a9495c43fe2d224ed30d594b6dbe5757d438",
    ("tiny-qwen3", "float32", 9): "f7a58fa4b1b86c8a654a59512683f5f5f9d846e0ec96f9a780bdd4fa31e6e5cb",
    ("tiny-qwen3", "float32", 2_147_483_911):
        "0d1c111c95e89ee4d1476f61260cb81e12c6579a59a6f8ad5fac28585b39eed5",
    ("tiny-qwen3", "bfloat16", 9): "656a2ac5ac211887028760841944eb76ff7b745f807773ce7789b8616443d2aa",
    ("tiny-qwen3", "bfloat16", 2_147_483_911):
        "773a85e7ddc16b90f25af2bd4320a93972d2a8143f3ff299edc3ac3a1c78bc5c",
}
LAYOUTS = {
    "qwen2.5-coder-7b": ("ee3c09cb2fd4d94c671067d6be358c0484f9e8f6a60858cac38c33d5d85e1ce5", 339),
    "qwen3-8b": ("8bf512c1287c71ce9fb15f95dca86687f890d25bf8396017a08e5ffe24b01118", 399),
}
COUNTS = {
    "qwen2.5-coder-7b": dict(k1_ops=1607846166528.0, k1_bytes=5791084544.0,
                             trip_pairs=2997184.0, prefill_pairs=1008332,
                             mfu_ops=98706868764672.0, prefill_mfu_ops=35059010732032),
    "qwen3-8b": dict(k1_ops=2362549469184.0, k1_bytes=11772665856.0,
                     trip_pairs=2997184.0, prefill_pairs=1008332,
                     mfu_ops=106112920322048.0, prefill_mfu_ops=37503674089472),
}


def tensor_digest(tensors) -> str:
    h = hashlib.sha256()
    for name in sorted(tensors):
        x = tensors[name]
        h.update(f"{name}|{tuple(x.shape)}|{x.dtype}|".encode())
        h.update(x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def config(name: str) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name, dtype, seed", list(TENSORS))
def test_tiny_tensors_are_the_same_bits(name, dtype, seed):
    base = {"tiny-qwen2": TINY_QWEN2, "tiny-qwen3": TINY_QWEN3}[name]
    cfg = dict(base, torch_dtype=dtype)
    assert tensor_digest(make_hf_tensors(QWEN, cfg, seed, "cpu")) == TENSORS[name, dtype, seed]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_full_width_checkpoint_list_is_the_same(name):
    def scale(s):
        return f"fan_in {s}" if isinstance(s, int) else {SMALL: "0.02", NORM: "norm"}[s]

    rows = [f"{i}|{n}|{tuple(shape)}|{scale(s)}|{'config' if d.dtype is None else 'float32'}"
            for i, d in enumerate(QWEN.draws(config(name))) for n, shape, s in d.tensors]
    digest = hashlib.sha256("\n".join(rows).encode()).hexdigest()
    assert (digest, len(rows)) == LAYOUTS[name]


class FakeSeq:
    """What `_observe` reads of a sequence's host mirror."""

    def __init__(self, n: int):
        from jacobiforcing_tpu_torch.engine.sequence import SequenceStatus

        self.S = SequenceStatus
        self.n, self.prefill_draft, self.status = n, None, SequenceStatus.WAITING
        self.num_completion_tokens, self.jacobi_iters = 0, 0

    def __len__(self):
        return self.n

    @property
    def is_finished(self):
        return self.status is self.S.FINISHED


# per step: ("p", seq) prefilled, ("w", seq) preempted, ("t", seq, trips, tokens[, finished])
SCRIPT = [
    [("p", 0)],
    [("t", 0, 8, 11), ("p", 1)],
    [("t", 0, 8, 9), ("t", 1, 8, 8), ("p", 2)],
    [("t", 0, 3, 5, True), ("t", 1, 8, 13), ("t", 2, 8, 10)],
    [("w", 1), ("t", 2, 8, 0)],
    [("p", 1), ("t", 2, 1, 1)],
    [("t", 1, 8, 17), ("t", 2, 7, 9, True)],
    [("t", 1, 2, 3, True)],
]


def observe_script(arch, prompts, script, L=64) -> serve.Work:
    """Drive `ServeRun._observe` through a fixed sequence of host
    observations; returns the window's counts."""
    sr = serve.ServeRun.__new__(serve.ServeRun)
    sr.arch, sr.L, sr.k1 = arch, L, REG.counts("paged_attention")
    seqs = [FakeSeq(n) for n in prompts]
    sr.active = [serve.Live(None, s, 0.0, 0.0, True, len0=len(s)) for s in seqs]
    work = serve.Work()
    for step in script:
        for ev in step:
            s = seqs[ev[1]]
            if ev[0] == "p":
                s.prefill_draft, s.status = [0], s.S.RUNNING
            elif ev[0] == "w":
                s.status, s.prefill_draft = s.S.WAITING, None
            else:
                s.jacobi_iters += ev[2]
                s.n += ev[3]
                s.num_completion_tokens += ev[3]
                if ev[4:] == (True,):
                    s.status = s.S.FINISHED
        sr._observe(1.0, work)
    return work


@pytest.mark.parametrize("name", list(COUNTS))
def test_scripted_observations_count_the_same(name):
    arch = REG.arch(config(name))
    w = observe_script(arch, (300, 517, 1023), SCRIPT)
    (shape, layers), = arch.attention
    assert (shape[3], layers) == (None, config(name)["num_hidden_layers"])
    rows = REG.counts("serve_rows")
    got = dict(k1_ops=w.k1_ops, k1_bytes=w.k1_bytes, trip_pairs=w.trip_pairs[shape],
               prefill_pairs=w.prefill_pairs[shape],
               mfu_ops=rows.rows_flops(arch, w.seq_trips * 64 + w.prefill_rows,
                                       w.seq_trips * 64 + w.prefill_head_rows,
                                       w.trip_pairs, w.prefill_pairs),
               prefill_mfu_ops=rows.rows_flops(arch, w.prefill_rows, w.prefill_head_rows,
                                               w.prefill_pairs))
    assert got == COUNTS[name]  # the same floats, not close ones
    assert (w.seq_trips, w.prefill_rows, w.prefill_head_rows) == (69, 2634, 256)


SHARED = ["run.py", "lib/*.py", "tasks/*.py", "metrics/*.py"]
NAMES = re.compile(r"""jacobiforcing_tpu_torch\.models|QwenReference|["']qwen[23]["']""")


def test_shared_code_names_no_architecture():
    files = [p for pattern in SHARED for p in sorted(BENCH.glob(pattern))]
    assert len(files) > 20
    found = [f"{p.relative_to(BENCH)}:{i}: {line.strip()}" for p in files
             for i, line in enumerate(p.read_text().splitlines(), 1) if NAMES.search(line)]
    assert not found, found
