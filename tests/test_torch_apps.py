"""The port's apps against the JAX package's, on the tiny fp64 model with the
same weights:

  * `chat_stream.jacobi_stream_chat`: streamed == blocking == the JAX app's
    stream;
  * `chat_web`: the page serves and `/generate` streams ndjson events over
    HTTP whose text equals blocking generation (tests/test_apps.py::
    test_chat_web_streams on the port), and its tokens equal the JAX server's;
  * `grid_search.run_grid`: every point's generated tokens equal the JAX
    sweep's; the MR points (auto-policy off, the host generator's drafts) also
    their tokens per forward;
  * `analyze_grid.analyze` == the JAX `analyze` on the same CSV, and without
    matplotlib it skips the plots with a line that says so;
  * `baseline_chart`: the JAX default data less its TPU row, and it draws.
"""

import builtins
import csv
import json
import os
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from jacobiforcing_tpu.apps import analyze_grid as janalyze
from jacobiforcing_tpu.apps import baseline_chart as jchart
from jacobiforcing_tpu.apps import chat_web as jchat_web
from jacobiforcing_tpu.apps import grid_search as jgrid
from jacobiforcing_tpu.apps.chat_stream import jacobi_stream_chat as j_stream_chat
from jacobiforcing_tpu.models import qwen as jq
from jacobiforcing_tpu_torch.apps import analyze_grid, baseline_chart, chat_web, grid_search
from jacobiforcing_tpu_torch.apps.chat_stream import jacobi_stream_chat
from jacobiforcing_tpu_torch.config import Config, SamplingParams
from jacobiforcing_tpu_torch.engine.llm_engine import LLMEngine
from jacobiforcing_tpu_torch.models import qwen as tq
from jacobiforcing_tpu_torch.utils.loader import params_from_numpy
from tests import test_engine as jtests
from tests.test_apps import FakeChatTokenizer

ENGINE_KW = dict(kvcache_page_size=16, max_model_len=256, jacobi_chunk_tokens=32,
                 prefill_token_buckets=(32, 64, 128, 256), eos=-1)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jparams = jq.init_params(jq.ModelConfig.tiny(), jax.random.PRNGKey(0))
    return params_from_numpy(jax.tree.map(np.asarray, jparams))


def make_engine(params, **kw):
    """The port's counterpart of tests/test_engine.make_engine (same weights)."""
    return LLMEngine(Config(**{**ENGINE_KW, **kw}), model_cfg=tq.ModelConfig.tiny(),
                     params=params, num_kv_pages=128, device="cpu")


def test_stream_chat_matches_blocking_and_jax(weights):
    prompts = jtests.make_prompts(256)[:1]
    blocking = make_engine(weights).generate(
        prompts, SamplingParams(temperature=0.0, max_tokens=20, decode_strategy="jacobi",
                                jacobi_block_len=8, jacobi_max_blocks=1))
    chunks = []
    out = jacobi_stream_chat(
        make_engine(weights, jacobi_chunk_tokens=8), None,
        [{"role": "user", "content": prompts[0]}], max_new_tokens=20, n_token_seq_len=8,
        on_chunk=lambda _t, toks: chunks.append(list(toks)))
    assert out["token_ids"] == blocking[0]["token_ids"]
    assert len(chunks) >= 2 and sum(chunks, []) == out["token_ids"]
    assert out["tokens_per_s"] > 0 and out["text"] == ""
    jout = j_stream_chat(jtests.make_engine(jacobi_chunk_tokens=8), None,
                         [{"role": "user", "content": prompts[0]}], max_new_tokens=20,
                         n_token_seq_len=8)
    assert out["token_ids"] == jout["token_ids"]
    # with a chat tokenizer: the template's ids are the prompt, the text decoded
    tok = FakeChatTokenizer()
    msgs = [{"role": "user", "content": "hi there"}]
    got = jacobi_stream_chat(make_engine(weights), tok, msgs, max_new_tokens=12,
                             n_token_seq_len=8, strategy="mr")
    want = j_stream_chat(jtests.make_engine(), tok, msgs, max_new_tokens=12,
                         n_token_seq_len=8, strategy="mr")
    assert got["token_ids"] == want["token_ids"] and got["text"] == want["text"]


def _post(port, prompt, max_tokens):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate",
        data=json.dumps({"prompt": prompt, "max_tokens": max_tokens}).encode(),
        headers={"Content-Type": "application/json"})
    events = []
    with urllib.request.urlopen(req, timeout=120) as resp:
        for line in resp:
            if line.strip():
                events.append(json.loads(line))
    return events


def _serve(module, engine, tok):
    server = module.serve(engine, tok, port=0, default_params={
        "jacobi_block_len": 8, "jacobi_max_blocks": 1, "max_tokens": 16})
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def test_chat_web_streams(weights):
    tok = FakeChatTokenizer()
    server = _serve(chat_web, make_engine(weights, jacobi_chunk_tokens=8), tok)
    jserver = _serve(jchat_web, jtests.make_engine(jacobi_chunk_tokens=8), tok)
    try:
        port, jport = server.server_address[1], jserver.server_address[1]
        page = urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=30).read().decode()
        assert page == jchat_web.PAGE and "JacobiForcing-TPU chat" in page
        for prompt in ("hello world", "second request"):
            events = _post(port, prompt, 16)
            text = "".join(e.get("text", "") for e in events if e["pane"] == "jacobi")
            stats = [e for e in events if "stats" in e]
            assert stats and "tok/s" in stats[0]["stats"]
            assert sum("text" in e for e in events) >= 2  # streamed in several events
            ids = tok.apply_chat_template([{"role": "user", "content": prompt}], tokenize=True,
                                          add_generation_prompt=True)
            want = make_engine(weights).generate([ids], SamplingParams(
                temperature=0.0, max_tokens=16, decode_strategy="jacobi", jacobi_block_len=8,
                jacobi_max_blocks=1, jacobi_max_iterations=4096))[0]["token_ids"]
            assert text == tok.decode(want)
            jtext = "".join(e.get("text", "") for e in _post(jport, prompt, 16)
                            if e["pane"] == "jacobi")
            assert text == jtext
    finally:
        server.shutdown()
        jserver.shutdown()
        server.server_close()
        jserver.server_close()


def _grid_args(module, out):
    args = module.make_parser().parse_args([])
    args.output_dir = str(out)
    args.block_sizes = [8]
    args.Ks = [1, 2]
    args.rs = [0.8]
    args.pools = [1, 2]
    args.max_new_tokens = 8
    args.limit = 2
    args.dataset = ""
    return args


def _tokens(out, row):
    """The token streams of one grid point, from its generations file."""
    point = f"n{row['n']}_K{row['K']}_r{row['r']}_p{row['pool']}"
    strategy = "mr" if row["K"] > 1 or row["pool"] > 1 else "jacobi"
    with open(os.path.join(out, point, f"generations_{strategy}.jsonl")) as f:
        return [json.loads(line)["token_ids"] for line in f]


def test_run_grid_equals_jax(weights, tmp_path):
    """Tokens of every point equal; MR points (K > 1 or pool > 1, the policy
    off so that both engines run the MR program) equal in tokens per forward
    too.  The Jacobi point's drafts carry a random tail drawn by
    jax.random / torch.Generator, so its tokens per forward may differ."""
    rows = grid_search.run_grid(
        _grid_args(grid_search, tmp_path / "port"),
        lambda: (make_engine(weights, jacobi_mr_auto_policy=False), None))
    jrows = jgrid.run_grid(_grid_args(jgrid, tmp_path / "jax"),
                           lambda: (jtests.make_engine(jacobi_mr_auto_policy=False), None))
    assert len(rows) == len(jrows) == 4
    assert all("error" not in r for r in rows + jrows), rows + jrows
    for r, j in zip(rows, jrows):
        assert (r["n"], r["K"], r["r"], r["pool"]) == (j["n"], j["K"], j["r"], j["pool"])
        assert _tokens(tmp_path / "port", r) == _tokens(tmp_path / "jax", j), r
        if r["K"] > 1 or r["pool"] > 1:
            assert r["tokens_per_forward"] == j["tokens_per_forward"], r
        assert r["tokens_per_forward"] >= 1.0 and r["tokens_per_s"] > 0
    with open(tmp_path / "port" / "grid_results.csv") as f:
        assert len(list(csv.DictReader(f))) == 4


def _grid_csv(path):
    """A sweep's CSV with enough (n, r) points per (K, pool) slice for the fit,
    and one failed point."""
    r = np.random.RandomState(0)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["n", "K", "r", "pool", "tokens_per_forward",
                                          "tokens_per_s", "error"])
        w.writeheader()
        for K in (1, 2):
            for pool in (1, 4):
                for n in (16, 32, 64):
                    for rr in (0.5, 0.85):
                        tps = 100 + n - 0.01 * n * n + 30 * rr + K * 5 + r.rand()
                        w.writerow({"n": n, "K": K, "r": rr, "pool": pool,
                                    "tokens_per_forward": 1 + n / 32, "tokens_per_s": tps,
                                    "error": ""})
        w.writerow({"n": 8, "K": 1, "r": 0.5, "pool": 1, "error": "boom"})


def test_analyze_grid_equals_jax(tmp_path, monkeypatch, capsys):
    path = tmp_path / "grid_results.csv"
    _grid_csv(path)
    for plot in ("", str(tmp_path)):
        got = analyze_grid.analyze(str(path), plot)
        assert got == janalyze.analyze(str(path), plot)
        assert len(got["fits"]) == 4 and all("fit_optimum" in x for x in got["fits"])
    assert len(list(tmp_path.glob("tps_surface_K*_p*.png"))) == 4
    # no matplotlib: the plots are skipped with a line that says why
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.startswith("matplotlib"):
            raise ImportError("no matplotlib")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    capsys.readouterr()
    got = analyze_grid.analyze(str(path), str(tmp_path / "none"))
    assert "plot of K=1 pool=1 skipped: matplotlib is not installed" in capsys.readouterr().out
    assert got == janalyze.analyze(str(path), "")
    empty = tmp_path / "empty.csv"
    empty.write_text("n,K,r,pool,tokens_per_forward,tokens_per_s,error\n")
    assert analyze_grid.analyze(str(empty)) == {"error": "no successful grid points"}


def test_baseline_chart_has_no_tpu_row(tmp_path):
    rows = baseline_chart.load_rows(None)
    jrows = jchart.load_rows(None)
    assert not any("v5e" in r["technique"] or "tpu" in r["technique"].lower() for r in rows)
    assert rows == [r for r in jrows if "v5e" not in r["technique"]]
    assert len(rows) == len(jrows) - 1 and rows[0]["technique"] == "AR baseline"
    out = tmp_path / "chart.png"
    baseline_chart.main(["--out", str(out)])
    assert out.stat().st_size > 1000
