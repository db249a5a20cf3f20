"""Browser chat UI: zero-dependency replacement for the reference Streamlit app.

Parity target: applications/jacobi_model_chat.py:20-120 — a chat page with
model kept loaded across requests, a Jacobi-decoding response stream, and an
optional side-by-side AR baseline with tokens/sec counters.  Streamlit is not
in this environment, so this serves the same UI from the standard library:
`http.server` + a single HTML page, streaming tokens over a chunked response
(one JSON event per engine chunk, the granularity of
`LLMEngine.generate_stream`).

PyTorch port of `jacobiforcing_tpu/apps/chat_web.py`: the same page and the
same ndjson `/generate` events, served by the port's engine on `--device`
(the card by default).

Usage:
    python -m jacobiforcing_tpu_torch.apps.chat_web --model /path/to/ckpt --port 8400

Then open http://localhost:8400.  `--compare` also streams the AR baseline
after the Jacobi pass (the reference renders both panes side by side).
"""

from __future__ import annotations

import argparse
import json
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>JacobiForcing-TPU chat</title>
<style>
 body { font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 60rem; }
 textarea { width: 100%; height: 5rem; font: inherit; }
 .panes { display: flex; gap: 1rem; }
 .pane { flex: 1; border: 1px solid #ccc; border-radius: 6px; padding: .75rem;
         min-height: 8rem; white-space: pre-wrap; font-family: ui-monospace, monospace; }
 .stats { color: #666; font-size: .85rem; margin-top: .25rem; }
 button { font: inherit; padding: .4rem 1.2rem; margin-top: .5rem; }
</style></head><body>
<h2>JacobiForcing-TPU chat</h2>
<textarea id="prompt" placeholder="Ask something..."></textarea><br>
<label><input type="checkbox" id="compare"> side-by-side AR baseline</label>
<button id="send">Send</button>
<div class="panes">
 <div><h4>Jacobi</h4><div class="pane" id="jacobi"></div><div class="stats" id="jacobi_stats"></div></div>
 <div id="ar_wrap" style="display:none"><h4>AR baseline</h4><div class="pane" id="ar"></div><div class="stats" id="ar_stats"></div></div>
</div>
<script>
document.getElementById('send').onclick = async () => {
  const prompt = document.getElementById('prompt').value;
  const compare = document.getElementById('compare').checked;
  document.getElementById('ar_wrap').style.display = compare ? '' : 'none';
  for (const id of ['jacobi','ar','jacobi_stats','ar_stats'])
    document.getElementById(id).textContent = '';
  const resp = await fetch('/generate', {method:'POST',
    headers:{'Content-Type':'application/json'},
    body: JSON.stringify({prompt, compare})});
  const reader = resp.body.getReader(); const dec = new TextDecoder();
  let buf = '';
  for (;;) {
    const {done, value} = await reader.read(); if (done) break;
    buf += dec.decode(value, {stream:true});
    let i;
    while ((i = buf.indexOf('\\n')) >= 0) {
      const line = buf.slice(0, i); buf = buf.slice(i+1);
      if (!line.trim()) continue;
      const ev = JSON.parse(line);
      if (ev.text) document.getElementById(ev.pane).textContent += ev.text;
      if (ev.stats) document.getElementById(ev.pane+'_stats').textContent = ev.stats;
    }
  }
};
</script></body></html>"""


def make_handler(engine, tokenizer, default_params=None):
    """Build the request handler bound to a live engine (the reference keeps
    the model loaded with st.cache_resource; here it simply lives in the
    server process)."""
    from jacobiforcing_tpu_torch.config import SamplingParams

    def encode_prompt(prompt: str):
        if hasattr(tokenizer, "apply_chat_template"):
            return tokenizer.apply_chat_template(
                [{"role": "user", "content": prompt}],
                tokenize=True, add_generation_prompt=True,
            )
        return tokenizer.encode(prompt)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path not in ("/", "/index.html"):
                self.send_error(404)
                return
            body = PAGE.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/html; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream(self, pane: str, prompt_ids, sp):
            t0 = time.perf_counter()
            n = 0
            for toks in engine.generate_stream(prompt_ids, sp):
                n += len(toks)
                text = tokenizer.decode(toks)
                self.wfile.write(
                    (json.dumps({"pane": pane, "text": text}) + "\n").encode()
                )
                self.wfile.flush()
            dt = max(time.perf_counter() - t0, 1e-9)
            stats = f"{n} tokens · {n / dt:.1f} tok/s"
            self.wfile.write(
                (json.dumps({"pane": pane, "stats": stats}) + "\n").encode()
            )
            self.wfile.flush()

        def do_POST(self):
            if self.path != "/generate":
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", "0"))
            req = json.loads(self.rfile.read(length) or b"{}")
            prompt_ids = encode_prompt(req.get("prompt", ""))
            base = default_params or {}
            jac = SamplingParams(
                temperature=float(req.get("temperature", 0.0)),
                max_tokens=int(req.get("max_tokens", base.get("max_tokens", 512))),
                decode_strategy=base.get("decode_strategy", "jacobi"),
                jacobi_block_len=base.get("jacobi_block_len", 64),
                jacobi_max_blocks=base.get("jacobi_max_blocks", 2),
                jacobi_max_iterations=base.get("jacobi_max_iterations", 4096),
            )
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.end_headers()
            # HTTP/1.0 close-delimited body: each ndjson line is flushed as it
            # is produced, so fetch()/urllib stream events incrementally.
            self._stream("jacobi", prompt_ids, jac)
            if req.get("compare"):
                ar = SamplingParams(
                    temperature=jac.temperature, max_tokens=jac.max_tokens,
                    decode_strategy="autoregressive",
                )
                self._stream("ar", prompt_ids, ar)

        protocol_version = "HTTP/1.0"  # close-delimited streaming

    return Handler


def serve(engine, tokenizer, port: int = 8400, default_params=None):
    # single-threaded: one engine, one request at a time (the scheduler owns
    # all device state; concurrent requests would race the KV pool)
    server = HTTPServer(
        ("127.0.0.1", port), make_handler(engine, tokenizer, default_params)
    )
    return server


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--port", type=int, default=8400)
    p.add_argument("--block-len", type=int, default=64)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    from jacobiforcing_tpu_torch.engine.llm import LLM

    llm = LLM(model=args.model, device=args.device)
    server = serve(
        llm.engine, llm.tokenizer, args.port,
        {"jacobi_block_len": args.block_len},
    )
    print(f"[chat_web] serving on http://localhost:{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
