"""Streaming chat app: chat-template -> prefill -> streamed Jacobi chunks.

PyTorch port of `jacobiforcing_tpu/apps/chat_stream.py` (re-design of the
reference streaming stack, its `jacobi_stream_chat` (applications/, lines
8-193) with per-token/per-chunk callbacks + TPS accounting, and
applications/jacobi_model_chat.py's Streamlit UI, here a terminal REPL).  The
port engine's `generate_stream` supplies the chunk granularity; the REPL
serves on `--device` (the card by default).

    python -m jacobiforcing_tpu_torch.apps.chat_stream --model /path/to/ckpt
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, List, Optional


def jacobi_stream_chat(
    engine,
    tokenizer,
    messages: List[dict],
    *,
    max_new_tokens: int = 512,
    n_token_seq_len: int = 64,
    strategy: str = "jacobi",
    on_chunk: Optional[Callable[[str, List[int]], None]] = None,
) -> dict:
    """Stream one assistant turn; returns {text, token_ids, tokens_per_s}."""
    from jacobiforcing_tpu_torch.config import SamplingParams

    if tokenizer is not None and hasattr(tokenizer, "apply_chat_template"):
        prompt_ids = tokenizer.apply_chat_template(
            messages, tokenize=True, add_generation_prompt=True
        )
    else:
        # token-id passthrough for tokenizer-less (test) use
        prompt_ids = messages[-1]["content"]

    sp = SamplingParams(
        temperature=0.0,
        max_tokens=max_new_tokens,
        decode_strategy={
            "ar": "autoregressive",
            "jacobi": "jacobi",
            "mr": "jacobi_multiblock_rejection_recycling",
        }[strategy],
        jacobi_block_len=n_token_seq_len,
    )
    t0 = time.perf_counter()
    all_tokens: List[int] = []
    for chunk in engine.generate_stream(list(prompt_ids), sp):
        all_tokens.extend(chunk)
        if on_chunk is not None:
            text = tokenizer.decode(chunk) if tokenizer is not None else str(chunk)
            on_chunk(text, chunk)
    dt = max(time.perf_counter() - t0, 1e-9)
    return {
        "token_ids": all_tokens,
        "text": tokenizer.decode(all_tokens) if tokenizer is not None else "",
        "tokens_per_s": len(all_tokens) / dt,
    }


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--strategy", choices=["ar", "jacobi", "mr"], default="jacobi")
    p.add_argument("--n-token-seq-len", type=int, default=64)
    p.add_argument("--max-new-tokens", type=int, default=512)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()

    from jacobiforcing_tpu_torch.engine.llm import LLM

    llm = LLM(model=args.model, device=args.device)
    messages: List[dict] = []
    print("chat ready (empty line to exit)")
    while True:
        try:
            user = input("you> ").strip()
        except EOFError:
            break
        if not user:
            break
        messages.append({"role": "user", "content": user})
        sys.stdout.write("assistant> ")
        out = jacobi_stream_chat(
            llm.engine, llm.tokenizer, messages,
            max_new_tokens=args.max_new_tokens,
            n_token_seq_len=args.n_token_seq_len,
            strategy=args.strategy,
            on_chunk=lambda text, _: (sys.stdout.write(text), sys.stdout.flush()),
        )
        sys.stdout.write(f"\n[{out['tokens_per_s']:.1f} tok/s]\n")
        messages.append({"role": "assistant", "content": out["text"]})


if __name__ == "__main__":
    main()
