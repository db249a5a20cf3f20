"""prefill_mfu_pct.open (%, program counter): the operations of the rows the
window's prefills forwarded (each admitted prompt and its bootstrap draft,
`counts/serve_rows.py`, padding not counted) over the host seconds of the
engine's `prefill` span (the change in `LLMEngine.stats["prefill_s"]`,
chunked segments and the read-back included) times the card's bf16 peak.
The span's seconds include its host work, so this is a lower bound on the
prefill's device efficiency.  None off the card."""


def compute(run):
    w, pk = run.work, run.peaks()
    if w is None or pk is None or w.prefill_rows == 0:
        return None
    prefill_s = w.stats.get("prefill_s", 0.0)
    if prefill_s <= 0:
        return None
    flops = run.counts("serve_rows").rows_flops(run.dims, w.prefill_rows, w.prefill_head_rows,
                                                w.prefill_pairs)
    return 100.0 * flops / (prefill_s * pk["bf16_flops"])
