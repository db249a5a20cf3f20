"""mfu_pct.serve (%, program counter): operations of every row the decoder
forwarded in the window, over the window times the card's bf16 peak.

Rows: each sequence's Jacobi trips times the block length (per-sequence
iterations from the host mirrors; padding rows of a batch bucket and the
rows of sequences that already finished are not counted) and each
prefill's prompt and bootstrap draft (padding not counted).  Operations per
row: `counts/serve_rows.py` (the linear layers as the architecture's layout
prices them), with the head on every trip row and on the prefill's draft
rows, and attention over the visible pairs, trips' and prefills' summed per
attention shape of the layers (`Work.trip_pairs`, `Work.prefill_pairs`)."""


def compute(run):
    w, pk = run.work, run.peaks()
    if w is None or pk is None or w.seq_trips + w.prefill_rows == 0:
        return None
    L = int(run.traffic["sampling"]["jacobi_block_len"])
    rows = run.counts("serve_rows")
    flops = rows.rows_flops(run.arch, w.seq_trips * L + w.prefill_rows,
                            w.seq_trips * L + w.prefill_head_rows,
                            w.trip_pairs, w.prefill_pairs)
    return 100.0 * flops / (run.window_s * pk["bf16_flops"])
