"""paged_attention_roofline_pct (%, device trace): kernel 1's least time per
launch over its device time per launch.

Least time: the operations and bytes that the window's launches need
(`counts/paged_attention.py`: each prefill's queries and each sequence's
Jacobi trips, from the host mirrors' committed lengths), as
max(operations / bf16 peak, bytes / HBM peak), divided by the launches the
kernel's own counter (`paged_attention_cuda.launches`) made in the window.
Device time: the summed device time of the trace's `paged_attention`
kernels over their number.  Per launch, so that a traced window that is not
exactly the counted one still compares like with like."""


def _parts(run):
    w, tr, pk = run.work, run.trace, run.peaks()
    if w is None or tr is None or pk is None or w.k1_launches <= 0:
        return None
    secs, n = tr.device_seconds("paged_attention")
    if n == 0 or secs <= 0:
        return None
    least, which = run.counts("paged_attention").bound_s(w.k1_ops, w.k1_bytes, pk["bf16_flops"],
                                                         pk["hbm_bytes_per_s"])
    return least / w.k1_launches, secs / n, which, n


def compute(run):
    p = _parts(run)
    return None if p is None else 100.0 * p[0] / p[1]


def note(run):
    p = _parts(run)
    if p is None:
        return None
    return (f"kernel 1: {p[3]} launches traced, {p[1] * 1e3:.5f} ms each on the device, "
            f"bound {p[0] * 1e3:.5f} ms by {p[2]}")
