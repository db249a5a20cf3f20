"""Share of the traced window (%, device trace) in which no kernel, copy or
set ran on the card: 100 * (window - union of device intervals) / window."""


def compute(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (tr.window_s - tr.busy_s) / tr.window_s
