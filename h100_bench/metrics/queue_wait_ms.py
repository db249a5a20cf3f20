"""queue_wait_ms (ms, program counter): the mean wait of an admission in the
scheduler's queue over the window, 1e3 x the change in
`LLMEngine.stats["queue_wait_s"]` over the change in `stats["admissions"]`.
The scheduler adds a sequence's wait, from its append to the waiting queue
to its admission to a prefill batch, at each admission; a preempted
sequence waits, and counts, again."""


def compute(run):
    st = run.work.stats if run.work is not None else {}
    n = st.get("admissions", 0)
    if n <= 0:
        return None
    return 1e3 * st["queue_wait_s"] / n
