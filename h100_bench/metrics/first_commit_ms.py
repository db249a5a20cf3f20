"""first_commit_ms (ms, program counter): the mean wait from a request's
prefill to the commit of its first output token over the window, 1e3 x the
change in `LLMEngine.stats["first_commit_s"]` over the change in
`stats["first_commits"]`.  Under the one-chunk-lag pipeline a Jacobi
request's first tokens are committed when the group's next chunk is
dispatched, so this holds the first chunk's trips and the lag."""


def compute(run):
    st = run.work.stats if run.work is not None else {}
    n = st.get("first_commits", 0)
    if n <= 0:
        return None
    return 1e3 * st["first_commit_s"] / n
