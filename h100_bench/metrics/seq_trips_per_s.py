"""seq_trips_per_s (trips/s, program counter): over the window, the change in
`LLMEngine.stats["jacobi_iterations"]` (per-sequence Jacobi iterations)
divided by the window.  It is `output_tokens_per_s` with the acceptance
taken out: the tokens a trip commits under random weights move with the
seed, the trips the decode loop runs a second hardly do."""


def compute(run):
    if run.work is None:
        return None
    it = run.work.stats.get("jacobi_iterations", 0)
    if it <= 0:
        return None
    return it / run.window_s
