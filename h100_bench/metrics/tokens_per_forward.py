"""tokens_per_forward (tokens, program counter): over the window, the change
in `LLMEngine.stats["generated_tokens"]` divided by the change in
`stats["jacobi_iterations"]` (per-sequence Jacobi iterations): tokens one
sequence commits per trip of the decode loop."""


def compute(run):
    if run.work is None:
        return None
    it = run.work.stats.get("jacobi_iterations", 0)
    if it <= 0:
        return None
    return run.work.stats["generated_tokens"] / it
