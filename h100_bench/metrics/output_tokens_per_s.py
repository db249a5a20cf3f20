"""output_tokens_per_s (tokens/s, host clock): output tokens that clients saw
committed inside the window, over all requests, divided by the window."""


def compute(run):
    if run.serve is None:
        return None
    return run.serve["output_tokens"] / run.window_s
