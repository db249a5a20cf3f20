"""setup_s (s, host clock): from the start of the process to the first timed
request or step: weights, engine, kernel builds (a checkout's first run),
warm-up and graph capture."""


def compute(run):
    return run.setup_s
