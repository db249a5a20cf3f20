"""engine_host_pct.batch (%, program counter): the share of the window the
engine's thread spent inside `LLMEngine.step` not waiting for the device,
100 x (the change in `stats["step_s"]` less the change in
`stats["device_wait_s"]`) over the window.  The device waits are the
engine's read-backs (prefill, AR, each trip's flag, a chunk's commit); the
rest is host work: scheduling, building and loading a chunk's inputs,
launches and graph replays, commits to the host mirrors."""


def compute(run):
    st = run.work.stats if run.work is not None else {}
    step_s = st.get("step_s", 0.0)
    if step_s <= 0 or run.window_s <= 0:
        return None
    return 100.0 * (step_s - st.get("device_wait_s", 0.0)) / run.window_s
