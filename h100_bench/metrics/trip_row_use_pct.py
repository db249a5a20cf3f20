"""trip_row_use_pct (%, program counter): the share of the rows the window's
Jacobi trips forwarded that belonged to running sequences, 100 x the change
in `LLMEngine.stats["jacobi_iterations"]` (per-sequence iterations) over the
change in `stats["trip_slots"]` (each chunk's batch bucket times its trips:
padding rows and rows of sequences that finished inside the chunk forward
anyway)."""


def compute(run):
    st = run.work.stats if run.work is not None else {}
    slots = st.get("trip_slots", 0)
    if slots <= 0:
        return None
    return 100.0 * st["jacobi_iterations"] / slots
