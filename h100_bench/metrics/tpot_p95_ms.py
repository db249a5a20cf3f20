"""tpot_p95_ms (ms, host clock): 95th percentile over the requests of the
window of (time its last token was seen - time its first was seen) /
(output tokens - 1).  Jacobi commits tokens in bursts, so a gap between two
tokens says little; this is the time per token a reader of the stream feels."""

import numpy as np


def compute(run):
    if run.serve is None or not run.serve["tpot_ms"]:
        return None
    return float(np.percentile(run.serve["tpot_ms"], 95))
