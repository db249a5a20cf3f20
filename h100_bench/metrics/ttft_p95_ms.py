"""ttft_p95_ms (ms, host clock): 95th percentile, over every request sent in
the window that finished, of the time from when it was due to be sent to the
end of the step after which its client saw its first committed token."""

import numpy as np


def compute(run):
    if run.serve is None or not run.serve["ttft_ms"]:
        return None
    return float(np.percentile(run.serve["ttft_ms"], 95))
