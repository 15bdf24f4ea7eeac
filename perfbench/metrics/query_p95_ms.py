"""The 95th percentile of the queries' latencies in the window, each
timed from its issue to its result on the host (which waits for the
device), over every query the window issued.  A per-layer metric: with
the client's run-to-run spread (PERF.md) no bound of at most 25% holds
for it.  Read in the traced run, so the profiler's cost is in it."""

import numpy as np


def read(r):
    if not r.latencies_ms:
        return None
    return float(np.percentile(np.asarray(r.latencies_ms), 95))
