"""prefill_ms_p95: the 95th percentile, over every batch of the window,
of the time from a batch's tokens on the host to its logits on the host,
in ms (linear between the two nearest ranks). Host clock."""
import numpy as np

from bench.metrics._work import driver_is


def read(run):
    lat = run.record.get("latencies_s")
    if not driver_is(run, "prefill") or not lat:
        return None
    return 1e3 * float(np.percentile(np.asarray(lat), 95))
