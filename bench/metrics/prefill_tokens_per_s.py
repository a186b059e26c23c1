"""prefill_tokens_per_s: every prompt token prefilled in the window over
the window's time (one batch in flight, closed loop). Host clock."""
from bench.metrics._work import driver_is


def read(run):
    if not driver_is(run, "prefill") or not run.record.get("window_s"):
        return None
    return run.record["tokens"] / run.record["window_s"]
