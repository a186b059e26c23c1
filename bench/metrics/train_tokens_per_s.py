"""train_tokens_per_s: the tokens of every step completed in the window
over the time those steps took back to back, each step ending with its
loss read on the host. Host clock."""
from bench.metrics._work import driver_is


def read(run):
    if not driver_is(run, "train") or not run.record.get("window_s"):
        return None
    return run.record["tokens"] / run.record["window_s"]
