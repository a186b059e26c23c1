"""peak_gb.train: ``torch.cuda.max_memory_allocated()`` over the traced
training steps (reset at their start), in GB of 10^9 bytes. The
allocator's counter."""
from bench.metrics._work import driver_is


def read(run):
    b = run.record.get("stretch_peak_bytes")
    return b / 1e9 if driver_is(run, "train") and b else None
