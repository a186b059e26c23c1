"""mfu.train: the model FLOPs (``_work.train_flops``) of the steps of
the traced window's device phase over the phase's length, at the bf16
peak, in %. Device trace (CUDA activity alone)."""
from bench.metrics._work import driver_is, mfu, train_flops


def read(run):
    if not driver_is(run, "train"):
        return None
    t = run.traffic
    f = train_flops(run.config, int(t["global_batch"]), int(t["seq_len"]))
    return mfu(run, f * len(run.record.get("traced_steps", ())))
