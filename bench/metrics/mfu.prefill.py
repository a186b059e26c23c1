"""mfu.prefill: the model FLOPs (``_work.prefill_flops``: the active
weights, the unembedding at the last position, causal attention) of the
batches of the traced window's device phase over the phase's length, at
the bf16 peak, in %. Device trace (CUDA activity alone)."""
from bench.metrics._work import driver_is, mfu, prefill_flops


def read(run):
    shapes = run.record.get("traced_shapes")
    if not driver_is(run, "prefill") or not shapes:
        return None
    return mfu(run, sum(prefill_flops(run.config, *bs) for bs in shapes))
