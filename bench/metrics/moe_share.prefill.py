"""moe_share.prefill: the device time of the MoE layers (``models/moe.py``
``moe_ff``: route, dispatch, expert FF, combine) over ``LM.prefill``'s,
in %. Device trace."""
from bench.metrics._work import driver_is, share

SPANS = {"moe_ff": ["repro_torch.models.moe:moe_ff"]}


def read(run):
    return share(run, "moe_ff", "prefill") if driver_is(run, "prefill") \
        else None
