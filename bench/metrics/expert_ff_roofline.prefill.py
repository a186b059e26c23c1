"""expert_ff_roofline.prefill: the expert FF's share of its roofline in
prefill: the bounds of its calls (``grouped_expert_ff``), counted over
the rows the capacity kept and the experts holding any, over the device
time in its range, in %. Device trace."""
from bench.metrics._work import driver_is, expert_ff, roofline

SPANS = {"grouped_expert_ff": [
    "repro_torch.kernels.moe_dispatch.moe_dispatch:grouped_expert_ff"]}


def read(run):
    if not driver_is(run, "prefill"):
        return None
    return roofline(run, [("grouped_expert_ff", expert_ff)])
