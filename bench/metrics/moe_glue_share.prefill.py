"""moe_glue_share.prefill: the device time of the MoE layers outside their
expert FF (the program's span ``moe.ff`` less ``moe.expert_ff``: the
route, the dispatch, the combine and its float glue) over the device's
busy time in ``lm.prefill``, in %. Device trace, the program's spans
(``bench/program.py``)."""
from bench.metrics._work import driver_is
from bench.program import install, program

install()


def read(run):
    p = program(run)
    if not driver_is(run, "prefill") or p is None or not p.count("moe.ff"):
        return None
    whole = p.busy_s_in("lm.prefill")
    glue = p.device_s("moe.ff") - p.device_s("moe.expert_ff")
    return 100.0 * glue / whole if whole > 0 else None
