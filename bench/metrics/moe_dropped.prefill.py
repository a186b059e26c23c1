"""moe_dropped.prefill: the share of the MoE layers' expert assignments
that the capacity dropped, over the spans stretch's batches and layers:
100 (1 - ``moe.kept`` / ``moe.assignments``), in %. The program's
counters (``bench/program.py``)."""
from bench.metrics._work import driver_is
from bench.program import install

install()


def read(run):
    c = run.record.get("counters") or {}
    n = c.get("moe.assignments")
    if not driver_is(run, "prefill") or not n:
        return None
    return 100.0 * (1.0 - c.get("moe.kept", 0) / n)
