"""recompute_share.train: the device time of remat's recomputation (the
program's ``lm.period`` ranges inside ``train.backward``) over the
device's busy time in ``train.step``, in %. Device trace, the program's
spans (``bench/program.py``)."""
from bench.metrics._work import driver_is
from bench.program import install, program

install()


def read(run):
    p = program(run)
    if not driver_is(run, "train") or p is None or not p.count("train.step"):
        return None
    whole = p.busy_s_in("train.step")
    return 100.0 * p.recompute_s("lm.period") / whole if whole > 0 else None
