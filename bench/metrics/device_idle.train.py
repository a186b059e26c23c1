"""device_idle.train: the share of the traced window's device phase
(training steps, CUDA activity alone) in which no kernel, copy or fill
ran on the card, in %. Device trace."""
from bench.metrics._work import driver_is, idle


def read(run):
    return idle(run) if driver_is(run, "train") else None
