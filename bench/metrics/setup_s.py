"""setup_s: seconds from the process's start to the window's: imports,
the card's start, the weights made from the seed, the kernels built or
loaded from ``build/``, and the warm-up (for training, the checked
steps). Host clock."""


def read(run):
    return run.record.get("setup_s")
