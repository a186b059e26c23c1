from .suite import BENCHES, Bench, get_bench  # noqa: F401
