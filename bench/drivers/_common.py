"""What both drivers do: the port's model for the configuration file and
the benchmark's weights, checked against the port's blueprint."""
from __future__ import annotations

import gc
import math
import time

import torch

from bench import weights
from bench.harness import derive_seed, note, port_config

#: the seed's streams
WEIGHTS, TOKENS, WARMUP, SAMPLE = 1, 2, 3, 4


def check_against(tree: dict, blueprint) -> None:
    """Raises where the port's blueprint has another tree or shape."""
    from repro_torch.models.blueprint import tree_map
    bad = []

    def one(leaf, t):
        if tuple(leaf.shape) != tuple(t.shape) or leaf.dtype != t.dtype:
            bad.append((leaf.shape, tuple(t.shape)))
    try:
        tree_map(one, blueprint, tree)
    except (KeyError, IndexError, TypeError) as e:
        raise ValueError(f"the port's parameter tree differs: {e!r}")
    if bad:
        raise ValueError(f"the port's parameter shapes differ: {bad[:4]}")


def build(run):
    """-> (the port's config, its LM, the weights from the seed)."""
    from repro_torch.models.registry import get_model
    run.record["libraries_before"] = built_libraries(run)
    cfg = port_config(run.config)
    model = get_model(cfg)
    params = weights.make(run.config, derive_seed(run.seed, WEIGHTS),
                          run.device)
    check_against(params, model.blueprint())
    return cfg, model, params


def built_libraries(run) -> int:
    """The kernel libraries in the checkout's ``build/``."""
    return sum(1 for _ in (run.root / "build").glob("*/*.so"))


def mark_setup_done(run) -> None:
    run.sync()
    run.record["setup_s"] = time.perf_counter() - run.t_start
    note(f"setup_s {run.record['setup_s']!r}; kernel libraries in build/ "
         f"{run.record.get('libraries_before')} before set-up, "
         f"{built_libraries(run)} after (more: this run built them)")



def free(run) -> None:
    """Drops the program's state (the model, its params and optimizer
    state) and hands the memory back."""
    run.state.clear()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def finite(x: float) -> float:
    """A reading as JSON can hold it: a number that is not finite reads
    as 1e30, past every limit."""
    return x if math.isfinite(x) else 1e30
