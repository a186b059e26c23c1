"""Serving launcher: random-inits a model from a seed and serves a stream
of synthetic requests through the continuous-batching engine.

    python -m repro_torch.launch.serve [--arch granite-3-2b] [--device cuda]

Port of ``repro.launch.serve``: the same flags and the same smoke-size
model, plus ``--device`` (default: the card).
"""
import argparse

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve_device
from ..models import get_model
from ..models.blueprint import init_params
from ..serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    model = get_model(cfg)
    params = init_params(model.blueprint(),
                         torch.Generator(dev).manual_seed(0))
    eng = ServeEngine(model, params, slots=args.slots, max_seq=64)
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        plen = int(rng.integers(3, 10))
        r = Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, size=plen).astype(np.int32),
            max_new=args.max_new)
        reqs.append(r)
        eng.submit(r)
    eng.run_until_drained()
    for r in reqs:
        print(f"[serve] req {r.rid}: prompt {len(r.prompt)} toks -> "
              f"{r.out}")


if __name__ == "__main__":
    main()
