"""Training launcher: the reference's CLI on one device.

    python -m repro_torch.launch.train [--arch granite-3-2b] [--full]
        [--steps 50] [--batch 8] [--seq 128] [--ckpt-dir DIR]
        [--device cuda|cpu]

Port of ``repro.launch.train``: the same flags and defaults (the smoke
config unless ``--full``, AdamW at lr 1e-3, remat, a checkpoint every 20
steps, resumed from ``--ckpt-dir`` where one exists), plus ``--device``
(default: the card). ``--distributed`` (the reference's multi-host
``jax.distributed.initialize()``) waits for the distributed slice and
raises.
"""
import argparse

from ..configs import get_config
from ..device import resolve_device
from ..models import get_model
from ..train.data import DataConfig
from ..train.loop import LoopConfig, train_loop
from ..train.optimizer import AdamWConfig
from ..train.train_step import StepConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host training (not ported: ROADMAP A10)")
    args = ap.parse_args(argv)

    if args.distributed:
        raise NotImplementedError("--distributed is not ported yet "
                                  "(ROADMAP A10)")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = get_model(cfg)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    res = train_loop(model, data_cfg,
                     LoopConfig(total_steps=args.steps, ckpt_every=20),
                     StepConfig(remat=True, opt=AdamWConfig(lr=1e-3)),
                     args.ckpt_dir, device=dev)
    print(f"[train] done: {res.steps_done} steps, "
          f"final loss {res.losses[-1]:.4f}"
          + (f" (resumed from {res.resumed_from})" if res.resumed_from
             else ""))


if __name__ == "__main__":
    main()
