"""Training launcher: the reference's CLI.

    python -m repro_torch.launch.train [--arch granite-3-2b] [--full]
        [--steps 50] [--batch 8] [--seq 128] [--ckpt-dir DIR]
        [--ckpt-every 20] [--device cuda|cpu] [--distributed]

Port of ``repro.launch.train``: the same flags and defaults (the smoke
config unless ``--full``, AdamW at lr 1e-3, remat, a checkpoint every 20
steps, resumed from ``--ckpt-dir`` where one exists), plus ``--device``
(default: the card) and ``--ckpt-every``.

``--distributed`` (the reference's ``jax.distributed.initialize()``):
one process a rank, started by a launcher that sets ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (as ``torchrun``
does; ``LOCAL_RANK`` picks the rank's card). The process group is NCCL
where every rank of the host has a card of its own, gloo otherwise (the
CPU, or several ranks on one card), and the launcher prints which; the
mesh is (world, 1) over ("data", "model"), as the reference's, and
``train_loop`` runs the sharded step on it. Only rank 0 prints.
"""
import argparse
import os

import torch
import torch.distributed as dist

from ..configs import get_config
from ..device import resolve_device
from ..models import get_model
from ..train.data import DataConfig
from ..train.loop import LoopConfig, train_loop
from ..train.optimizer import AdamWConfig
from ..train.train_step import StepConfig
from .mesh import end_world, local_device, make_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--distributed", action="store_true",
                    help="one process a rank, from RANK, WORLD_SIZE, "
                         "MASTER_ADDR and MASTER_PORT")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    mesh = None
    if args.distributed:
        dev, mesh = init_distributed(dev)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = get_model(cfg)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    try:
        res = train_loop(model, data_cfg,
                         LoopConfig(total_steps=args.steps,
                                    ckpt_every=args.ckpt_every),
                         StepConfig(remat=True, opt=AdamWConfig(lr=1e-3)),
                         args.ckpt_dir, device=dev, mesh=mesh)
    finally:
        if mesh is not None:
            end_world()
    if mesh is None or res.rank == 0:
        print(f"[train] done: {res.steps_done} steps, "
              f"final loss {res.losses[-1]:.4f}"
              + (f" (resumed from {res.resumed_from})" if res.resumed_from
                 else ""))
    return res


def init_distributed(dev: torch.device):
    """The process group from the launcher's environment and the mesh
    (world, 1) over ("data", "model") -> (this rank's device, the mesh)."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed: {', '.join(missing)} not set; "
                           "start each rank from a launcher such as "
                           "torchrun")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    backend = ("nccl" if dev.type == "cuda"
               and torch.cuda.device_count() >= local_world else "gloo")
    dev = local_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, rank=rank, world_size=world)
    if rank == 0:
        print(f"[train] distributed: {world} ranks, backend {backend}, "
              f"device {dev}", flush=True)
    return dev, make_mesh((world, 1), ("data", "model"), dev)


if __name__ == "__main__":
    main()
