"""End-to-end training on the PyTorch port: a ~110M-parameter
granite-family model for a few hundred steps on the synthetic pipeline,
with checkpointing and auto-resume, on the card unless ``--device cpu``
is given.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu \
        --steps 2 --batch 2 --seq 32 --ckpt /tmp/ck
"""
import argparse
from dataclasses import replace

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.models.blueprint import count_params
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import StepConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="artifacts/train_lm_ckpt")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ~110M params: granite family scaled to d=768/L=12
    cfg = replace(get_config("granite-3-2b"),
                  name="granite-110m", n_layers=12, d_model=768,
                  n_heads=12, n_kv_heads=4, head_dim=64, d_ff=2048,
                  vocab=32768, loss_chunk=0, attn_chunk=128)
    model = get_model(cfg)
    n = count_params(model.blueprint())
    print(f"[train_lm] {cfg.name}: {n/1e6:.1f}M params on {dev.type}")

    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    res = train_loop(
        model, data_cfg,
        LoopConfig(total_steps=args.steps, ckpt_every=50, log_every=10),
        StepConfig(remat=True, opt=AdamWConfig(lr=6e-4, warmup_steps=30)),
        args.ckpt, device=dev)
    first = res.losses[0] if res.losses else float("nan")
    print(f"[train_lm] {res.steps_done} steps: loss {first:.3f} -> "
          f"{res.losses[-1]:.3f}"
          + (f" (resumed from {res.resumed_from})" if res.resumed_from
             else ""))


if __name__ == "__main__":
    main()
