"""The train step (port of ``repro.train.train_step``).

``build_train_step(model, step_cfg)`` returns ``step(params, opt_state,
batch) -> (params, opt_state, metrics)``: the loss and its gradient by
autograd (``LM.loss_fn``, whose RMSNorms and attentions run the port's
kernels and their backward kernels on CUDA tensors), then AdamW, which
updates params and moments in place. Gradient accumulation over
``microbatches`` is a Python loop where the reference has ``lax.scan``,
with the same float32 sums and averaging.

Run on one device. The reference's sharded builders
(``param_sharding_tree``, ``opt_state_shardings``, ``jit_train_step``,
``jit_prefill_step``, ``jit_decode_step``) wait for the distributed
slice (ROADMAP A10).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from ..models.blueprint import tree_map
from .optimizer import AdamWConfig, adamw_update, leaves


@dataclass
class StepConfig:
    microbatches: int = 1
    remat: bool = True
    opt: AdamWConfig = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.opt is None:
            self.opt = AdamWConfig()


def value_and_grad(model, params, batch: Dict[str, torch.Tensor], *,
                   remat: bool) -> Tuple[torch.Tensor, Any]:
    """(loss, grads) of ``model.loss_fn`` at params: grads a tree of the
    params' structure, each leaf in its param's dtype. params are not
    changed; autograd runs on detached aliases of them."""
    ps = tree_map(lambda a: a.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = model.loss_fn(ps, batch, remat=remat)
        gs = iter(torch.autograd.grad(loss, leaves(ps)))
    return loss.detach(), tree_map(lambda _: next(gs), params)


def build_train_step(model, step_cfg: StepConfig):
    """-> step(params, opt_state, batch) -> (params, opt_state, metrics),
    metrics holding 0-d tensors ``loss``, ``grad_norm`` and ``lr``."""

    def step(params, opt_state, batch):
        n = step_cfg.microbatches
        if n > 1:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            loss = None
            for i in range(n):
                micro = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                         for k, v in batch.items()}
                l, g = value_and_grad(model, params, micro,
                                      remat=step_cfg.remat)
                tree_map(lambda a, b: a.add_(b), acc, g)
                loss = l if loss is None else loss + l
            grads = tree_map(lambda a: a / n, acc)
            loss = loss / n
        else:
            loss, grads = value_and_grad(model, params, batch,
                                         remat=step_cfg.remat)
        params, opt_state, metrics = adamw_update(params, grads, opt_state,
                                                  step_cfg.opt)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step
