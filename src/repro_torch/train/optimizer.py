"""AdamW on dict trees of tensors, with the reference's options (port of
``repro.train.optimizer``):

  * ``state_dtype``: float32 (default) or bf16 moments;
  * global-norm clipping and a linear warmup;
  * int8 gradient compression with error feedback (``compress_int8``).

The update is computed in float32 and cast back to each leaf's dtype at
the reference's points, but **in place**: ``adamw_update`` writes the new
values into the params and moments it is given and returns the same
trees (JAX returns new arrays; at granite's size a second copy of the
params and moments would be 25 GB). It works through each leaf in flat
slices of ``SLICE`` elements, so its float32 temporaries stay small; the
arithmetic is elementwise, so the slices give the values a whole-leaf
update would. The step counter, the learning rate and the bias
corrections are 0-d tensors on the params' device: an update never waits
for the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Tuple

import torch

from ..models.blueprint import leaves, tree_map

#: elements of a leaf updated at once (256 MB of float32 a temporary)
SLICE = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: torch.dtype = torch.float32
    warmup_steps: int = 100


def _slices(*ts: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching flat slices of tensors of one shape, views of each (a
    tensor that is not contiguous is copied whole first)."""
    flat = [t.reshape(-1) for t in ts]
    for i in range(0, flat[0].numel(), SLICE):
        yield tuple(f[i:i + SLICE] for f in flat)


def init_opt_state(params, cfg: AdamWConfig):
    dev = leaves(params)[0].device
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype,  # noqa
                                  device=p.device)
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    return cfg.lr * warm


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32, summed
    leaf by leaf as the reference's."""
    total = None
    for t in leaves(tree):
        sq = torch.sum(torch.square(t.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """Returns (params, new_state, metrics); params and the moments are
    updated in place (the module's docstring), the step is a new 0-d
    int32 tensor."""
    step = state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-9), max=1.0)
    lr = _schedule(cfg, state["step"])
    bc1 = 1 - cfg.b1 ** step
    bc2 = 1 - cfg.b2 ** step
    quads: List[Tuple[torch.Tensor, ...]] = []
    tree_map(lambda *t: quads.append(t), params, grads, state["m"],
             state["v"])     # matched by key, whatever the dicts' order
    for p, g, m, v in quads:
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("adamw_update updates params and moments in "
                             "place: they must be contiguous")
        for pc, gc, mc, vc in _slices(p, g, m, v):
            gf = gc.float() * scale
            m2 = cfg.b1 * mc.float() + (1 - cfg.b1) * gf
            v2 = cfg.b2 * vc.float() + (1 - cfg.b2) * gf * gf
            mhat = m2 / bc1
            vhat = v2 / bc2
            pf = pc.float()
            delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
                + cfg.weight_decay * pf
            pc.copy_(pf - lr * delta)
            mc.copy_(m2)
            vc.copy_(v2)
    new_state = {"step": step, "m": state["m"], "v": state["v"]}
    metrics: Dict[str, Any] = {"grad_norm": gn, "lr": lr}
    return params, new_state, metrics


# --------------------------------------------------------------------------
# int8 gradient compression with error feedback
# --------------------------------------------------------------------------

def compress_int8(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (q int8, scale, new_err). err is the carried residual (same
    shape). ``torch.round`` rounds half to even, as ``jnp.round``."""
    gf = g.float() + err
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-9) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return q, scale, gf - deq


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
