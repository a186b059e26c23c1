"""Parameter blueprints: shape, dtype and logical axes per leaf.

Port of ``repro.models.blueprint``. A blueprint is a tree of dicts and
lists with a ``Leaf`` at each end; ``tree_map`` walks it in place of
``jax.tree``. The sharding rules (``DEFAULT_RULES``, ``spec_for``,
``param_specs``) wait for the distributed slice.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

Tree = Any


@dataclass(frozen=True)
class Leaf:
    """Blueprint of one parameter tensor."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical name per dim (None = repl)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                 # normal | zeros | ones
    scale_dim: Optional[int] = None      # fan-in dim index for init scale

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def leaf(shape: Sequence[int], axes: Sequence[Optional[str]],
         dtype: torch.dtype = torch.bfloat16, init: str = "normal",
         scale_dim: Optional[int] = None) -> Leaf:
    return Leaf(tuple(int(s) for s in shape), tuple(axes), dtype, init,
                scale_dim)


def tree_map(f: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """``f`` over the leaves of ``tree`` (anything not a dict, list or
    tuple), with the matching leaves of ``rest`` of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(f, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(f, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return f(tree, *rest)


# -- materialization ----------------------------------------------------------

def init_params(bp: Tree, generator: torch.Generator,
                device=None) -> Tree:
    """Random init, with the reference's rules: zeros, ones, or a normal
    draw in float32 times ``1/sqrt(fan_in)`` cast to the leaf's dtype.
    Draws from ``generator`` in leaf order on its device and puts each
    leaf on ``device`` (default: the generator's). The numbers are
    torch's, not jax.random's."""
    device = generator.device if device is None else torch.device(device)

    def one(l: Leaf) -> torch.Tensor:
        if l.init == "zeros":
            return torch.zeros(l.shape, dtype=l.dtype, device=device)
        if l.init == "ones":
            return torch.ones(l.shape, dtype=l.dtype, device=device)
        fan_in = (l.shape[l.scale_dim] if l.scale_dim is not None
                  else (l.shape[-2] if len(l.shape) >= 2 else l.shape[-1]))
        w = torch.randn(l.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        # in place: a leaf of a large expert layer is 26 GB in float32
        return w.mul_(1.0 / math.sqrt(max(1, fan_in))).to(device, l.dtype)

    return tree_map(one, bp)


def count_params(bp: Tree) -> int:
    sizes: list = []
    tree_map(lambda l: sizes.append(math.prod(l.shape)), bp)
    return sum(sizes)
