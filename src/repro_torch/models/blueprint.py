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


def leaves(tree: Tree) -> list:
    """The leaves of a tree of dicts and lists, in ``tree_map``'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


# -- materialization ----------------------------------------------------------

#: a leaf of more elements is drawn in slices of this many (1 GiB of
#: float32 a slice)
DRAW_SLICE = 1 << 28


def init_params(bp: Tree, generator: torch.Generator,
                device=None) -> Tree:
    """Random init, with the reference's rules: zeros, ones, or a normal
    draw in float32 times ``1/sqrt(fan_in)`` cast to the leaf's dtype.
    Draws from ``generator`` in leaf order on its device and puts each
    leaf on ``device`` (default: the generator's). A leaf of more than
    ``DRAW_SLICE`` elements is drawn slice by slice of its flattened
    elements into the leaf itself, so the float32 draw never exists whole
    (kimi-k2's expert leaf is 45 GB in float32); its numbers differ from
    one draw of the whole leaf. The numbers are torch's, not
    jax.random's."""
    device = generator.device if device is None else torch.device(device)

    def draw(n: int, scale: float) -> torch.Tensor:
        w = torch.randn(n, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return w.mul_(scale)

    def one(l: Leaf) -> torch.Tensor:
        if l.init == "zeros":
            return torch.zeros(l.shape, dtype=l.dtype, device=device)
        if l.init == "ones":
            return torch.ones(l.shape, dtype=l.dtype, device=device)
        fan_in = (l.shape[l.scale_dim] if l.scale_dim is not None
                  else (l.shape[-2] if len(l.shape) >= 2 else l.shape[-1]))
        scale = 1.0 / math.sqrt(max(1, fan_in))
        n = math.prod(l.shape)
        if n <= DRAW_SLICE:
            return draw(n, scale).to(device, l.dtype).view(l.shape)
        out = torch.empty(l.shape, dtype=l.dtype, device=device)
        flat = out.view(-1)
        for i in range(0, n, DRAW_SLICE):
            m = min(DRAW_SLICE, n - i)
            flat[i:i + m] = draw(m, scale)
        return out

    return tree_map(one, bp)


def count_params(bp: Tree) -> int:
    sizes: list = []
    tree_map(lambda l: sizes.append(math.prod(l.shape)), bp)
    return sum(sizes)
