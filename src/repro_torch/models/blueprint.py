"""Parameter blueprints: shape, dtype and logical axes per leaf.

Port of ``repro.models.blueprint``. A blueprint is a tree of dicts and
lists with a ``Leaf`` at each end; ``tree_map`` walks it in place of
``jax.tree``.

The sharding rules are the reference's (``DEFAULT_RULES``, ``spec_for``,
``param_specs``): every leaf names a logical axis a dim, and the rules
alone map logical axes to mesh axes. A spec is a ``PSpec``, the port's
tuple of mesh axes a dim (None, an axis name, or a tuple of names), with
trailing Nones dropped as the reference's ``PartitionSpec`` has them;
``placements`` turns one into ``torch.distributed.tensor`` placements on
a ``DeviceMesh``. A leaf's ``blocks`` says that its last sharded dim is
that many equal blocks side by side (a gated FF's ``wi``: gate | up), and
a shard takes the same columns of every block, so that a rank holds
matching gate and up columns (see ``distributed/context.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

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
    blocks: int = 1                      # equal blocks along the last dim

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def leaf(shape: Sequence[int], axes: Sequence[Optional[str]],
         dtype: torch.dtype = torch.bfloat16, init: str = "normal",
         scale_dim: Optional[int] = None, blocks: int = 1) -> Leaf:
    return Leaf(tuple(int(s) for s in shape), tuple(axes), dtype, init,
                scale_dim, blocks)


def tree_map(f: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """``f`` over the leaves of ``tree`` (anything not a dict, list or
    tuple; a ``PSpec`` or a named tuple is a leaf), with the matching
    leaves of ``rest`` of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(f, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, PSpec) \
            and not hasattr(tree, "_fields"):
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


def abstract_params(bp: Tree) -> Tree:
    """Meta-device tensors of the leaves' shapes and dtypes: all the dry
    run ever touches (no allocation), where the reference gives
    ``ShapeDtypeStruct``s."""
    return tree_map(lambda l: torch.empty(l.shape, dtype=l.dtype,
                                          device="meta"), bp)


# -- sharding rules (the "uniformity analysis" for parameters) -----------------

Axes = Union[None, str, Tuple[str, ...]]


class PSpec(tuple):
    """Mesh axes a dim: ``PSpec("data", None, "model")``; equal to the
    plain tuple of its parts, as ``tuple(PartitionSpec(...))`` is."""

    def __new__(cls, *parts: Axes):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PSpec{tuple.__repr__(self)}"


# default logical->mesh rules for the production meshes
#   fsdp axes shard over the data axis (ZeRO-style), tensor axes over model
DEFAULT_RULES: Dict[str, Axes] = {
    "layers": None,        # stacked periods: never sharded
    "period": None,
    "vocab": "model",
    "embed": "fsdp",       # row-sharded embeddings / FSDP params
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "experts": "model",    # expert parallelism
    "expert_ff": None,
    "d_inner": "model",
    "state": None,
    "conv": None,
}


def spec_for(l: Leaf, rules: Dict[str, Any], fsdp_axis: Axes = "data"
             ) -> PSpec:
    parts = []
    for ax in l.axes:
        m = rules.get(ax) if ax is not None else None
        if m == "fsdp":
            m = fsdp_axis
        parts.append(m)
    # drop trailing Nones for tidier specs
    while parts and parts[-1] is None:
        parts.pop()
    return PSpec(*parts)


def param_specs(bp: Tree, rules: Optional[Dict[str, Any]] = None,
                fsdp_axis: Axes = "data") -> Tree:
    rules = rules or DEFAULT_RULES
    return tree_map(lambda l: spec_for(l, rules, fsdp_axis), bp)


def dim_axes(spec: PSpec, dim: int) -> Tuple[str, ...]:
    """The mesh axes dim ``dim`` is split over, major first (none past
    the spec's end)."""
    a = spec[dim] if dim < len(spec) else None
    return () if a is None else (a,) if isinstance(a, str) else tuple(a)


def placements(spec: PSpec, mesh) -> tuple:
    """``spec`` as one ``Shard(dim)`` or ``Replicate()`` a mesh dim of the
    ``DeviceMesh``, as ``DTensor`` takes them. A dim split over several
    mesh axes is sharded on each, major first, as ``spec_for`` orders
    them. A ``blocks`` leaf's shards are not ``Shard``'s contiguous
    ranges (``distributed/context.py``): its placements name the dim,
    not the layout."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d in range(len(spec)) if name in dim_axes(spec, d)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)
