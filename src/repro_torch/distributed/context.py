"""The sharding context: where a rank's shards lie on the mesh.

``ShardCtx`` holds a mesh, the rules that ``models/registry.py:
dynamic_rules`` adapted to it, the model's blueprint and the specs that
``param_specs`` derives from both, and, for one step, the axes its batch
and a sequence-sharded cache are split over, and those the residual
stream's sequence is split over between layers. The layers read it to
work on their local slice of heads, kv heads, ff columns, experts,
``d_inner`` channels or vocab; with no context they run the one-device
code, untouched.

A leaf's shard is the rank's block of every sharded dim: dim ``i`` split
over the mesh axes ``spec[i]`` (major first) in as many equal parts as
those axes have ranks, the rank taking the part of its index in
``launch/mesh.py:axis_group(mesh, axes)``. A leaf with ``blocks`` > 1
has its last dim cut block by block: the shard holds the rank's part of
each block, side by side, so that the rank's columns of every block
match (Megatron's layout of a SwiGLU's column-parallel product). The
gated FF's ``wi`` [gate | up] and mamba's ``in_proj`` [x | z] have 2
blocks, the sLSTM's ``wx``, ``wh`` and ``b`` [i | f | z | o] have 4.

Uneven leaves, stored as far as the reference's plan can be (ROADMAP
C19: an sLSTM whose 4·d splits over the model axis where d does not).
A ``blocks`` leaf whose dim splits over its axes but whose blocks' parts
do not is cut as one dim, the rank taking a contiguous range of it, as
the reference's GSPMD cuts it (``block_split`` says which; ``gather``
and ``unshard`` join such a shard the same way). Beside such a leaf, a
dim on the same axes that does not split over them at all (the sLSTM's
``wo`` rows there) is kept whole: the context's ``specs`` replicate it
(``fit_specs``), so ``sum_replicas`` sums its gradient's copies. Any
other dim that does not split is refused by ``shard``. ``param_specs``
itself, the plan held against the reference's, is not changed.

Design limits, as the reference's rules set them: a dim is sharded on
the model axis only where ``dynamic_rules`` shards it; activations are
split over the data axes (the batch spec of ``input_shardings``) and
replicated over the model axis, but where the config sets
``seq_shard_activations`` (``sp``, train and prefill steps): the
residual stream between layers is then (B, S/m, d) on the model axis,
as Megatron-LM's sequence parallelism has it (Korthikanti et al., 2022,
arXiv:2205.05198). The norms and residual adds run on the rank's S
shard; ``seq_full`` all-gathers S before each column-parallel product,
and ``row_out`` reduce-scatters S after each row-parallel one where
``reduce`` would all-reduce.

The gradient convention: every rank computes the same global loss L
(the sums over the data and model axes are all-reduced) and back-
propagates L / world. With the collectives' exact adjoints
(``collectives.py``) each rank then holds the gradient of world * L / world
with respect to its local tensors, so a leaf's gradient is whole on
the axes that shard it, and its copies' gradients sum to the whole on
the axes that replicate it: ``sum_replicas`` all-reduces them there.
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..launch.mesh import (axis_group, data_axes, fsdp_axis,
                           mesh_axis_sizes)
from ..models.blueprint import (Leaf, PSpec, dim_axes, leaves, param_specs,
                                tree_map)
from . import collectives as col


def as_axes(a) -> Tuple[str, ...]:
    return () if a is None else (a,) if isinstance(a, str) else tuple(a)


@dataclass
class ShardCtx:
    mesh: Any
    rules: Dict[str, Any]
    bp: Any                              # the model's blueprint
    specs: Any = None                    # param_specs(bp, rules, fsdp)
    batch: Tuple[str, ...] = ()          # axes this step's batch is split on
    seq: Tuple[str, ...] = ()            # axes a seq-sharded cache is split on
    sp: Tuple[str, ...] = ()             # axes the residual's S is split on

    def __post_init__(self):
        if self.specs is None:
            self.specs = self.fit_specs(param_specs(
                self.bp, self.rules, fsdp_axis(self.mesh)))
        # every group a step can use, made now, in one order on every rank
        names = self.axes
        for r in range(1, len(names) + 1):
            for axes in itertools.combinations(names, r):
                self.group(axes)

    # -- the mesh -------------------------------------------------------------
    @property
    def sizes(self) -> Dict[str, int]:
        return mesh_axis_sizes(self.mesh)

    @property
    def fsdp(self) -> Tuple[str, ...]:
        return data_axes(self.mesh)

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(self.mesh.mesh_dim_names)

    def size(self, axes) -> int:
        return math.prod(self.sizes[a] for a in as_axes(axes))

    def group(self, axes):
        return axis_group(self.mesh, as_axes(axes))

    def index(self, axes) -> int:
        """This rank's index along ``axes`` (major first)."""
        axes = as_axes(axes)
        if not axes:
            return 0
        return dist.get_rank(self.group(axes))

    def with_step(self, batch=(), seq=(), sp=()) -> "ShardCtx":
        return replace(self, batch=as_axes(batch), seq=as_axes(seq),
                       sp=as_axes(sp))

    # -- logical axes ---------------------------------------------------------
    def logical(self, name: str) -> Tuple[str, ...]:
        """The mesh axes a logical axis is sharded on (none where the
        rules replicate it or its axes have one rank)."""
        m = self.rules.get(name)
        axes = self.fsdp if m == "fsdp" else as_axes(m)
        return axes if self.size(axes) > 1 else ()

    def part(self, name: str, n: int) -> Tuple[int, int]:
        """[lo, hi) of a dim of size ``n`` on logical axis ``name`` that
        this rank holds."""
        axes = self.logical(name)
        k = self.size(axes)
        if n % k:
            raise ValueError(f"{name}: {n} does not split {k} ways")
        i = self.index(axes)
        return i * n // k, (i + 1) * n // k

    # -- collectives ----------------------------------------------------------
    def reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes = as_axes(axes)
        if self.size(axes) == 1:
            return x
        return col.all_reduce(x, self.group(axes), "sum")

    def rmax(self, x: torch.Tensor, axes) -> torch.Tensor:
        axes = as_axes(axes)
        if self.size(axes) == 1:
            return x.detach()
        return col.all_reduce(x, self.group(axes), "max")

    def gather(self, x: torch.Tensor, dim: int, axes,
               blocks: int = 1) -> torch.Tensor:
        """x's shards over ``axes`` joined along ``dim``; with ``blocks``,
        block by block where the shard holds a part of each block (a
        shard of ``x.shape[dim]`` not made of whole blocks' parts was cut
        as one dim, ``block_split``, and is joined as one)."""
        axes = as_axes(axes)
        k = self.size(axes)
        if k == 1:
            return x
        b = blocks if self.block_split(x.shape[dim] * k, k, blocks) else 1
        return col.all_gather(x, dim, self.group(axes), b)

    @staticmethod
    def block_split(n: int, k: int, blocks: int) -> bool:
        """Whether a dim of n in ``blocks`` blocks, over k ranks, is cut
        block by block (each block's part splits k ways); where it is
        not, the dim is cut as one (ROADMAP C19)."""
        return blocks > 1 and n % (k * blocks) == 0

    def fit_specs(self, specs, bp=None):
        """``specs`` with the dims replicated that the module's docstring
        keeps whole (uneven leaves): in a dict of the blueprint that holds
        a ``blocks`` leaf cut as one dim, a sibling's dim on the same axes
        that does not split over them (the sLSTM's ``wo`` rows). Any
        other dim that does not split keeps its spec, and ``shard``
        refuses it."""
        bp = self.bp if bp is None else bp
        if isinstance(bp, dict):
            uneven = set()
            for k, l in bp.items():
                if isinstance(l, Leaf) and l.blocks > 1:
                    axes = dim_axes(specs[k], len(l.shape) - 1)
                    m = self.size(axes)
                    if (m > 1 and l.shape[-1] % m == 0
                            and not self.block_split(l.shape[-1], m,
                                                     l.blocks)):
                        uneven.add(axes)
            return {k: self._whole(specs[k], l, uneven)
                    if isinstance(l, Leaf) else self.fit_specs(specs[k], l)
                    for k, l in bp.items()}
        if isinstance(bp, (list, tuple)) and not isinstance(bp, PSpec):
            return type(bp)(self.fit_specs(s, b) for s, b in zip(specs, bp))
        return specs

    def _whole(self, s: PSpec, l: Leaf, uneven) -> PSpec:
        """``s`` with each dim on axes in ``uneven`` that does not split
        over them replicated."""
        parts = [None if dim_axes(s, d) in uneven
                 and l.shape[d] % self.size(dim_axes(s, d))
                 else (s[d] if d < len(s) else None)
                 for d in range(len(l.shape))]
        while parts and parts[-1] is None:
            parts.pop()
        return s if tuple(parts) == tuple(s) else PSpec(*parts)

    # -- the sequence-parallel residual ---------------------------------------
    def seq_full(self, x: torch.Tensor) -> torch.Tensor:
        """The residual's S shard (B, S/m, ...) -> (B, S, ...), gathered
        over ``sp`` (x itself without it)."""
        return self.gather(x, 1, self.sp) if self.sp else x

    def seq_part(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, S, ...), the same on every rank of ``sp`` -> this rank's
        S shard (no communication). S must split over ``sp``."""
        k = self._seq_split(x)
        if k == 1:
            return x
        S = x.shape[1]
        return x.narrow(1, self.index(self.sp) * (S // k), S // k)

    def _seq_split(self, x: torch.Tensor) -> int:
        """The ranks of ``sp``; raises where x's S does not split over
        them."""
        k = self.size(self.sp)
        if x.shape[1] % k:
            raise ValueError(f"seq_shard_activations: a sequence of "
                             f"{x.shape[1]} does not split over {self.sp} "
                             f"({k} ranks)")
        return k

    def row_out(self, x: torch.Tensor, axes) -> torch.Tensor:
        """A row-parallel product's output x (B, S, ...), partial over
        ``axes``: summed over them, or under the sequence-parallel
        residual, summed and this rank's S shard kept (a reduce-scatter
        where ``axes`` are the residual's; a slice where nothing is
        partial)."""
        axes = as_axes(axes)
        if not self.sp:
            return self.reduce(x, axes)
        if axes == self.sp and self._seq_split(x) > 1:
            return col.reduce_scatter(x, 1, self.group(axes))
        return self.seq_part(self.reduce(x, axes))

    # -- leaves ---------------------------------------------------------------
    def shard(self, t: torch.Tensor, spec: PSpec, blocks: int = 1
              ) -> torch.Tensor:
        """This rank's shard of the whole leaf ``t`` (a view where it can
        be; no communication)."""
        for d in range(t.dim()):
            axes = dim_axes(spec, d)
            k = self.size(axes)
            if k == 1:
                continue
            i = self.index(axes)
            n = t.shape[d]
            b = blocks if d == t.dim() - 1 else 1
            if n % k:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"split {k} ways ({spec})")
            if not self.block_split(n, k, b):
                b = 1           # cut as one dim (ROADMAP C19)
            s = n // (k * b)
            if b == 1:
                t = t.narrow(d, i * s, s)
            else:
                t = torch.cat([t.narrow(d, j * k * s + i * s, s)
                               for j in range(b)], dim=d)
        return t

    def unshard(self, t: torch.Tensor, spec: PSpec, blocks: int = 1,
                only=None) -> torch.Tensor:
        """The leaf gathered over the axes of its sharded dims (those on
        ``only``'s axes where given), differentiable."""
        for d in range(t.dim()):
            axes = dim_axes(spec, d)
            if only is not None and axes != as_axes(only):
                continue
            b = blocks if d == t.dim() - 1 else 1
            t = self.gather(t, d, axes, b)
        return t

    def gather_fsdp(self, tree, layout):
        """Every leaf of ``tree`` gathered over the fsdp axes (ZeRO-3: the
        rank then holds its tensor-parallel slice whole)."""
        return tree_map(lambda t, l: self.unshard(t, l[0], l[1], self.fsdp),
                        tree, layout)

    def layout(self, name: Optional[str] = None, period: bool = False):
        """(spec, blocks) a leaf of the blueprint (or of its subtree
        ``name``); ``period``: of one period of a stacked subtree (the
        leading ``layers`` dim dropped)."""
        specs = self.specs if name is None else self.specs[name]
        bp = self.bp if name is None else self.bp[name]

        def one(s, l: Leaf):
            if period:
                s = PSpec(*s[1:])
            return (s, l.blocks)
        return tree_map(one, specs, bp)

    # -- whole trees ----------------------------------------------------------
    def shard_tree(self, tree, specs=None):
        """Every leaf of a whole tree of the blueprint's structure (params
        or moments) as this rank's contiguous shard."""
        lay = self.layout() if specs is None else tree_map(
            lambda s: (s, 1), specs)
        return tree_map(lambda t, l: self.shard(t, l[0], l[1])
                        .contiguous(), tree, lay)

    def unshard_tree(self, tree, specs=None):
        lay = self.layout() if specs is None else tree_map(
            lambda s: (s, 1), specs)
        with torch.no_grad():
            return tree_map(lambda t, l: self.unshard(t, l[0], l[1]),
                            tree, lay)

    def replicas(self, spec: PSpec) -> Tuple[str, ...]:
        """The mesh axes a leaf of this spec is replicated on."""
        used = {a for d in range(len(spec)) for a in dim_axes(spec, d)}
        return tuple(a for a in self.axes if a not in used)

    def sum_replicas(self, grads):
        """Each leaf's gradient summed over the axes that replicate it
        (the module's docstring), in place of the tree."""
        def one(g, s):
            axes = self.replicas(s)
            if self.size(axes) == 1:
                return g
            return col.all_reduce(g.contiguous(), self.group(axes), "sum")
        with torch.no_grad():
            return tree_map(one, grads, self.specs)

    def global_norm(self, grads) -> torch.Tensor:
        """sqrt of the sum of squares of every element of the whole tree:
        each rank's squared norms, a leaf's divided by its replica count
        so that it counts once, all-reduced over every axis."""
        with torch.no_grad():
            parts = [torch.linalg.vector_norm(g, dtype=torch.float32) ** 2
                     / self.size(self.replicas(s))
                     for g, s in zip(leaves(grads), leaves(self.specs))]
            tot = torch.stack(parts).sum()
            return torch.sqrt(self.reduce(tot, self.axes))


def make_ctx(model, mesh, rules=None) -> ShardCtx:
    from ..models.registry import dynamic_rules
    rules = rules or dynamic_rules(model.cfg, mesh_axis_sizes(mesh))
    return ShardCtx(mesh, rules, model.blueprint())
