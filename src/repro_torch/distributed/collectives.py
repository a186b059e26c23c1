"""Collectives of the sharded steps and the pipeline, with autograd.

Thin wrappers over ``torch.distributed``'s c10d calls on a process group
(a mesh axis's, ``launch/mesh.py:axis_group``):

  * ``all_reduce``: a sum whose backward is the same sum of the
    gradients (the exact adjoint when the objective is the sum of every
    rank's loss), or a max without gradient;
  * ``all_gather`` along a dim (the fsdp gather of a leaf), whose
    backward is a reduce-scatter that sums;
  * ``reduce_scatter`` along a dim (the sequence-parallel residual's
    sum of a row-parallel product), whose backward is the all-gather;
  * ``send``, ``recv``, ``broadcast`` for the pipeline, forward only.

Each call counts what it moves under the reference's five kinds
(``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``, as ``repro.launch.dryrun.collective_bytes`` names
them; ``broadcast`` apart): the bytes of its output, as the reference's
HLO parse counts an op's result shape (a send counts what it sends).

Gloo has no CUDA point to point (torch 2.11 with CUDA 12.8: a CUDA send
fails in gloo's tcp transport, "writev ... Bad address"), so ``send`` and
``recv`` on a gloo group copy a CUDA tensor through host memory and count
the bytes they copy each way in ``STAGED``. Gloo's all-reduce, broadcast,
all-gather and reduce-scatter take CUDA tensors, and ``chip_smoke.py``'s
distributed phase runs them so on the card. The compute never leaves the
card.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional

import torch
import torch.distributed as dist

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

#: output bytes and calls by kind since the last ``reset``
BYTES: Dict[str, int] = dict.fromkeys(KINDS + ("broadcast",), 0)
COUNTS: Dict[str, int] = dict.fromkeys(KINDS + ("broadcast",), 0)
#: bytes a gloo ``send`` or ``recv`` copied between the card and host
#: memory, by operation
STAGED: Dict[str, int] = {}


def reset() -> None:
    for d in (BYTES, COUNTS):
        for k in d:
            d[k] = 0
    STAGED.clear()


def counters() -> dict:
    return {"bytes": dict(BYTES), "counts": dict(COUNTS),
            "staged": dict(STAGED)}


def _count(kind: str, t: torch.Tensor) -> None:
    BYTES[kind] += t.numel() * t.element_size()
    COUNTS[kind] += 1


def _host(group, t: torch.Tensor) -> bool:
    """Whether a point-to-point transfer of ``t`` goes through host memory
    on this group (a CUDA tensor on gloo)."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _stage_out(op: str, t: torch.Tensor) -> torch.Tensor:
    STAGED[op] = STAGED.get(op, 0) + t.numel() * t.element_size()
    return t.cpu()


def _stage_in(op: str, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    STAGED[op] = STAGED.get(op, 0) + t.numel() * t.element_size()
    return t.to(like.device)


def group_size(group) -> int:
    return dist.get_world_size(group)


# -- the raw calls (out of place) --------------------------------------------

def _all_reduce(x: torch.Tensor, group, op: str) -> torch.Tensor:
    red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    out = x.clone()
    dist.all_reduce(out, op=red, group=group)
    _count("all-reduce", out)
    return out


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    """(L, ...) on each of n ranks -> (n * L, ...) in group-rank order."""
    n = group_size(group)
    src = x.contiguous()
    out = src.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    with warnings.catch_warnings():     # torch 2.13 renames it; 2.11 lacks
        warnings.simplefilter("ignore", FutureWarning)   # the new name
        dist.all_gather_into_tensor(out, src, group=group)
    _count("all-gather", out)
    return out


def _scatter0(g: torch.Tensor, group) -> torch.Tensor:
    """(n * L, ...) on each of n ranks -> the sum over ranks of rank i's
    (L, ...) slice, on rank i."""
    n = group_size(group)
    src = g.contiguous()
    out = src.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
    with warnings.catch_warnings():     # torch 2.13 renames it; 2.11 lacks
        warnings.simplefilter("ignore", FutureWarning)   # the new name
        dist.reduce_scatter_tensor(out, src, group=group)
    _count("reduce-scatter", out)
    return out


def _blocks_to_ranks(t: torch.Tensor, n: int, blocks: int) -> torch.Tensor:
    """A full dim 0 of ``blocks`` blocks, each split n ways -> rank-major
    order (rank i's shard, its pieces of every block, contiguous)."""
    rest = tuple(t.shape[1:])
    s = t.shape[0] // (n * blocks)
    return (t.reshape((blocks, n, s) + rest).transpose(0, 1)
            .reshape((n * blocks * s,) + rest))


def _ranks_to_blocks(t: torch.Tensor, n: int, blocks: int) -> torch.Tensor:
    rest = tuple(t.shape[1:])
    s = t.shape[0] // (n * blocks)
    return (t.reshape((n, blocks, s) + rest).transpose(0, 1)
            .reshape((n * blocks * s,) + rest))


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group, "sum")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.group, "sum"), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, blocks):
        ctx.dim, ctx.group, ctx.blocks = dim, group, blocks
        n = group_size(group)
        out = _gather0(x.movedim(dim, 0), group)
        if blocks > 1:
            out = _ranks_to_blocks(out, n, blocks)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        n = group_size(ctx.group)
        g0 = g.movedim(ctx.dim, 0)
        if ctx.blocks > 1:
            g0 = _blocks_to_ranks(g0, n, ctx.blocks)
        return (_scatter0(g0, ctx.group).movedim(0, ctx.dim).contiguous(),
                None, None, None)


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter0(x.movedim(dim, 0), group).movedim(0, dim) \
            .contiguous()

    @staticmethod
    def backward(ctx, g):
        return (_gather0(g.movedim(ctx.dim, 0), ctx.group)
                .movedim(0, ctx.dim).contiguous(), None, None)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The sum (or max) of ``x`` over the group's ranks, a new tensor.
    The sum is differentiable (its backward sums the gradients over the
    group); the max is not, and is taken of ``x`` detached."""
    if op == "max":
        return _all_reduce(x.detach(), group, "max")
    return _AllReduceSum.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group, blocks: int = 1
               ) -> torch.Tensor:
    """The group's shards of ``x`` joined along ``dim`` in group-rank
    order; with ``blocks``, each shard holds its piece of every one of
    ``blocks`` equal blocks, and the pieces are joined block by block.
    Differentiable: the backward reduce-scatters (sums) the gradient."""
    return _AllGather.apply(x, dim, group, blocks)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, of which each rank keeps
    its block along ``dim`` (in group-rank order). Differentiable: the
    backward all-gathers the gradient."""
    return _ReduceScatter.apply(x, dim, group)


# -- point to point and broadcast (the pipeline; forward only) ----------------

def send(x: torch.Tensor, dst: int, group) -> Optional[tuple]:
    """Start sending ``x`` to global rank ``dst``; returns a handle for
    ``wait`` (its staging buffer stays alive in it)."""
    buf = _stage_out("send", x) if _host(group, x) else x.contiguous()
    _count("collective-permute", buf)
    return (dist.isend(buf, dst, group=group), buf)


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor of ``like``'s shape, dtype and device, received from
    global rank ``src``."""
    host = _host(group, like)
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if host else like.device)
    dist.recv(buf, src, group=group)
    return _stage_in("recv", buf, like) if host else buf


def wait(handle: Optional[tuple]) -> None:
    if handle is not None:
        handle[0].wait()


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` of global rank ``src`` on every rank of the group (every rank
    passes a tensor of the same shape and dtype)."""
    out = x.clone()
    dist.broadcast(out, src, group=group)
    _count("broadcast", out)
    return out

