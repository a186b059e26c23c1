"""Pipeline parallelism (GPipe) over a ``pipe`` mesh axis (port of
``repro.distributed.pipeline``).

Each stage holds ``n_layers / P`` layers; microbatches stream through
the stages; bubbles = (P - 1) / (M + P - 1). The reference runs it under
``shard_map`` with ``ppermute`` and a scan over T = M + P - 1 ticks; here
each rank is one stage and runs its part of the same schedule: at tick
t stage i applies its layers to microbatch t - i, taken from the inputs
(stage 0) or received from stage i - 1, and sends the result to stage
i + 1 by point to point; the last stage keeps it. It computes only at
its M ticks of work, where the reference computes on its bubbles too
and masks the result away: the outputs are the same. At the end the
last stage broadcasts the outputs to every stage, where the reference
fans out with a masked ``psum``. Forward only, as the reference.

The calling convention is the reference's: the stage-stacked params
``(P, L/P, ...)`` go in, each rank reading only its own slice, the
microbatches ``(M, mb, ...)`` go in, and every rank gets the outputs.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..models.blueprint import tree_map
from . import collectives as col


def gpipe_forward(layer_fn: Callable, n_microbatches: int,
                  axis: str = "pipe", axis_size: Optional[int] = None, *,
                  mesh):
    """Build a pipelined forward: fn(params_stage, xs) -> ys on this rank.

    ``layer_fn(stage_params, x) -> x`` applies one stage's layers;
    ``params_stage`` are this stage's (L/P, ...) params, ``xs`` the
    (M, mb, ...) microbatches (only stage 0 reads them); every stage
    returns the (M, mb, ...) outputs. ``axis_size`` must be the mesh
    axis's extent, as in the reference (``make_pipelined_apply`` fills
    it in from the mesh). ``mesh``: the ``DeviceMesh`` whose ``axis``
    the stages are; the reference finds its mesh from ``shard_map``."""
    group = mesh.get_group(axis)
    P_ = axis_size if axis_size is not None else dist.get_world_size(group)
    idx = dist.get_rank(group)
    prev = None if idx == 0 else dist.get_global_rank(group, idx - 1)
    nxt = None if idx == P_ - 1 else dist.get_global_rank(group, idx + 1)
    last = dist.get_global_rank(group, P_ - 1)

    def staged(params_stage, xs):
        M = xs.shape[0]
        if M != n_microbatches:
            raise ValueError(f"{M} microbatches for a schedule of "
                             f"{n_microbatches}")
        ys = torch.zeros_like(xs)
        pending = None
        for m in range(M):        # this stage's tick i + m
            x = xs[m] if prev is None else col.recv(xs[m], prev, group)
            y = layer_fn(params_stage, x)
            if nxt is None:
                ys[m] = y
            else:
                col.wait(pending)
                pending = col.send(y, nxt, group)
        col.wait(pending)
        return col.broadcast(ys, last, group)

    return staged


def make_pipelined_apply(mesh, layer_fn: Callable, n_microbatches: int,
                         axis: str = "pipe"):
    """-> apply(stage-stacked params (P, L/P, ...), xs (M, mb, ...)) ->
    ys (M, mb, ...) on every rank; each rank reads its slice of the
    params."""
    staged = gpipe_forward(layer_fn, n_microbatches, axis,
                           axis_size=int(mesh.shape[
                               mesh.mesh_dim_names.index(axis)]),
                           mesh=mesh)
    idx = mesh.get_local_rank(axis)

    def apply(params, xs):
        return staged(tree_map(lambda a: a[idx], params), xs)

    return apply


def bubble_share(n_stages: int, n_microbatches: int) -> float:
    """(P - 1) / (M + P - 1): the schedule's share of idle stage-ticks."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)
