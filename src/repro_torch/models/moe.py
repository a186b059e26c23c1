"""Mixture-of-Experts FF layer: top-k router, capacity-based sort/gather
dispatch, grouped expert FF, weighted gather combine.

Port of ``repro.models.moe``, with the reference's semantics, which are
those of its code, not of its docstring:

  * the capacity is ``int(max(1, (T*k // E) * cf))``, a floor;
  * the top-k gate values are renormalized before the capacity drop and
    never after it, so a dropped assignment's weight is lost;
  * ties in the top-k go to the lower expert index, as ``lax.top_k``
    does: a stable descending sort, not ``torch.topk``, whose order on
    ties is unspecified (bf16 router logits tie often).

The expert FF goes through the moe_dispatch kernel on CUDA tensors and
its plain version on CPU tensors, with each expert's filled slots
(``counts``, taken from the dispatch table on the device), so that an
expert no token chose reads no weights. That changes no value: a free
slot is the zero row, whose output is zero either way. The plain version
keeps the hidden in float32 and the kernel's tensor-core route rounds it
to fp16, where the reference's einsums round it to bf16, so all meet at
bf16 tolerance. The expert FF goes through ``GroupedExpertFF``, whose
backward runs on the tensor cores from the pre-activation that its
forward keeps in grad mode (``kernels/moe_dispatch/moe_dispatch_bwd.py``);
where autograd records nothing (serving) it is the forward kernel alone
and keeps nothing, as the dispatch and the combine are their forward
gathers alone.

Every sum of the layer runs in a fixed order, so a train step gives the
same bits every time. The reference's combine is a scatter-add over the
dispatch table, which torch would run as ``index_add_`` with float
atomics on the card, and the gradient of its gather ``xp[table]`` is the
same scatter-add. Here both are gathers over the table's inverse
(``dispatch``: each (token, gate rank)'s slot, or none where the
capacity dropped it) through the ``moe_combine`` kernel
(``kernels/moe_dispatch/moe_combine.py``), which sums a token's k slots
in gate-rank order; the combine's own gradient and the dispatch are
row gathers through the table, each slot one token (``_Dispatch``,
``_Combine``). The values are the reference's within float32 rounding.
Capacity comes from shapes and nothing here reads a value back to the
host.

The layer's spans (``tracing``) are ``moe.ff`` around it, and within it
``moe.route`` (the router, the top-k and the aux loss), ``moe.dispatch``
(the capacity, the dispatch table, the counts and the gather),
``moe.expert_ff`` and ``moe.combine`` (the gate weights, the combine
and the cast back). While tracing is on it also counts, summed over its
calls since the counters' reset: ``moe.assignments``, the T*k expert
assignments (a host number), ``moe.kept``, those the capacity kept, and
``moe.expert_load``, each expert's assignments before the capacity (both
on the device). Under a sharding context each rank counts its own
tokens' assignments, and ``moe.kept`` the filled slots of its own
experts. Under remat a recomputation of the layer is a call and counts
again.

Under a sharding context (``distributed/context.py``) the layer keeps
the one-device semantics over the whole batch: the capacity comes from
the tokens of every data rank, and an assignment is kept where its place
among the expert's assignments of the whole batch (this rank's preceded
by those of the lower data ranks, from an all-gather of the per-expert
counts) is below it; the aux loss reads the whole batch's sums. Every
rank of a model group computes the same routing and table, runs the
expert FF on its own experts (its block of the expert axis), and the
combine's partial sums are all-reduced over the experts' axes (under the
sequence-parallel residual, reduce-scattered over S:
``ShardCtx.row_out``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from .. import tracing
from ..kernels.moe_dispatch.moe_combine import gather_sum
from ..kernels.moe_dispatch.moe_dispatch_bwd import GroupedExpertFF
from .blueprint import leaf

Params = Dict[str, Any]


def moe_bp(d: int, n_experts: int, d_ff_expert: int):
    return {
        "router": leaf((d, n_experts), ("embed", None), scale_dim=0),
        "wi": leaf((n_experts, d, 2 * d_ff_expert),
                   ("experts", "embed", "expert_ff"), scale_dim=1),
        "wo": leaf((n_experts, d_ff_expert, d),
                   ("experts", "expert_ff", "embed"), scale_dim=1),
    }


def capacity(T: int, top_k: int, n_experts: int,
             capacity_factor: float) -> int:
    """Slots per expert for T tokens (the reference's formula)."""
    return int(max(1, (T * top_k // n_experts) * capacity_factor))


def route(p: Params, xt: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xt: (T, d) -> (softmax probs (T, E) float32, renormalized gate
    values (T, k), expert indices (T, k)), lower index first on ties."""
    probs = torch.softmax((xt @ p["router"]).float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :top_k], idx[:, :top_k]
    return probs, vals / vals.sum(-1, keepdim=True).clamp_min(1e-9), idx


def dispatch(gate_idx: torch.Tensor, gate_vals: torch.Tensor, T: int,
             n_experts: int, C: int, before: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (E*C,) table of token ids and weights, and its inverse: the
    (T, k) int32 slot of each token's gate ranks, E*C where the capacity
    dropped the assignment. Assignments are sorted stably by expert, so
    an expert's slots go to its tokens in order; those past C are
    dropped, and free slots point at the zero row T. ``before`` (E,):
    each expert's assignments that precede these tokens (other ranks'),
    which count against C."""
    dev = gate_idx.device
    n = gate_idx.numel()
    flat_e = gate_idx.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(gate_idx.shape[1])
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], gate_vals.reshape(-1)[order]
    idx = torch.arange(n, device=dev)
    run_start = torch.full((n_experts,), n, device=dev).scatter_reduce(
        0, se, idx, reduce="amin")
    pos = idx - run_start[se]
    keep = pos < C if before is None else pos + before[se] < C
    # dropped assignments all land in one spill slot past the table
    dst = torch.where(keep, se * C + pos, n_experts * C)
    table = torch.full((n_experts * C + 1,), T, device=dev)
    table[dst] = st
    wtable = torch.zeros(n_experts * C + 1, device=dev)
    wtable[dst] = sw
    slots = torch.empty(n, dtype=torch.int32, device=dev)
    slots[order] = dst.int()
    return table[:-1], wtable[:-1], slots.view(gate_idx.shape)


def _take(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """rows (T, d) at the table's slots, the zero row where it holds T."""
    return torch.cat([rows, rows.new_zeros(1, rows.shape[1])])[table]


class _Dispatch(torch.autograd.Function):
    """xt (T, d) -> its rows at the table's slots (E*C, d), the zero row
    where the table holds T; the gradient sums each token's slots in
    gate-rank order (``gather_sum``), with no atomics."""

    @staticmethod
    def forward(ctx, xt, table, slots):
        ctx.save_for_backward(slots)
        return _take(xt, table)

    @staticmethod
    def backward(ctx, dxg):
        slots, = ctx.saved_tensors
        return gather_sum(dxg.contiguous(), slots), None, None


class _Combine(torch.autograd.Function):
    """yw (E*C, d), the slots' outputs scaled by their gate weights ->
    each token's sum of its slots in gate-rank order (T, d); the gradient
    is the row of the slot's token (a free slot's is zero)."""

    @staticmethod
    def forward(ctx, yw, table, slots):
        ctx.save_for_backward(table)
        return gather_sum(yw, slots)

    @staticmethod
    def backward(ctx, dout):
        table, = ctx.saved_tensors
        return _take(dout, table), None, None


def moe_ff(p: Params, x: torch.Tensor, *, n_experts: int, top_k: int,
           capacity_factor: float = 1.25, ctx=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d) in x's dtype, aux loss float32).
    ``ctx``: the module's docstring."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    with tracing.span("moe.ff"):
        with tracing.span("moe.route"):
            probs, gate_vals, gate_idx = route(p, xt, top_k)

            # load-balancing aux loss (Switch-style)
            assigned = torch.zeros(n_experts, device=x.device).index_add_(
                0, gate_idx.reshape(-1),
                torch.ones(gate_idx.numel(), device=x.device))
            before, T_all = None, T
            if ctx is not None and ctx.size(ctx.batch) > 1:
                # the whole batch's counts and probabilities
                each = ctx.gather(assigned[None], 0, ctx.batch)  # (n, E)
                before = each[:ctx.index(ctx.batch)].sum(0)
                T_all = T * ctx.size(ctx.batch)
                ce = each.sum(0) / (T_all * top_k)
                aux = n_experts * torch.sum(
                    ctx.reduce(probs.sum(0), ctx.batch) / T_all * ce)
            else:
                ce = assigned / (T * top_k)
                aux = n_experts * torch.sum(probs.mean(0) * ce)

        with tracing.span("moe.dispatch"):
            C = capacity(T_all, top_k, n_experts, capacity_factor)
            table, wtable, slots = dispatch(gate_idx, gate_vals, T,
                                            n_experts, C, before)
            E_lo, E_hi = (0, n_experts) if ctx is None else ctx.part(
                "experts", n_experts)
            if (E_lo, E_hi) != (0, n_experts):  # this rank's experts only
                table = table[E_lo * C:E_hi * C]
                wtable = wtable[E_lo * C:E_hi * C]
                M = (E_hi - E_lo) * C
                slots = slots - E_lo * C
                slots = torch.where((slots >= 0) & (slots < M), slots, M)
            E = E_hi - E_lo
            # filled slots of each expert: min(assigned, C), on the device
            counts = (table.view(E, C) != T).sum(1, dtype=torch.int32)
            xg = _Dispatch.apply(xt, table, slots).reshape(E, C, d)
        with tracing.span("moe.expert_ff"):
            y = GroupedExpertFF.apply(xg, p["wi"], p["wo"], counts,
                                      torch.is_grad_enabled())
        with tracing.span("moe.combine"):
            yw = y.reshape(E * C, d).float() * wtable[:, None]
            out = _Combine.apply(yw, table, slots).reshape(B, S, d)
            if ctx is not None:
                out = ctx.row_out(out, ctx.logical("experts"))
            out = out.to(x.dtype)
    if tracing.enabled():
        tracing.count("moe.assignments", gate_idx.numel())
        tracing.count("moe.kept", counts.sum())
        tracing.count("moe.expert_load", assigned)
    return out, aux


def dropped_share(p: Params, x: torch.Tensor, *, n_experts: int,
                  top_k: int, capacity_factor: float = 1.25) -> float:
    """The share of the T*k expert assignments of x (B, S, d) that the
    capacity drops. Reads the result back to the host: for reports, not
    for the layer."""
    T = x.shape[0] * x.shape[1]
    _, _, gate_idx = route(p, x.reshape(T, -1), top_k)
    C = capacity(T, top_k, n_experts, capacity_factor)
    per_expert = torch.zeros(n_experts, device=x.device).index_add_(
        0, gate_idx.reshape(-1), torch.ones(gate_idx.numel(),
                                            device=x.device))
    return float((per_expert - C).clamp_min(0).sum()) / (T * top_k)
