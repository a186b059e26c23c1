"""The gradient of the grouped SwiGLU expert FF, with a CUDA kernel on
Hopper, and the autograd Function that pairs it with the forward kernel.

The reference has no kernel here: it trains through the einsums of
``repro/models/moe.py:moe_ff`` under ``jax.grad``, and its Pallas
``grouped_expert_ff`` has no ``custom_vjp``. The port's MoE layer sends
CUDA tensors to the hand-written forward (``moe_dispatch.py``), a ctypes
call that autograd cannot see through, so training on the card needs
``GroupedExpertFF``: its forward is the forward kernel, with the
per-expert ``counts``; its backward, ``grouped_expert_ff_bwd``:

  1. gu = x~ @ wi again, x~ being x with the rows at or past ``counts``
     zeroed (the forward keeps no hidden);
  2. dh = dy @ wo^T;
  3. ``csrc/moe_dispatch_bwd.cu``, ``swiglu_bwd``: one pass over the
     (E, C) rows in 16-byte vectors that reads g, u and dh and writes
     dgu = [dh u silu'(g), dh silu(g)] and h = silu(g) u, silu in
     float32, both stored in x's dtype (h in bf16, as the reference's
     ``moe.py:85``), zero rows at or past ``counts``;
  4. dwo = h^T @ dy, dwi = x~^T @ dgu, dx = dgu @ wi^T.

The five products are batched ``torch.bmm``: plain large products that
the reference leaves to XLA outside any Pallas kernel. cuBLAS sums them
in a fixed order with no float atomics, so two backward calls give the
same bits.

The SwiGLU kernel is built with nvcc at first use into
``build/moe_dispatch_bwd/<sha256>.so`` and launched through ctypes on
the current stream; ``LAUNCHES`` counts its launches. On CPU tensors the
Function runs the plain forward and ``grouped_expert_ff_bwd_plain``, the
same formulas in float32 torch; a CUDA tensor goes to the kernel or
raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .. import plain_dtype
from ..build import SourceKernel
from ..rmsnorm.rmsnorm import VEC16
from . import moe_dispatch as MD

#: launches of the SwiGLU backward kernel; the plain version does not
#: count
LAUNCHES = 0

_P, _I = ctypes.c_void_p, ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL = SourceKernel(
    "moe_dispatch_bwd",
    Path(__file__).resolve().parent / "csrc" / "moe_dispatch_bwd.cu",
    {f"swiglu_bwd_{t}": [_P] * 5 + [_I] * 3 + [_P]
     for t in _SUFFIX.values()}, headers=[VEC16])


def swiglu_bwd_plain(gu: torch.Tensor, dh: torch.Tensor,
                     counts: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dgu, h) of the SwiGLU hidden h = silu(g) * u, gu = [g, u] (E, C,
    2f), at its gradient dh (E, C, f): float32 (float64 for float64
    inputs), cast to gu's dtype; rows at or past ``counts`` zero. Any
    device."""
    t = plain_dtype(gu.dtype)
    f = dh.shape[-1]
    g, u = gu[..., :f].to(t), gu[..., f:].to(t)
    d = dh.to(t)
    s = torch.sigmoid(g)
    silu = g * s
    dgu = torch.cat([d * u * (s * (1 + g * (1 - s))), d * silu], dim=-1)
    h = silu * u
    live = MD.live_rows(counts, gu.shape[1], gu.device)
    if live is not None:
        dgu, h = dgu * live, h * live
    return dgu.to(gu.dtype), h.to(gu.dtype)


def swiglu_bwd(gu: torch.Tensor, dh: torch.Tensor,
               counts: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dgu, h) as ``swiglu_bwd_plain``. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    global LAUNCHES
    if gu.dim() != 3 or dh.dim() != 3 or gu.shape[:2] != dh.shape[:2] \
            or gu.shape[2] != 2 * dh.shape[2]:
        raise ValueError(f"swiglu_bwd takes gu (E, C, 2f) and dh (E, C, f), "
                         f"got {tuple(gu.shape)}, {tuple(dh.shape)}")
    E, C, f = dh.shape
    MD._check_counts(counts, E, gu.device)
    devices = {gu.device, dh.device}
    if devices == {torch.device("cpu")}:
        return swiglu_bwd_plain(gu, dh, counts)
    if len(devices) != 1 or not gu.is_cuda:
        raise ValueError(f"swiglu_bwd kernel: gu, dh on {devices}; both "
                         f"must be on one CUDA device")
    if gu.dtype not in _SUFFIX or dh.dtype != gu.dtype:
        raise TypeError(f"swiglu_bwd kernel takes float32 or bfloat16 gu "
                        f"and dh of one dtype, got {gu.dtype}, {dh.dtype}")
    gu, dh = gu.contiguous(), dh.contiguous()
    dgu, h = torch.empty_like(gu), torch.empty_like(dh)
    if E * C * f == 0:
        return dgu, h
    KERNEL.call(f"swiglu_bwd_{_SUFFIX[gu.dtype]}", gu.get_device(),
                gu.data_ptr(), dh.data_ptr(),
                None if counts is None else counts.data_ptr(),
                dgu.data_ptr(), h.data_ptr(), E, C, f)
    LAUNCHES += 1
    return dgu, h


def grouped_expert_ff_bwd_plain(x: torch.Tensor, wi: torch.Tensor,
                                wo: torch.Tensor, dy: torch.Tensor,
                                counts: Optional[torch.Tensor] = None
                                ) -> Tuple[torch.Tensor, ...]:
    """(dx, dwi, dwo) of ``grouped_expert_ff_plain`` at its gradient dy
    (E, C, d): the closed form in float32 (float64 for float64 inputs),
    cast to the inputs' dtypes; rows of x at or past ``counts`` get zero.
    Any device."""
    E, C, d, f = MD._shapes(x, wi, wo)
    MD._check_counts(counts, E, x.device)
    t = plain_dtype(x.dtype)
    xf, wif, wof, dyf = x.to(t), wi.to(t), wo.to(t), dy.to(t)
    live = MD.live_rows(counts, C, x.device)
    if live is not None:
        xf = xf * live
    gu = torch.bmm(xf, wif)
    dh = torch.bmm(dyf, wof.transpose(1, 2))
    dgu, h = swiglu_bwd_plain(gu, dh, counts)
    dwo = torch.bmm(h.transpose(1, 2), dyf)
    dwi = torch.bmm(xf.transpose(1, 2), dgu)
    dx = torch.bmm(dgu, wif.transpose(1, 2))
    return dx.to(x.dtype), dwi.to(wi.dtype), dwo.to(wo.dtype)


def grouped_expert_ff_bwd(x: torch.Tensor, wi: torch.Tensor,
                          wo: torch.Tensor, dy: torch.Tensor,
                          counts: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, ...]:
    """(dx, dwi, dwo) as ``grouped_expert_ff_bwd_plain``. CPU tensors take
    the plain version; CUDA tensors the five batched products in the
    inputs' dtype (float32 accumulators) around the ``swiglu_bwd``
    kernel."""
    E, C, d, f = MD._shapes(x, wi, wo)
    if dy.shape != x.shape:
        raise ValueError(f"grouped_expert_ff_bwd: dy {tuple(dy.shape)} does "
                         f"not fit x {tuple(x.shape)}")
    if {t.device for t in (x, wi, wo, dy)} == {torch.device("cpu")}:
        return grouped_expert_ff_bwd_plain(x, wi, wo, dy, counts)
    MD._check_counts(counts, E, x.device)
    if {wi.dtype, wo.dtype, dy.dtype} != {x.dtype}:
        raise TypeError(f"grouped_expert_ff_bwd takes x, wi, wo, dy of one "
                        f"dtype, got {x.dtype}, {wi.dtype}, {wo.dtype}, "
                        f"{dy.dtype}")
    live = MD.live_rows(counts, C, x.device)
    xt = x if live is None else torch.where(live, x, x.new_zeros(()))
    dy = dy.contiguous()
    gu = torch.bmm(xt, wi)
    dh = torch.bmm(dy, wo.transpose(1, 2))
    dgu, h = swiglu_bwd(gu, dh, counts)
    del gu, dh
    dwo = torch.bmm(h.transpose(1, 2), dy)
    del h
    dwi = torch.bmm(xt.transpose(1, 2), dgu)
    dx = torch.bmm(dgu, wi.transpose(1, 2))
    return dx, dwi, dwo


class GroupedExpertFF(torch.autograd.Function):
    """``grouped_expert_ff(x, wi, wo, counts)`` with its gradient: the
    forward kernel, which keeps nothing; the backward recomputes the
    up product and runs ``grouped_expert_ff_bwd``. CPU tensors take both
    plain versions."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                counts: Optional[torch.Tensor]):
        ctx.save_for_backward(x, wi, wo, counts)
        return MD.grouped_expert_ff(x, wi, wo, counts)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, wi, wo, counts = ctx.saved_tensors
        dx, dwi, dwo = grouped_expert_ff_bwd(x, wi, wo, dy, counts)
        return dx, dwi, dwo, None

