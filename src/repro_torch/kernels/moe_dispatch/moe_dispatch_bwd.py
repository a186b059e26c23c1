"""The gradient of the grouped SwiGLU expert FF, with CUDA kernels on
Hopper, and the autograd Function that pairs it with the forward kernel.

The reference has no kernel here: it trains through the einsums of
``repro/models/moe.py:moe_ff`` under ``jax.grad``, and its Pallas
``grouped_expert_ff`` has no ``custom_vjp``. The port's MoE layer sends
CUDA tensors to the hand-written forward (``moe_dispatch.py``), a ctypes
call that autograd cannot see through, so training on the card needs
``GroupedExpertFF``: its forward is the forward kernel, with the
per-expert ``counts``; its backward, ``grouped_expert_ff_bwd``, takes
one of two routes that ``route`` picks from the dtype and the shapes
(the forward's rule; ``csrc/moe_dispatch_bwd.cu`` holds the kernels and
their note):

  * ``tensor_cores`` (bf16, C > 1, d and f multiples of 8): the forward
    keeps the pre-activation gu = x~ @ wi (x~ being x with the rows at or
    past ``counts`` zeroed), which its up kernel writes where the Function
    asks, and three wgmma kernels over the filled rows only: dh = dy @
    wo^T with the SwiGLU backward in its epilogue (dgu and h in bf16,
    dh never stored), dx = dgu @ wi^T, and the weight gradients dwi =
    x~^T @ dgu and dwo = h^T @ dy. No mask pass over x: the copies
    zero-fill the rows past the count.
  * ``cuda_cores`` (float32, and bf16 that the tensor cores do not take):
    gu = x~ @ wi again, dh = dy @ wo^T, the ``swiglu_bwd`` kernel (one
    pass that reads g, u and dh and writes dgu = [dh u silu'(g), dh
    silu(g)] and h = silu(g) u, silu in float32, both in x's dtype, zero
    rows at or past ``counts``), then dwo = h^T @ dy, dwi = x~^T @ dgu,
    dx = dgu @ wi^T as batched ``torch.bmm``: plain large products that
    the reference leaves to XLA outside any Pallas kernel.

Every sum runs in a fixed order with no float atomics (cuBLAS's, and
one accumulator an output tile in the wgmma kernels), so two backward
calls give the same bits.

The kernels are built with nvcc at first use into
``build/moe_dispatch_bwd/<sha256>.so`` and launched through ctypes on
the current stream. ``LAUNCHES`` counts the launches of the
hand-written kernels on the card where they are made: the tensor-core
route's entry (its three kernels) and ``swiglu_bwd`` (the CUDA-core
route's one kernel, or a call of its own); ``LAUNCHES_BY_ROUTE`` the
same by route. On CPU tensors the Function runs the plain forward and
``grouped_expert_ff_bwd_plain``, the same formulas in float32 torch; a
CUDA tensor goes to its route's kernels or raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .. import plain_dtype
from ... import tracing
from ..build import CSRC, SourceKernel
from ..rmsnorm.rmsnorm import VEC16
from . import moe_dispatch as MD

#: launches on the card (the tensor-core entry, ``swiglu_bwd``); the
#: plain version does not count
LAUNCHES = 0
#: the same launches by route (``route``): ``swiglu_bwd`` is the
#: CUDA-core route's; kept in the program's counters
LAUNCHES_BY_ROUTE = tracing.Routes("grouped_expert_ff_bwd",
                                   ("tensor_cores", "cuda_cores"))

_P, _I = ctypes.c_void_p, ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_CSRC = Path(__file__).resolve().parent / "csrc"
KERNEL = SourceKernel(
    "moe_dispatch_bwd", _CSRC / "moe_dispatch_bwd.cu",
    {**{f"swiglu_bwd_{t}": [_P] * 5 + [_I] * 3 + [_P]
        for t in _SUFFIX.values()},
     "moe_ff_bwd_bf16_tc": [_P] * 11 + [_I] * 4 + [_P]},
    headers=[VEC16, CSRC / "sm90.cuh", _CSRC / "moe_tc.cuh"])

#: the forward's rule: bf16 at C > 1 with d and f multiples of 8 takes the
#: tensor cores
route = MD.route


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
    version, CUDA tensors the kernel (the CUDA-core route's pass)."""
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
    LAUNCHES_BY_ROUTE["cuda_cores"] += 1
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
                          counts: Optional[torch.Tensor] = None,
                          gu: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, ...]:
    """(dx, dwi, dwo) as ``grouped_expert_ff_bwd_plain``. CPU tensors take
    the plain version (``gu`` unused); CUDA tensors their route's kernels
    (``route``): on the tensor cores ``gu`` (E, C, 2f) is the forward's
    pre-activation of the filled rows (``moe_dispatch.grouped_expert_ff``
    with ``gu``), which the route needs; on the CUDA cores it is
    recomputed and ``gu`` must be None."""
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
    if route(x.dtype, C, d, f) == "tensor_cores":
        return _bwd_tensor_cores(x, wi, wo, dy.contiguous(), counts, gu)
    if gu is not None:
        raise ValueError("grouped_expert_ff_bwd: the cuda_cores route "
                         "recomputes gu; it takes none")
    return _bwd_cuda_cores(x, wi, wo, dy.contiguous(), counts)


def _bwd_cuda_cores(x, wi, wo, dy, counts):
    """Five batched products around the ``swiglu_bwd`` kernel."""
    live = MD.live_rows(counts, x.shape[1], x.device)
    xt = x if live is None else torch.where(live, x, x.new_zeros(()))
    gu = torch.bmm(xt, wi)
    dh = torch.bmm(dy, wo.transpose(1, 2))
    dgu, h = swiglu_bwd(gu, dh, counts)
    del gu, dh
    dwo = torch.bmm(h.transpose(1, 2), dy)
    del h
    dwi = torch.bmm(xt.transpose(1, 2), dgu)
    dx = torch.bmm(dgu, wi.transpose(1, 2))
    return dx, dwi, dwo


def _bwd_tensor_cores(x, wi, wo, dy, counts, gu):
    """The three wgmma kernels, from the forward's gu."""
    global LAUNCHES
    E, C, d, f = MD._shapes(x, wi, wo)
    if gu is None or gu.shape != (E, C, 2 * f) or gu.dtype != x.dtype \
            or gu.device != x.device:
        raise ValueError(f"grouped_expert_ff_bwd: the tensor-core route "
                         f"takes the forward's gu, {x.dtype} {(E, C, 2 * f)} "
                         f"on {x.device}; got "
                         f"{None if gu is None else (gu.dtype, gu.shape)}")
    tensors = (dy, x, wi, wo, gu)
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("grouped_expert_ff_bwd kernel: dy, x, wi, wo and gu "
                         "must be contiguous and 16-byte aligned")
    n_mb = -(-C // MD.TC_BLOCK)
    cols = 2 * MD.TC_BLOCK
    grids = (E * n_mb * -(-f // cols), E * n_mb * -(-d // cols),
             E * (-(-d // MD.TC_BLOCK) * -(-2 * f // cols)
                  + -(-f // MD.TC_BLOCK) * -(-d // cols)))
    if max(grids) >= 2**31:
        raise ValueError(f"grouped_expert_ff_bwd kernel: grids {grids}")
    dgu = torch.empty_like(gu)
    h = torch.empty(E, C, f, dtype=x.dtype, device=x.device)
    dx, dwi, dwo = (torch.empty_like(t) for t in (x, wi, wo))
    KERNEL.call("moe_ff_bwd_bf16_tc", x.get_device(),
                *(t.data_ptr() for t in tensors),
                None if counts is None else counts.data_ptr(),
                dgu.data_ptr(), h.data_ptr(), dx.data_ptr(), dwi.data_ptr(),
                dwo.data_ptr(), E, C, d, f)
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE["tensor_cores"] += 1
    return dx, dwi, dwo


class GroupedExpertFF(torch.autograd.Function):
    """``grouped_expert_ff(x, wi, wo, counts)`` with its gradient. The
    forward is the forward kernel; where ``keep`` (the caller's grad
    mode: ``models/moe.py`` passes ``torch.is_grad_enabled()``) and an
    input requires grad and the route is the tensor cores', it also keeps
    the pre-activation gu for the backward, ``grouped_expert_ff_bwd``.
    Serving keeps nothing. CPU tensors take both plain versions."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                counts: Optional[torch.Tensor], keep: bool):
        E, C, d, f = MD._shapes(x, wi, wo)
        gu = None
        if keep and any(ctx.needs_input_grad[:3]) and x.is_cuda \
                and route(x.dtype, C, d, f) == "tensor_cores":
            gu = torch.empty(E, C, 2 * f, dtype=x.dtype, device=x.device)
        ctx.save_for_backward(x, wi, wo, counts, gu)
        if gu is None:
            return MD.grouped_expert_ff(x, wi, wo, counts)
        return MD.grouped_expert_ff(x, wi, wo, counts, gu)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, wi, wo, counts, gu = ctx.saved_tensors
        dx, dwi, dwo = grouped_expert_ff_bwd(x, wi, wo, dy, counts, gu)
        return dx, dwi, dwo, None, None
