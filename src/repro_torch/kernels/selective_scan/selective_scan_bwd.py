"""The gradient of the selective scan, as CUDA kernels on Hopper, and the
autograd Function that pairs them with the forward kernel.

The reference has no kernel here: it trains through its chunked scan in
``jnp`` (``repro/models/ssm.py:mamba_scan_chunked``) under ``jax.grad``,
and its Pallas ``selective_scan`` has no ``custom_vjp``. The port's
mamba block sends CUDA tensors to the hand-written forward
(``selective_scan.py``), a ctypes call that autograd cannot see through,
so training on the card needs ``SelectiveScan``, a Function
``(dA, dBx, Cm, h0) -> (y, h_last)``: its forward is the forward kernel
on a fresh state (the caller's ``h0`` is never written), its backward
``csrc/selective_scan_bwd.cu`` (that file's note has the design): one
thread a (batch, channel) walks the chunk forward, keeping each h_t in
the d(dA) output, then backward, carrying the state's gradient in
registers; dCm is summed over the channels by a fixed warp butterfly and
a second kernel that adds the warps' partials in order. No float
atomics: two calls give the same bits. No torch call runs a reverse
scan.

float32 only: the model's dA, dBx and Cm are float32
(``models/ssm.py:_ssm_params``). The kernels are built with nvcc at
first use into ``build/selective_scan_bwd/<sha256>.so`` and launched
through ctypes on the current stream; ``LAUNCHES`` counts wrapper calls
(two kernels each). On CPU tensors the Function runs the plain forward
and ``selective_scan_bwd_plain``, the same recurrence as a reverse torch
loop; a CUDA tensor goes to the kernels or raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .. import plain_dtype
from ..build import SourceKernel
from . import selective_scan as SS

#: launches of the CUDA backward (one a call, two kernels); the plain
#: version does not count
LAUNCHES = 0
#: channels a CTA takes, each warp of them writing one row of dCm
#: partials
CTA_CHANNELS = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = SourceKernel(
    "selective_scan_bwd",
    Path(__file__).resolve().parent / "csrc" / "selective_scan_bwd.cu",
    {"selective_scan_bwd_f32": [_P] * 11 + [_I] * 4 + [_P]})


def _check(dA, dBx, Cm, h0, dy, dh_last):
    B, S, d, n = SS._shapes(dA, dBx, Cm, h0)
    if dy.shape != (B, S, d):
        raise ValueError(f"selective_scan_bwd: dy {tuple(dy.shape)} does "
                         f"not fit dA {tuple(dA.shape)}: it must be (B, S, d)")
    if dh_last is not None and dh_last.shape != (B, d, n):
        raise ValueError(f"selective_scan_bwd: dh_last "
                         f"{tuple(dh_last.shape)} must be (B, d, n)")
    return B, S, d, n


def selective_scan_bwd_plain(dA: torch.Tensor, dBx: torch.Tensor,
                             Cm: torch.Tensor, h0: Optional[torch.Tensor],
                             dy: torch.Tensor,
                             dh_last: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, ...]:
    """(d(dA), d(dBx), dCm, dh0) of ``selective_scan_plain`` from the
    first state h0 (None: zeros) at the gradients dy (B, S, d) of y and
    dh_last (B, d, n) of the last state (None: zeros): the states again
    forward, then ``g_t = dy_t Cm_t + dA_{t+1} g_{t+1}`` backward, in
    float32 (float64 for float64 inputs), cast to dA's, dBx's, Cm's
    dtypes and float32 for dh0. Any device."""
    B, S, d, n = _check(dA, dBx, Cm, h0, dy, dh_last)
    t = plain_dtype(dA.dtype)
    a, bx, c, g_y = dA.to(t), dBx.to(t), Cm.to(t), dy.to(t)
    h = (torch.zeros(B, d, n, dtype=t, device=dA.device) if h0 is None
         else h0.to(t))
    hs = [h]
    for s in range(S):
        h = a[:, s] * h + bx[:, s]
        hs.append(h)
    G = (torch.zeros(B, d, n, dtype=t, device=dA.device) if dh_last is None
         else dh_last.to(t).clone())
    ddA, ddBx = torch.empty_like(a), torch.empty_like(bx)
    dC = torch.empty_like(c)
    for s in reversed(range(S)):
        g = G + g_y[:, s, :, None] * c[:, s, None, :]
        ddBx[:, s] = g
        ddA[:, s] = g * hs[s]
        dC[:, s] = (g_y[:, s, :, None] * hs[s + 1]).sum(dim=1)
        G = a[:, s] * g
    dh0_t = torch.float64 if t == torch.float64 else torch.float32
    return (ddA.to(dA.dtype), ddBx.to(dBx.dtype), dC.to(Cm.dtype),
            G.to(dh0_t))


def selective_scan_bwd(dA: torch.Tensor, dBx: torch.Tensor, Cm: torch.Tensor,
                       h0: Optional[torch.Tensor], dy: torch.Tensor,
                       dh_last: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """(d(dA), d(dBx), dCm, dh0) as ``selective_scan_bwd_plain``. CPU
    tensors take the plain version, float32 CUDA tensors the kernels."""
    global LAUNCHES
    B, S, d, n = _check(dA, dBx, Cm, h0, dy, dh_last)
    tensors = [t for t in (dA, dBx, Cm, h0, dy, dh_last) if t is not None]
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return selective_scan_bwd_plain(dA, dBx, Cm, h0, dy, dh_last)
    if len(devices) != 1 or not dA.is_cuda:
        raise ValueError(f"selective_scan_bwd kernel: inputs on {devices}; "
                         f"all must be on one CUDA device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"selective_scan_bwd kernel takes float32 inputs, "
                        f"got {[t.dtype for t in tensors]}")
    n_cb = -(-d // CTA_CHANNELS)
    if n not in SS.STATE_SIZES or B * n_cb >= 2**31:
        raise ValueError(f"selective_scan_bwd kernel: state size n = {n} "
                         f"(it takes {SS.STATE_SIZES}), {B * n_cb} blocks")
    dA, dBx, Cm, dy = (t.contiguous() for t in (dA, dBx, Cm, dy))
    h0, dh_last = (None if t is None else t.contiguous()
                   for t in (h0, dh_last))
    ddA, ddBx, dC = (torch.empty_like(t) for t in (dA, dBx, Cm))
    dh0 = torch.empty(B, d, n, dtype=torch.float32, device=dA.device)
    if S == 0:
        return ddA, ddBx, dC, (dh0.zero_() if dh_last is None
                               else dh0.copy_(dh_last))
    partial = torch.empty(B, n_cb * CTA_CHANNELS // 32, S, n,
                          dtype=torch.float32, device=dA.device)
    KERNEL.call("selective_scan_bwd_f32", dA.get_device(), dA.data_ptr(),
                dBx.data_ptr(), Cm.data_ptr(),
                None if h0 is None else h0.data_ptr(), dy.data_ptr(),
                None if dh_last is None else dh_last.data_ptr(),
                ddA.data_ptr(), ddBx.data_ptr(), partial.data_ptr(),
                dC.data_ptr(), dh0.data_ptr(), B, S, d, n)
    LAUNCHES += 1
    return ddA, ddBx, dC, dh0


class SelectiveScan(torch.autograd.Function):
    """``(dA, dBx, Cm, h0) -> (y, h_last)`` with its gradient: the forward
    kernel on a copy of h0 (the caller's state is not overwritten, so
    autograd may hold it), the backward kernels for d(dA), d(dBx), dCm
    and dh0. CPU tensors take both plain versions."""

    @staticmethod
    def forward(ctx, dA: torch.Tensor, dBx: torch.Tensor, Cm: torch.Tensor,
                h0: torch.Tensor):
        if dA.is_cuda and dA.dtype != torch.float32:
            raise TypeError(f"SelectiveScan on the card takes float32 dA, "
                            f"dBx, Cm (its backward kernel's), got "
                            f"{dA.dtype}")
        h = h0.clone()
        y = SS.selective_scan(dA, dBx, Cm, h)
        ctx.save_for_backward(dA, dBx, Cm, h0)
        return y, h

    @staticmethod
    def backward(ctx, dy: torch.Tensor, dh_last: torch.Tensor):
        dA, dBx, Cm, h0 = ctx.saved_tensors
        return selective_scan_bwd(dA, dBx, Cm, h0, dy, dh_last)
