"""The gradient of RMSNorm, as a CUDA kernel on Hopper, and the autograd
Function that pairs it with the forward kernel.

The reference has no kernel here: it trains through plain ``jnp`` under
``jax.grad``, and its Pallas ``rmsnorm`` has no ``custom_vjp``. The
port's layers send CUDA tensors to the hand-written forward, a ctypes
call that autograd cannot see through, so training on the card needs
``RMSNorm``: its forward is the forward kernel (which also stores each
row's ``r = rsqrt(var + eps)``), its backward ``csrc/rmsnorm_bwd.cu``:

  * dx = r * g - x * r^3 * mean(x * g) per row, g = scale * dy, in
    float32, cast to x's dtype; rows read and written in 16-byte vectors
    where d is a whole number of them and the pointers are on 16 bytes,
    one element a thread otherwise (the C launcher picks);
  * dscale = the sum over rows of dy * x * r: per-CTA float32 partials,
    summed by a second kernel in one fixed order (no float atomics, so
    the result is the same bits every call);
  * rows up to ``MAX_D`` = 16384 columns (llama3-405b's d_model): past
    8192 a CTA of 512 threads holds only its partials and reads the row
    again for dx.

It is built with nvcc at first use into ``build/rmsnorm_bwd/<sha256>.so``
and launched through ctypes on the current stream. On CPU tensors the
Function runs the plain forward and ``rmsnorm_bwd_plain``, the same
closed form in torch; a CUDA tensor goes to the kernels or raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from .. import plain_dtype
from ..build import SourceKernel
from . import rmsnorm as RN

#: launches of the CUDA backward (one a call, two kernels); the plain
#: version does not count
LAUNCHES = 0
#: CTAs that take the rows, each writing one row of dscale partials
PARTS = 528
#: widest row the kernel takes: 32 columns a thread, 512 threads (256
#: threads up to 8192 columns)
MAX_D = 16384

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = SourceKernel(
    "rmsnorm_bwd",
    Path(__file__).resolve().parent / "csrc" / "rmsnorm_bwd.cu",
    {f"rmsnorm_bwd_{t}": [_P] * 7 + [_I] * 3 + [_P]
     for t in ("f32", "bf16")}, headers=[RN.VEC16])
_NAME = {torch.float32: "rmsnorm_bwd_f32", torch.bfloat16: "rmsnorm_bwd_bf16"}


def rmsnorm_bwd_plain(x: torch.Tensor, scale: torch.Tensor,
                      rstd: torch.Tensor, dy: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) of ``rmsnorm_plain`` at x (N, d), scale (d,), rows'
    rstd (N,) and dy (N, d): the closed form in float32 (float64 for
    float64 inputs), cast to x's and scale's dtypes; any device."""
    t = plain_dtype(x.dtype)
    xf, dyf, r = x.to(t), dy.to(t), rstd.to(t)[:, None]
    g = scale.to(t) * dyf
    mean = (xf * g).mean(dim=-1, keepdim=True)
    dx = r * g - xf * (r * r * r * mean)
    dscale = (dyf * xf * r).sum(dim=0)
    return dx.to(x.dtype), dscale.to(scale.dtype)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, rstd: torch.Tensor,
                dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) as ``rmsnorm_bwd_plain``. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    global LAUNCHES
    if x.dim() != 2 or dy.shape != x.shape or scale.shape != x.shape[1:] \
            or rstd.shape != x.shape[:1]:
        raise ValueError(f"rmsnorm_bwd takes x, dy (N, d), scale (d,), "
                         f"rstd (N,), got {tuple(x.shape)}, "
                         f"{tuple(dy.shape)}, {tuple(scale.shape)}, "
                         f"{tuple(rstd.shape)}")
    tensors = (x, scale, rstd, dy)
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return rmsnorm_bwd_plain(x, scale, rstd, dy)
    if len(devices) != 1 or not x.is_cuda:
        raise ValueError(f"rmsnorm_bwd kernel: x, scale, rstd, dy on "
                         f"{devices}; all must be on one CUDA device")
    name = _NAME.get(x.dtype)
    if name is None or {scale.dtype, dy.dtype} != {x.dtype} \
            or rstd.dtype != torch.float32:
        raise TypeError(f"rmsnorm_bwd kernel takes float32 or bfloat16 x, "
                        f"scale, dy of one dtype and float32 rstd, got "
                        f"{x.dtype}, {scale.dtype}, {dy.dtype}, "
                        f"{rstd.dtype}")
    N, d = x.shape
    if d > MAX_D:
        raise ValueError(f"rmsnorm_bwd kernel: d = {d} > {MAX_D}")
    x, scale, rstd, dy = (t.contiguous() for t in tensors)
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    if N == 0:
        return dx, dscale.zero_()
    parts = min(N, PARTS)
    partial = torch.empty(parts, d, dtype=torch.float32, device=x.device)
    KERNEL.call(name, x.get_device(), x.data_ptr(), scale.data_ptr(),
                rstd.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                dscale.data_ptr(), partial.data_ptr(), N, d, parts)
    LAUNCHES += 1
    return dx, dscale


class RMSNorm(torch.autograd.Function):
    """``rmsnorm(x, scale)`` of (N, d) rows with its gradient: the forward
    kernel saves x, scale and each row's rstd; the backward kernel gives
    dx and dscale. CPU tensors take both plain versions."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: torch.Tensor, eps: float):
        y, rstd = RN.rmsnorm(x, scale, eps=eps, with_rstd=True)
        ctx.save_for_backward(x, scale, rstd)
        return y

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        x, scale, rstd = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, rstd, dy)
        return dx, dscale, None
