"""RMSNorm over the rows of an (N, d) array, as a CUDA kernel on Hopper.

Replaces ``repro/kernels/rmsnorm/rmsnorm.py:rmsnorm`` (the Pallas TPU
kernel). ``csrc/rmsnorm.cu`` holds the kernel and its note: one CTA of
256 threads a row, each row read once in 16-byte vectors (a scalar route
where the row is not whole vectors or not on 16 bytes); bound by bytes. It is built with nvcc at first use into
``build/rmsnorm/<sha256>.so`` and launched through ctypes on the current
stream. At decode's 8 rows the wrapper's host time is the call's time, so
the C functions are bound once and the device is switched only for a
tensor that is not on the current one.

On CPU tensors ``rmsnorm`` runs ``rmsnorm_plain``, the same function in
torch. A CUDA tensor goes to the kernel or raises; there is no fallback.
``with_rstd`` also returns each row's ``rsqrt(var + eps)`` in float32,
which the backward (``rmsnorm_bwd.py``) reads.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import plain_dtype
from ..build import SourceKernel

#: launches of the CUDA kernel; the plain version does not count
LAUNCHES = 0

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the element access both rmsnorm sources include (16-byte vectors)
VEC16 = Path(__file__).resolve().parent / "csrc" / "vec16.cuh"
KERNEL = SourceKernel(
    "rmsnorm", Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu",
    {f"rmsnorm_{t}": [_P, _P, _P, _P, _I, _I, _F, _P]
     for t in ("f32", "bf16")}, headers=[VEC16])
#: the C function of each dtype
_NAME = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}


def rmsnorm_plain(x: torch.Tensor, scale: torch.Tensor, *,
                  eps: float = 1e-6, with_rstd: bool = False):
    """The float32 mean of squares per row, then ``x * rsqrt(var + eps)
    * scale``, cast back to x's dtype; any device, any leading dims. With
    ``with_rstd``: (y, rsqrt(var + eps) of each row)."""
    xf = x.to(plain_dtype(x.dtype))
    var = (xf * xf).mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    y = (xf * r * scale.to(xf.dtype)).to(x.dtype)
    return (y, r[..., 0]) if with_rstd else y


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6, with_rstd: bool = False):
    """x: (N, d) row-normalized; scale: (d,). CPU tensors take the plain
    version, CUDA tensors the kernel. With ``with_rstd``: (y, rstd (N,)
    float32)."""
    global LAUNCHES
    if x.dim() != 2 or scale.dim() != 1 or scale.shape[0] != x.shape[1]:
        raise ValueError(f"rmsnorm takes x (N, d) and scale (d,), got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if x.is_cpu and scale.is_cpu:
        return rmsnorm_plain(x, scale, eps=eps, with_rstd=with_rstd)
    if not x.is_cuda or scale.get_device() != x.get_device():
        raise ValueError(f"rmsnorm kernel: x on {x.device}, scale on "
                         f"{scale.device}; both must be on one CUDA device")
    name = _NAME.get(x.dtype)
    if name is None or scale.dtype != x.dtype:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16 x and "
                        f"scale of one dtype, got {x.dtype}, {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel: x and scale must be contiguous")
    N, d = x.shape
    out = torch.empty_like(x)
    rstd = (torch.empty(N, dtype=torch.float32, device=x.device)
            if with_rstd else None)
    if N > 0:
        KERNEL.call(name, x.get_device(), x.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), None if rstd is None else rstd.data_ptr(),
                    N, d, float(eps))
        LAUNCHES += 1
    return (out, rstd) if with_rstd else out
