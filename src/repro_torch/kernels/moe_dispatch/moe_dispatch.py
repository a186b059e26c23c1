"""The grouped SwiGLU expert feed-forward, as a CUDA kernel on Hopper.

Replaces ``repro/kernels/moe_dispatch/moe_dispatch.py:grouped_expert_ff``
(the Pallas TPU kernel). ``csrc/moe_dispatch.cu`` holds the kernel and
its note: one CTA per (expert, 16 capacity rows), float32 on the CUDA
cores, the hidden kept in shared memory. It is built with nvcc at first
use into ``build/moe_dispatch/<sha256>.so`` and launched through ctypes
on the current stream.

Unlike the Pallas kernel, any capacity C is taken (the block size is the
kernel's own business), and C = 0 gives an empty output.

On CPU tensors ``grouped_expert_ff`` runs ``grouped_expert_ff_plain``,
the same function in torch. A CUDA tensor goes to the kernel or raises;
there is no fallback.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from ..build import SourceKernel

#: launches of the CUDA kernel; the plain version does not count
LAUNCHES = 0
#: capacity rows per CTA, and the shared memory a CTA may use (bytes)
BLOCK_ROWS = 16
MAX_SMEM = 232448
_SMEM_FIXED = 64 * (BLOCK_ROWS + 4) * 4      # the x^T tile

_P, _I = ctypes.c_void_p, ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL = SourceKernel(
    "moe_dispatch",
    Path(__file__).resolve().parent / "csrc" / "moe_dispatch.cu",
    {f"moe_ff_{t}": [_P] * 4 + [_I] * 4 + [_P] for t in _SUFFIX.values()})


def _shapes(x, wi, wo):
    if x.dim() != 3 or wi.dim() != 3 or wo.dim() != 3:
        raise ValueError(f"grouped_expert_ff takes x (E, C, d), wi "
                         f"(E, d, 2f), wo (E, f, d), got {tuple(x.shape)}, "
                         f"{tuple(wi.shape)}, {tuple(wo.shape)}")
    E, C, d = x.shape
    f = wo.shape[1]
    if wi.shape != (E, d, 2 * f) or wo.shape != (E, f, d):
        raise ValueError(f"wi {tuple(wi.shape)} and wo {tuple(wo.shape)} "
                         f"do not fit x {tuple(x.shape)}: wi must be "
                         f"(E, d, 2f) and wo (E, f, d)")
    return E, C, d, f


def grouped_expert_ff_plain(x: torch.Tensor, wi: torch.Tensor,
                            wo: torch.Tensor) -> torch.Tensor:
    """``(silu(x @ wi[..., :f]) * (x @ wi[..., f:])) @ wo`` per expert in
    float32, cast to x's dtype; any device."""
    E, C, d, f = _shapes(x, wi, wo)
    h = torch.bmm(x.float(), wi.float())
    h = F.silu(h[..., :f]) * h[..., f:]
    return torch.bmm(h, wo.float()).to(x.dtype)


def grouped_expert_ff(x: torch.Tensor, wi: torch.Tensor,
                      wo: torch.Tensor) -> torch.Tensor:
    """x: (E, C, d), wi: (E, d, 2f), wo: (E, f, d) -> (E, C, d), float32
    or bfloat16. CPU tensors take the plain version, CUDA tensors the
    kernel."""
    global LAUNCHES
    E, C, d, f = _shapes(x, wi, wo)
    if x.dtype not in _SUFFIX or {wi.dtype, wo.dtype} != {x.dtype}:
        raise TypeError(f"grouped_expert_ff takes float32 or bfloat16 x, "
                        f"wi, wo of one dtype, got {x.dtype}, {wi.dtype}, "
                        f"{wo.dtype}")
    devices = {x.device, wi.device, wo.device}
    if devices == {torch.device("cpu")}:
        return grouped_expert_ff_plain(x, wi, wo)
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"grouped_expert_ff kernel: x, wi, wo on "
                         f"{devices}; all must be on one CUDA device")
    if not all(t.is_contiguous() for t in (x, wi, wo)):
        raise ValueError("grouped_expert_ff kernel: x, wi and wo must be "
                         "contiguous")
    smem = f * BLOCK_ROWS * 4 + _SMEM_FIXED
    n_blocks = E * -(-C // BLOCK_ROWS)
    if smem > MAX_SMEM or n_blocks >= 2**31 or min(d, f) < 1:
        raise ValueError(f"grouped_expert_ff kernel: d = {d}, f = {f} "
                         f"({smem} B of shared memory, at most "
                         f"{MAX_SMEM}), {n_blocks} blocks")
    out = torch.empty_like(x)
    if n_blocks == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        KERNEL.call(f"moe_ff_{_SUFFIX[x.dtype]}", x.data_ptr(),
                    wi.data_ptr(), wo.data_ptr(), out.data_ptr(), E, C, d,
                    f, stream)
    LAUNCHES += 1
    return out
