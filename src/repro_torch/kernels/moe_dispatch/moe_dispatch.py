"""The grouped SwiGLU expert feed-forward, as a CUDA kernel on Hopper.

Replaces ``repro/kernels/moe_dispatch/moe_dispatch.py:grouped_expert_ff``
(the Pallas TPU kernel). ``csrc/moe_dispatch.cu`` holds the kernels and
their note, in two routes that ``route`` picks from the dtype and the
shapes:

  * ``tensor_cores``: bf16 at C > 1 (prefill) with d and f multiples of
    8. Two grouped GEMMs by wgmma (bf16 in, float32 accumulators): the
    gate and up products with h = silu(g) * u written as two bf16 parts
    (hi + lo, about 16 bits) into an (E, C, 2f) scratch that the wrapper
    allocates, then (hi + lo) @ wo;
  * ``cuda_cores``: everything else (float32; decode's C = 1; bf16 rows
    the 16-byte copies cannot take). One CTA per (expert, slice of the
    hidden columns, block of capacity rows), float32 on the CUDA cores,
    the hidden kept in shared memory a chunk of columns at a time, each
    slice's part of the output summed by a second small kernel.

It is built with nvcc at first use into ``build/moe_dispatch/<sha256>.so``
and launched through ctypes on the current stream. ``LAUNCHES`` counts
wrapper calls: one call launches two kernels.

Unlike the Pallas kernel, any capacity C and any width f are taken (the
block size is the kernel's own business), and C = 0 gives an empty
output. On the CUDA cores the wrapper cuts f into slices so that the
grid has at least ``TARGET_CTAS`` CTAs where f allows: many slices at
decode (C = 1), one at prefill, where the row blocks already fill the
card.

On CPU tensors ``grouped_expert_ff`` runs ``grouped_expert_ff_plain``,
the same function in torch. A CUDA tensor goes to the kernel or raises;
there is no fallback.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch
import torch.nn.functional as F

from ..build import CSRC, SourceKernel

#: wrapper calls that launched the CUDA kernels; the plain version does
#: not count
LAUNCHES = 0
#: the same calls by route (``route``)
LAUNCHES_BY_ROUTE = {"tensor_cores": 0, "cuda_cores": 0}
#: capacity rows per CTA on the CUDA cores at C > 1 (one row at C = 1)
BLOCK_ROWS = 16
#: rows and columns of a CTA's output tile on the tensor cores
TC_BLOCK = 128
#: the grid the wrapper's f-slicing aims for: two CTAs per SM of an H100
TARGET_CTAS = 2 * 132
#: slice widths are multiples of this many hidden columns
SLICE_COLS = 256

_P, _I = ctypes.c_void_p, ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL = SourceKernel(
    "moe_dispatch",
    Path(__file__).resolve().parent / "csrc" / "moe_dispatch.cu",
    {**{f"moe_ff_{t}": [_P] * 5 + [_I] * 6 + [_P]
        for t in _SUFFIX.values()},
     "moe_ff_bf16_tc": [_P] * 5 + [_I] * 4 + [_P]},
    headers=[CSRC / "sm90.cuh"])


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


def route(dtype: torch.dtype, C: int, d: int, f: int) -> str:
    """The route a CUDA launch takes: ``tensor_cores`` for bf16 at C > 1
    with d and f multiples of 8 (rows of x, wi, wo and h a multiple of
    16 bytes: the copies move 16 bytes a thread), else ``cuda_cores``."""
    if dtype == torch.bfloat16 and C > 1 and d % 8 == 0 and f % 8 == 0:
        return "tensor_cores"
    return "cuda_cores"


def entry(dtype: torch.dtype, C: int, d: int, f: int) -> str:
    """The exported C function a CUDA launch calls."""
    if route(dtype, C, d, f) == "tensor_cores":
        return "moe_ff_bf16_tc"
    return f"moe_ff_{_SUFFIX[dtype]}"


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
    if min(d, f) < 1 or not all(t.data_ptr() % 16 == 0
                                for t in (x, wi, wo)):
        raise ValueError(f"grouped_expert_ff kernel: d = {d} and f = {f} "
                         f"must be >= 1, x, wi, wo 16-byte aligned")
    way = route(x.dtype, C, d, f)
    n_slices, fs = slicing(E, C, f)
    n_blocks = (E * -(-C // TC_BLOCK) * -(-max(d, f) // TC_BLOCK)
                if way == "tensor_cores"
                else E * -(-C // BLOCK_ROWS) * n_slices)
    if n_blocks >= 2**31:
        raise ValueError(f"grouped_expert_ff kernel: {n_blocks} blocks")
    out = torch.empty_like(x)
    if C == 0 or E == 0:
        return out
    # the hidden's bf16 hi and lo parts (tensor cores) or the slices'
    # float32 sums (CUDA cores)
    scratch = (torch.empty(E, C, 2 * f, dtype=x.dtype, device=x.device)
               if way == "tensor_cores" else
               torch.empty(n_slices, E, C, d, dtype=torch.float32,
                           device=x.device))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        args = (x.data_ptr(), wi.data_ptr(), wo.data_ptr(),
                scratch.data_ptr(), out.data_ptr(), E, C, d, f)
        if way == "tensor_cores":
            KERNEL.call(entry(x.dtype, C, d, f), *args, stream)
        else:
            KERNEL.call(entry(x.dtype, C, d, f), *args, fs, n_slices,
                        stream)
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[way] += 1
    return out


def slicing(E: int, C: int, f: int):
    """(n_slices, slice width) of f >= 1 hidden columns: enough slices
    that E * ceil(C / 16) * n_slices reaches ``TARGET_CTAS`` where f
    allows, each slice a multiple of ``SLICE_COLS`` wide but the last."""
    blocks = max(1, E * -(-C // BLOCK_ROWS))
    n = max(1, min(-(-TARGET_CTAS // blocks), -(-f // SLICE_COLS)))
    fs = -(-f // n)
    fs = -(-fs // SLICE_COLS) * SLICE_COLS
    return -(-f // fs), fs
