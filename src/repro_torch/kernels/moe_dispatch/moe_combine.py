"""The MoE layer's combine as a fixed-order gather, as a CUDA kernel on
Hopper.

``gather_sum(src, slots)`` sums, for every token, the rows of ``src``
that its gate ranks name in ``slots``, in gate-rank order, in float32:
``models/moe.py`` calls it for the combine (the expert FF's output rows,
scaled by their gate weights, back to their tokens) and for the
dispatch's gradient (each slot's dx back to its token). The reference
combines with a scatter-add (``repro/models/moe.py:moe_ff``,
``.at[table].add``), which torch runs as ``index_add_``: float atomics
in any order on the card, and 18.68 ms of olmoe's prefill. This gather
has no atomics, so a step gives the same bits every time.

``csrc/moe_combine.cu`` holds the kernel and its note: one CTA a token,
16-byte vectors along the row, bound by bytes. It is built with nvcc at
first use into ``build/moe_combine/<sha256>.so`` and launched through
ctypes on the current stream. On CPU tensors ``gather_sum`` runs
``gather_sum_plain``, the same sums in torch; a CUDA tensor goes to the
kernel or raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .. import plain_dtype
from ... import tracing
from ..build import SourceKernel
from ..rmsnorm.rmsnorm import VEC16

#: launches of the CUDA kernel; the plain version does not count
LAUNCHES = 0
#: gate ranks a token may have (the kernel's limit)
MAX_K = 64

_P, _I = ctypes.c_void_p, ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL = SourceKernel(
    "moe_combine",
    Path(__file__).resolve().parent / "csrc" / "moe_combine.cu",
    {f"gather_sum_{t}": [_P] * 3 + [_I] * 4 + [_P]
     for t in _SUFFIX.values()}, headers=[VEC16])


def _check(src: torch.Tensor, slots: torch.Tensor) -> None:
    if src.dim() != 2 or slots.dim() != 2 or slots.dtype != torch.int32:
        raise ValueError(f"gather_sum takes src (M, d) and int32 slots "
                         f"(T, k), got {tuple(src.shape)} and "
                         f"{slots.dtype} {tuple(slots.shape)}")


def gather_sum_plain(src: torch.Tensor, slots: torch.Tensor
                     ) -> torch.Tensor:
    """``out[t] = sum_j src[slots[t, j]]`` over j in order, in float32
    (float64 for float64 src), slots outside [0, M) adding nothing; cast
    to src's dtype. Any device."""
    _check(src, slots)
    M, d = src.shape
    t = plain_dtype(src.dtype)
    rows = torch.cat([src.to(t), src.new_zeros(1, d, dtype=t)])
    idx = torch.where((slots >= 0) & (slots < M), slots, M).long()
    out = torch.zeros(slots.shape[0], d, dtype=t, device=src.device)
    for j in range(slots.shape[1]):
        out += rows[idx[:, j]]
    return out.to(src.dtype)


@tracing.kernel("gather_sum")
def gather_sum(src: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """src: (M, d) float32 or bfloat16, slots: (T, k) int32 -> (T, d) in
    src's dtype, as ``gather_sum_plain``. CPU tensors take the plain
    version, CUDA tensors the kernel."""
    global LAUNCHES
    _check(src, slots)
    devices = {src.device, slots.device}
    if devices == {torch.device("cpu")}:
        return gather_sum_plain(src, slots)
    if len(devices) != 1 or not src.is_cuda:
        raise ValueError(f"gather_sum kernel: src, slots on {devices}; "
                         f"both must be on one CUDA device")
    if src.dtype not in _SUFFIX:
        raise TypeError(f"gather_sum kernel takes float32 or bfloat16 src, "
                        f"got {src.dtype}")
    (M, d), (T, k) = src.shape, slots.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"gather_sum kernel: k = {k}, it takes 1 to "
                         f"{MAX_K}")
    src, slots = src.contiguous(), slots.contiguous()
    out = torch.empty(T, d, dtype=src.dtype, device=src.device)
    if T == 0:
        return out
    KERNEL.call(f"gather_sum_{_SUFFIX[src.dtype]}", src.get_device(),
                src.data_ptr(), slots.data_ptr(), out.data_ptr(), T, k, M, d)
    LAUNCHES += 1
    return out
