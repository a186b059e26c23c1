"""The MoE layer's combine as a fixed-order gather, as a CUDA kernel on
Hopper.

``gather_sum(src, slots, weights, out_dtype)`` sums, for every token,
the rows of ``src`` that its gate ranks name in ``slots``, each scaled
by its slot's weight where ``weights`` are given, in gate-rank order, in
float32, and stores the sum once in ``out_dtype``: ``models/moe.py``
calls it for the combine (the expert FF's bf16 output rows and their
gate weights, back to their tokens, in one pass) and, unweighted, for
the dispatch's gradient (each slot's dx back to its token). The
reference combines with a scatter-add (``repro/models/moe.py:moe_ff``,
``.at[table].add``), which torch runs as ``index_add_``: float atomics
in any order on the card, and 18.68 ms of olmoe's prefill. This gather
has no atomics, so a step gives the same bits every time.

``csrc/moe_combine.cu`` holds the kernel and its note: a thread a
16-byte vector of a token's row, a token's slots loaded before they are
summed, bound by bytes. It is built with nvcc at first use into
``build/moe_combine/<sha256>.so`` and launched through ctypes on the
current stream. On CPU tensors ``gather_sum`` runs ``gather_sum_plain``,
the same sums in torch; a CUDA tensor goes to the kernel or raises.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .. import plain_dtype
from ... import tracing
from ..build import SourceKernel
from ..rmsnorm.rmsnorm import VEC16

#: launches of the CUDA kernel; the plain version does not count
LAUNCHES = 0
#: the same launches by route: ``weighted`` (with each slot's weight,
#: the combine), ``unweighted`` (the dispatch's gradient)
LAUNCHES_BY_ROUTE = tracing.Routes("gather_sum", ("weighted", "unweighted"))
#: gate ranks a token may have (the kernel's limit)
MAX_K = 64

_P, _I = ctypes.c_void_p, ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: ``gather_sum_<src>``: unweighted, out in src's type; ``gather_sum_w_
#: <src>[_f32]``: a weights pointer (or None) after slots, out in src's
#: type or float32
KERNEL = SourceKernel(
    "moe_combine",
    Path(__file__).resolve().parent / "csrc" / "moe_combine.cu",
    {**{f"gather_sum_{t}": [_P] * 3 + [_I] * 4 + [_P]
        for t in _SUFFIX.values()},
     **{f"gather_sum_w_{t}": [_P] * 4 + [_I] * 4 + [_P]
        for t in ("f32", "bf16", "bf16_f32")}},
    headers=[VEC16])


def _check(src: torch.Tensor, slots: torch.Tensor,
           weights: Optional[torch.Tensor], out_dtype: torch.dtype) -> None:
    if src.dim() != 2 or slots.dim() != 2 or slots.dtype != torch.int32:
        raise ValueError(f"gather_sum takes src (M, d) and int32 slots "
                         f"(T, k), got {tuple(src.shape)} and "
                         f"{slots.dtype} {tuple(slots.shape)}")
    if weights is not None and (weights.dtype != torch.float32
                                or tuple(weights.shape) != src.shape[:1]):
        raise ValueError(f"gather_sum takes float32 weights ({src.shape[0]},)"
                         f", got {weights.dtype} {tuple(weights.shape)}")
    if out_dtype not in (src.dtype, torch.float32):
        raise TypeError(f"gather_sum stores in src's dtype or float32, not "
                        f"{out_dtype}")


def gather_sum_plain(src: torch.Tensor, slots: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     out_dtype: Optional[torch.dtype] = None
                     ) -> torch.Tensor:
    """``out[t] = sum_j src[s_j] * weights[s_j]`` over j in order, s_j =
    ``slots[t, j]``, each product rounded to float32 (no product without
    weights), in float32 (float64 for unweighted float64 src), slots
    outside [0, M) adding nothing; cast to ``out_dtype`` (src's dtype by
    default). Any device."""
    out_dtype = src.dtype if out_dtype is None else out_dtype
    _check(src, slots, weights, out_dtype)
    M, d = src.shape
    if weights is None:
        rows = src.to(plain_dtype(src.dtype))
    else:
        rows = src.to(torch.float32) * weights[:, None]
    rows = torch.cat([rows, rows.new_zeros(1, d)])
    idx = torch.where((slots >= 0) & (slots < M), slots, M).long()
    out = torch.zeros(slots.shape[0], d, dtype=rows.dtype, device=src.device)
    for j in range(slots.shape[1]):
        out += rows[idx[:, j]]
    return out.to(out_dtype)


@tracing.kernel("gather_sum")
def gather_sum(src: torch.Tensor, slots: torch.Tensor,
               weights: Optional[torch.Tensor] = None,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """src: (M, d) float32 or bfloat16, slots: (T, k) int32, weights:
    (M,) float32 or None -> (T, d) in ``out_dtype`` (src's dtype or
    float32; src's by default), as ``gather_sum_plain``. CPU tensors take
    the plain version, CUDA tensors the kernel."""
    global LAUNCHES
    out_dtype = src.dtype if out_dtype is None else out_dtype
    _check(src, slots, weights, out_dtype)
    devices = {src.device, slots.device}
    if weights is not None:
        devices.add(weights.device)
    if devices == {torch.device("cpu")}:
        return gather_sum_plain(src, slots, weights, out_dtype)
    if len(devices) != 1 or not src.is_cuda:
        raise ValueError(f"gather_sum kernel: src, slots, weights on "
                         f"{devices}; all must be on one CUDA device")
    if src.dtype not in _SUFFIX:
        raise TypeError(f"gather_sum kernel takes float32 or bfloat16 src, "
                        f"got {src.dtype}")
    (M, d), (T, k) = src.shape, slots.shape
    if not 1 <= k <= MAX_K:
        raise ValueError(f"gather_sum kernel: k = {k}, it takes 1 to "
                         f"{MAX_K}")
    src, slots = src.contiguous(), slots.contiguous()
    out = torch.empty(T, d, dtype=out_dtype, device=src.device)
    if T == 0:
        return out
    sfx = _SUFFIX[src.dtype]
    if weights is None and out_dtype == src.dtype:
        KERNEL.call(f"gather_sum_{sfx}", src.get_device(), src.data_ptr(),
                    slots.data_ptr(), out.data_ptr(), T, k, M, d)
    else:
        if weights is not None:
            weights = weights.contiguous()
        name = f"gather_sum_w_{sfx}" + ("_f32" if out_dtype != src.dtype
                                        else "")
        KERNEL.call(name, src.get_device(), src.data_ptr(), slots.data_ptr(),
                    None if weights is None else weights.data_ptr(),
                    out.data_ptr(), T, k, M, d)
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE["unweighted" if weights is None else "weighted"] += 1
    return out
