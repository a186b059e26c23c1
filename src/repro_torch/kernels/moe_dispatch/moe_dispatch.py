"""The grouped SwiGLU expert feed-forward, as a CUDA kernel on Hopper.

Replaces ``repro/kernels/moe_dispatch/moe_dispatch.py:grouped_expert_ff``
(the Pallas TPU kernel). ``csrc/moe_dispatch.cu`` holds the kernels and
their note, in three routes that ``route`` picks from the dtype, the
shapes and whether the caller passes counts:

  * ``tensor_cores``: bf16 at C > 1 (prefill) with d and f multiples of
    8. Two grouped GEMMs by wgmma (float32 accumulators): the gate and up
    products in bf16 with h = silu(g) * u written as one fp16 part (11
    bits) into an (E, C, f) scratch that the wrapper allocates, then h @
    wo in fp16 (each wo tile converted in shared memory). h and wo past
    fp16's range are kept in it by power-of-two exponents (h's a row
    and 64-column tile, in two more scratch tensors; wo's a column, in
    shared memory), which are 0 wherever the values are in range: the
    down product's common kernel leaves a block that meets one to a
    second kernel, flagged in a fourth scratch tensor. Where the caller
    passes ``gu`` (training, ``moe_dispatch_bwd.GroupedExpertFF``), the
    up kernel also stores the gate and up products of the filled rows
    there in bf16, for the backward;
  * ``decode``: bf16 at C = 1 with counts (decode's dispatch), d and f
    multiples of 8, d at most ``DECODE_MAX_D``. ``csrc/moe_decode.cu``
    (its note): bound by bytes; a persistent grid of ``DECODE_CTAS_PER_SM``
    CTAs an SM walks units of (live expert, slice of f), the live experts
    listed on the device from ``counts``, each unit's weights streamed
    through a cp.async ring; the slices' float32 partials summed in order
    by a second small kernel (``decode_slicing``);
  * ``cuda_cores``: everything else (float32; C = 1 without counts; bf16
    rows the 16-byte copies cannot take). One CTA per (expert, slice of the
    hidden columns, block of capacity rows), float32 on the CUDA cores,
    the hidden kept in shared memory a chunk of columns at a time, each
    slice's part of the output summed by a second small kernel.

Both routes take ``counts``, an optional int32 (E,) tensor on x's
device: the rows of each expert that hold a token. Rows at or past an
expert's count are taken as zero rows (their output is zero), and a
block of rows wholly past it reads no weights, so at decode an expert
that no token chose costs only its zeros. ``models/moe.py`` passes the
counts of its dispatch table, where every free slot is the zero row.

They are built with nvcc at first use into
``build/moe_dispatch/<sha256>.so`` and ``build/moe_decode/<sha256>.so``
and launched through ctypes on the current stream. ``LAUNCHES`` counts
wrapper calls: one call launches two kernels on the CUDA cores and at
decode, three on the tensor cores (the up product, the down product and
its scaled pass, which finds nothing to do wherever the values are in
range).

Unlike the Pallas kernel, any capacity C and any width f are taken (the
block size is the kernel's own business), and C = 0 gives an empty
output. On the CUDA cores the wrapper cuts f into slices so that the
grid has at least ``TARGET_CTAS`` CTAs where f allows: many slices at
decode (C = 1), one at prefill, where the row blocks already fill the
card. At C = 1 with counts, as few as one expert may hold a token, so f
is cut as finely as the slices allow: the CTAs that read weights fill
the card however few experts they belong to (an empty expert's CTAs
return at once, and the slices' sums are read for filled rows only).

On CPU tensors ``grouped_expert_ff`` runs ``grouped_expert_ff_plain``,
the same function in torch. A CUDA tensor goes to the kernel or raises;
there is no fallback. The wrapper records nothing for autograd: the
gradient goes through ``moe_dispatch_bwd.GroupedExpertFF``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from ... import tracing
from ..build import CSRC, SourceKernel, sm_count

#: wrapper calls that launched the CUDA kernels; the plain version does
#: not count
LAUNCHES = 0
#: the same calls by route (``route``), kept in the program's counters
LAUNCHES_BY_ROUTE = tracing.Routes("grouped_expert_ff",
                                   ("tensor_cores", "cuda_cores", "decode"))
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
    {**{f"moe_ff_{t}": [_P] * 6 + [_I] * 6 + [_P]
        for t in _SUFFIX.values()},
     "moe_ff_bf16_tc": [_P] * 10 + [_I] * 4 + [_P]},
    headers=[CSRC / "sm90.cuh",
             Path(__file__).resolve().parent / "csrc" / "moe_tc.cuh"])
DECODE_KERNEL = SourceKernel(
    "moe_decode", Path(__file__).resolve().parent / "csrc" / "moe_decode.cu",
    {"moe_ff_decode_bf16": [_P] * 6 + [_I] * 6 + [_P]},
    headers=[CSRC / "sm90.cuh"])
#: the decode route's widest d (its CTA holds 8 columns of every 2048 in
#: four passes) and most experts (their live list in shared memory)
DECODE_MAX_D, DECODE_MAX_E = 8192, 1024
#: the decode route's persistent CTAs an SM (82-106 KB of shared memory)
DECODE_CTAS_PER_SM = 2
#: hidden columns a chunk of a decode unit; a slice is whole chunks
DECODE_CHUNK = 64
#: the most float32 scratch the decode route's slices may take, bytes
DECODE_WS_BYTES = 128 << 20


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


def route(dtype: torch.dtype, C: int, d: int, f: int,
          n_counts: int = 0) -> str:
    """The route a CUDA launch takes, d and f multiples of 8 (rows of x,
    wi, wo and h a multiple of 16 bytes: the copies move 16 bytes a
    thread) for both bf16 routes: ``tensor_cores`` for bf16 at C > 1;
    ``decode`` for bf16 at C = 1 where the caller passes counts, one an
    expert (``n_counts``, their number E; 0 where it passes none), d <=
    ``DECODE_MAX_D`` and E <= ``DECODE_MAX_E``; else ``cuda_cores``."""
    if dtype == torch.bfloat16 and d % 8 == 0 and f % 8 == 0:
        if C > 1:
            return "tensor_cores"
        if C == 1 and 0 < n_counts <= DECODE_MAX_E and d <= DECODE_MAX_D:
            return "decode"
    return "cuda_cores"


def entry(dtype: torch.dtype, C: int, d: int, f: int,
          n_counts: int = 0) -> str:
    """The exported C function a CUDA launch calls."""
    way = route(dtype, C, d, f, n_counts)
    if way == "tensor_cores":
        return "moe_ff_bf16_tc"
    if way == "decode":
        return "moe_ff_decode_bf16"
    return f"moe_ff_{_SUFFIX[dtype]}"


def decode_slicing(E: int, d: int, f: int):
    """(n_slices, W) of the decode route: f cut into slices of W hidden
    columns, W a multiple of ``DECODE_CHUNK``, as many slices as the
    chunks allow within ``DECODE_WS_BYTES`` of float32 scratch (n_slices
    E d floats): 16 of 64 at olmoe, 192 of 128 at jamba, 11 of 192 at
    kimi-k2."""
    chunks = -(-f // DECODE_CHUNK)
    n = max(1, min(chunks, DECODE_WS_BYTES // (4 * E * d)))
    W = -(-chunks // n) * DECODE_CHUNK
    return -(-f // W), W


def _check_counts(counts, E: int, device) -> None:
    if counts is None:
        return
    if (counts.dtype != torch.int32 or tuple(counts.shape) != (E,)
            or counts.device != device or not counts.is_contiguous()):
        raise ValueError(f"grouped_expert_ff: counts must be a contiguous "
                         f"int32 ({E},) tensor on {device}, got "
                         f"{counts.dtype} {tuple(counts.shape)} on "
                         f"{counts.device}")


def live_rows(counts: Optional[torch.Tensor], C: int, device
              ) -> Optional[torch.Tensor]:
    """The rows below each expert's count, an (E, C, 1) bool tensor; None
    where ``counts`` is None (every row live)."""
    if counts is None:
        return None
    return (torch.arange(C, device=device)[None, :]
            < counts[:, None])[..., None]


def grouped_expert_ff_plain(x: torch.Tensor, wi: torch.Tensor,
                            wo: torch.Tensor,
                            counts: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """``(silu(x @ wi[..., :f]) * (x @ wi[..., f:])) @ wo`` per expert in
    float32, cast to x's dtype; rows of x at or past ``counts`` taken as
    zero rows. Any device."""
    E, C, d, f = _shapes(x, wi, wo)
    _check_counts(counts, E, x.device)
    xf = x.float()
    live = live_rows(counts, C, x.device)
    if live is not None:
        xf = xf * live
    h = torch.bmm(xf, wi.float())
    h = F.silu(h[..., :f]) * h[..., f:]
    return torch.bmm(h, wo.float()).to(x.dtype)


def up_product_plain(x: torch.Tensor, wi: torch.Tensor,
                     counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """gu = x @ wi per expert in float32 (the gate in columns [0, f), the
    up part in [f, 2f)), rows of x at or past ``counts`` taken as zero
    rows, cast to x's dtype. Any device."""
    E, C, d = x.shape
    _check_counts(counts, E, x.device)
    xf = x.float()
    live = live_rows(counts, C, x.device)
    if live is not None:
        xf = xf * live
    return torch.bmm(xf, wi.float()).to(x.dtype)


@tracing.kernel("grouped_expert_ff")
def grouped_expert_ff(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
                      counts: Optional[torch.Tensor] = None,
                      gu: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (E, C, d), wi: (E, d, 2f), wo: (E, f, d) -> (E, C, d), float32
    or bfloat16; ``counts`` as in the module's docstring. CPU tensors
    take the plain version, CUDA tensors the kernel. ``gu``, an (E, C,
    2f) tensor of x's dtype, receives the up product x @ wi of the filled
    rows (the backward's saved pre-activation; rows past the count are
    left as they were on the card, zero on the CPU): only the CPU and the
    tensor-core route take it."""
    global LAUNCHES
    E, C, d, f = _shapes(x, wi, wo)
    if gu is not None and (gu.shape != (E, C, 2 * f) or gu.dtype != x.dtype
                           or gu.device != x.device
                           or not gu.is_contiguous()):
        raise ValueError(f"grouped_expert_ff: gu must be a contiguous "
                         f"{x.dtype} {(E, C, 2 * f)} tensor on {x.device}, "
                         f"got {gu.dtype} {tuple(gu.shape)} on {gu.device}")
    if x.dtype not in _SUFFIX or {wi.dtype, wo.dtype} != {x.dtype}:
        raise TypeError(f"grouped_expert_ff takes float32 or bfloat16 x, "
                        f"wi, wo of one dtype, got {x.dtype}, {wi.dtype}, "
                        f"{wo.dtype}")
    devices = {x.device, wi.device, wo.device}
    if devices == {torch.device("cpu")}:
        if gu is not None:
            gu.copy_(up_product_plain(x, wi, counts))
        return grouped_expert_ff_plain(x, wi, wo, counts)
    if len(devices) != 1 or x.device.type != "cuda":
        raise ValueError(f"grouped_expert_ff kernel: x, wi, wo on "
                         f"{devices}; all must be on one CUDA device")
    _check_counts(counts, E, x.device)
    if not all(t.is_contiguous() for t in (x, wi, wo)):
        raise ValueError("grouped_expert_ff kernel: x, wi and wo must be "
                         "contiguous")
    if min(d, f) < 1 or not all(t.data_ptr() % 16 == 0
                                for t in (x, wi, wo)):
        raise ValueError(f"grouped_expert_ff kernel: d = {d} and f = {f} "
                         f"must be >= 1, x, wi, wo 16-byte aligned")
    way = route(x.dtype, C, d, f, 0 if counts is None else E)
    if gu is not None and way != "tensor_cores":
        raise ValueError(f"grouped_expert_ff kernel: the {way} route keeps "
                         f"no gu; only the tensor-core route writes it")
    n_slices, fs = slicing(1 if counts is not None and C == 1 else E, C,
                           f)
    n_blocks = (E * -(-C // TC_BLOCK) * -(-max(d, f) // TC_BLOCK)
                if way == "tensor_cores"
                else E * -(-C // BLOCK_ROWS) * n_slices)
    if n_blocks >= 2**31:
        raise ValueError(f"grouped_expert_ff kernel: {n_blocks} blocks")
    out = torch.empty_like(x)
    if C == 0 or E == 0:
        return out
    if way == "decode":
        n_sl, W = decode_slicing(E, d, f)
        ws = torch.empty(n_sl, E, d, dtype=torch.float32, device=x.device)
        DECODE_KERNEL.call(
            "moe_ff_decode_bf16", x.get_device(), x.data_ptr(),
            wi.data_ptr(), wo.data_ptr(), counts.data_ptr(), ws.data_ptr(),
            out.data_ptr(), E, d, f, W, n_sl,
            min(E * n_sl, DECODE_CTAS_PER_SM * sm_count(x.get_device())))
        LAUNCHES += 1
        LAUNCHES_BY_ROUTE[way] += 1
        return out
    # the hidden as fp16 with its exponents (tensor cores) or the slices'
    # float32 sums (CUDA cores)
    scratch = (tc_scratch(E, C, d, f, x.device) if way == "tensor_cores" else
               [torch.empty(n_slices, E, C, d, dtype=torch.float32,
                            device=x.device)])
    args = (x.data_ptr(), wi.data_ptr(), wo.data_ptr(),
            None if counts is None else counts.data_ptr(),
            *(t.data_ptr() for t in scratch))
    if way == "tensor_cores":
        args += (None if gu is None else gu.data_ptr(),)
    args += (out.data_ptr(), E, C, d, f)
    if way == "cuda_cores":
        args += (fs, n_slices)
    KERNEL.call(entry(x.dtype, C, d, f), x.get_device(), *args)
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[way] += 1
    return out


def tc_scratch(E: int, C: int, d: int, f: int, device):
    """The tensor-core entry's scratch: for the hidden, h (E, C, f) fp16,
    the exponent of each row's 64-column tiles (E, C, ceil(f / 64))
    uint8 and each row's largest (E, C) int32, which the launcher zeroes;
    and a flag a CTA of the down product (128 rows, 256 columns), int32,
    that its common launch sets where it leaves the CTA to the scaled
    one."""
    return (torch.empty(E, C, f, dtype=torch.float16, device=device),
            torch.empty(E, C, -(-f // 64), dtype=torch.uint8,
                        device=device),
            torch.empty(E, C, dtype=torch.int32, device=device),
            torch.empty(E * -(-C // TC_BLOCK) * -(-d // (2 * TC_BLOCK)),
                        dtype=torch.int32, device=device))


def slicing(E: int, C: int, f: int):
    """(n_slices, slice width) of f >= 1 hidden columns: enough slices
    that E * ceil(C / 16) * n_slices reaches ``TARGET_CTAS`` where f
    allows, each slice a multiple of ``SLICE_COLS`` wide but the last.
    The wrapper passes E = 1 at C = 1 with counts (the finest slicing)."""
    blocks = max(1, E * -(-C // BLOCK_ROWS))
    n = max(1, min(-(-TARGET_CTAS // blocks), -(-f // SLICE_COLS)))
    fs = -(-f // n)
    fs = -(-fs // SLICE_COLS) * SLICE_COLS
    return -(-f // fs), fs
