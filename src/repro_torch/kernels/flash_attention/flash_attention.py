"""Attention forward with an online softmax, as a CUDA kernel on Hopper.

Replaces ``repro/kernels/flash_attention/flash_attention.py:
flash_attention`` (the Pallas TPU kernel ``_fa_kernel``).
``csrc/flash_attention.cu`` holds the kernels and their note: bound by
operations, causal key tiles past the diagonal never loaded, in two
routes that ``route`` picks from the dtype, the head dim and the rows'
alignment:

  * ``tensor_cores``: bf16 at head dim 64, 112 or 128 with 16-byte
    aligned rows. One CTA per (batch, head, 64-row query tile), products
    by wgmma (float32 accumulators): Q K^T in bf16, P V in fp16, P
    carried between the two as one fp16 part (11 bits) and v converted
    to fp16 once a call into a scratch that the wrapper allocates (a |v|
    above 65504 becomes inf);
  * ``cuda_cores``: everything else (float32; bf16 at head dim 32 or
    with unaligned rows). One CTA per (batch, head, 64-row query tile),
    float32 on the CUDA cores.

It is built with nvcc at first use into
``build/flash_attention/<sha256>.so`` and launched through ctypes on the
current stream.

The public layout is the JAX kernel's, q (B, H, Sq, D), with two
widenings: k and v may have Hkv heads, Hkv dividing H (head h reads KV
head ``h // (H // Hkv)``), and Sq, Sk are any length. The kernel reads
q, k and v through their strides, so transposed views of a
(B, S, H, D) layout are taken as they are; only the last dimension must
be contiguous. The output is a new contiguous (B, H, Sq, D).

On CPU tensors ``flash_attention`` runs ``flash_attention_plain``, the
float32 math of the JAX package's ``ref.py``. A CUDA tensor goes to the
kernel or raises; there is no fallback. ``with_lse`` also returns each
query row's log-sum-exp of the scaled, masked scores, float32
(B, H, Sq), which the backward (``flash_attention_bwd.py``) reads; the
output is the same with or without it.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from .. import plain_dtype
from ..build import CSRC, SourceKernel

#: launches of the CUDA kernels; the plain version does not count
LAUNCHES = 0
#: the same launches by route (``route``)
LAUNCHES_BY_ROUTE = {"tensor_cores": 0, "cuda_cores": 0}
#: head dims the kernels are instantiated for
HEAD_DIMS = (32, 64, 112, 128)
#: head dims the tensor-core route takes (bf16)
TC_HEAD_DIMS = (64, 112, 128)
#: query rows a CTA takes (both routes)
BLOCK_Q = 64

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
#: q, k, v, o, lse; B, H, Hkv, Sq, Sk; strides; causal, scale, stream
_ARGS = [_P] * 5 + [_I] * 5 + [_L] * 9 + [_I, _F, _P]
#: the tensor-core entries also take v's fp16 scratch, after v
_TC_ARGS = [_P] * 6 + [_I] * 5 + [_L] * 9 + [_I, _F, _P]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL = SourceKernel(
    "flash_attention",
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    {**{f"flash_attention_{t}_d{d}": _ARGS
        for t in _SUFFIX.values() for d in HEAD_DIMS},
     **{f"flash_attention_bf16_tc_d{d}": _TC_ARGS for d in TC_HEAD_DIMS}},
    headers=[CSRC / "sm90.cuh"])


def route(dtype: torch.dtype, head_dim: int, rows_aligned: bool = True
          ) -> str:
    """The route a CUDA launch takes: ``tensor_cores`` for bf16 at a head
    dim of ``TC_HEAD_DIMS`` whose q, k, v rows start on 16 bytes (their
    pointers and strides; the copies move 16 bytes a thread), else
    ``cuda_cores``."""
    if (dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS
            and rows_aligned):
        return "tensor_cores"
    return "cuda_cores"


def entry(dtype: torch.dtype, head_dim: int, rows_aligned: bool = True
          ) -> str:
    """The exported C function a CUDA launch calls."""
    tc = route(dtype, head_dim, rows_aligned) == "tensor_cores"
    return (f"flash_attention_{_SUFFIX[dtype]}{'_tc' if tc else ''}"
            f"_d{head_dim}")


def _rows_aligned(*ts: torch.Tensor) -> bool:
    """Every row of each (B, H, S, D) tensor starts on 16 bytes."""
    return all(t.data_ptr() % 16 == 0
               and all(st * t.element_size() % 16 == 0
                       for st in t.stride()[:3]) for t in ts)


def _shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, H, Sq, D) and k, v "
                         f"(B, Hkv, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % Hkv:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}: Hkv must divide H")
    return B, H, Hkv, Sq, Sk, D


def scores_plain(q: torch.Tensor, k: torch.Tensor, causal: bool
                 ) -> torch.Tensor:
    """``q k^T / sqrt(D)`` with the causal mask at -1e30, in float32
    (float64 for float64 inputs), K repeated to q's heads."""
    B, H, Hkv, Sq, Sk, D = _shapes(q, k, k)
    t = plain_dtype(q.dtype)
    k = k.repeat_interleave(H // Hkv, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(t), k.to(t)) / math.sqrt(D)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = s.masked_fill(~mask, -1e30)
    return s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          with_lse: bool = False):
    """``softmax(q k^T / sqrt(D), causal mask -1e30) v`` in float32, cast
    to q's dtype; any device. With ``with_lse``: (out, the rows'
    log-sum-exp (B, H, Sq))."""
    B, H, Hkv, Sq, Sk, D = _shapes(q, k, v)
    s = scores_plain(q, k, causal)
    w = torch.softmax(s, dim=-1)
    v = v.repeat_interleave(H // Hkv, dim=1)
    out = torch.einsum("bhqk,bhkd->bhqd", w, v.to(s.dtype)).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if with_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, with_lse: bool = False):
    """q: (B, H, Sq, D), k/v: (B, Hkv, Sk, D) -> (B, H, Sq, D), and with
    ``with_lse`` the rows' log-sum-exp (B, H, Sq) float32 beside it. CPU
    tensors take the plain version, CUDA tensors the kernel."""
    global LAUNCHES
    B, H, Hkv, Sq, Sk, D = _shapes(q, k, v)
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return flash_attention_plain(q, k, v, causal=causal,
                                     with_lse=with_lse)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel: q, k, v on {devices}; "
                         "all must be on one CUDA device")
    if q.dtype not in _SUFFIX or {k.dtype, v.dtype} != {q.dtype}:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: the last dimension of "
                         "q, k and v must be contiguous")
    aligned = _rows_aligned(q, k, v)
    way = route(q.dtype, D, aligned)
    n_blocks = B * H * -(-Sq // BLOCK_Q)
    if Sk == 0 or n_blocks >= 2**31:
        raise ValueError(f"flash_attention kernel: Sk = {Sk}, "
                         f"{n_blocks} blocks")
    out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if Sq == 0:
        return (out, lse) if with_lse else out
    # the tensor cores take v as fp16, converted once a call
    vh = ([torch.empty(B, Hkv, Sk, D, dtype=torch.float16,
                       device=q.device).data_ptr()]
          if way == "tensor_cores" else [])
    KERNEL.call(entry(q.dtype, D, aligned), q.get_device(),
                q.data_ptr(), k.data_ptr(), v.data_ptr(), *vh,
                out.data_ptr(), None if lse is None else lse.data_ptr(),
                B, H, Hkv, Sq, Sk,
                *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                int(causal), 1.0 / math.sqrt(D))
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[way] += 1
    return (out, lse) if with_lse else out
