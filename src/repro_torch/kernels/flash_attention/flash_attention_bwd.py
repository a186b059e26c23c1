"""The gradient of attention, as CUDA kernels on Hopper, and the autograd
Function that pairs them with the forward kernel.

The reference has no kernel here: it trains through plain ``jnp`` under
``jax.grad``, and its Pallas ``flash_attention`` has no ``custom_vjp``.
The port's layers send CUDA tensors to the hand-written forward, a
ctypes call that autograd cannot see through, so training on the card
needs ``FlashAttention``: its forward is the forward kernel, which also
stores each query row's log-sum-exp, and its backward is
``csrc/flash_attention_bwd.cu`` (that file's note has the design): a
pre-pass for ``delta = rowsum(do * o)``, one kernel a (batch, KV head,
64-key tile) for dk and dv, one a (batch, head, 64-query tile) for dq,
each summing in one fixed order with no float atomics, so two calls give
the same bits. Two routes, which ``route`` picks up front from the dtype,
the head dim and the rows' alignment, as the forward's:

  * ``tensor_cores``: bf16 at head dim 64, 112 or 128 with q, k, v and do
    rows on 16 bytes. One warpgroup a CTA, all seven products by wgmma
    (bf16 in, float32 accumulators), P and dS carried between products
    in registers as bf16 pairs;
  * ``cuda_cores``: everything else (float32; bf16 at head dim 32 or with
    unaligned rows), float32 on the CUDA cores.

Head dims 32, 64, 112 and 128; K and V may have fewer heads than q (Hkv
dividing H); every input is read through its strides.

It is built with nvcc at first use into
``build/flash_attention_bwd/<sha256>.so`` and launched through ctypes on
the current stream. On CPU tensors the Function runs the plain forward
and ``flash_attention_bwd_plain``, the closed form from lse in float32;
a CUDA tensor goes to the kernels or raises.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Tuple

import torch

from ... import tracing
from ..build import CSRC, SourceKernel
from . import flash_attention as FA

#: launches of the CUDA backward (one a call, three kernels); the plain
#: version does not count
LAUNCHES = 0
#: the same launches by route (``route``), kept in the program's counters
LAUNCHES_BY_ROUTE = tracing.Routes("flash_attention_bwd",
                                   ("tensor_cores", "cuda_cores"))
HEAD_DIMS = FA.HEAD_DIMS

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.c_longlong * 15
#: q, k, v, o, do, lse, delta, dq, dk, dv; B, H, Hkv, Sq, Sk; strides;
#: causal, scale, stream
_ARGS = [_P] * 10 + [_I] * 5 + [ctypes.POINTER(ctypes.c_longlong), _I, _F,
                                  _P]
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL = SourceKernel(
    "flash_attention_bwd",
    Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu",
    {**{f"flash_attention_bwd_{t}_d{d}": _ARGS
        for t in _SUFFIX.values() for d in HEAD_DIMS},
     **{f"flash_attention_bwd_bf16_tc_d{d}": _ARGS
        for d in FA.TC_HEAD_DIMS}},
    headers=[CSRC / "sm90.cuh"])


def route(dtype: torch.dtype, head_dim: int, rows_aligned: bool = True
          ) -> str:
    """The route a CUDA launch takes, by the forward's rule
    (``flash_attention.route``): ``tensor_cores`` for bf16 at a head dim
    of ``TC_HEAD_DIMS`` whose q, k, v and do rows start on 16 bytes, else
    ``cuda_cores``."""
    return FA.route(dtype, head_dim, rows_aligned)


def entry(dtype: torch.dtype, head_dim: int, rows_aligned: bool = True
          ) -> str:
    """The exported C function a CUDA launch calls."""
    tc = route(dtype, head_dim, rows_aligned) == "tensor_cores"
    return (f"flash_attention_bwd_{_SUFFIX[dtype]}{'_tc' if tc else ''}"
            f"_d{head_dim}")


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              do: torch.Tensor, lse: torch.Tensor, *,
                              causal: bool = True
                              ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) of ``flash_attention_plain`` from the output o, its
    gradient do and the rows' log-sum-exp lse: P = exp(s - lse),
    dv = P^T do, dS = P (do v^T - rowsum(do o)), dq = dS k / sqrt(D),
    dk = dS^T q / sqrt(D), in float32 (float64 for float64 inputs); dk
    and dv summed over each KV head's query heads; cast to the inputs'
    dtypes. Any device."""
    B, H, Hkv, Sq, Sk, D = FA._shapes(q, k, v)
    G = H // Hkv
    s = FA.scores_plain(q, k, causal)
    t = s.dtype
    p = torch.exp(s - lse.to(t)[..., None])
    dof = do.to(t)
    vr = v.repeat_interleave(G, dim=1).to(t)
    kr = k.repeat_interleave(G, dim=1).to(t)
    delta = (dof * o.to(t)).sum(dim=-1, keepdim=True)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vr) - delta)
    scale = 1.0 / math.sqrt(D)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kr) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(t)) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.view(B, Hkv, G, Sk, D).sum(dim=2)
    dv = dv.view(B, Hkv, G, Sk, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, o, do, lse):
    B, H, Hkv, Sq, Sk, D = FA._shapes(q, k, v)
    if o.shape != q.shape or do.shape != q.shape \
            or lse.shape != q.shape[:3]:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    return B, H, Hkv, Sq, Sk, D


@tracing.kernel("flash_attention_bwd")
def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True
                        ) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) as ``flash_attention_bwd_plain``; dq (B, H, Sq, D),
    dk and dv (B, Hkv, Sk, D), contiguous. CPU tensors take the plain
    version, CUDA tensors the kernels of ``route``."""
    global LAUNCHES
    B, H, Hkv, Sq, Sk, D = _check(q, k, v, o, do, lse)
    tensors = (q, k, v, o, do, lse)
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal)
    if len(devices) != 1 or not q.is_cuda:
        raise ValueError(f"flash_attention_bwd kernel: inputs on "
                         f"{devices}; all must be on one CUDA device")
    if q.dtype not in _SUFFIX or {k.dtype, v.dtype, o.dtype, do.dtype} \
            != {q.dtype} or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd kernel takes float32 or "
                        f"bfloat16 q, k, v, o, do of one dtype and float32 "
                        f"lse, got {[t.dtype for t in tensors]}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd kernel: head dim {D} not in "
                         f"{HEAD_DIMS}")
    q, k, v, o, do = (t if t.stride(-1) == 1 else t.contiguous()
                      for t in (q, k, v, o, do))
    lse = lse.contiguous()
    aligned = FA._rows_aligned(q, k, v, do)
    way = route(q.dtype, D, aligned)
    blocks = max(B * H * -(-Sq // 64), B * Hkv * -(-Sk // 64))
    if Sk == 0 or blocks >= 2**31:
        raise ValueError(f"flash_attention_bwd kernel: Sk = {Sk}, "
                         f"{blocks} blocks")
    dq = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Hkv, Sk, D), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    strides = _STRIDES(*(st for t in (q, k, v, o, do)
                         for st in t.stride()[:3]))
    KERNEL.call(entry(q.dtype, D, aligned), q.get_device(), q.data_ptr(),
                k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), B, H, Hkv, Sq, Sk, strides,
                int(causal), 1.0 / math.sqrt(D))
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[way] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_attention(q, k, v)`` with its gradient: the forward kernel
    saves q, k, v, the output and the rows' log-sum-exp; the backward
    kernels give dq, dk, dv. CPU tensors take both plain versions."""

    @staticmethod
    def forward(ctx, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool):
        out, lse = FA.flash_attention(q, k, v, causal=causal, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do: torch.Tensor):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse,
                                         causal=ctx.causal)
        return dq, dk, dv, None
