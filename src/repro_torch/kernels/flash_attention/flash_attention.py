"""Attention forward with an online softmax, as a CUDA kernel on Hopper.

Replaces ``repro/kernels/flash_attention/flash_attention.py:
flash_attention`` (the Pallas TPU kernel ``_fa_kernel``).
``csrc/flash_attention.cu`` holds the kernels and their note: bound by
operations, causal key tiles past the diagonal never loaded, in three
routes that ``route`` picks from the dtype, the head dim, the rows'
alignment and, where the caller gives it, the query rows:

  * ``tensor_cores``: bf16 at head dim 64, 112 or 128 with 16-byte
    aligned rows. One CTA per (batch, head, 64-row query tile), products
    by wgmma (float32 accumulators): Q K^T in bf16, P V in fp16, P
    carried between the two as one fp16 part (11 bits) and v converted
    to fp16 once a call into a scratch that the wrapper allocates, each
    64-key tile at a power-of-two exponent that keeps it in fp16's
    range (0, the tile as it is, wherever it is in range; the exponents
    and a flag a (batch, KV head) in two more scratch tensors);
  * ``decode``: one query row (Sq = 1, a decoder's cross-attention at
    decode), float32 or bf16 at every head dim of ``HEAD_DIMS`` with
    16-byte aligned rows. ``csrc/flash_attention_decode.cu`` (its note):
    bound by bytes; one CTA per (batch, KV head, up to 8 query rows of
    its group, split of the keys, ``decode_splits``), K and V through a
    cp.async ring, float32 on the CUDA cores, the splits' partials merged
    in split order by the last of them to finish, one launch a call
    (``decode_scratch`` keeps their float32 scratch and counters);
  * ``cuda_cores``: everything else (float32; bf16 at head dim 32 or
    with unaligned rows). One CTA per (batch, head, 64-row query tile),
    float32 on the CUDA cores.

They are built with nvcc at first use into
``build/flash_attention/<sha256>.so`` and
``build/flash_attention_decode/<sha256>.so`` and launched through ctypes
on the current stream.

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
import functools
import math
from pathlib import Path

import torch

from .. import plain_dtype
from ..build import CSRC, SourceKernel, sm_count

#: launches of the CUDA kernels; the plain version does not count
LAUNCHES = 0
#: the same launches by route (``route``)
LAUNCHES_BY_ROUTE = {"tensor_cores": 0, "cuda_cores": 0, "decode": 0}
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
#: the tensor-core entries also take v's fp16 scratch, its tiles'
#: exponents and a flag a (batch, KV head), after v
_TC_ARGS = [_P] * 8 + [_I] * 5 + [_L] * 9 + [_I, _F, _P]
#: keys a tile of the tensor-core route: one exponent of v each
TC_BLOCK_K = 64
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL = SourceKernel(
    "flash_attention",
    Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    {**{f"flash_attention_{t}_d{d}": _ARGS
        for t in _SUFFIX.values() for d in HEAD_DIMS},
     **{f"flash_attention_bf16_tc_d{d}": _TC_ARGS for d in TC_HEAD_DIMS}},
    headers=[CSRC / "sm90.cuh"])
#: q, k, v, o, lse, ws, done; B, H, Hkv, Sk; strides of q (batch, head),
#: k and v (batch, head, row); causal, scale, n_split, split_len, stream
_DEC_ARGS = [_P] * 7 + [_I] * 4 + [_L] * 8 + [_I, _F, _I, _I, _P]
DECODE_KERNEL = SourceKernel(
    "flash_attention_decode",
    Path(__file__).resolve().parent / "csrc" / "flash_attention_decode.cu",
    {**{f"flash_attention_decode_{t}_d{d}": _DEC_ARGS
        for t in _SUFFIX.values() for d in HEAD_DIMS},
     "flash_attention_decode_ctas": [_I] * 3},
    headers=[CSRC / "sm90.cuh"])
#: the decode route's splits keep at least this many keys each
DECODE_MIN_KEYS = 128
#: query rows a CTA of the decode route takes at most (of a GQA group)
DECODE_ROWS = 8


def route(dtype: torch.dtype, head_dim: int, rows_aligned: bool = True,
          Sq: int = 0) -> str:
    """The route a CUDA launch takes: ``decode`` for one query row (``Sq``
    1) whose q, k, v rows start on 16 bytes (their pointers and strides;
    the copies move 16 bytes a thread); else ``tensor_cores`` for bf16 at
    a head dim of ``TC_HEAD_DIMS`` with such rows; else ``cuda_cores``.
    ``Sq`` 0 (not given) is any number of rows but one."""
    if Sq == 1 and rows_aligned:
        return "decode"
    if (dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS
            and rows_aligned):
        return "tensor_cores"
    return "cuda_cores"


def entry(dtype: torch.dtype, head_dim: int, rows_aligned: bool = True,
          Sq: int = 0) -> str:
    """The exported C function a CUDA launch calls."""
    way = route(dtype, head_dim, rows_aligned, Sq)
    if way == "decode":
        return f"flash_attention_decode_{_SUFFIX[dtype]}_d{head_dim}"
    tc = way == "tensor_cores"
    return (f"flash_attention_{_SUFFIX[dtype]}{'_tc' if tc else ''}"
            f"_d{head_dim}")


@functools.lru_cache(maxsize=256)
def decode_splits(B: int, Hkv: int, G: int, keys: int, slots: int):
    """(n_split, split_len) of the decode route's ``keys`` keys: as many
    splits as keep the grid, B * Hkv * ceil(G / 8) CTAs a split, within
    ``slots`` (the CTAs the card holds at once: one wave), each split at
    least ``DECODE_MIN_KEYS`` keys where there are that many; split_len a
    multiple of 64, and no split empty."""
    ctas = B * Hkv * -(-G // DECODE_ROWS)
    n = max(1, min(slots // ctas, keys // DECODE_MIN_KEYS))
    length = -(-(-(-keys // n)) // 64) * 64
    return -(-keys // length), length


_SLOTS: dict = {}


def decode_slots(device: int, dtype: torch.dtype, D: int, G: int) -> int:
    """The decode kernel's CTAs that CUDA device ``device`` holds at once
    for this dtype, head dim and GQA group (its SMs times the CTAs an SM
    holds, ``flash_attention_decode_ctas``), asked once."""
    key = (device, dtype, D, min(G, DECODE_ROWS))
    if key not in _SLOTS:
        with torch.cuda.device(device):
            n = DECODE_KERNEL.lib().flash_attention_decode_ctas(
                int(dtype == torch.bfloat16), D, G)
        if n < 1:
            raise RuntimeError(f"flash_attention decode: no occupancy for "
                               f"{dtype} D {D} G {G} ({n})")
        _SLOTS[key] = n * sm_count(device)
    return _SLOTS[key]


def _rows_aligned(*ts: torch.Tensor) -> bool:
    """Every row of each (B, H, S, D) tensor starts on 16 bytes."""
    return _aligned(ts, [t.stride() for t in ts])


def _aligned(ts, strides) -> bool:
    """``_rows_aligned`` from the tensors' strides, already read."""
    for t, (b, h, s, _) in zip(ts, strides):
        a = 16 // t.element_size()
        if t.data_ptr() % 16 or b % a or h % a or s % a:
            return False
    return True


def _shapes(q, k, v):
    qs, ks = q.shape, k.shape
    if len(qs) != 4 or len(ks) != 4 or ks != v.shape:
        raise ValueError(f"flash_attention takes q (B, H, Sq, D) and k, v "
                         f"(B, Hkv, Sk, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = qs
    Bk, Hkv, Sk, Dk = ks
    if Bk != B or Dk != D or H % Hkv:
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


def v_scratch(B: int, Hkv: int, Sk: int, D: int, device):
    """The tensor-core entries' scratch for v: its fp16 copy (B, Hkv, Sk,
    D), one uint8 exponent a tile of ``TC_BLOCK_K`` keys, and each
    (batch, KV head)'s largest, int32, which the launcher zeroes."""
    return (torch.empty(B, Hkv, Sk, D, dtype=torch.float16, device=device),
            torch.empty(B, Hkv, -(-Sk // TC_BLOCK_K), dtype=torch.uint8,
                        device=device),
            torch.empty(B, Hkv, dtype=torch.int32, device=device))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, with_lse: bool = False):
    """q: (B, H, Sq, D), k/v: (B, Hkv, Sk, D) -> (B, H, Sq, D), and with
    ``with_lse`` the rows' log-sum-exp (B, H, Sq) float32 beside it. CPU
    tensors take the plain version, CUDA tensors the kernel."""
    global LAUNCHES
    B, H, Hkv, Sq, Sk, D = _shapes(q, k, v)
    dev = q.device
    if (dev.type == "cpu" and k.device.type == "cpu"
            and v.device.type == "cpu"):
        return flash_attention_plain(q, k, v, causal=causal,
                                     with_lse=with_lse)
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"flash_attention kernel: q, k, v on "
                         f"{ {q.device, k.device, v.device} }; all must be "
                         "on one CUDA device")
    if q.dtype not in _SUFFIX or {k.dtype, v.dtype} != {q.dtype}:
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16 "
                        f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {D} not in "
                         f"{HEAD_DIMS}")
    st = (q.stride(), k.stride(), v.stride())
    if st[0][3] != 1 or st[1][3] != 1 or st[2][3] != 1:
        raise ValueError("flash_attention kernel: the last dimension of "
                         "q, k and v must be contiguous")
    aligned = _aligned((q, k, v), st)
    way = route(q.dtype, D, aligned, Sq)
    n_blocks = B * H * -(-Sq // BLOCK_Q)
    if Sk == 0 or n_blocks >= 2**31:
        raise ValueError(f"flash_attention kernel: Sk = {Sk}, "
                         f"{n_blocks} blocks")
    out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    if Sq == 0:
        return (out, lse) if with_lse else out
    if way == "decode":
        _decode(q, k, v, out, lse, causal, B, H, Hkv, Sk, D, st)
        LAUNCHES += 1
        LAUNCHES_BY_ROUTE[way] += 1
        return (out, lse) if with_lse else out
    # the tensor cores take v as fp16, converted once a call, and its
    # tiles' exponents
    vh = ([t.data_ptr() for t in v_scratch(B, Hkv, Sk, D, q.device)]
          if way == "tensor_cores" else [])
    KERNEL.call(entry(q.dtype, D, aligned), q.get_device(),
                q.data_ptr(), k.data_ptr(), v.data_ptr(), *vh,
                out.data_ptr(), None if lse is None else lse.data_ptr(),
                B, H, Hkv, Sq, Sk, *st[0][:3], *st[1][:3], *st[2][:3],
                int(causal), 1.0 / math.sqrt(D))
    LAUNCHES += 1
    LAUNCHES_BY_ROUTE[way] += 1
    return (out, lse) if with_lse else out


#: the decode route's scratch a (device, stream): the groups' split
#: counters (int32, zeroed once; the kernel leaves each at 0) and the
#: splits' float32 partials, each grown to the largest call so far. Kept
#: a stream, as a launch reads them only after the last one on its stream
#: is done with them.
_DECODE_SCRATCH: dict = {}


def decode_scratch(device: int, n_done: int, n_ws: int):
    """(done, ws) of at least n_done counters and n_ws floats on the
    current stream of CUDA device ``device``."""
    key = (device, torch._C._cuda_getCurrentRawStream(device))
    have = _DECODE_SCRATCH.get(key)
    if have is None or have[0].numel() < n_done or have[1].numel() < n_ws:
        n_done = max(n_done, 0 if have is None else have[0].numel())
        n_ws = max(n_ws, 0 if have is None else have[1].numel())
        have = _DECODE_SCRATCH[key] = (
            torch.zeros(n_done, dtype=torch.int32, device=device),
            torch.empty(n_ws, dtype=torch.float32, device=device))
    return have


def _decode(q, k, v, out, lse, causal: bool, B: int, H: int, Hkv: int,
            Sk: int, D: int, st) -> None:
    """The decode route's launch: the splits and, for more than one, their
    scratch (``decode_scratch``), the entry; ``st`` q's, k's and v's
    strides."""
    G = H // Hkv
    dev = q.get_device()
    n_split, length = decode_splits(B, Hkv, G, min(Sk, 1) if causal else Sk,
                                    decode_slots(dev, q.dtype, D, G))
    done = ws = None
    if n_split > 1:
        done, ws = decode_scratch(dev, B * Hkv * -(-G // DECODE_ROWS),
                                  B * H * n_split * (D + 2))
        done, ws = done.data_ptr(), ws.data_ptr()
    DECODE_KERNEL.call(
        entry(q.dtype, D, True, 1), dev, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), ws, done, B, H, Hkv, Sk,
        *st[0][:2], *st[1][:3], *st[2][:3], int(causal),
        1.0 / math.sqrt(D), n_split, length)
