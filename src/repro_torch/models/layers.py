"""Shared neural layers: norms, rotary embeddings (RoPE + M-RoPE), MLPs,
GQA attention (naive / chunked-flash / decode-with-cache).

Port of ``repro.models.layers``, with the same signatures, layouts
(activations (B, S, H, D)) and rounding points: compute in the inputs'
dtype (bf16 in the LM), float32 where the reference casts to it. Two
functions go through the port's hand-written kernels on CUDA tensors and
through their plain versions on CPU tensors:

  * ``rmsnorm`` -> ``kernels.rmsnorm`` (the reference's math in one pass);
  * ``attention_chunked`` -> ``kernels.flash_attention``, which takes
    K/V with fewer heads than q, so ``gqa_attention`` does not repeat
    them for it.

Where a gradient is needed (grad mode on and an input that requires
it), both go through the kernels' autograd Functions, ``RMSNorm`` and
``FlashAttention``, whose backward is a hand-written kernel too; without
one they call the forward kernels directly, as serving does.

``gqa_attention`` always goes through ``attention_chunked``: the
reference's ``impl`` switch and its XLA lowering knobs (``chunk``,
``skip_masked_blocks``, ``unroll_kv``) change no result here and are not
taken, so nothing routes the LM off the kernel. ``attention_naive`` stays
as the small-S reference function.

Params are dict trees matching the blueprints below.

``mlp``, ``gqa_attention`` and ``attention_decode`` take an optional
sharding context (``distributed/context.py``). With none, the code path
is the one above. With one, each works on the rank's local slice, as the
leaf's spec says (its fsdp dims already gathered): local heads and kv
heads, local ff columns (a gated ``wi``'s gate and up columns matching);
a row-parallel product (attention's ``wo``, the FF's ``wo``) is
all-reduced over exactly the mesh axes its contraction dim is sharded
on, and a dim the rules replicate takes no collective. Under the
sequence-parallel residual (``ShardCtx.sp``) their input is the whole
sequence, gathered by the caller, and their output is
``ShardCtx.row_out``'s: reduce-scattered over S, or sliced where nothing
is partial.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import needs_grad
from ..kernels.flash_attention.flash_attention import flash_attention
from ..kernels.flash_attention.flash_attention_bwd import FlashAttention
from ..kernels.rmsnorm.rmsnorm import rmsnorm as rmsnorm_rows
from ..kernels.rmsnorm.rmsnorm_bwd import RMSNorm
from .blueprint import leaf

Params = Dict[str, Any]
_MASKED = -1e30


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rmsnorm_bp(d: int):
    return {"scale": leaf((d,), ("embed",), init="ones")}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    d = x.shape[-1]
    rows = x.reshape(-1, d).contiguous()
    if needs_grad(rows, p["scale"]):
        return RMSNorm.apply(rows, p["scale"], eps).view(x.shape)
    return rmsnorm_rows(rows, p["scale"], eps=eps).view(x.shape)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S). Rotates
    the two halves of D (not interleaved pairs)."""
    inv = rope_freqs(x.shape[-1], theta, x.device)           # (D/2,)
    ang = positions[..., None].float() * inv                 # (..., S, D/2)
    return _rotate(x, ang[..., None, :])                     # (..., S, 1, D/2)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Tuple[int, int, int] = (1, 1, 2),
                theta: float = 10000.0) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the head-dim frequency bands are partitioned among
    (temporal, height, width) position streams.

    x: (B, S, H, D); positions3: (3, B, S).
    ``sections`` are relative band sizes (t:h:w over D/2)."""
    half = x.shape[-1] // 2
    tot = sum(sections)
    bt = half * sections[0] // tot
    bh = half * sections[1] // tot
    inv = rope_freqs(x.shape[-1], theta, x.device)          # (half,)
    band = torch.arange(half, device=x.device)
    stream = torch.where(band < bt, 0, torch.where(band < bt + bh, 1, 2))
    pos_sel = positions3.float()[stream]                    # (half, B, S)
    ang = torch.movedim(pos_sel, 0, -1) * inv               # (B, S, half)
    return _rotate(x, ang[..., None, :])                    # (B, S, 1, half)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def mlp_bp(d: int, ff: int, gated: bool = True):
    if gated:   # wi is [gate | up]: two blocks along ff
        return {"wi": leaf((d, 2 * ff), ("embed", "ff"), scale_dim=0,
                           blocks=2),
                "wo": leaf((ff, d), ("ff", "embed"), scale_dim=0)}
    return {"wi": leaf((d, ff), ("embed", "ff"), scale_dim=0),
            "wo": leaf((ff, d), ("ff", "embed"), scale_dim=0)}


def mlp(p: Params, x: torch.Tensor, gated: bool = True, ctx=None
        ) -> torch.Tensor:
    h = x @ p["wi"]
    if gated:
        g, u = h.chunk(2, dim=-1)
        h = F.silu(g.float()).to(x.dtype) * u
    else:   # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    out = h @ p["wo"]
    return out if ctx is None else ctx.row_out(out, ctx.logical("ff"))


# --------------------------------------------------------------------------
# GQA attention
# --------------------------------------------------------------------------

def attn_bp(d: int, n_heads: int, n_kv: int, head_dim: int):
    return {
        "wq": leaf((d, n_heads, head_dim), ("embed", "heads", "head_dim"),
                   scale_dim=0),
        "wk": leaf((d, n_kv, head_dim), ("embed", "kv_heads", "head_dim"),
                   scale_dim=0),
        "wv": leaf((d, n_kv, head_dim), ("embed", "kv_heads", "head_dim"),
                   scale_dim=0),
        "wo": leaf((n_heads, head_dim, d), ("heads", "head_dim", "embed"),
                   scale_dim=2),
    }


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv*groups, D); head h reads KV head
    h // groups."""
    return k if groups == 1 else k.repeat_interleave(groups, dim=2)


def attention_naive(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,D) k/v: (B,Sk,H,D). Reference implementation (small S)."""
    D = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(D)
    if causal:
        Sq, Sk = q.shape[1], k.shape[1]
        qpos = torch.arange(Sq, device=q.device) + q_offset
        mask = qpos[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        scores = scores.masked_fill(~mask, _MASKED)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True) -> torch.Tensor:
    """Flash-style online-softmax attention. q: (B,Sq,H,D), k/v:
    (B,Sk,Hkv,D) with Hkv dividing H.

    The flash_attention kernel on CUDA tensors, its plain version on CPU
    tensors, through transposed (B, H, S, D) views that the kernel reads
    by their strides. The kernel tiles by itself and, when causal, never
    loads a key tile above the diagonal. Non-causal attention (the
    reference's ``attention_naive``) takes the same kernel; under autograd
    the ``FlashAttention`` Function, whose backward is a kernel too."""
    qkv = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    if needs_grad(*qkv):
        return FlashAttention.apply(*qkv, causal).transpose(1, 2)
    return flash_attention(*qkv, causal=causal).transpose(1, 2)


def attention_decode(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor,
                     ctx=None, seq_lo: int = 0) -> torch.Tensor:
    """One-token decode: q (B,1,H,D), caches (B,Smax,Hkv,D).

    With a context whose ``seq`` axes split the cache's sequence, the
    caches are this rank's positions [seq_lo, seq_lo + Smax): each rank
    takes its partial softmax, and the ranks' parts are combined by an
    all-reduced max, sum and weighted V, in float32."""
    B, Smax, Hkv, D = k_cache.shape
    groups = q.shape[2] // Hkv
    k = _repeat_kv(k_cache, groups)
    v = _repeat_kv(v_cache, groups)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(D)
    valid = (torch.arange(Smax, device=q.device)[None, :] + seq_lo
             < cache_len[:, None])                           # (B, Smax)
    s = s.masked_fill(~valid[:, None, None, :], _MASKED)
    if ctx is not None and ctx.size(ctx.seq) > 1:
        mx = ctx.rmax(s.amax(dim=-1, keepdim=True), ctx.seq)
        e = torch.exp(s - mx)
        den = ctx.reduce(e.sum(dim=-1, keepdim=True), ctx.seq)
        num = ctx.reduce(torch.einsum("bhqk,bkhd->bhqd", e, v.float()),
                         ctx.seq)
        return (num / den).transpose(1, 2).to(q.dtype)
    # the weights are cast to q's dtype before the product with v
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


def local_kv(k: torch.Tensor, n_heads: int, n_kv: int, ctx
             ) -> torch.Tensor:
    """k or v (B, S, n_kv, D) with every kv head (the rules replicate
    them) -> the kv heads this rank's query heads read, (B, S, Hkv', D)
    with Hkv' dividing its local query heads: the few kv heads of its
    heads where they fall evenly, else one a query head."""
    lo, hi = ctx.part("heads", n_heads)
    if (lo, hi) == (0, n_heads):
        return k
    g = n_heads // n_kv
    idx = [h // g for h in range(lo, hi)]
    uniq = sorted(set(idx))
    if (hi - lo) % len(uniq) == 0 and all(
            idx[j] == uniq[j // ((hi - lo) // len(uniq))]
            for j in range(hi - lo)):
        return k[:, :, uniq[0]:uniq[-1] + 1]
    return k[:, :, idx]


def gqa_attention(p: Params, x: torch.Tensor, positions: torch.Tensor,
                  *, n_heads: int, n_kv: int, causal: bool = True,
                  rope_theta: float = 10000.0, use_rope: bool = True,
                  mrope_positions: Optional[torch.Tensor] = None,
                  kv_in: Optional[torch.Tensor] = None, ctx=None
                  ) -> torch.Tensor:
    """Full GQA block (projections + rope + attention + out projection).
    ``kv_in`` switches to cross-attention (keys/values from encoder).
    With ``ctx``: the rank's heads, ``wo`` all-reduced over the heads'
    axes."""
    src = x if kv_in is None else kv_in
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"])
    if use_rope and kv_in is None:
        if mrope_positions is not None:
            q = apply_mrope(q, mrope_positions, theta=rope_theta)
            k = apply_mrope(k, mrope_positions, theta=rope_theta)
        else:
            q = apply_rope(q, positions, rope_theta)
            k = apply_rope(k, positions, rope_theta)
    if ctx is not None and not ctx.logical("kv_heads"):
        k, v = (local_kv(t, n_heads, n_kv, ctx) for t in (k, v))
    # K/V keep their n_kv heads: the kernel reads them per group
    o = attention_chunked(q, k, v, causal=causal)
    out = torch.einsum("bshk,hkd->bsd", o, p["wo"])
    return out if ctx is None else ctx.row_out(out, ctx.logical("heads"))
