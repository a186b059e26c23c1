"""xLSTM blocks (for xlstm-1.3b): mLSTM (matrix memory, chunkwise-parallel)
and sLSTM (scalar memory, sequential), interleaved 7:1 by the config.

Port of ``repro.models.xlstm``: the same leaves, axes and init rules
(the mLSTM's ``norm`` leaf included, unused as in the reference), the
same dtypes at each step: bf16 projections, float32 gates, stabilisers
and states. None of it reaches a kernel: plain torch, as ``ssm.py``'s
glue is.

mLSTM, prefill (``mlstm_chunked``). The recurrence (``mlstm_decode_step``,
the xLSTM paper's, arXiv:2405.04517) is, per head, with log gates ig and
fg = log_sigmoid(f):

    m_t = max(m_{t-1} + fg_t, ig_t)
    C_t = C_{t-1} exp(m_{t-1} + fg_t - m_t) + exp(ig_t - m_t) k_t v_t^T
    n_t = n_{t-1} exp(m_{t-1} + fg_t - m_t) + exp(ig_t - m_t) k_t
    h_t = q_t C_t / max(|q_t n_t|, 1)

A chunk of c positions from a carried (C, n, m), with cf_t the cumulative
fg within the chunk, has m_t = max(m + cf_t, max_{s <= t} (cf_t - cf_s
+ ig_s)), and with w_ts = exp(cf_t - cf_s + ig_s - m_t) for s <= t, 0
past t:

    q_t C_t = exp(m + cf_t - m_t) q_t C + sum_s w_ts (q_t . k_s) v_s

so the chunk's outputs are an attention: ((q k^T) o w) v and its row
sums, plus the carried state's part; then (C, n, m) move to the chunk's
end. The (c, c) weights are made a chunk and head at a time, never the
reference's (B, c, c, H, Dk, Dv) intermediate (``xlstm.py:81-87``: 1.07
GB a chunk in bf16 at xlstm-1.3b's widths). Unlike the reference
(ROADMAP C14), w is causal, and a last chunk shorter than ``chunk`` (or
S < chunk) is taken as it is: the result equals the recurrence at any S.
Products and states are float32 (the recurrence's), the output cast to
x's dtype before the out projection.

sLSTM: ``slstm_seq`` takes x @ wx for every position in one product
before its time loop; only h @ wh stays in the loop, as bf16 products
summed in bf16 and then cast, as the reference rounds them.

The decode steps advance their state in place and return it.

Under a sharding context (``distributed/context.py``):

  * the mLSTM works on the rank's heads (``wq``, ``wk``, ``wv`` and
    ``wif`` column-parallel on ``heads``); its chunk loop is local, and
    ``wo`` is row-parallel, summed by ``ShardCtx.row_out``. Its decode
    state is replicated (the reference's ``cache_pspecs``), so at decode
    the step's q, k, v and gates, (B, H, hd) and (B, H), are all-gathered
    over the heads, every rank advances the whole state, and only its
    heads go through ``wo`` before the sum;
  * the sLSTM's ``ff`` axis is four gate blocks [i | f | z | o] of d
    each: ``wx``, ``wh`` and ``b`` have 4 blocks, so a rank holds the
    same channels of every gate, and ``wo`` (d, d) is row-parallel over
    those channels. ``slstm_seq`` keeps every collective out of its time
    loop: it gathers the layer's ``wx``, ``wh`` and ``b`` whole once,
    runs the recurrence on every channel, and takes the rank's h channels
    into ``wo`` (the gathers' adjoint sums each rank's part of the
    weights' gradients, so each shard gets its whole gradient once). Its
    decode state is sharded on d: h is all-gathered once a step, before
    ``h @ wh``, and the rest of the step is the rank's channels.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from .blueprint import leaf

Params = Dict[str, Any]

#: the stabiliser's initial value (the reference's ``m0``)
M_INIT = -1e30


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------

def mlstm_bp(d: int, n_heads: int):
    hd = d // n_heads
    return {
        "wq": leaf((d, n_heads, hd), ("embed", "heads", "head_dim"),
                   scale_dim=0),
        "wk": leaf((d, n_heads, hd), ("embed", "heads", "head_dim"),
                   scale_dim=0),
        "wv": leaf((d, n_heads, hd), ("embed", "heads", "head_dim"),
                   scale_dim=0),
        "wif": leaf((d, n_heads, 2), ("embed", "heads", None), scale_dim=0),
        "wo": leaf((n_heads, hd, d), ("heads", "head_dim", "embed"),
                   scale_dim=2),
        "norm": leaf((d,), ("embed",), init="ones"),
    }


def mlstm_init_state(B: int, n_heads: int, hd: int, device=None
                     ) -> Dict[str, torch.Tensor]:
    """C (B, H, Dk, Dv), n (B, H, Dk), m (B, H), float32: the empty
    memory, stabiliser at ``M_INIT``."""
    return {"C": torch.zeros(B, n_heads, hd, hd, device=device),
            "n": torch.zeros(B, n_heads, hd, device=device),
            "m": torch.full((B, n_heads), M_INIT, device=device)}


def _mlstm_in(p: Params, x: torch.Tensor, n_heads: int):
    """q (scaled by 1/sqrt(Dk)), k, v (B, S, H, D) in x's dtype, and the
    log gates ig, fg (B, S, H) float32."""
    hd = x.shape[-1] // n_heads
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"]) / (hd ** 0.5)
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    gates = torch.einsum("bsd,dhg->bshg", x, p["wif"]).float()
    return q, k, v, gates[..., 0], F.logsigmoid(gates[..., 1])


def mlstm_chunked(p: Params, x: torch.Tensor, *, n_heads: int,
                  chunk: int = 128, ctx=None) -> torch.Tensor:
    """Prefill's mLSTM, causal. x: (B, S, d) -> (B, S, d) (``ctx``: the
    rank's heads, the module's docstring)."""
    B, S, d = x.shape
    hd = d // n_heads
    q, k, v, ig, fg = _mlstm_in(p, x, n_heads)
    n_heads = q.shape[2]                                 # the rank's
    # (B, H, S, D) and (B, H, S), float32
    q, k, v = (t.float().transpose(1, 2) for t in (q, k, v))
    ig, fg = ig.transpose(1, 2), fg.transpose(1, 2)
    st = mlstm_init_state(B, n_heads, hd, x.device)
    C, n, m = st["C"], st["n"], st["m"]
    y = torch.empty(B, n_heads, S, hd, device=x.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        qc, kc, vc, igc = q[:, :, sl], k[:, :, sl], v[:, :, sl], ig[:, :, sl]
        c = qc.shape[2]
        cf = torch.cumsum(fg[:, :, sl], dim=-1)                 # (B, H, c)
        # dmat[t, s] = cf_t - cf_s + ig_s, s <= t
        dmat = cf[..., :, None] - cf[..., None, :] + igc[..., None, :]
        causal = torch.ones(c, c, dtype=torch.bool, device=x.device).tril()
        dmat = dmat.masked_fill(~causal, -torch.inf)
        mt = torch.maximum(dmat.amax(-1), m[..., None] + cf)     # m_t
        w = torch.exp(dmat - mt[..., None])                      # (B,H,c,c)
        inter = torch.exp(m[..., None] + cf - mt)                # (B, H, c)
        a = (qc @ kc.transpose(-1, -2)) * w
        num = a @ vc + (qc @ C) * inter[..., None]
        den = a.sum(-1) + (qc @ n[..., None])[..., 0] * inter
        y[:, :, sl] = num / den.abs().clamp_min(1.0)[..., None]
        # the state at the chunk's end
        m_new = mt[..., -1]
        decay = torch.exp(m[..., None] + cf[..., -1:] - m_new[..., None])
        u = torch.exp(cf[..., -1:] - cf + igc - m_new[..., None])  # (B,H,c)
        C = C * decay[..., None] + (kc * u[..., None]).transpose(-1, -2) @ vc
        n = n * decay + (kc * u[..., None]).sum(-2)
        m = m_new
    y = y.transpose(1, 2).to(x.dtype)                            # (B,S,H,D)
    out = torch.einsum("bshk,hkd->bsd", y, p["wo"])
    return out if ctx is None else ctx.row_out(out, ctx.logical("heads"))


def mlstm_decode_step(p: Params, x: torch.Tensor,
                      state: Dict[str, torch.Tensor], *, n_heads: int,
                      ctx=None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d); state: C (B, H, Dk, Dv), n (B, H, Dk), m (B, H),
    float32, advanced in place (every head, under ``ctx`` too). Returns
    (out (B, 1, d), state)."""
    q, k, v, ig, fg = _mlstm_in(p, x, n_heads)
    hax = () if ctx is None else ctx.logical("heads")
    if hax:     # every head's step, for the replicated state
        q, k, v, ig, fg = (ctx.gather(t, 2, hax) for t in (q, k, v, ig, fg))
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()
    ig, fg = ig[:, 0], fg[:, 0]
    m = state["m"]
    m_new = torch.maximum(m + fg, ig)
    dec = torch.exp(m + fg - m_new)
    inp = torch.exp(ig - m_new)
    C = state["C"] * dec[..., None, None] + \
        inp[..., None, None] * (k[..., :, None] * v[..., None, :])
    nvec = state["n"] * dec[..., None] + inp[..., None] * k
    num = torch.einsum("bhk,bhkv->bhv", q, C)
    den = torch.einsum("bhk,bhk->bh", q, nvec).abs().clamp_min(1.0)
    y = (num / den[..., None]).to(x.dtype)[:, None]             # (B,1,H,D)
    state["C"].copy_(C)
    state["n"].copy_(nvec)
    state["m"].copy_(m_new)
    if hax:     # the rank's heads through its rows of wo
        lo, hi = ctx.part("heads", n_heads)
        y = y[:, :, lo:hi]
    out = torch.einsum("bshk,hkd->bsd", y, p["wo"])
    return (out if ctx is None else ctx.reduce(out, hax)), state


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def slstm_bp(d: int, n_heads: int):
    # ff is [i | f | z | o], four gate blocks of d
    return {
        "wx": leaf((d, 4 * d), ("embed", "ff"), scale_dim=0, blocks=4),
        "wh": leaf((d, 4 * d), ("embed", "ff"), scale_dim=0, blocks=4),
        "b": leaf((4 * d,), ("ff",), init="zeros", blocks=4),
        "wo": leaf((d, d), ("ff", "embed"), scale_dim=0),
    }


def slstm_init_state(B: int, d: int, dtype=torch.bfloat16, device=None):
    """(h in ``dtype``, c, n, m float32), each (B, d): the reference's
    4-tuple, m at ``M_INIT``."""
    return (torch.zeros(B, d, dtype=dtype, device=device),
            torch.zeros(B, d, device=device),
            torch.zeros(B, d, device=device),
            torch.full((B, d), M_INIT, device=device))


def _slstm_cell(p: Params, zx: torch.Tensor, carry, h_in=None):
    """One step from zx = x_t @ wx (B, 4d) in x's dtype: the new (h, c, n,
    m). ``h_in``: the h that multiplies ``wh`` where it is not the
    carry's (all the channels, where the carry holds a rank's)."""
    h, c, n, m = carry
    z = (zx + (h if h_in is None else h_in) @ p["wh"]).float() \
        + p["b"].float()
    zi, zf, zz, zo = z.chunk(4, dim=-1)
    lf = F.logsigmoid(zf)
    m_new = torch.maximum(lf + m, zi)
    i = torch.exp(zi - m_new)
    f = torch.exp(lf + m - m_new)
    c_new = f * c + i * torch.tanh(zz)
    n_new = f * n + i
    h_new = (torch.sigmoid(zo) * c_new / n_new.clamp_min(1.0)).to(h.dtype)
    return h_new, c_new, n_new, m_new


def slstm_seq(p: Params, x: torch.Tensor, ctx=None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), a sequential loop over time (``ctx``:
    the module's docstring)."""
    d = x.shape[-1]
    fax = () if ctx is None else ctx.logical("ff")
    wo = p["wo"]
    if fax:     # every channel's weights, once, outside the loop
        p = {k: ctx.gather(p[k], p[k].dim() - 1, fax, blocks=4)
             for k in ("wx", "wh", "b")}
    hs = _slstm_steps(p, x @ p["wx"], d)                 # zx (B, S, 4d)
    if fax:     # the rank's channels, its rows of wo
        lo, hi = ctx.part("ff", d)
        hs = hs[..., lo:hi]
    out = hs @ wo
    return out if ctx is None else ctx.row_out(out, fax)


def _slstm_steps(p: Params, zx: torch.Tensor, d: int) -> torch.Tensor:
    """The time loop from the initial state: zx (B, S, 4d) -> every
    step's h (B, S, d) in zx's dtype."""
    B, S, _ = zx.shape
    carry = slstm_init_state(B, d, zx.dtype, zx.device)
    hs = torch.empty(B, S, d, dtype=zx.dtype, device=zx.device)
    for t in range(S):
        carry = _slstm_cell(p, zx[:, t], carry)
        hs[:, t] = carry[0]
    return hs


def slstm_decode_step(p: Params, x: torch.Tensor, state, ctx=None
                      ) -> Tuple[torch.Tensor, Any]:
    """x: (B, 1, d); state: the (h, c, n, m) tuple, advanced in place
    (under ``ctx``, each the rank's channels). Returns (out (B, 1, d),
    state)."""
    fax = () if ctx is None else ctx.logical("ff")
    h_in = ctx.gather(state[0], 1, fax) if fax else None
    carry = _slstm_cell(p, x[:, 0] @ p["wx"], state, h_in)
    for t, new in zip(state, carry):
        t.copy_(new)
    out = (carry[0] @ p["wo"])[:, None]
    return (out if ctx is None else ctx.reduce(out, fax)), state
