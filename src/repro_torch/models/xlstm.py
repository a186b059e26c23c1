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
                  chunk: int = 128) -> torch.Tensor:
    """Prefill's mLSTM, causal. x: (B, S, d) -> (B, S, d)."""
    B, S, d = x.shape
    hd = d // n_heads
    q, k, v, ig, fg = _mlstm_in(p, x, n_heads)
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
    return torch.einsum("bshk,hkd->bsd", y, p["wo"])


def mlstm_decode_step(p: Params, x: torch.Tensor,
                      state: Dict[str, torch.Tensor], *, n_heads: int
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d); state: C (B, H, Dk, Dv), n (B, H, Dk), m (B, H),
    float32, advanced in place. Returns (out (B, 1, d), state)."""
    q, k, v, ig, fg = _mlstm_in(p, x, n_heads)
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
    return torch.einsum("bshk,hkd->bsd", y, p["wo"]), state


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------

def slstm_bp(d: int, n_heads: int):
    return {
        "wx": leaf((d, 4 * d), ("embed", "ff"), scale_dim=0),
        "wh": leaf((d, 4 * d), ("embed", "ff"), scale_dim=0),
        "b": leaf((4 * d,), ("ff",), init="zeros"),
        "wo": leaf((d, d), ("ff", "embed"), scale_dim=0),
    }


def slstm_init_state(B: int, d: int, dtype=torch.bfloat16, device=None):
    """(h in ``dtype``, c, n, m float32), each (B, d): the reference's
    4-tuple, m at ``M_INIT``."""
    return (torch.zeros(B, d, dtype=dtype, device=device),
            torch.zeros(B, d, device=device),
            torch.zeros(B, d, device=device),
            torch.full((B, d), M_INIT, device=device))


def _slstm_cell(p: Params, zx: torch.Tensor, carry):
    """One step from zx = x_t @ wx (B, 4d) in x's dtype: the new (h, c, n,
    m)."""
    h, c, n, m = carry
    z = (zx + h @ p["wh"]).float() + p["b"].float()
    zi, zf, zz, zo = z.chunk(4, dim=-1)
    lf = F.logsigmoid(zf)
    m_new = torch.maximum(lf + m, zi)
    i = torch.exp(zi - m_new)
    f = torch.exp(lf + m - m_new)
    c_new = f * c + i * torch.tanh(zz)
    n_new = f * n + i
    h_new = (torch.sigmoid(zo) * c_new / n_new.clamp_min(1.0)).to(h.dtype)
    return h_new, c_new, n_new, m_new


def slstm_seq(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), a sequential loop over time."""
    B, S, d = x.shape
    zx = x @ p["wx"]                                      # (B, S, 4d)
    carry = slstm_init_state(B, d, x.dtype, x.device)
    hs = torch.empty(B, S, d, dtype=x.dtype, device=x.device)
    for t in range(S):
        carry = _slstm_cell(p, zx[:, t], carry)
        hs[:, t] = carry[0]
    return hs @ p["wo"]


def slstm_decode_step(p: Params, x: torch.Tensor, state
                      ) -> Tuple[torch.Tensor, Any]:
    """x: (B, 1, d); state: the (h, c, n, m) tuple, advanced in place.
    Returns (out (B, 1, d), state)."""
    carry = _slstm_cell(p, x[:, 0] @ p["wx"], state)
    for t, new in zip(state, carry):
        t.copy_(new)
    return (carry[0] @ p["wo"])[:, None], state
