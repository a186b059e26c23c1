"""Mamba-style selective SSM block (for jamba-1.5).

Port of ``repro.models.ssm``, with the reference's dtypes at each step:
bf16 projections and causal conv, float32 ``dt``, ``A``, state and
output math.

Prefill and training: depthwise causal conv1d, then the selective scan
chunk by chunk. Each chunk's dA and dBx (B, chunk, d_inner, d_state) are
made when the chunk is scanned, and the (B, d_inner, d_state) state is
handed from one chunk to the next: the whole (B, S, d_inner, d_state)
tensor never exists. The scan goes through the selective_scan kernel on
CUDA tensors and its plain version on CPU tensors. Unlike the reference
(ROADMAP C10), a last chunk shorter than ``chunk`` is scanned as it is,
so the result is right at any S.

Where autograd records (grad mode on and an input that requires grad)
the chunks hand the state on through ``SelectiveScan``
(``kernels/selective_scan/selective_scan_bwd.py``), whose forward keeps
the state every few steps and whose backward is a hand-written reverse
scan from them, and each chunk's ``_ssm_params -> dA, dBx ->
scan`` is a non-reentrant ``torch.utils.checkpoint`` region: autograd
keeps the chunk's input and its first state, and the backward makes the
chunk's dA and dBx again, one chunk at a time. At jamba's width each is
(4, 256, 16384, 16) float32, 1.07 GB; kept for every chunk they would
be 17 GB a mamba layer over 8 chunks. Without grad the state is one
tensor that the kernel overwrites in place, chunk after chunk.

Decode: the O(1) recurrent update of one token in plain torch, as in the
reference; it runs no kernel. The state is advanced in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import needs_grad
from ..kernels.selective_scan.selective_scan import selective_scan
from ..kernels.selective_scan.selective_scan_bwd import SelectiveScan
from .blueprint import leaf

Params = Dict[str, Any]


def mamba_bp(d: int, d_inner: int, d_state: int = 16, d_conv: int = 4,
             dt_rank: Optional[int] = None):
    dt_rank = dt_rank or max(1, d // 16)
    return {
        "in_proj": leaf((d, 2 * d_inner), ("embed", "d_inner"), scale_dim=0),
        "conv_w": leaf((d_conv, d_inner), ("conv", "d_inner"), init="small",
                       scale_dim=0),
        "conv_b": leaf((d_inner,), ("d_inner",), init="zeros"),
        "x_proj": leaf((d_inner, dt_rank + 2 * d_state),
                       ("d_inner", None), scale_dim=0),
        "dt_proj": leaf((dt_rank, d_inner), (None, "d_inner"), scale_dim=0),
        "dt_bias": leaf((d_inner,), ("d_inner",), init="zeros"),
        "A_log": leaf((d_inner, d_state), ("d_inner", "state"), init="ones"),
        "D": leaf((d_inner,), ("d_inner",), init="ones"),
        "out_proj": leaf((d_inner, d), ("d_inner", "embed"), scale_dim=0),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv in x's dtype. x: (B, S, C); w: (K, C);
    state: the last K-1 inputs (B, K-1, C) or None for zeros. Returns
    (y, the new last K-1 inputs)."""
    K, S = w.shape[0], x.shape[1]
    pad = (x.new_zeros(x.shape[0], K - 1, x.shape[2]) if state is None
           else state)
    xp = torch.cat([pad, x], dim=1)                  # (B, S+K-1, C)
    y = sum(xp[:, i:i + S] * w[i] for i in range(K))
    return y + b, xp[:, S:]


def _ssm_params(p: Params, xz: torch.Tensor, d_state: int):
    """dt (B,S,C), A (C,N), Bm and Cm (B,S,N), all float32."""
    dt_rank = p["dt_proj"].shape[0]
    proj = (xz @ p["x_proj"]).float()
    dt, Bm, Cm = proj.split([dt_rank, d_state, d_state], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    return dt, A, Bm, Cm


def _in(p: Params, x: torch.Tensor, conv_state=None):
    """The block's input side: the in projection, the conv and its silu.
    Returns (xs in x's dtype, z, the conv's new last inputs)."""
    xz = x @ p["in_proj"]
    xs, z = xz.chunk(2, dim=-1)
    xs, tail = _causal_conv1d(xs, p["conv_w"], p["conv_b"], conv_state)
    return F.silu(xs.float()).to(x.dtype), z, tail


def _out(p: Params, y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    """The skip through D, the silu(z) gate and the out projection."""
    y = y + xs.float() * p["D"].float()
    y = y * F.silu(z.float())
    return y.to(dtype) @ p["out_proj"]


def _scan_inputs(p: Params, xc: torch.Tensor, d_state: int):
    """A chunk's dA = exp(dt A), dBx = dt x B (B, c, C, N) and Cm (B, c,
    N), float32."""
    dt, A, Bm, Cm = _ssm_params(p, xc, d_state)
    dA = (dt[..., None] * A).exp_()
    dBx = (dt * xc.float())[..., None] * Bm[:, :, None, :]
    return dA, dBx, Cm.contiguous()


def mamba_scan_chunked(p: Params, x: torch.Tensor, *, d_state: int = 16,
                       chunk: int = 256) -> torch.Tensor:
    """Prefill's and training's selective scan. x: (B, S, d) -> (B, S,
    d)."""
    B, S, _ = x.shape
    xs, z, _ = _in(p, x)
    C = xs.shape[-1]
    h = torch.zeros(B, C, d_state, dtype=torch.float32, device=x.device)
    if needs_grad(xs, *p.values()):
        def chunk_fn(xc, h):
            return SelectiveScan.apply(*_scan_inputs(p, xc, d_state), h)

        ys = []
        for c0 in range(0, S, chunk):
            yc, h = checkpoint(chunk_fn, xs[:, c0:c0 + chunk], h,
                               use_reentrant=False)
            ys.append(yc)
        return _out(p, torch.cat(ys, dim=1), xs, z, x.dtype)
    y = torch.empty(B, S, C, dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        dA, dBx, Cm = _scan_inputs(p, xs[:, c0:c0 + chunk], d_state)
        y[:, c0:c0 + chunk] = selective_scan(dA, dBx, Cm, h)
        del dA, dBx
    return _out(p, y, xs, z, x.dtype)


def mamba_decode_step(p: Params, x: torch.Tensor,
                      state: Dict[str, torch.Tensor], *, d_state: int = 16
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, 1, d); state: {"conv": (B, K-1, C) bf16, "ssm": (B, C, N)
    float32}, advanced in place. Returns (out (B, 1, d), state)."""
    xs, z, tail = _in(p, x, state["conv"])
    dt, A, Bm, Cm = _ssm_params(p, xs, d_state)
    dA = torch.exp(dt[:, 0, :, None] * A)                   # (B, C, N)
    dBx = (dt[:, 0] * xs[:, 0].float())[..., None] * Bm[:, 0, None, :]
    h = dA * state["ssm"] + dBx
    y = torch.bmm(h, Cm[:, 0, :, None])[..., 0][:, None, :]  # (B, 1, C)
    state["conv"].copy_(tail)
    state["ssm"].copy_(h)
    return _out(p, y, xs, z, x.dtype), state
