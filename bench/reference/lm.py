"""The plain reference of the benchmark's language models: a decoder of
pre-norm layers (RMSNorm, GQA attention with RoPE on the two halves of
each head, a SwiGLU feed-forward or a top-k mixture of SwiGLU experts),
written from the configuration file in plain ``torch`` and float32.

The semantics are those the configuration states for the port:

  * RMSNorm ``x * rsqrt(mean(x^2) + eps) * scale`` with the file's eps;
  * attention scores scaled by 1/sqrt(head_dim), causal, head h reading
    KV head h // (H / Hkv); RoPE rotates the halves [0, D/2) and
    [D/2, D) by position * theta^(-i / (D/2));
  * the SwiGLU's ``wi`` holds the gate in its first half of columns;
  * the mixture: softmax router, the k largest probabilities (the lower
    expert first on ties), renormalized to sum to 1 before the capacity
    drop; each expert keeps its first ``int(max(1, (T*k // E) * cf))``
    assignments in (token, rank) order of the whole batch, a dropped one
    adds nothing; a token sums its kept experts' outputs in rank order.
    The training loss adds 0.01 times the Switch balance loss a layer,
    averaged over layers;
  * the vocabulary padded as the file says; the loss masks the pad
    columns, prefill's logits are compared over the real vocabulary.

``prec`` "fp8" is the control: every product's operands rounded to
float8 e4m3 at a scale per tensor (gradients to e5m2), the nearest
precision below the bf16 the configuration states.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench.weights import arch, get, leaf_table, make

MASKED = -1e30


@contextlib.contextmanager
def exact_fp32():
    """float32 products in float32: TF32 off for the duration."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


# --------------------------------------------------------------------------
# products, in float32 or rounded to fp8
# --------------------------------------------------------------------------

def _round(t: torch.Tensor, dtype) -> torch.Tensor:
    fmax = torch.finfo(dtype).max
    amax = t.detach().abs().amax().clamp_min(1e-30)
    s = fmax / amax
    return (t * s).to(dtype).to(t.dtype) / s


class _Fp8Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        aq = _round(a, torch.float8_e4m3fn)
        bq = _round(b, torch.float8_e4m3fn)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _round(g, torch.float8_e5m2)
        return gq @ bq.transpose(-1, -2), aq.transpose(-1, -2) @ gq


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """a @ b of two 2-d, or two 3-d (batched), float32 tensors."""
    if prec == "fp32":
        return a @ b
    if prec == "fp8":
        return _Fp8Product.apply(a, b)
    raise ValueError(prec)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) at positions 0..S-1."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention_row(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  prec: str) -> torch.Tensor:
    """One sequence: q (S, H, D), k and v (S, Hkv, D) -> (S, H, D)."""
    S, H, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qh = q.permute(1, 0, 2).reshape(Hkv, G * S, D)
    s = mm(qh, k.permute(1, 2, 0), prec) / math.sqrt(D)     # (Hkv, G*S, S)
    qpos = torch.arange(G * S, device=q.device) % S
    keep = qpos[:, None] >= torch.arange(S, device=q.device)[None, :]
    p = torch.softmax(s.masked_fill(~keep, MASKED), dim=-1)
    o = mm(p, v.permute(1, 0, 2), prec)                     # (Hkv, G*S, D)
    return o.reshape(Hkv, G, S, D).permute(2, 0, 1, 3).reshape(S, H, D)


def swiglu(x: torch.Tensor, wi: torch.Tensor, wo: torch.Tensor,
           prec: str) -> torch.Tensor:
    f = wo.shape[0]
    h = mm(x, wi, prec)
    return mm(F.silu(h[:, :f]) * h[:, f:], wo, prec)


def capacity(T: int, k: int, E: int, cf: float) -> int:
    return int(max(1, (T * k // E) * cf))


def mixture(x: torch.Tensor, router: torch.Tensor, wi: torch.Tensor,
            wo: torch.Tensor, k: int, cf: float, prec: str, drops=None):
    """x (T, d) -> (out (T, d), balance loss). ``drops``, a list where
    given, gets the number of the T*k assignments that capacity drops."""
    T, d = x.shape
    E = router.shape[1]
    probs = torch.softmax(mm(x, router, prec), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    gates = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    C = capacity(T, k, E, cf)
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    if drops is not None:
        drops.append(int((counts - C).clamp_min(0).sum()))
    ys, kept = [], []
    for e, (n, s0) in enumerate(zip(counts.tolist(), starts.tolist())):
        js = order[s0:s0 + min(n, C)]
        if len(js):
            ys.append(swiglu(x[js // k], wi[e], wo[e], prec))
            kept.append(js)
    kept_j = torch.cat(kept)
    where = torch.full((T * k,), len(kept_j), dtype=torch.long,
                       device=x.device)
    where[kept_j] = torch.arange(len(kept_j), device=x.device)
    y = torch.cat(ys + [x.new_zeros(1, d)])[where].view(T, k, d)
    out = gates[:, 0, None] * y[:, 0]
    for r in range(1, k):
        out = out + gates[:, r, None] * y[:, r]
    aux = E * torch.sum(probs.mean(0) * counts.float() / (T * k))
    return out, aux


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], a: dict,
          prec: str, train: bool):
    """One layer over x (B, S, d) -> (x, balance loss or 0)."""
    B, S, d = x.shape
    H, Hkv, D = a["H"], a["Hkv"], a["D"]
    h = rmsnorm(x, w["ln1"], a["eps"]).reshape(B * S, d)
    q = mm(h, w["wq"].reshape(d, H * D), prec).view(B, S, H, D)
    kk = mm(h, w["wk"].reshape(d, Hkv * D), prec).view(B, S, Hkv, D)
    v = mm(h, w["wv"].reshape(d, Hkv * D), prec).view(B, S, Hkv, D)
    q, kk = rope(q, a["theta"]), rope(kk, a["theta"])
    rows = []
    for b in range(B):
        if train:
            rows.append(checkpoint(attention_row, q[b], kk[b], v[b], prec,
                                   use_reentrant=False))
        else:
            rows.append(attention_row(q[b], kk[b], v[b], prec))
    o = torch.stack(rows).reshape(B * S, H * D)
    x = x + mm(o, w["wo"].reshape(H * D, d), prec).view(B, S, d)
    h2 = rmsnorm(x, w["ln2"], a["eps"]).reshape(B * S, d)
    if a["E"]:
        y, aux = mixture(h2, w["router"], w["mwi"], w["mwo"], a["k"],
                         a["cf"], prec, a.get("drops"))
    else:
        y, aux = swiglu(h2, w["wi"], w["wo_ff"], prec), x.new_zeros(())
    return x + y.view(B, S, d), aux


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

#: the layer's leaves under their short names
LAYER_LEAVES = {"ln1": ("ln1", "scale"), "ln2": ("ln2", "scale"),
                "wq": ("attn", "wq"), "wk": ("attn", "wk"),
                "wv": ("attn", "wv"), "wo": ("attn", "wo"),
                "wi": ("mlp", "wi"), "wo_ff": ("mlp", "wo"),
                "router": ("moe", "router"), "mwi": ("moe", "wi"),
                "mwo": ("moe", "wo")}


def model_arch(config: dict) -> dict:
    a = dict(arch(config))
    a.update(eps=float(config["rms_norm_eps"]),
             theta=float(config["rope_theta"]),
             cf=float(config.get("capacity_factor") or 0.0),
             aux_coef=float(config.get("router_aux_loss_coef", 0.01)))
    return a


def _layer_weights(stack: dict, l: int, convert) -> Dict[str, torch.Tensor]:
    out = {}
    for short, path in LAYER_LEAVES.items():
        if path[0] in stack:
            out[short] = convert(stack[path[0]][path[1]][l])
    return out


def _unembed(weights: dict, a: dict, convert) -> torch.Tensor:
    return (convert(weights["embed"]).t() if a["tied"]
            else convert(weights["unembed"]))


@torch.no_grad()
def prefill_logits(config: dict, weights: dict, tokens: torch.Tensor,
                   prec: str = "fp32", drops=None) -> torch.Tensor:
    """Last-position logits (B, V), float32, of tokens (B, S) on the
    weights' device; the weights are upcast a layer at a time. ``drops``,
    a list where given, gets each MoE layer's count of assignments that
    capacity drops."""
    a = model_arch(config)
    a["drops"] = drops
    f32 = lambda t: t.float()  # noqa: E731
    with exact_fp32():
        x = weights["embed"][tokens.long()].float()
        stack = weights["stack"][0]
        for l in range(a["L"]):
            x, _ = layer(x, _layer_weights(stack, l, f32), a, prec, False)
        xn = rmsnorm(x[:, -1], f32(weights["ln_f"]["scale"]), a["eps"])
        return mm(xn, _unembed(weights, a, f32), prec)[:, :a["V"]]


def _nll_row(xn: torch.Tensor, unembed: torch.Tensor, labels: torch.Tensor,
             V: int, prec: str) -> torch.Tensor:
    """The summed NLL of one sequence's positions but its last."""
    logits = mm(xn, unembed, prec)
    if logits.shape[-1] != V:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= V
        logits = logits.masked_fill(pad, MASKED)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[:, None])[:, 0]
    return (lse - ll)[:-1].sum()


def loss(config: dict, w32: dict, tokens: torch.Tensor, prec: str
         ) -> torch.Tensor:
    """The training loss of tokens (B, S) at float32 weights ``w32`` (a
    tree like the port's), a checkpoint region a layer and a sequence."""
    a = model_arch(config)
    B, S = tokens.shape
    toks = tokens.long()
    x = w32["embed"][toks]
    stack = w32["stack"][0]
    aux = x.new_zeros(())

    def run_layer(x, *ws):
        return layer(x, dict(zip(names, ws)), a, prec, True)

    names = [n for n, p in LAYER_LEAVES.items() if p[0] in stack]
    for l in range(a["L"]):
        x, la = checkpoint(run_layer, x,
                           *[stack[LAYER_LEAVES[n][0]][LAYER_LEAVES[n][1]][l]
                             for n in names], use_reentrant=False)
        aux = aux + la
    unembed = _unembed(w32, a, lambda t: t)
    scale = w32["ln_f"]["scale"]
    labels = torch.cat([toks[:, 1:], toks[:, :1]], dim=1)
    tot = x.new_zeros(())
    for b in range(B):
        xn = rmsnorm(x[b], scale, a["eps"])
        tot = tot + checkpoint(_nll_row, xn, unembed, labels[b], a["V"],
                               prec, use_reentrant=False)
    return tot / (B * (S - 1)) + a["aux_coef"] * aux / a["L"]


# --------------------------------------------------------------------------
# training: loss, gradient and AdamW as the configuration states them
# --------------------------------------------------------------------------

SLICE = 1 << 26


def _adamw(params: List[torch.Tensor], grads: List[torch.Tensor],
           m: List[torch.Tensor], v: List[torch.Tensor], opt: dict,
           t: int, scale: float) -> None:
    """One AdamW step (0-based step t): float32 arithmetic, the params
    kept in their own dtype and the moments in float32, in place."""
    lr = opt["lr"] * min((t + 1) / max(1, opt["warmup_steps"]), 1.0)
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1 - b1 ** (t + 1), 1 - b2 ** (t + 1)
    for p, g, mm_, vv in zip(params, grads, m, v):
        pf_all, gf_all = p.view(-1), g.reshape(-1)
        mf_all, vf_all = mm_.view(-1), vv.view(-1)
        for i in range(0, pf_all.numel(), SLICE):
            pc, gc = pf_all[i:i + SLICE], gf_all[i:i + SLICE]
            mc, vc = mf_all[i:i + SLICE], vf_all[i:i + SLICE]
            gf = gc.float() * scale
            mc.mul_(b1).add_((1 - b1) * gf)
            vc.mul_(b2).add_((1 - b2) * gf * gf)
            pf = pc.float()
            delta = (mc / bc1) / (torch.sqrt(vc / bc2) + opt["eps"]) \
                + opt["weight_decay"] * pf
            pc.copy_(pf - lr * delta)


def train(config: dict, seed: int, batches: List[torch.Tensor], opt: dict,
          prec: str = "fp32", device=None) -> dict:
    """The first len(batches) steps from the seed's weights -> each step's
    loss, each leaf's first gradient as the optimizer takes it (clipped),
    and each leaf's change over the steps, as float norms by leaf name."""
    device = batches[0].device if device is None else device
    table = leaf_table(config)
    names = [".".join(str(k) for k in p) for p, _, _, _ in table]
    weights = make(config, seed, device)
    params = [get(weights, p) for p, _, _, _ in table]
    m = [torch.zeros(p.shape, dtype=torch.float32, device=device)
         for p in params]
    v = [torch.zeros_like(x) for x in m]
    losses, first, gn0 = [], {}, None
    with exact_fp32():
        for t, toks in enumerate(batches):
            w32 = [p.float().requires_grad_() for p in params]
            tree = _tree(table, w32)
            with torch.enable_grad():
                L = loss(config, tree, toks, prec)
                grads = torch.autograd.grad(L, w32)
            del w32, tree
            norms = [g.norm() for g in grads]
            gn = float(torch.linalg.vector_norm(torch.stack(norms)))
            scale = min(opt["grad_clip"] / max(gn, 1e-9), 1.0)
            if t == 0:
                first = {n: float(x) * scale for n, x in zip(names, norms)}
                gn0 = gn
            _adamw(params, grads, m, v, opt, t, scale)
            losses.append(float(L.detach()))
            del grads
    del m, v
    start = make(config, seed, device)
    change = {n: float((p.float() - get(start, path).float()).norm())
              for n, p, (path, _, _, _) in zip(names, params, table)}
    return {"losses": losses, "grad_norms": first, "change_norms": change,
            "global_grad_norm": gn0}


def _tree(table, tensors) -> dict:
    from bench.weights import _put
    tree: dict = {}
    for (path, _, _, _), t in zip(table, tensors):
        _put(tree, path, t)
    return tree
