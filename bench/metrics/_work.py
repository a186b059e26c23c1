"""The yardstick's arithmetic: the H100's peaks, and the operations and
bytes of the model and of each kernel's call, counted from shapes.

  * A kernel call's work counts each input read once and each output
    written once; where the work depends on the data (the expert FF's
    filled rows, its experts with any row) it counts what these inputs
    need. The roofline share of a layer entry is the sum of its calls'
    bounds over the device time in its range.
  * Model FLOPs (``mfu.*``) count 2 a token per matmul weight forward
    (6 forward and backward), the tied unembedding once and the embedding
    lookup not, plus causal attention's products; recomputation is not
    counted.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

#: NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FLOPS = 989e12           # bf16 / fp16 tensor cores
PEAK_BYTES = 3.35e12          # HBM3

ELEM_BYTES = {"torch.bfloat16": 2, "torch.float16": 2, "torch.float32": 4,
              "torch.int32": 4, "torch.int64": 8}


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for the work."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def causal_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs that causal attention computes; the queries are
    the last Sq of Sk positions."""
    if not causal:
        return Sq * Sk
    off = Sk - Sq
    return sum(min(Sk, i + off + 1) for i in range(Sq)) if Sq != Sk \
        else Sq * (Sq + 1) // 2


# --------------------------------------------------------------------------
# kernel calls, from the spans' descriptions of their arguments
# --------------------------------------------------------------------------

def _nbytes(arg: dict) -> int:
    n = 1
    for s in arg["shape"]:
        n *= s
    return n * ELEM_BYTES[arg["dtype"]]


def _causal(call: dict) -> bool:
    c = call["kwargs"].get("causal", True)
    return True if c is None else bool(c)


def attention_fwd(call: dict) -> Tuple[float, float]:
    """flash_attention(q, k, v, causal=, with_lse=): q (B, H, Sq, D),
    k and v (B, Hkv, Sk, D); out like q, lse (B, H, Sq) float32."""
    q, k, v = call["args"][:3]
    B, H, Sq, D = q["shape"]
    Sk = k["shape"][2]
    flops = 4.0 * B * H * D * causal_pairs(Sq, Sk, _causal(call))
    nbytes = 2 * _nbytes(q) + _nbytes(k) + _nbytes(v)
    if call["kwargs"].get("with_lse"):
        nbytes += 4 * B * H * Sq
    return flops, float(nbytes)


def attention_bwd(call: dict) -> Tuple[float, float]:
    """flash_attention_bwd(q, k, v, o, do, lse): five products (the
    scores again, dP, dV, dQ, dK); reads q, k, v, o, do, lse, writes dq,
    dk, dv."""
    q, k, v, o, do, lse = call["args"][:6]
    B, H, Sq, D = q["shape"]
    Sk = k["shape"][2]
    flops = 10.0 * B * H * D * causal_pairs(Sq, Sk, _causal(call))
    nbytes = (2 * (_nbytes(q) + _nbytes(k) + _nbytes(v)) + _nbytes(o)
              + _nbytes(do) + _nbytes(lse))
    return flops, float(nbytes)


def expert_ff(call: dict) -> Optional[Tuple[float, float]]:
    """grouped_expert_ff(x, wi, wo, counts, gu=None): x (E, C, d), wi (E,
    d, 2f), wo (E, f, d). Counts the filled rows (the per-expert counts)
    and the weights of the experts with any: None without counts."""
    args = call["args"]
    x, wi, wo = args[:3]
    counts = args[3] if len(args) > 3 else call["kwargs"].get("counts")
    if not isinstance(counts, dict) or counts.get("tensor") is None:
        return None
    c = counts["tensor"]
    rows = float(c.sum())
    live = float((c > 0).sum())
    E, _, d = x["shape"]
    f = wo["shape"][1]
    eb = ELEM_BYTES[x["dtype"]]
    flops = rows * 6.0 * d * f
    nbytes = (2 * rows * d * eb + live * 3 * d * f * ELEM_BYTES[wi["dtype"]]
              + _nbytes(counts))
    gu = args[4] if len(args) > 4 else call["kwargs"].get("gu")
    if isinstance(gu, dict):
        nbytes += rows * 2 * f * ELEM_BYTES[gu["dtype"]]
    return flops, nbytes


def roofline(run, spans: Iterable[Tuple[str, object]]) -> Optional[float]:
    """The share, in %, of the bound of the calls recorded in ``spans``
    ((span, counter) pairs) over the device time in those spans; None
    where the trace or the spans hold nothing."""
    if run.summary is None or run.spans is None:
        return None
    bound = device = 0.0
    for span, counter in spans:
        calls = run.spans.calls.get(span, [])
        for call in calls:
            w = counter(call)
            if w is None:
                return None
            bound += bound_s(*w)
        if calls:
            device += run.summary.device_s(span)
    if bound <= 0 or device <= 0:
        return None
    return 100.0 * bound / device


# --------------------------------------------------------------------------
# model FLOPs
# --------------------------------------------------------------------------

def _sizes(config: dict):
    from bench.weights import arch
    return arch(config)


def matmul_weights_per_token(config: dict) -> Tuple[float, float]:
    """(weights a token passes through in the layers, unembedding
    weights): attention projections and the dense FF, or the router and
    the k routed experts."""
    a = _sizes(config)
    d, H, Hkv, D = a["d"], a["H"], a["Hkv"], a["D"]
    attn = d * H * D + 2 * d * Hkv * D + H * D * d
    ff = (d * a["E"] + a["k"] * 3 * d * a["ff"]) if a["E"] \
        else 3 * d * a["ff"]
    return float(a["L"] * (attn + ff)), float(d * a["V"])


def train_flops(config: dict, B: int, S: int) -> float:
    """Model FLOPs of one training step of B sequences of S tokens."""
    a = _sizes(config)
    layers, unembed = matmul_weights_per_token(config)
    attn = 12.0 * a["L"] * B * a["H"] * a["D"] * causal_pairs(S, S, True)
    return 6.0 * (layers + unembed) * B * S + attn


def prefill_flops(config: dict, B: int, S: int) -> float:
    """Model FLOPs of prefilling B sequences of S tokens to their
    last-position logits."""
    a = _sizes(config)
    layers, unembed = matmul_weights_per_token(config)
    attn = 4.0 * a["L"] * B * a["H"] * a["D"] * causal_pairs(S, S, True)
    return 2.0 * layers * B * S + 2.0 * unembed * B + attn


def mfu(run, flops: float) -> Optional[float]:
    """``flops`` of model work done in the device phase of the traced
    window over the phase's length at the bf16 peak, in %."""
    s = run.device_summary
    if s is None or s.window_s <= 0 or s.n_device_events == 0 or flops <= 0:
        return None
    return 100.0 * flops / (s.window_s * PEAK_FLOPS)


def share(run, part: str, whole: str) -> Optional[float]:
    """Device time in ``part`` over the device's busy time in ``whole``
    (first event to last, each instance), in %."""
    if run.summary is None:
        return None
    w = run.summary.busy_s_in(whole)
    p = run.summary.device_s(part)
    return 100.0 * p / w if w > 0 and run.summary.count(part) else None


def idle(run) -> Optional[float]:
    """The share of the device phase of the traced window in which
    nothing ran on the device, in %."""
    s = run.device_summary
    if s is None or s.window_s <= 0 or s.n_device_events == 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def driver_is(run, name: str) -> bool:
    return run.traffic.get("driver") == name
