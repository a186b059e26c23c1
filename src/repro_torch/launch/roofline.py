"""Roofline analysis from dry-run records (port of
``repro.launch.roofline``), with the H100's constants.

Per (arch x shape x mesh) cell:

  compute term    = FLOPs_per_device / peak_FLOPs              [s]
  memory term     = bytes_per_device / HBM_bw                  [s]
  collective term = ring-weighted collective bytes / link_bw   [s]

Hardware constants: NVIDIA's datasheet figures for the H100 80GB HBM3
SXM at 700 W, not measurements: 989 TFLOP/s bf16 dense, 3.35 TB/s HBM3,
80 GB a device; NVLink 450 GB/s a direction between the 8 GPUs of a
node, 50 GB/s a GPU across nodes (400 Gb/s a GPU). A ring of up to 8
ranks runs on NVLink, a longer one is priced at the cross-node rate.

The dry run's FLOPs are ``FlopCounterMode``'s (matrix products and
attention) and its bytes the unfused sum of every op's inputs and
outputs (``launch/dryrun.py``), so the memory term is an upper bound.
Collective bytes are per-op output bytes, turned into per-device link
traffic with the standard ring factors on the model axis's ring (the
record's last mesh dim), as the reference takes its 16-wide model axis:

  all-gather:     bytes * (n-1)/n
  reduce-scatter: bytes * (n-1)/n
  all-reduce:     2 * bytes * (n-1)/n
  all-to-all:     bytes * (n-1)/n
  collective-permute: bytes

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) per step, compared to
the traced FLOPs to expose remat/redundancy waste.
"""
from __future__ import annotations

import argparse
import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

#: NVIDIA datasheet, H100 80GB HBM3 SXM, 700 W (not measured)
PEAK_FLOPS = 989e12          # bf16 dense / GPU
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9             # bytes / GPU
NVLINK_BW = 450e9            # bytes/s a direction, within a node
NODE_GPUS = 8                # GPUs a node on NVLink
NET_BW = 50e9                # bytes/s a GPU across nodes (400 Gb/s)


def link_bw(ring: int) -> float:
    """The per-device rate a ring of ``ring`` ranks runs at."""
    return NVLINK_BW if ring <= NODE_GPUS else NET_BW


@dataclass
class RooflineRow:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_dev: float
    useful_ratio: float
    fit_note: str
    next_move: str

    def as_dict(self):
        return self.__dict__


def _active_params(rec: dict, arch_cfg) -> float:
    """Active params per token: full for dense; routed top-k + shared +
    attn/backbone for MoE."""
    n = rec["n_params"]
    c = arch_cfg
    if not c.moe_experts:
        return float(n)
    from ..models import get_model
    bp = get_model(c).blueprint()
    routed = total = 0

    def walk(t, path):
        nonlocal routed, total
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (str(k),))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (str(i),))
        else:
            sz = math.prod(t.shape)
            total += sz
            if "moe" in path and path[-1] in ("wi", "wo"):
                routed += sz
    walk(bp, ())
    return float((total - routed) + routed * (c.moe_top_k / c.moe_experts))


def _analytic_state_bytes(rec: dict, cfg) -> float:
    """The reference's analytic per-device state (its dry run's temp
    estimate is not representative, nor is the port's: the plain
    attention materializes its scores, which the kernel never does)."""
    from ..configs.base import SHAPES
    sh = SHAPES[rec["shape"]]
    nd = rec["n_devices"]
    n = rec["n_params"]
    d = cfg.d_model
    if sh.kind == "train":
        state = n * (2 + 4 + 4 + 4) / nd          # p bf16, g fp32, m, v
        B_loc = max(1, sh.global_batch // 16)
        pat = len(cfg.layer_pattern())
        periods = cfg.n_layers // pat
        acts = B_loc * sh.seq_len * d * 2 * periods / 16  # TP-sharded resid
        logits = B_loc * sh.seq_len * cfg.padded_vocab * 4 / 16
        if cfg.loss_chunk:
            logits *= cfg.loss_chunk / sh.seq_len
        return state + acts + logits
    params = n * 2 / nd
    if sh.kind == "prefill":
        B_loc = max(1, sh.global_batch // 16)
        acts = B_loc * sh.seq_len * d * 2 * 4 / 16
        return params + acts
    # decode: KV/state cache
    cache = 0.0
    pat = cfg.layer_pattern()
    periods = cfg.n_layers // len(pat)
    for k in pat:
        if k.mixer in ("attn", "attn_cross"):
            cache += (2 * sh.global_batch * sh.seq_len * cfg.n_kv_heads
                      * cfg.head_dim * 2)
        elif k.mixer == "mamba":
            cache += sh.global_batch * cfg.ssm_d_inner * (cfg.ssm_d_state
                                                          * 4 + 6)
        elif k.mixer == "mlstm":
            hd = cfg.d_model // cfg.n_heads
            cache += sh.global_batch * cfg.n_heads * hd * (hd + 2) * 4
        elif k.mixer == "slstm":
            cache += sh.global_batch * cfg.d_model * 14
    cache *= periods
    return params + cache / nd


def tokens_of(shape_name: str) -> float:
    from ..configs.base import SHAPES
    sh = SHAPES[shape_name]
    if sh.kind in ("train", "prefill"):
        return sh.global_batch * sh.seq_len
    return sh.global_batch * 1.0          # decode: one token per sequence


def model_flops(rec: dict, arch_cfg) -> float:
    """6*N_active*D per step (backward included only for train)."""
    n_active = _active_params(rec, arch_cfg)
    toks = tokens_of(rec["shape"])
    mult = 6.0 if rec["step_kind"] == "train" else 2.0
    return mult * n_active * toks


def ring_factor(kind: str, n: int) -> float:
    if kind == "all-gather":
        return (n - 1) / n
    if kind == "reduce-scatter":
        return (n - 1) / n
    if kind == "all-reduce":
        return 2 * (n - 1) / n
    if kind == "all-to-all":
        return (n - 1) / n
    if kind == "collective-permute":
        return 1.0
    return 1.0


def analyze(rec: dict, arch_cfg) -> Optional[RooflineRow]:
    if rec.get("status") != "ok":
        return None
    nd = rec["n_devices"]
    ring = int(rec["mesh_shape"][-1])          # the model axis's ring
    ex = rec.get("extrapolated") or {}
    if "flops" in ex and "error" not in ex:
        flops = ex["flops"]
        nbytes = ex["bytes"]
        coll_map = ex["coll"]
    else:
        flops = rec["flops"]
        nbytes = rec["bytes_accessed"]
        coll_map = rec["collectives"]["bytes"]
    compute = flops / PEAK_FLOPS
    memory = nbytes / HBM_BW
    coll_bytes = 0.0
    for kind, b in coll_map.items():
        coll_bytes += b * ring_factor(kind, ring)
    collective = coll_bytes / link_bw(ring)
    mf = model_flops(rec, arch_cfg)
    total = flops * nd
    useful = mf / total if total else 0.0

    terms = {"compute": compute, "memory": memory, "collective": collective}
    dominant = max(terms, key=terms.get)

    per_dev = _analytic_state_bytes(rec, arch_cfg)
    fit = f"{per_dev/2**30:.1f} GiB/dev " + \
        ("FITS 80G" if per_dev < HBM_BYTES else "EXCEEDS 80G")

    moves = {
        "compute": "cut redundant FLOPs (remat policy, fused attention)",
        "memory": "reduce bytes: fuse normalizations, avoid logits "
                  "materialization, bf16 accumulators where safe",
        "collective": "re-shard to cut all-gathers (2D FSDP, overlap "
                      "collectives with compute, int8 grad compression)",
    }
    return RooflineRow(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=compute, memory_s=memory, collective_s=collective,
        dominant=dominant, model_flops=mf, hlo_flops_dev=rec["flops"],
        useful_ratio=useful, fit_note=fit, next_move=moves[dominant])


def load_rows(art_dir: Path, mesh: str = "pod") -> List[RooflineRow]:
    from ..configs import get_config
    rows = []
    for f in sorted(Path(art_dir).glob(f"*__{mesh}.json")):
        rec = json.loads(f.read_text())
        if rec.get("status") != "ok":
            continue
        row = analyze(rec, get_config(rec["arch"]))
        if row:
            rows.append(row)
    return rows


def render_table(rows: List[RooflineRow]) -> str:
    hdr = ("| arch | shape | compute s | memory s | collective s | "
           "dominant | MODEL/traced | fit |")
    sep = "|" + "---|" * 8
    lines = [hdr, sep]
    for r in rows:
        lines.append(
            f"| {r.arch} | {r.shape} | {r.compute_s:.3e} | "
            f"{r.memory_s:.3e} | {r.collective_s:.3e} | {r.dominant} | "
            f"{r.useful_ratio:.2f} | {r.fit_note} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifacts", default="artifacts/dryrun")
    ap.add_argument("--mesh", default="pod")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    rows = load_rows(Path(args.artifacts), args.mesh)
    print(render_table(rows))
    if args.json_out:
        Path(args.json_out).write_text(
            json.dumps([r.as_dict() for r in rows], indent=1))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
