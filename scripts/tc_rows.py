"""Times the tensor-core kernels at the serving paths' prefill shapes with
the kernels and the timing code of one checkout, to set two checkouts
against each other on one card (run it for each, in turns).

It loads ``<root>/chip_smoke.py`` (which puts ``<root>/src`` first on the
path, so the checkout's own ``repro_torch`` is imported and its kernels
are built into ``<root>/build``) and times with its helpers: CUDA events
around batches of wrapper calls (``_median_ms``) and the profiler's device
time (``_device_ms``, by kernel too), after the ``-Xptxas -v`` registers
and spills of the tensor-core kernels (``_ptxas_lines``). Rows:
flash_attention, bf16, causal, 4 x 2048
tokens, at granite-3-2b's, olmoe-1b-7b's, jamba's and kimi-k2's heads
(head dims 64, 128, 128, 112); the expert FF, bf16, every capacity slot
filled, at olmoe-1b-7b's, jamba's and kimi-k2's prefill shapes (64, 16
and 384 experts). Inputs are drawn from ``--seed`` on the card.

    python3 scripts/tc_rows.py --root <checkout> [--seed N] [--reps N]

Prints the card's name and power limit, one line a row, and a last line
``{"root": ..., "card": ..., "rows": [...]}``. Needs a CUDA device.
"""
import argparse
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    spec = importlib.util.spec_from_file_location("checkout_chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    torch = cs.torch
    if not torch.cuda.is_available():
        print("tc_rows: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = cs._smi("name,power.limit").splitlines()[0]
    print(card)
    for m in (cs.fa, cs.md):
        so, secs = m.KERNEL.build()
        print(f"build {m.KERNEL.kind} {so.name[:12]} nvcc {secs:.1f} s")
        for line in cs._ptxas_lines(m.KERNEL):
            print(f"ptxas {line}")
    g = torch.Generator(dev).manual_seed(args.seed)
    B, S = cs.PREFILL_B, cs.PREFILL_S
    bf16 = torch.bfloat16
    cuts = {cs.LM_ARCH: {}, cs.MOE_ARCH: {}, cs.HYBRID_ARCH: cs.HYBRID_CUT,
            cs.KIMI_ARCH: cs.KIMI_CUT}
    rows = []

    def row(kernel, arch, shape, fn, batch):
        ms = cs._median_ms(fn, args.reps, batch)
        dev_ms, by_kernel, _ = cs._device_ms(fn, 2 * batch)
        rows.append({"kernel": kernel, "arch": arch, "shape": shape,
                     "ms": ms, "device_ms": dev_ms,
                     "device_ms_by_kernel": by_kernel})
        print(f"{kernel} {arch} {shape}: {ms:.4f} ms, device "
              + ("not measured" if dev_ms is None else f"{dev_ms:.4f} ms")
              + "".join(f"; {k} {v:.4f}" for k, v in by_kernel.items()))

    for arch, cut in cuts.items():
        cfg = dataclasses.replace(cs.get_config(arch), **cut)
        q, k, v = cs._qkv(g, dev, cfg, B, S, bf16)
        row("flash_attention", arch,
            f"({B}, {cfg.n_heads}, {S}, {cfg.head_dim}) kv "
            f"{cfg.n_kv_heads} causal",
            lambda: cs.fa.flash_attention(q, k, v, causal=True), 10)
        del q, k, v
    for arch in (cs.MOE_ARCH, cs.HYBRID_ARCH, cs.KIMI_ARCH):
        cfg = dataclasses.replace(cs.get_config(arch), **cuts[arch])
        E, d, f = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
        C = cs._moe_shapes(cfg)["prefill"]
        x = torch.randn(E, C, d, generator=g, device=dev, dtype=bf16)
        wi = torch.randn(E, d, 2 * f, generator=g, device=dev,
                         dtype=bf16).mul_(d ** -0.5)
        wo = torch.randn(E, f, d, generator=g, device=dev,
                         dtype=bf16).mul_(f ** -0.5)
        row("moe_dispatch", arch, f"({E}, {C}, {d}) f {f}",
            lambda: cs.md.grouped_expert_ff(x, wi, wo),
            10 if E * f * d < 2**31 else 3)
        del x, wi, wo
        torch.cuda.empty_cache()
    print(json.dumps({"root": str(root), "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
