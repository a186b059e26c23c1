"""Times the hand-written kernels at the paths' shapes with the kernels and
the timing code of one checkout, to set two checkouts against each other
on one card (run it for each, in turns).

It loads ``<root>/chip_smoke.py`` (which puts ``<root>/src`` first on the
path, so the checkout's own ``repro_torch`` is imported and its kernels
are built into ``<root>/build``) and times with its helpers: CUDA events
around batches of wrapper calls (``_median_ms``) and the profiler's device
time (``_device_ms``, by kernel too), after the ``-Xptxas -v`` registers
and spills of the kernels it builds (``_ptxas_lines``). Inputs are drawn
from ``--seed`` on the card. The groups of rows (``--rows``, all by
default):

  * ``fa``: flash_attention, bf16, causal, 4 x 2048 tokens, at
    granite-3-2b's, olmoe-1b-7b's, jamba's and kimi-k2's heads (head dims
    64, 128, 128, 112);
  * ``expert_fwd``: the expert FF, bf16, every capacity slot filled, at
    olmoe-1b-7b's, jamba's and kimi-k2's prefill shapes (64, 16 and 384
    experts); ``expert_fwd_gu`` the same at olmoe's and jamba's, keeping
    the pre-activation gu for the backward, as training runs it;
  * ``expert_bwd``: the expert FF's backward from the forward's gu at
    olmoe-1b-7b's layer (64, 1280, 2048) f 1024 and jamba-1.5-large's
    (16, 1280, 8192) f 24576, with the counts of a random routing of 4 x
    2048 tokens (``_expert_bwd_inputs``), first held against its plain
    version (on 2 experts where all would not fit); bound 12 FLOP a
    filled row and (d, f) pair;
  * ``scan_fwd``: the selective scan, float32, at jamba's chunk (4, 256,
    16384, 16) from a state, as prefill runs it; ``scan_fwd_states`` the
    same keeping the states for the backward;
  * ``scan_bwd``: the scan's backward there from the forward's states,
    with the last state's gradient, first held against its plain
    version; bound 16 bytes an element;
  * ``fa_decode``: flash_attention at one query row, bf16, non-causal,
    at seamless-m4t's cross-attention at decode (8, 16, 1 x 2048, 64)
    and qwen2-vl's check shape (8, 64 on 8 KV heads, 1 x 4096, 128):
    the checkout's route at Sq = 1 (the decode route, or the tensor
    cores before it); bound the bytes of q, k, v and o;
  * ``expert_decode``: the expert FF at C = 1 with the counts of a
    random routing of the engine's 8 tokens, at olmoe-1b-7b's,
    jamba's and kimi-k2's widths (one layer's experts); bound the live
    experts' weights;
  * ``decode_step``: ``LM.decode_step`` at 8 slots (cache 512, position
    100), olmoe-1b-7b at full width and depth and seamless-m4t-large-v2
    against its encoder's output over 8 x 2048 frames (random weights
    from ``--seed``): the median of 10 host-clock steps ending in a
    sync, and the device's busy ms in one step's trace.

``fa``, ``expert_fwd``, ``scan_fwd`` and the decode groups call only
entry points that checkouts from before the kept gu and states had too,
so they time such a parent as well; the other groups need the kept gu
or states.

    python3 scripts/tc_rows.py --root <checkout> [--rows a,b] [--seed N]
        [--reps N]

Prints the card's name and power limit, one line a row, and a last line
``{"root": ..., "card": ..., "rows": [...]}``. Needs a CUDA device.
"""
import argparse
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

GROUPS = ("fa", "expert_fwd", "expert_fwd_gu", "expert_bwd", "scan_fwd",
          "scan_fwd_states", "scan_bwd", "fa_decode", "expert_decode",
          "decode_step")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--rows", default=",".join(GROUPS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    want = args.rows.split(",")
    if not set(want) <= set(GROUPS):
        ap.error(f"--rows takes some of {GROUPS}")
    root = Path(args.root).resolve()
    spec = importlib.util.spec_from_file_location("checkout_chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = cs   # its dataclasses look their module up
    spec.loader.exec_module(cs)
    torch = cs.torch
    if not torch.cuda.is_available():
        print("tc_rows: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs._smi("name,power.limit").splitlines()[0]
    print(card)
    mods = {"fa": [cs.fa], "expert_fwd": [cs.md], "expert_fwd_gu": [cs.md],
            "expert_bwd": [cs.md, cs.mb], "scan_fwd": [cs.ss],
            "scan_fwd_states": [cs.ss], "scan_bwd": [cs.ss, cs.sb],
            "fa_decode": [cs.fa], "expert_decode": [cs.md],
            "decode_step": [cs.rn, cs.fa, cs.md, cs.mc]}
    # each module's kernels: the decode routes' where the checkout has them
    kernels = [k for m in dict.fromkeys(m for w in want for m in mods[w])
               for k in (m.KERNEL, getattr(m, "DECODE_KERNEL", None)) if k]
    for k in kernels:
        so, secs = k.build()
        print(f"build {k.kind} {so.name[:12]} nvcc {secs:.1f} s")
        for line in cs._ptxas_lines(k):
            print(f"ptxas {line}")
    g = torch.Generator(dev).manual_seed(args.seed)
    B, S = cs.PREFILL_B, cs.PREFILL_S
    bf16 = torch.bfloat16
    cuts = {cs.LM_ARCH: {}, cs.MOE_ARCH: {}, cs.HYBRID_ARCH: cs.HYBRID_CUT,
            cs.KIMI_ARCH: cs.KIMI_CUT}
    rows = []

    def row(kernel, arch, shape, fn, batch, ops=None, nbytes=None,
            rate=None, err=None):
        ms = cs._median_ms(fn, args.reps, batch)
        dev_ms, by_kernel, _ = cs._device_ms(fn, 2 * batch)
        bound = None
        if ops is not None:
            bound = max(ops / rate, nbytes / cs.HBM_BYTES_PER_S) * 1e3
        rows.append({"kernel": kernel, "arch": arch, "shape": shape,
                     "ms": ms, "device_ms": dev_ms,
                     "device_ms_by_kernel": by_kernel, "bound_ms": bound,
                     "max_rel_err": err})
        print(f"{kernel} {arch} {shape}: {ms:.4f} ms, device "
              + ("not measured" if dev_ms is None else f"{dev_ms:.4f} ms")
              + ("" if bound is None else
                 f", bound {bound:.4f} ms, share {bound / ms:.3f}")
              + ("" if err is None else f", vs plain {err:.3g}")
              + "".join(f"; {k} {v:.4f}" for k, v in by_kernel.items()))

    def rel_err(got, want_):
        return max(float((a.float() - b.float()).abs().max()
                         / b.float().abs().max().clamp_min(1e-30))
                   for a, b in zip(got, want_))

    if "fa" in want:
        for arch, cut in cuts.items():
            cfg = dataclasses.replace(cs.get_config(arch), **cut)
            q, k, v = cs._qkv(g, dev, cfg, B, S, bf16)
            row("flash_attention", arch,
                f"({B}, {cfg.n_heads}, {S}, {cfg.head_dim}) kv "
                f"{cfg.n_kv_heads} causal",
                lambda: cs.fa.flash_attention(q, k, v, causal=True), 10)
            del q, k, v
    for arch in (cs.MOE_ARCH, cs.HYBRID_ARCH, cs.KIMI_ARCH):
        kept = [w for w in ("expert_fwd", "expert_fwd_gu", "expert_bwd")
                if w in want and (w == "expert_fwd" or arch != cs.KIMI_ARCH)]
        if not kept:
            continue
        cfg = dataclasses.replace(cs.get_config(arch), **cuts[arch])
        E, d, f = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
        C = cs._moe_shapes(cfg)["prefill"]
        wi = torch.randn(E, d, 2 * f, generator=g, device=dev,
                         dtype=bf16).mul_(d ** -0.5)
        wo = torch.randn(E, f, d, generator=g, device=dev,
                         dtype=bf16).mul_(f ** -0.5)
        batch = 10 if E * f * d < 2**31 else 3
        if "expert_fwd" in kept or "expert_fwd_gu" in kept:
            x = torch.randn(E, C, d, generator=g, device=dev, dtype=bf16)
            if "expert_fwd" in kept:
                row("moe_dispatch", arch, f"({E}, {C}, {d}) f {f}",
                    lambda: cs.md.grouped_expert_ff(x, wi, wo), batch)
            if "expert_fwd_gu" in kept:
                gu = torch.empty(E, C, 2 * f, dtype=bf16, device=dev)
                row("moe_dispatch with gu", arch, f"({E}, {C}, {d}) f {f}",
                    lambda: cs.md.grouped_expert_ff(x, wi, wo, None, gu),
                    batch)
                del gu
            del x
        if "expert_bwd" in kept:
            x, dy, counts = cs._expert_bwd_inputs(g, dev, cfg, E)
            filled = int(counts.sum())
            gu = torch.empty(E, C, 2 * f, dtype=bf16, device=dev)
            cs.md.grouped_expert_ff(x, wi, wo, counts, gu)
            k = 2 if E > 32 or d * f > 2**26 else E
            err = rel_err(
                cs.mb.grouped_expert_ff_bwd(x[:k], wi[:k], wo[:k], dy[:k],
                                            counts[:k], gu[:k]),
                cs.mb.grouped_expert_ff_bwd_plain(x[:k], wi[:k], wo[:k],
                                                  dy[:k], counts[:k]))
            torch.cuda.empty_cache()
            row("expert FF bwd", arch, f"({E}, {C}, {d}) f {f}, {filled} "
                f"rows", lambda: cs.mb.grouped_expert_ff_bwd(
                    x, wi, wo, dy, counts, gu), 3, 12 * filled * d * f,
                2 * (3 * E * C * d + 2 * E * d * 2 * f + 2 * E * f * d),
                cs.BF16_OPS_PER_S, err)
            del x, dy, gu
        del wi, wo
        torch.cuda.empty_cache()
    if "fa_decode" in want:
        for name in ("cross_decode", "cross_decode_d128"):
            B, H, Hkv, Sq, Sk, D = cs.CROSS_FWD[name]
            q, k, v = cs._cross_qkv(g, dev, B, H, Hkv, Sq, Sk, D)
            err = rel_err([cs.fa.flash_attention(q, k, v, causal=False)],
                          [cs.fa.flash_attention_plain(q, k, v,
                                                       causal=False)])
            row("flash_attention", name, [B, H, Hkv, Sq, Sk, D],
                lambda: cs.fa.flash_attention(q, k, v, causal=False), 10,
                4 * B * H * D * Sk, 2 * (2 * B * H * D + 2 * B * Hkv * Sk
                                         * D), cs.BF16_OPS_PER_S, err)
            del q, k, v
    if "expert_decode" in want:
        for arch in (cs.MOE_ARCH, cs.HYBRID_ARCH, cs.KIMI_ARCH):
            cfg = cs.get_config(arch)
            E, d, f = cfg.moe_experts, cfg.d_model, cfg.moe_d_ff
            wi, wo = cs._expert_weights(g, dev, E, d, f)
            counts = cs._sim_counts(g, dev, cfg, cs.SERVE_SLOTS, 1)
            x = torch.randn(E, 1, d, generator=g, device=dev, dtype=bf16)
            live = int((counts > 0).sum())
            k = min(E, 32)      # the plain version k experts a call
            got = cs.md.grouped_expert_ff(x, wi, wo, counts)
            err = rel_err(
                [got[a:a + k] for a in range(0, E, k)],
                [cs.md.grouped_expert_ff_plain(
                    x[a:a + k], wi[a:a + k], wo[a:a + k],
                    counts[a:a + k].contiguous()) for a in range(0, E, k)])
            row("moe_dispatch", arch, f"({E}, 1, {d}) f {f}, {live} "
                "experts live", lambda: cs.md.grouped_expert_ff(
                    x, wi, wo, counts), 10 if E * f * d < 2**31 else 3,
                6 * live * d * f, 2 * (live * 3 * d * f + live * d + E * d),
                cs.BF16_OPS_PER_S, err)
            del wi, wo, x
            torch.cuda.empty_cache()
    if "decode_step" in want:
        for arch in (cs.MOE_ARCH, cs.ENCDEC_ARCH):
            cfg = cs.get_config(arch)
            model, params = cs._init(dev, cfg, args.seed)
            enc = None
            if cfg.enc_dec:
                frames = torch.randn(cs.ENC_B, cs.ENC_S, cfg.d_model,
                                     generator=g, device=dev).bfloat16()
                with torch.no_grad():
                    enc = model._encode(params, frames)
            cache = model.init_cache(cs.SERVE_SLOTS, cs.SERVE_MAX_SEQ,
                                     device=dev)
            toks = torch.randint(0, cfg.vocab, (cs.SERVE_SLOTS, 1),
                                 generator=g, device=dev)
            pos = torch.full((cs.SERVE_SLOTS,), 100, device=dev)

            def step():
                with torch.no_grad():
                    return model.decode_step(params, cache, toks, pos, enc)

            for _ in range(3):
                cs._sync_s(step)
            ms = sorted(cs._sync_s(step)[1] * 1e3 for _ in range(10))
            busy, _, _ = cs._device_ms(step, 3)
            rows.append({"kernel": "decode_step", "arch": arch,
                         "shape": [cs.SERVE_SLOTS, cs.SERVE_MAX_SEQ],
                         "ms": (ms[4] + ms[5]) / 2, "ms_all": ms,
                         "device_ms": busy})
            print(f"decode_step {arch} {cs.SERVE_SLOTS} slots: median "
                  f"{(ms[4] + ms[5]) / 2:.2f} ms (min {ms[0]:.2f}, max "
                  f"{ms[-1]:.2f}), device busy "
                  + ("not measured" if busy is None else f"{busy:.2f} ms"))
            del model, params, cache, enc
            torch.cuda.empty_cache()
    if not {"scan_fwd", "scan_fwd_states", "scan_bwd"} & set(want):
        print(json.dumps({"root": str(root), "card": card, "rows": rows}))
        return 0
    cfg = cs.get_config(cs.HYBRID_ARCH)
    shape = (cs.TRAIN_B, cfg.ssm_chunk, cfg.ssm_d_inner, cfg.ssm_d_state)
    Bs, Ss, d, n = shape
    dA, dBx, Cm = cs._scan_inputs(g, dev, shape, torch.float32)
    h = torch.zeros(Bs, d, n, device=dev)
    if "scan_fwd" in want:
        row("selective_scan", cs.HYBRID_ARCH, list(shape),
            lambda: cs.ss.selective_scan(dA, dBx, Cm, h), 10)
    if "scan_fwd_states" in want or "scan_bwd" in want:
        states = torch.empty(cs.ss.states_shape(*shape), device=dev)
    if "scan_fwd_states" in want:
        row("selective_scan with states", cs.HYBRID_ARCH, list(shape),
            lambda: cs.ss.selective_scan(dA, dBx, Cm, h, states), 10)
    if "scan_bwd" in want:
        h0 = torch.randn(Bs, d, n, generator=g, device=dev)
        dy = torch.randn(Bs, Ss, d, generator=g, device=dev)
        dh = torch.randn(Bs, d, n, generator=g, device=dev)
        cs.ss.selective_scan(dA, dBx, Cm, h0.clone(), states)
        args_b = (dA, dBx, Cm, h0, dy, dh, states)
        err = rel_err(cs.sb.selective_scan_bwd(*args_b),
                      cs.sb.selective_scan_bwd_plain(*args_b[:6]))
        el = dA.numel()
        small = Cm.numel() * 2 + dy.numel() + 3 * h0.numel()
        row("selective_scan_bwd", cs.HYBRID_ARCH, list(shape),
            lambda: cs.sb.selective_scan_bwd(*args_b), 3, 8 * el,
            4 * (4 * el + small), cs.F32_OPS_PER_S, err)
    print(json.dumps({"root": str(root), "card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
