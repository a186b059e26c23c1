"""Prints, for every config the port runs, at smoke size (the parity
tests' params, cut and tokens), how far the port's whole model is from
the JAX package's, and how far one bf16 ulp of noise moves the port from
itself: the measurement behind ROADMAP C15.

For each config: the largest |logit| gap of prefill and of 6 decode
steps (xlstm-1.3b: every position against its decode recurrence,
chained), the loss gap, the largest relative L2 gradient error of a leaf
(against ``tests/test_torch_archs_train.py``'s oracle), and the same
gaps between the port and itself when a tenth of the embedding's entries
are moved by one bf16 ulp. A gap at or under the port's own is bf16
noise, not a fault.

Run from the repo root on the CPU (a few minutes):

    PYTHONPATH=src:tests python tests/arch_parity_report.py [arch ...]
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import test_torch_archs as TA
import test_torch_archs_train as TT
from repro_torch.models import layers as PL
from repro_torch.train.train_step import value_and_grad


def _noisy(params):
    """params with a tenth of the embedding's entries one ulp up."""
    e = params["embed"].clone()
    mask = torch.rand(e.shape, generator=torch.Generator().manual_seed(0)
                      ) < 0.1
    e[mask] = (e[mask].float() * (1 + 2 ** -8)).bfloat16()
    return {**params, "embed": e}


def _logits(arch, model, params, toks):
    """(prefill logits at the last position, or every position for
    xlstm; decode logits of 6 steps)."""
    T = torch.from_numpy(toks).long()
    if arch == "xlstm-1.3b":
        x = params["embed"][T].to(torch.bfloat16)
        x, _ = model._run_stack(params["stack"], x,
                                torch.arange(T.shape[1])[None, :],
                                kinds=model.period, causal=True)
        pre = (PL.rmsnorm(params["ln_f"], x) @ model._unembed(params)).float()
    else:
        pre = model.prefill(params, T)
    cache = model.init_cache(T.shape[0], 16, device="cpu")
    dec = []
    for t in range(6):
        lg, cache = model.decode_step(params, cache, T[:, t:t + 1],
                                      torch.full((T.shape[0],), t))
        dec.append(lg[:, 0])
    return pre, torch.stack(dec, 1)


def _ref_logits(arch, ref, rp, toks):
    if arch == "xlstm-1.3b":   # its decode recurrence, every position
        every = np.asarray(jax.jit(TA._ref_teacher_forced(arch))(
            rp, jnp.array(toks)))
        return every, every[:, :6]
    pre = np.asarray(ref.prefill(rp, jnp.array(toks)))
    cache = ref.init_cache(toks.shape[0], 16)
    dec = []
    for t in range(6):
        pos = jnp.full((toks.shape[0],), t, jnp.int32)
        if arch == "command-r-plus-104b":
            dec.append(np.asarray(ref.prefill(rp, jnp.array(toks[:, :t + 1]))))
            continue
        lg, cache = ref.decode_step(rp, cache, jnp.array(toks[:, t:t + 1]),
                                    pos)
        dec.append(np.asarray(lg)[:, 0])
    return pre, np.stack(dec, 1)


def _gap(a, b, vocab):
    a = a.numpy() if isinstance(a, torch.Tensor) else a
    b = b.numpy() if isinstance(b, torch.Tensor) else b
    return float(np.abs(a[..., :vocab] - b[..., :vocab]).max())


def report(arch):
    cfg, ref, rp, model, params, toks = TA.carried(arch)
    noisy = _noisy(params)
    pre, dec = _logits(arch, model, params, toks)
    npre, ndec = _logits(arch, model, noisy, toks)
    rpre, rdec = _ref_logits(arch, ref, rp, toks)
    row = {"prefill": (_gap(pre, rpre, cfg.vocab),
                       _gap(pre, npre, cfg.vocab)),
           "decode": (_gap(dec, rdec, cfg.vocab),
                      _gap(dec, ndec, cfg.vocab))}
    if arch in TT.TRAIN:
        (wl, _), (gl, got) = TT.both(arch)
        tk = torch.from_numpy(TT.tokens(arch))
        nl, ng = value_and_grad(model, noisy, {"tokens": tk}, remat=True)
        errs = TT.grad_errors(arch)
        worst = max(errs, key=errs.get)
        self_err = {}
        for k, g in TT._paths(ng).items():
            a = got[k]
            if a.any() and k != "/embed":
                self_err[k] = float(np.linalg.norm(g.float().numpy() - a)
                                    / np.linalg.norm(a))
        sw = max(self_err, key=self_err.get)
        row["loss"] = (abs(gl - wl), abs(float(nl) - gl))
        row["grad"] = ((round(errs[worst], 4), worst),
                       (round(self_err[sw], 4), sw))
    return row


if __name__ == "__main__":
    for arch in sys.argv[1:] or TA.RUN:
        print(arch, "(port vs reference, port vs itself with one-ulp "
              "noise):", report(arch), flush=True)
