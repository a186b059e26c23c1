"""The MoE layer's combine as ``models/moe.py:moe_ff`` composed it before
the gather took the gate weights and the casts, kept as the yardstick of
bit-for-bit tests on the CPU and on the card: ``y.float() * wtable`` over
every slot, the float32 gather, the cast to the output's dtype, autograd
through the product and the casts. Imports no JAX."""
import numpy as np
import torch

from repro_torch.kernels.moe_dispatch import moe_combine as MC
from repro_torch.models import moe as PM


class CombineBefore:
    """Stands in for ``moe.py``'s ``_Combine`` (same ``apply``
    arguments) with the composition it replaced."""

    class _Gather(torch.autograd.Function):
        @staticmethod
        def forward(ctx, yw, table, slots):
            ctx.save_for_backward(table)
            return MC.gather_sum(yw, slots)

        @staticmethod
        def backward(ctx, dout):
            table, = ctx.saved_tensors
            return PM._take(dout, table), None, None

    @classmethod
    def apply(cls, y, wtable, table, slots, out_dtype):
        yw = y.float() * wtable[:, None]
        return cls._Gather.apply(yw, table, slots).to(out_dtype)


def moe_ff_and_grads(p, x, dtype, cf, kw, device="cpu"):
    """``moe_ff``'s output, its aux loss and the gradients of x and every
    leaf, in ``dtype`` on ``device``, under a loss that weighs the output
    (a numpy seed's weights) and the aux loss; x is a numpy array."""
    ps = {key: v.detach().to(device, dtype).requires_grad_()
          for key, v in p.items()}
    xs = torch.from_numpy(x).to(device, dtype).requires_grad_()
    w = torch.from_numpy(np.random.default_rng(3).standard_normal(x.shape)
                         .astype(np.float32)).to(device)
    out, aux = PM.moe_ff(ps, xs, capacity_factor=cf, **kw)
    ((out.float() * w).sum() + 0.5 * aux).backward()
    return out.detach(), aux.detach(), {"x": xs.grad,
                                        **{k: v.grad for k, v in ps.items()}}
