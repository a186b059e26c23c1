"""The train step (port of ``repro.train.train_step``).

``build_train_step(model, step_cfg)`` returns ``step(params, opt_state,
batch) -> (params, opt_state, metrics)``: the loss and its gradient by
autograd (``LM.loss_fn``, whose RMSNorms and attentions run the port's
kernels and their backward kernels on CUDA tensors), then AdamW, which
updates params and moments in place. Gradient accumulation over
``microbatches`` is a Python loop where the reference has ``lax.scan``,
with the same float32 sums and averaging. Each batch leaf is split along
its batch axis: axis 0, but axis 1 of ``mrope_positions`` (3, B, S),
whose axis 0 holds the three M-RoPE components. The reference reshapes
axis 0 of every leaf and so cannot split a VLM batch (ROADMAP C17).

The reference's sharded builders keep their names, so that a reader
finds them, but nothing is jitted: ``jit_train_step``,
``jit_prefill_step`` and ``jit_decode_step`` return ``(step,
shardings)``, the step one rank's Python function over its shards and
the shardings the ``PSpec`` trees its arguments follow
(``param_sharding_tree`` gives the same as ``torch.distributed.tensor``
placements). The sharded train step (``distributed/context.py`` has the
gradient convention):

  * each rank takes its local batch (``input_shardings``' batch axes) and
    its local params and moments (``shard_params``);
  * the loss's numerator and token count are summed over the data axes
    (``LM.loss_fn`` under the context), and each rank back-propagates the
    global loss over the world's size;
  * the fsdp-gathered leaves' gradients are reduce-scattered by autograd;
    every leaf's gradient is then summed over the axes that replicate it
    (the data axes for a data-replicated leaf), once, after the
    microbatches;
  * AdamW runs on the shards, with the global grad norm.

The step's spans (``tracing``): ``train.step`` around it,
``train.forward`` around the loss, ``train.backward`` around its
gradient (autograd's backward, which on the card runs on autograd's own
thread while this one waits), and ``train.optimizer`` around the
gradients' sum over replicas and AdamW, with ``train.grad_norm`` around
the global norm.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from .. import tracing
from ..launch.mesh import data_axes, mesh_axis_sizes
from ..models.blueprint import PSpec, placements, tree_map
from ..models.registry import batch_spec, input_shardings
from .optimizer import AdamWConfig, adamw_update, leaves


@dataclass
class StepConfig:
    microbatches: int = 1
    remat: bool = True
    opt: AdamWConfig = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.opt is None:
            self.opt = AdamWConfig()


def value_and_grad(model, params, batch: Dict[str, torch.Tensor], *,
                   remat: bool, scale: float = 1.0
                   ) -> Tuple[torch.Tensor, Any]:
    """(loss, grads) of ``model.loss_fn`` at params: grads a tree of the
    params' structure, each leaf in its param's dtype, zeros for a leaf
    the loss does not read (the mLSTM's ``norm``, as ``jax.grad`` gives).
    params are not changed; autograd runs on detached aliases of them.
    ``scale``: the gradients are those of loss * scale (a sharded step's
    1 / world)."""
    ps = tree_map(lambda a: a.detach().requires_grad_(), params)
    with torch.enable_grad():
        with tracing.span("train.forward"):
            loss = model.loss_fn(ps, batch, remat=remat)
        with tracing.span("train.backward"):
            gs = iter(torch.autograd.grad(
                loss if scale == 1.0 else loss * scale, leaves(ps),
                materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(gs), params)


#: batch leaves whose batch axis is not axis 0
BATCH_AXIS = {"mrope_positions": 1}


def microbatch(batch: Dict[str, torch.Tensor], n: int, i: int
               ) -> Dict[str, torch.Tensor]:
    """The i-th of n equal microbatches of ``batch``, each leaf split
    along its batch axis (``BATCH_AXIS``, else 0)."""
    out = {}
    for k, v in batch.items():
        ax = BATCH_AXIS.get(k, 0)
        out[k] = v.unflatten(ax, (n, v.shape[ax] // n)).select(ax, i)
    return out


def build_train_step(model, step_cfg: StepConfig, ctx=None):
    """-> step(params, opt_state, batch) -> (params, opt_state, metrics),
    metrics holding 0-d tensors ``loss``, ``grad_norm`` and ``lr``.
    ``ctx``: one rank's step of a sharded run (the module's docstring;
    ``jit_train_step`` builds it)."""
    if ctx is not None:
        model = model.sharded(ctx)
    scale = 1.0 if ctx is None else 1.0 / ctx.size(ctx.axes)

    def step(params, opt_state, batch):
        with tracing.span("train.step"):
            return _step(params, opt_state, batch)

    def _step(params, opt_state, batch):
        n = step_cfg.microbatches
        if n > 1:
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=p.device), params)
            loss = None
            for i in range(n):
                l, g = value_and_grad(model, params,
                                      microbatch(batch, n, i),
                                      remat=step_cfg.remat, scale=scale)
                tree_map(lambda a, b: a.add_(b), acc, g)
                loss = l if loss is None else loss + l
            grads = tree_map(lambda a: a / n, acc)
            loss = loss / n
        else:
            loss, grads = value_and_grad(model, params, batch,
                                         remat=step_cfg.remat, scale=scale)
        gn = None
        with tracing.span("train.optimizer"):
            if ctx is not None:
                grads = ctx.sum_replicas(grads)
                with tracing.span("train.grad_norm"):
                    gn = ctx.global_norm(grads)
            params, opt_state, metrics = adamw_update(
                params, grads, opt_state, step_cfg.opt, grad_norm=gn)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return step


# --------------------------------------------------------------------------
# the sharded builders (the reference's names; nothing is jitted)
# --------------------------------------------------------------------------

def make_step_ctx(model, mesh, shape_name: str,
                  rules: Optional[Dict] = None):
    """The model's sharding context on ``mesh`` for one (arch x shape)
    cell: the batch split over the data axes where the shape's global
    batch divides them; a decode cache whose kv heads do not divide the
    model axis split on its sequence (``input_shardings``); a train or
    prefill step's residual stream split on S over the model axis where
    the config sets ``seq_shard_activations``."""
    from ..configs.base import SHAPES
    from ..distributed.context import as_axes, make_ctx
    ctx = make_ctx(model, mesh, rules)
    da = data_axes(mesh)
    bspec = batch_spec(shape_name, da, mesh_axis_sizes(mesh))
    seq = ()
    m = mesh_axis_sizes(mesh).get("model", 1)
    kind = SHAPES[shape_name].kind
    if kind in ("decode", "long_decode") and model.cfg.n_kv_heads % m:
        seq = ("model",) if bspec is not None else da + ("model",)
    sp = _sp_axes(model, mesh) if kind in ("train", "prefill") else ()
    return ctx.with_step(batch=as_axes(bspec), seq=seq, sp=sp)


def _sp_axes(model, mesh) -> tuple:
    """The axes the residual's S is split on: the model axis where the
    config sets ``seq_shard_activations`` and the axis has ranks."""
    m = mesh_axis_sizes(mesh).get("model", 1)
    return ("model",) if model.cfg.seq_shard_activations and m > 1 else ()


def data_parallel_ctx(model, mesh, global_batch: int,
                      rules: Optional[Dict] = None):
    """The model's sharding context on ``mesh`` for a train step over
    batches of ``global_batch`` rows split evenly over the mesh's data
    axes (``train_loop``'s step; a named shape's is ``make_step_ctx``).
    ``ValueError`` where the data axes do not divide the batch."""
    from ..distributed.context import make_ctx
    da = data_axes(mesh)
    n = math.prod(mesh_axis_sizes(mesh)[a] for a in da)
    if global_batch % n:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over the data axes {da} of {n} ranks")
    return make_ctx(model, mesh, rules).with_step(
        batch=da, sp=_sp_axes(model, mesh))


def param_sharding_tree(model, mesh, rules: Optional[Dict] = None):
    """Each leaf's ``torch.distributed.tensor`` placements on ``mesh``
    (``blueprint.placements`` of its spec)."""
    from ..distributed.context import make_ctx
    ctx = make_ctx(model, mesh, rules)
    return tree_map(lambda sp: placements(sp, mesh), ctx.specs)


def opt_state_shardings(param_sh, mesh):
    return {"step": placements(PSpec(), mesh), "m": param_sh,
            "v": param_sh}


def shard_params(params, mesh, model, rules: Optional[Dict] = None):
    """A whole tree of the blueprint's structure (params, or AdamW's m
    or v) -> this rank's contiguous shards."""
    from ..distributed.context import make_ctx
    return make_ctx(model, mesh, rules).shard_tree(params)


def shard_batch(batch: Dict[str, Any], ctx, specs: Dict[str, Any]):
    """The global batch's leaves -> this rank's (``input_shardings``'
    specs; leaves it has no spec for whole)."""
    return tree_map(lambda t, s: ctx.shard(t, s).contiguous(),
                    {k: batch[k] for k in specs if k in batch},
                    {k: specs[k] for k in specs if k in batch})


def shard_rows(batch: Dict[str, Any], ctx):
    """The global batch's leaves -> this rank's rows: each leaf split over
    the context's batch axes along its batch axis (``BATCH_AXIS``, else
    0)."""
    return {k: ctx.shard(v, PSpec(*(None,) * BATCH_AXIS.get(k, 0),
                                  ctx.batch)).contiguous()
            for k, v in batch.items()}


def jit_train_step(model, mesh, step_cfg: StepConfig, shape_name: str,
                   rules: Optional[Dict] = None):
    """One rank's sharded train step (nothing is jitted) -> (step, (param
    specs, opt-state specs, batch specs)); step(params, opt, batch) over
    this rank's shards -> (params, opt, metrics), the metrics global."""
    ctx = make_step_ctx(model, mesh, shape_name, rules)
    psh = ctx.specs
    osh = {"step": PSpec(), "m": psh, "v": psh}
    bsh = input_shardings(model.cfg, shape_name, data_axes(mesh),
                          mesh_axis_sizes(mesh))
    return build_train_step(model, step_cfg, ctx), (psh, osh, bsh)


def jit_prefill_step(model, mesh, shape_name: str,
                     rules: Optional[Dict] = None):
    """-> (prefill, (param specs, batch specs)); prefill(params, batch)
    returns this rank's last-position logits (its batch rows, its vocab
    columns: the reference's ``P(None, "model")``)."""
    ctx = make_step_ctx(model, mesh, shape_name, rules)
    smodel = model.sharded(ctx)
    bsh = input_shardings(model.cfg, shape_name, data_axes(mesh),
                          mesh_axis_sizes(mesh))

    def prefill(params, batch):
        return smodel.prefill(params, batch["tokens"])

    return prefill, (ctx.specs, bsh)


def jit_decode_step(model, mesh, shape_name: str,
                    rules: Optional[Dict] = None):
    """serve_step: one token for every sequence in the batch -> (step,
    (param specs, batch specs)); step(params, batch) -> (this rank's
    logits, its cache updated in place)."""
    ctx = make_step_ctx(model, mesh, shape_name, rules)
    smodel = model.sharded(ctx)
    bsh = input_shardings(model.cfg, shape_name, data_axes(mesh),
                          mesh_axis_sizes(mesh))

    def serve_step(params, batch):
        return smodel.decode_step(params, batch["cache"], batch["tokens"],
                                  batch["pos"], batch.get("enc_out"))

    return serve_step, (ctx.specs, bsh)
