"""The training loop with the reference's fault tolerance (port of
``repro.train.loop``):

  * auto-resume from the latest checkpoint;
  * periodic and preemption-signal checkpointing (SIGTERM handler);
  * straggler watchdog: an EWMA of each step's wall time; a step slower
    than ``straggler_factor`` times the EWMA is recorded with its host;
  * deterministic restart: (seed, step)-addressed data, and kernels whose
    backward sums in a fixed order, so a resumed run repeats the losses
    of an uninterrupted one bit for bit;
  * a crash injection hook for tests (``fail_at_step``).

It runs on the card unless ``device`` says otherwise. Fresh params come
from ``init_params`` with a ``torch.Generator`` on the device seeded from
``DataConfig.seed`` (the reference uses ``PRNGKey(0)``); params that the
caller passes are trained in place. A step's time is the host clock
around the step, which ends when its loss is read back.

With a ``mesh`` (``launch/mesh.py``) each rank runs the sharded step
(``train_step.build_train_step`` with ``data_parallel_ctx``): it holds
its shards of the params and moments (of fresh params drawn whole from
the seed on every rank, of the caller's params, or of a checkpoint) and
its rows of each global batch, which the mesh's data axes must divide.
Checkpoints stay in the reference's format: every rank gathers the whole
leaves, rank 0 writes them, and each rank reads its shard back, so a run
resumes onto another mesh, or onto one device (the reference's "elastic"
resume).
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.blueprint import init_params
from .checkpoint import CheckpointManager
from .data import DataConfig, Prefetcher
from .optimizer import init_opt_state
from .train_step import (StepConfig, build_train_step, data_parallel_ctx,
                         shard_rows)


def _moments(fn, opt_state) -> dict:
    """AdamW's state with ``fn`` applied to both moment trees."""
    return {"step": opt_state["step"], "m": fn(opt_state["m"]),
            "v": fn(opt_state["v"])}


def _save(mgr: CheckpointManager, step: int, params, opt_state, ctx
          ) -> None:
    """A checkpoint of the whole leaves: with a context every rank
    gathers them and rank 0 writes."""
    if ctx is not None:
        params = ctx.unshard_tree(params)
        opt_state = _moments(ctx.unshard_tree, opt_state)
        if dist.get_rank() != 0:
            return
    mgr.save(step, params, opt_state, extra={"data_step": step})


@dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    log_every: int = 10
    straggler_factor: float = 3.0
    fail_at_step: Optional[int] = None    # test hook: simulated crash


@dataclass
class LoopResult:
    steps_done: int
    losses: List[float] = field(default_factory=list)
    straggler_events: List[Dict[str, Any]] = field(default_factory=list)
    resumed_from: Optional[int] = None
    #: each step's grad norm and wall ms, beside ``losses``
    grad_norms: List[float] = field(default_factory=list)
    step_ms: List[float] = field(default_factory=list)
    #: this process's rank (0 without a mesh)
    rank: int = 0


def train_loop(model, data_cfg: DataConfig, loop_cfg: LoopConfig,
               step_cfg: StepConfig, ckpt_dir: str,
               params: Optional[Any] = None, device=None,
               mesh=None) -> LoopResult:
    """Run (or resume) training. Params are initialized fresh where no
    checkpoint exists and none are passed. ``mesh``: the sharded step on
    it (the module's docstring); the result's losses are the global
    batch's on every rank."""
    dev = resolve_device(device)
    mgr = CheckpointManager(ckpt_dir)
    if mesh is None:
        ctx, step_fn = None, build_train_step(model, step_cfg)
    else:
        ctx = data_parallel_ctx(model, mesh, data_cfg.global_batch)
        step_fn = build_train_step(model, step_cfg, ctx)
    lead = ctx is None or dist.get_rank() == 0

    resumed_from = None
    start_step = 0
    if mgr.latest_step() is not None:
        bp = model.blueprint()
        params, opt_state, extra = mgr.restore(
            (bp, {"step": None, "m": bp, "v": bp}), device=dev)
        start_step = int(extra.get("data_step", mgr.latest_step()))
        resumed_from = mgr.latest_step()
        if ctx is not None:
            params = ctx.shard_tree(params)
            opt_state = _moments(ctx.shard_tree, opt_state)
    else:
        if params is None:
            params = init_params(model.blueprint(), torch.Generator(
                dev).manual_seed(data_cfg.seed))
        if ctx is not None:
            params = ctx.shard_tree(params)
        opt_state = init_opt_state(params, step_cfg.opt)

    # preemption: checkpoint on SIGTERM and exit cleanly
    preempted = {"flag": False}

    def _on_term(signum, frame):
        preempted["flag"] = True

    old_handler = signal.signal(signal.SIGTERM, _on_term)

    result = LoopResult(steps_done=start_step, resumed_from=resumed_from,
                        rank=0 if ctx is None else dist.get_rank())
    pre = Prefetcher(data_cfg, start_step=start_step)
    ewma = None
    try:
        for s in range(start_step, loop_cfg.total_steps):
            if loop_cfg.fail_at_step is not None and s == loop_cfg.fail_at_step:
                raise RuntimeError(f"injected failure at step {s}")
            t0 = time.perf_counter()
            ds, batch = pre.next()
            if ds != s:
                raise RuntimeError(f"data stream desync {ds} != {s}")
            tbatch = {k: torch.from_numpy(v).to(dev)
                      for k, v in batch.items()}
            if ctx is not None:
                tbatch = shard_rows(tbatch, ctx)
            params, opt_state, metrics = step_fn(params, opt_state, tbatch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            result.losses.append(loss)
            result.grad_norms.append(float(metrics["grad_norm"]))
            result.step_ms.append(dt * 1e3)
            ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
            if dt > loop_cfg.straggler_factor * ewma and s > start_step + 3:
                result.straggler_events.append(
                    {"step": s, "dt": dt, "ewma": ewma,
                     "host": data_cfg.host_id})
            if lead and loop_cfg.log_every and s % loop_cfg.log_every == 0:
                print(f"[train] step={s} loss={loss:.4f} dt={dt*1e3:.0f}ms",
                      flush=True)
            result.steps_done = s + 1
            if ctx is not None:     # a signal to any rank stops them all
                preempted["flag"] = bool(ctx.rmax(torch.tensor(
                    float(preempted["flag"]), device=dev), ctx.axes))
            if (s + 1) % loop_cfg.ckpt_every == 0 or preempted["flag"]:
                _save(mgr, s + 1, params, opt_state, ctx)
            if preempted["flag"]:
                print("[train] preemption checkpoint written, exiting",
                      flush=True)
                break
    finally:
        pre.stop()
        signal.signal(signal.SIGTERM, old_handler)
    return result
