"""Ranks of the port's distribution tests (``tests/test_torch_distributed.py``).

Each rank joins a gloo world on the CPU, runs every task it is given in
turn and writes its results to ``<workdir>/rank<r>.pt``; rank 0 also
runs the one-device references and records the differences. Imports
torch and the port only (no JAX), so that each rank starts quickly.
"""
from __future__ import annotations

import datetime
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

#: the test's configs (smoke size) for the train-step checks
TRAIN_ARCHS = ("granite-3-2b", "olmoe-1b-7b", "command-r-plus-104b",
               "qwen2-vl-72b", "seamless-m4t-large-v2")
SERVE_ARCHS = ("granite-3-2b", "olmoe-1b-7b", "seamless-m4t-large-v2")
MESHES = ((2, 2), (1, 4))
B, S, FRAMES = 8, 32, 16
DEC_LEN, DEC_STEPS, PRE_S = 12, 6, 24


def _paths(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{path}/{k}"))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, f"{path}/{i}"))
        return out
    return {path: tree}


def _rel(a, b) -> float:
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


def granite_params(workdir: Path, model):
    """The smoke granite's params from the test's numpy draw (the JAX
    subprocess reads the same file), leaf by leaf in blueprint order."""
    from repro_torch.models.blueprint import tree_map
    arrays = np.load(workdir / "params.npz")
    bp = model.blueprint()
    names = iter(_paths(bp))
    return tree_map(lambda l: torch.from_numpy(np.array(
        arrays[npz_key(next(names))], copy=True)).to(l.dtype), bp)


def npz_key(path: str) -> str:
    return path.strip("/").replace("/", "__")


def _model(arch):
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    return get_model(get_config(arch, smoke=True))


def _params(arch, model, workdir):
    from repro_torch.models.blueprint import init_params
    if arch == "granite-3-2b":
        return granite_params(workdir, model)
    p = init_params(model.blueprint(), torch.Generator().manual_seed(0),
                    device="cpu")
    for layer in p["stack"]:
        if "moe" in layer:
            layer["moe"]["router"].zero_()
    return p


def _batch(cfg, workdir):
    from repro_torch.models.registry import mrope_grid_positions
    toks = torch.from_numpy(np.load(workdir / "batch.npz")["tokens"])
    batch = {"tokens": toks}
    g = torch.Generator().manual_seed(2)
    if cfg.frontend_embeds:
        batch["frontend_embeds"] = torch.randn(
            B, FRAMES, cfg.d_model, generator=g).bfloat16()
    if cfg.pos == "mrope":
        batch["mrope_positions"] = mrope_grid_positions(B, S, 4, 4)
    return batch


def task_gpipe(workdir, rank):
    from repro_torch.distributed.pipeline import make_pipelined_apply
    from repro_torch.launch.mesh import make_mesh
    a = np.load(workdir / "gpipe.npz")
    Ws, xs = torch.from_numpy(a["Ws"]), torch.from_numpy(a["xs"])
    L, d = Ws.shape[0], Ws.shape[1]

    def layer_fn(stage, x):
        for w in stage:
            x = torch.tanh(x @ w)
        return x
    mesh = make_mesh((4,), ("pipe",), "cpu")
    ys = make_pipelined_apply(mesh, layer_fn, xs.shape[0])(
        Ws.reshape(4, L // 4, d, d), xs)
    return {"ys": ys.numpy()}


def task_train(workdir, rank, shape, arch, mb):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.blueprint import leaves, tree_map
    from repro_torch.train.optimizer import AdamWConfig, init_opt_state
    from repro_torch.train.train_step import (StepConfig, build_train_step,
                                              jit_train_step, make_step_ctx,
                                              shard_batch, value_and_grad)
    model = _model(arch)
    cfg = model.cfg
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    params = _params(arch, model, workdir)
    batch = _batch(cfg, workdir)
    scfg = StepConfig(microbatches=mb, remat=True, opt=AdamWConfig(lr=1e-3))
    step, (_, _, bsh) = jit_train_step(model, mesh, scfg, "train_4k")
    ctx = make_step_ctx(model, mesh, "train_4k")
    lb = shard_batch(batch, ctx, bsh)
    # the gradients, sharded then whole
    _, sg = value_and_grad(model.sharded(ctx), ctx.shard_tree(params), lb,
                           remat=True, scale=1.0 / ctx.size(ctx.axes))
    sg = ctx.unshard_tree(ctx.sum_replicas(sg))
    lp = ctx.shard_tree(tree_map(lambda a: a.clone(), params))
    lp, _, met = step(lp, init_opt_state(lp, scfg.opt), lb)
    whole = ctx.unshard_tree(lp)
    out = {"loss": float(met["loss"]), "grad_norm": float(met["grad_norm"])}
    if rank == 0:
        names = list(_paths(params).keys())
        from_zero = {n for n, a in zip(names, leaves(params))
                     if not a.float().any()}
        _, g1 = value_and_grad(model, params, batch, remat=True)
        if arch == "granite-3-2b" and mb == 1:  # for the reference's
            out["grads"] = {npz_key(n): a.float().numpy()
                            for n, a in zip(names, leaves(sg))}
            out["grads_one"] = {npz_key(n): a.float().numpy()
                                for n, a in zip(names, leaves(g1))}
        p1 = tree_map(lambda a: a.clone(), params)
        p1, _, m1 = build_train_step(model, scfg)(
            p1, init_opt_state(p1, scfg.opt), batch)
        out.update(
            loss_one=float(m1["loss"]), grad_norm_one=float(m1["grad_norm"]),
            gerr={n: _rel(a, b) for n, a, b in zip(names, leaves(sg),
                                                    leaves(g1))
                  if b.float().any()},
            perr={n: _rel(a, b) for n, a, b in zip(names, leaves(whole),
                                                    leaves(p1))
                  if n not in from_zero},
            zero_grads=sorted(n for n, b in zip(names, leaves(g1))
                              if not b.float().any()),
            zero_grads_sharded=sorted(n for n, a in zip(names, leaves(sg))
                                      if not a.float().any()))
    return out


def task_serve(workdir, rank, shape, arch):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.blueprint import PSpec, tree_map
    from repro_torch.train.train_step import (jit_decode_step,
                                              jit_prefill_step, make_step_ctx,
                                              shard_batch)
    model = _model(arch)
    cfg = model.cfg
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    params = _params(arch, model, workdir)
    toks = torch.from_numpy(np.load(workdir / "batch.npz")["tokens"])
    toks = toks[:, :PRE_S]
    pre, (_, bsh) = jit_prefill_step(model, mesh, "prefill_32k")
    ctx = make_step_ctx(model, mesh, "prefill_32k")
    lp = ctx.shard_tree(params)
    vax = "model" if ctx.logical("vocab") else None
    logits = ctx.unshard(pre(lp, shard_batch({"tokens": toks}, ctx, bsh)),
                         PSpec(ctx.batch or None, vax))
    dstep, (_, dsh) = jit_decode_step(model, mesh, "decode_32k")
    dctx = make_step_ctx(model, mesh, "decode_32k")
    cache = model.init_cache(B, DEC_LEN, device="cpu")
    lcache = tree_map(lambda t, sp: dctx.shard(t, sp).clone(), cache,
                      dsh["cache"])
    enc = None
    if cfg.enc_dec:
        g = torch.Generator().manual_seed(3)
        enc = torch.randn(B, FRAMES, cfg.d_model, generator=g).bfloat16()
    got = []
    for t in range(DEC_STEPS):
        pos = torch.full((B,), t)
        lb = {"tokens": dctx.shard(toks[:, t:t + 1], dsh["tokens"]),
              "pos": dctx.shard(pos, dsh["pos"]), "cache": lcache}
        if enc is not None:
            lb["enc_out"] = dctx.shard(enc, dsh["enc_out"])
        lo, _ = dstep(lp, lb)
        got.append(dctx.unshard(lo, PSpec(dctx.batch or None, None, vax)))
    out = {"seq": list(dctx.seq),
           "cache_spec": [str(a) for a in dsh["cache"][0]["k"]]}
    if rank == 0:
        if arch == "granite-3-2b":      # for the reference's
            out["prefill"] = logits.float().numpy()
            out["decode"] = torch.stack(got).float().numpy()
        want = model.prefill(params, toks)
        out["prefill_err"] = float((logits - want).abs().max())
        out["prefill_ok"] = bool(torch.allclose(logits, want, atol=0.1,
                                                rtol=0.1))
        rc = model.init_cache(B, DEC_LEN, device="cpu")
        errs, oks = [], []
        for t in range(DEC_STEPS):
            w, _ = model.decode_step(params, rc, toks[:, t:t + 1],
                                     torch.full((B,), t), enc)
            errs.append(float((got[t] - w).abs().max()))
            oks.append(bool(torch.allclose(got[t], w, atol=0.1, rtol=0.1)))
        out["decode_errs"], out["decode_ok"] = errs, all(oks)
    return out


def task_placements(workdir, rank, shape):
    """A few leaves' placements and shards on the mesh."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.train_step import (opt_state_shardings,
                                              param_sharding_tree,
                                              shard_params)
    model = _model("granite-3-2b")
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    psh = param_sharding_tree(model, mesh)
    osh = opt_state_shardings(psh, mesh)
    local = shard_params(granite_params(workdir, model), mesh, model)
    def names(ps):
        return [(type(p).__name__, getattr(p, "dim", None)) for p in ps]
    return {"embed": names(psh["embed"]),
            "wi": names(psh["stack"][0]["mlp"]["wi"]),
            "ln1": names(osh["m"]["stack"][0]["ln1"]["scale"]),
            "step": names(osh["step"]),
            "shapes": {k: tuple(local["stack"][0][a][k].shape)
                       for a, k in (("attn", "wq"), ("attn", "wk"),
                                    ("mlp", "wi"))}}


def task_rows(workdir, rank, shape):
    """The loop's data-parallel context on the mesh: a batch the data
    axes do not divide is refused; one they do is split by rows, axis 1
    of ``mrope_positions``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.train_step import data_parallel_ctx, shard_rows
    model = _model("granite-3-2b")
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    n = shape[0]
    try:
        data_parallel_ctx(model, mesh, 2 * n + 1)
        refused = False
    except ValueError:
        refused = True
    ctx = data_parallel_ctx(model, mesh, 2 * n)
    toks = torch.arange(2 * n * 3).reshape(2 * n, 3)
    pos = torch.arange(3 * 2 * n * 5).reshape(3, 2 * n, 5)
    rows = shard_rows({"tokens": toks, "mrope_positions": pos}, ctx)
    i = ctx.index(ctx.batch)
    return {"refused": refused, "batch": ctx.batch,
            "tokens": torch.equal(rows["tokens"], toks[2 * i:2 * i + 2]),
            "mrope": torch.equal(rows["mrope_positions"],
                                 pos[:, 2 * i:2 * i + 2])}


TASKS = {"gpipe": task_gpipe, "train": task_train, "serve": task_serve,
         "placements": task_placements, "rows": task_rows}


def rank_main(rank: int, world: int, workdir: str, tasks) -> None:
    workdir = Path(workdir)
    torch.manual_seed(0)
    torch.set_num_threads(1)     # four ranks share the host's cores
    # a file store: no port to race other processes for
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    results = {}
    for task in tasks:
        name, *args = task
        try:
            results[tuple(task)] = TASKS[name](workdir, rank, *args)
        except Exception:
            results[tuple(task)] = {"error": traceback.format_exc()}
            break
    torch.save(results, workdir / f"rank{rank}.pt")
    dist.destroy_process_group()


def all_tasks():
    out = [("gpipe",), ("placements", (2, 2)), ("rows", (4, 1)),
           ("rows", (2, 2))]
    for shape in MESHES:
        for arch in TRAIN_ARCHS:
            out.append(("train", shape, arch, 1))
        out.append(("train", shape, "granite-3-2b", 2))
        for arch in SERVE_ARCHS:
            out.append(("serve", shape, arch))
    return out


def launch_rank(rank: int, port: int, ckpt: str, out: str) -> None:
    """A rank of ``launch/train.py --distributed`` (2 ranks, the CPU)."""
    import os
    os.environ.update(RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from repro_torch.launch import train
    res = train.main(["--distributed", "--device", "cpu", "--steps", "3",
                      "--batch", "4", "--seq", "32", "--ckpt-dir", ckpt,
                      "--ckpt-every", "3"])
    torch.save({"losses": res.losses, "rank": res.rank},
               Path(out) / f"launch{rank}.pt")

