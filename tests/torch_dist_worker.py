"""Ranks of the port's distribution tests (``tests/test_torch_distributed.py``).

Each rank joins a gloo world on the CPU, runs every task it is given in
turn and writes its results to ``<workdir>/rank<r>.pt``; rank 0 also
runs the one-device references and records the differences. Imports
torch and the port only (no JAX), so that each rank starts quickly.
"""
from __future__ import annotations

import contextlib
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
#: the configs with recurrent mixers (mamba, mLSTM, sLSTM): their loss,
#: prefill and decode sharded; their mixer blocks' gradients in float32
RECURRENT_ARCHS = ("jamba-1.5-large-398b", "xlstm-1.3b")
#: the configs whose sharded step runs with the sequence-parallel
#: residual and without it: every family (the parallel block, MoE,
#: M-RoPE with frames over the embeddings, an encoder's frames)
SEQPAR_ARCHS = ("granite-3-2b", "jamba-1.5-large-398b", "xlstm-1.3b",
                "olmoe-1b-7b", "command-r-plus-104b", "qwen2-vl-72b",
                "seamless-m4t-large-v2")
#: a mixer's model and its layer in the smoke period
MIXERS = {"mamba": ("jamba-1.5-large-398b", 0), "mlstm": ("xlstm-1.3b", 1),
          "slstm": ("xlstm-1.3b", 0)}
#: the params both packages read from the test's numpy draw
DRAWN = ("granite-3-2b",) + RECURRENT_ARCHS
MESHES = ((2, 2), (1, 4))
B, S, FRAMES = 8, 32, 16
DEC_LEN, DEC_STEPS, PRE_S = 12, 6, 24
#: jamba's prefill: a multiple of its smoke ssm_chunk (16), where the
#: reference's chunked scan is right (ROADMAP C10)
PRE_S_HYBRID = 32
MIX_B, MIX_DEC_STEPS = 2, 3


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


def params_file(arch: str) -> str:
    return ("params.npz" if arch == "granite-3-2b"
            else f"params_{arch.split('-')[0]}.npz")


def granite_params(workdir: Path, model, arch: str = "granite-3-2b"):
    """A smoke model's params from the test's numpy draw (the JAX
    subprocess reads the same file), leaf by leaf in blueprint order."""
    from repro_torch.models.blueprint import tree_map
    arrays = np.load(workdir / params_file(arch))
    bp = model.blueprint()
    names = iter(_paths(bp))
    return tree_map(lambda l: torch.from_numpy(np.array(
        arrays[npz_key(next(names))], copy=True)).to(l.dtype), bp)


def npz_key(path: str) -> str:
    return path.strip("/").replace("/", "__")


def _model(arch, **over):
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    return get_model(dataclasses.replace(get_config(arch, smoke=True),
                                         **over))


def _params(arch, model, workdir):
    from repro_torch.models.blueprint import init_params
    if arch in DRAWN:
        return granite_params(workdir, model, arch)
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


@contextlib.contextmanager
def float32_lm():
    """The LM in float32 while inside: the embedding's rows (bf16, the
    one owner's row summed exactly under a context) upcast, so that every
    layer computes in its input's dtype, float32, from float32 params and
    caches. A test's patch: it holds the sharded logic where bf16 noise
    on the random smoke models (ROADMAP C15) would hide it."""
    from repro_torch.models.transformer import LM
    orig = LM._embed
    LM._embed = lambda self, p, t: orig(self, p, t).float()
    try:
        yield
    finally:
        LM._embed = orig


@contextlib.contextmanager
def float32_launch():
    """``train_loop``'s initial params in float32 and the LM in float32
    (``float32_lm``) while inside: the launcher's run in float32, a
    test's patch as ``float32_lm`` is."""
    from repro_torch.train import loop
    orig = loop.init_params
    loop.init_params = lambda *a, **k: _f32(orig(*a, **k))
    try:
        with float32_lm():
            yield
    finally:
        loop.init_params = orig


def _f32(tree):
    from repro_torch.models.blueprint import tree_map
    return tree_map(lambda t: t.float() if t.is_floating_point() else t,
                    tree)


def _serve_run(model, mesh, params, toks, enc, f32=False):
    """The sharded prefill's logits and DEC_STEPS sharded decode steps'
    logits, gathered, and the decode step's specs."""
    from repro_torch.models.blueprint import PSpec, tree_map
    from repro_torch.train.train_step import (jit_decode_step,
                                              jit_prefill_step, make_step_ctx,
                                              shard_batch)
    pre, (_, bsh) = jit_prefill_step(model, mesh, "prefill_32k")
    ctx = make_step_ctx(model, mesh, "prefill_32k")
    lp = ctx.shard_tree(params)
    vax = "model" if ctx.logical("vocab") else None
    logits = ctx.unshard(pre(lp, shard_batch({"tokens": toks}, ctx, bsh)),
                         PSpec(ctx.batch or None, vax))
    dstep, (_, dsh) = jit_decode_step(model, mesh, "decode_32k")
    dctx = make_step_ctx(model, mesh, "decode_32k")
    cache = model.init_cache(B, DEC_LEN, device="cpu")
    if f32:
        cache = _f32(cache)
    lcache = tree_map(lambda t, sp: dctx.shard(t, sp).clone(), cache,
                      dsh["cache"])
    got = []
    for t in range(DEC_STEPS):
        pos = torch.full((B,), t)
        lb = {"tokens": dctx.shard(toks[:, t:t + 1], dsh["tokens"]),
              "pos": dctx.shard(pos, dsh["pos"]), "cache": lcache}
        if enc is not None:
            lb["enc_out"] = dctx.shard(enc, dsh["enc_out"])
        lo, _ = dstep(lp, lb)
        got.append(dctx.unshard(lo, PSpec(dctx.batch or None, None, vax)))
    return logits, torch.stack(got), dctx, dsh


#: ``_one_device``'s runs, by config
_ONE_DEVICE: dict = {}


def _one_device_run(model, params, toks, enc, f32=False):
    """The one-device prefill's logits and DEC_STEPS decode steps'."""
    rc = model.init_cache(B, DEC_LEN, device="cpu")
    if f32:
        rc = _f32(rc)
    dec = [model.decode_step(params, rc, toks[:, t:t + 1],
                             torch.full((B,), t), enc)[0]
           for t in range(DEC_STEPS)]
    return model.prefill(params, toks), torch.stack(dec)


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _noisy(params):
    """params with a tenth of the embedding's entries one bf16 ulp up
    (``tests/arch_parity_report.py``'s, ROADMAP C15's yardstick)."""
    e = params["embed"].clone()
    mask = torch.rand(e.shape, generator=torch.Generator().manual_seed(0)
                      ) < 0.1
    e[mask] = (e[mask].float() * (1 + 2 ** -8)).bfloat16()
    return {**params, "embed": e}


def task_serve(workdir, rank, shape, arch):
    """The sharded prefill and decode against the one-device path (rank
    0). A recurrent config also in float32 (``float32_lm``), and with the
    one-device path's own movement under ``_noisy``."""
    from repro_torch.launch.mesh import make_mesh
    model = _model(arch)
    cfg = model.cfg
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    params = _params(arch, model, workdir)
    toks = torch.from_numpy(np.load(workdir / "batch.npz")["tokens"])
    toks = toks[:, :PRE_S_HYBRID if cfg.family == "hybrid" else PRE_S]
    enc = None
    if cfg.enc_dec:
        g = torch.Generator().manual_seed(3)
        enc = torch.randn(B, FRAMES, cfg.d_model, generator=g).bfloat16()
    with torch.no_grad():
        logits, got, dctx, dsh = _serve_run(model, mesh, params, toks, enc)
        if arch in RECURRENT_ARCHS:
            with float32_lm():
                f_logits, f_got, _, _ = _serve_run(model, mesh,
                                                   _f32(params), toks, enc,
                                                   f32=True)
    attn = [i for i, k in enumerate(model.period)
            if k.mixer.startswith("attn")]
    out = {"seq": list(dctx.seq),
           "cache_spec": ([str(a) for a in dsh["cache"][attn[0]]["k"]]
                          if attn else None)}
    if rank:
        return out
    if arch in DRAWN:               # for the reference's (in float32
        #                             where the reference runs so)
        rec = arch in RECURRENT_ARCHS
        out["prefill"] = (f_logits if rec else logits).float().numpy()
        out["decode"] = (f_got if rec else got).float().numpy()
    with torch.no_grad():
        one = _one_device(arch, model, params, toks, enc)
    want, want_dec = one["bf16"]
    out["prefill_err"] = _max_err(logits, want)
    out["prefill_ok"] = bool(torch.allclose(logits, want, atol=0.1,
                                            rtol=0.1))
    out["decode_errs"] = [_max_err(a, b) for a, b in zip(got, want_dec)]
    out["decode_ok"] = all(torch.allclose(a, b, atol=0.1, rtol=0.1)
                           for a, b in zip(got, want_dec))
    if arch in RECURRENT_ARCHS:
        (n_pre, n_dec), (f_want, f_dec) = one["noisy"], one["f32"]
        out["noise"] = {"prefill": _max_err(n_pre, want),
                        "decode": _max_err(n_dec, want_dec)}
        out["f32"] = {"prefill": _max_err(f_logits, f_want),
                      "decode": _max_err(f_got, f_dec)}
    return out


def _one_device(arch, model, params, toks, enc) -> dict:
    """The one-device runs of a config (the same on every mesh, so made
    once a process): bf16; a recurrent config's also from ``_noisy``
    params and in float32."""
    if arch not in _ONE_DEVICE:
        one = {"bf16": _one_device_run(model, params, toks, enc)}
        if arch in RECURRENT_ARCHS:
            one["noisy"] = _one_device_run(model, _noisy(params), toks, enc)
            with float32_lm():
                one["f32"] = _one_device_run(model, _f32(params), toks,
                                             enc, f32=True)
        _ONE_DEVICE[arch] = one
    return _ONE_DEVICE[arch]


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


def task_loss(workdir, rank, shape, arch):
    """The sharded loss of a smoke model on the mesh (rank 0: and the
    one-device loss)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import input_shardings
    from repro_torch.train.train_step import make_step_ctx, shard_batch
    model = _model(arch)
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    params = _params(arch, model, workdir)
    batch = _batch(model.cfg, workdir)
    ctx = make_step_ctx(model, mesh, "train_4k")
    bsh = input_shardings(model.cfg, "train_4k", ("data",),
                          dict(zip(("data", "model"), shape)))
    with torch.no_grad():
        loss = model.sharded(ctx).loss_fn(
            ctx.shard_tree(params), shard_batch(batch, ctx, bsh),
            remat=False)
        out = {"loss": float(loss)}
        if rank == 0:
            out["loss_one"] = float(model.loss_fn(params, batch,
                                                  remat=False))
    return out


def _sharded_grads(model, ctx, params, batch, bsh):
    """(loss, each leaf's whole gradient) of the sharded step."""
    from repro_torch.train.train_step import shard_batch, value_and_grad
    loss, g = value_and_grad(model.sharded(ctx), ctx.shard_tree(params),
                             shard_batch(batch, ctx, bsh), remat=True,
                             scale=1.0 / ctx.size(ctx.axes))
    return float(loss), ctx.unshard_tree(ctx.sum_replicas(g))


def task_seqpar(workdir, rank, shape, arch):
    """The sharded step's loss and gradients with the sequence-parallel
    residual and without it, and each one's collective bytes and calls
    by kind on this rank; a recurrent config's in float32
    (``float32_lm``: its whole-model bf16 gradients are ROADMAP C15's
    noise)."""
    from repro_torch.distributed import collectives as col
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.blueprint import leaves
    from repro_torch.models.registry import input_shardings
    from repro_torch.train.train_step import make_step_ctx
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    out = {}
    f32 = arch in RECURRENT_ARCHS
    for sp in (False, True):
        model = _model(arch, seq_shard_activations=sp)
        params = _params(arch, model, workdir)
        batch = _batch(model.cfg, workdir)
        ctx = make_step_ctx(model, mesh, "train_4k")
        bsh = input_shardings(model.cfg, "train_4k", ("data",),
                              dict(zip(("data", "model"), shape)))
        col.reset()
        with float32_lm() if f32 else contextlib.nullcontext():
            loss, g = _sharded_grads(model, ctx, _f32(params) if f32
                                     else params, batch, bsh)
        out[sp] = {"loss": loss, "sp": list(ctx.sp),
                   "coll": col.counters(), "grads": leaves(g)}
    names = list(_paths(params))
    res = {"f32": f32, "loss": out[False]["loss"],
           "loss_sp": out[True]["loss"],
           "sp": out[True]["sp"], "sp_off": out[False]["sp"],
           "coll": out[False]["coll"], "coll_sp": out[True]["coll"]}
    if rank == 0:
        res["gerr"] = {n: _rel(a, b) for n, a, b in
                       zip(names, out[True]["grads"], out[False]["grads"])
                       if b.float().any()}
    return res


def _mixer(which, p, x, cfg, ctx):
    from repro_torch.models import ssm as SSM
    from repro_torch.models import xlstm as XL
    if which == "mamba":
        return SSM.mamba_scan_chunked(p, x, d_state=cfg.ssm_d_state,
                                      chunk=cfg.ssm_chunk, ctx=ctx)
    if which == "mlstm":
        return XL.mlstm_chunked(p, x, n_heads=cfg.n_heads,
                                chunk=cfg.xlstm_chunk, ctx=ctx)
    return XL.slstm_seq(p, x, ctx)


def _mixer_setup(which, shape):
    """The mixer's smoke model, its float32 params of one layer, the
    step's context on the mesh and the leaves' (spec, blocks)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.blueprint import init_params
    from repro_torch.train.train_step import make_step_ctx
    arch, k = MIXERS[which]
    model = _model(arch)
    bp = model._layer_bp(model.period[k])[which]
    p = {n: t.float() for n, t in init_params(
        bp, torch.Generator().manual_seed(5), device="cpu").items()}
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    ctx = make_step_ctx(model, mesh, "train_4k")
    lay = ctx.layout("stack", period=True)[k][which]
    return model.cfg, p, ctx, lay


def task_mixer(workdir, rank, shape, which):
    """A mixer block's output and gradients (every leaf's and the
    input's) in float32 under the context, gathered, against the block
    with none: loss sum(out * w), the same x on every rank."""
    cfg, p, ctx, lay = _mixer_setup(which, shape)
    g = torch.Generator().manual_seed(6)
    x = torch.randn(MIX_B, S, cfg.d_model, generator=g)
    w = torch.randn(MIX_B, S, cfg.d_model, generator=g)
    names = sorted(p)

    def run(params, c):
        ps = {n: t.detach().requires_grad_() for n, t in params.items()}
        xi = x.clone().requires_grad_()
        with torch.enable_grad():
            pg = ps if c is None else c.gather_fsdp(ps, lay)
            y = _mixer(which, pg, xi, cfg, c)
            scale = 1.0 if c is None else 1.0 / c.size(c.axes)
            gs = torch.autograd.grad((y * w).sum() * scale,
                                     [ps[n] for n in names] + [xi],
                                     allow_unused=True,
                                     materialize_grads=True)
        return y.detach(), dict(zip(names, gs[:-1])), gs[-1]

    y, gp, gx = run({n: ctx.shard(t, *lay[n]) for n, t in p.items()}, ctx)
    with torch.no_grad():
        gx = ctx.reduce(gx, ctx.axes)
        gp = {n: ctx.unshard(ctx.reduce(t.contiguous(),
                                        ctx.replicas(lay[n][0])), *lay[n])
              for n, t in gp.items()}
    y1, gp1, gx1 = run(p, None)
    return {"y": _rel(y, y1), "x": _rel(gx, gx1),
            "grads": {n: _rel(gp[n], gp1[n]) for n in names}}


def _mixer_state(which, cfg, B_, ctx):
    """A mixer's initial decode state, float32 where the cache is; with
    ``ctx`` the rank's part of it, as ``cache_pspecs`` shards it."""
    from repro_torch.models import xlstm as XL
    C, d = cfg.ssm_d_inner, cfg.d_model
    if which == "mamba":
        lo, hi = (0, C) if ctx is None else ctx.part("d_inner", C)
        return {"conv": torch.zeros(B_, cfg.ssm_d_conv - 1, hi - lo),
                "ssm": torch.zeros(B_, hi - lo, cfg.ssm_d_state)}
    if which == "mlstm":
        return XL.mlstm_init_state(B_, cfg.n_heads, d // cfg.n_heads)
    lo, hi = (0, d) if ctx is None else ctx.part("ff", d)
    return XL.slstm_init_state(B_, hi - lo, torch.float32)


def task_mixer_decode(workdir, rank, shape, which):
    """MIX_DEC_STEPS decode steps of a mixer in float32 under the context
    against none: each step's output and the rank's part of the final
    state."""
    from repro_torch.models import ssm as SSM
    from repro_torch.models import xlstm as XL
    cfg, p, ctx, lay = _mixer_setup(which, shape)
    local = ctx.gather_fsdp({n: ctx.shard(t, *lay[n]) for n, t in p.items()},
                            lay)
    g = torch.Generator().manual_seed(7)
    xs = torch.randn(MIX_DEC_STEPS, MIX_B, 1, cfg.d_model, generator=g)

    def step(params, x, st, c):
        if which == "mamba":
            return SSM.mamba_decode_step(params, x, st,
                                         d_state=cfg.ssm_d_state, ctx=c)[0]
        if which == "mlstm":
            return XL.mlstm_decode_step(params, x, st, n_heads=cfg.n_heads,
                                        ctx=c)[0]
        return XL.slstm_decode_step(params, x, st, c)[0]

    st, st1 = _mixer_state(which, cfg, MIX_B, ctx), \
        _mixer_state(which, cfg, MIX_B, None)
    errs = []
    with torch.no_grad():
        for x in xs:
            errs.append(_rel(step(local, x, st, ctx), step(p, x, st1, None)))
    if which == "mamba":
        lo, hi = ctx.part("d_inner", cfg.ssm_d_inner)
        want = {"conv": st1["conv"][..., lo:hi], "ssm": st1["ssm"][:, lo:hi]}
    elif which == "slstm":
        lo, hi = ctx.part("ff", cfg.d_model)
        want = tuple(t[:, lo:hi] for t in st1)
    else:
        want = st1
    pairs = (zip(st.values(), want.values()) if isinstance(st, dict)
             else zip(st, want))
    return {"y": errs, "state": [_rel(a, b) for a, b in pairs],
            "local_state": [tuple(t.shape) for t in
                            (st.values() if isinstance(st, dict) else st)]}


def task_blocks(workdir, rank, shape):
    """A leaf of 2 and of 4 blocks on the mesh: the rank's shard holds its
    part of each block, and ``unshard`` gives the leaf back; a leaf whose
    blocks' parts do not split is refused."""
    from repro_torch.distributed.context import ShardCtx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.blueprint import PSpec
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    ctx = ShardCtx(mesh, {}, {}, specs={})
    m, i = shape[1], ctx.index("model")
    out = {}
    for b in (2, 4):
        d = 8 * m
        t = torch.arange(3 * b * d).reshape(3, b * d)
        sh = ctx.shard(t, PSpec(None, "model"), b)
        want = torch.cat([t[:, j * d + i * d // m:j * d + (i + 1) * d // m]
                          for j in range(b)], 1)
        out[b] = {"shard": torch.equal(sh, want),
                  "round_trip": torch.equal(
                      ctx.unshard(sh.contiguous(), PSpec(None, "model"), b),
                      t)}
    try:    # 4 blocks of 6: 24 splits 4 ways, each block does not
        ctx.shard(torch.zeros(2, 24), PSpec(None, "model"), 4)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    return out


def task_seq_split(workdir, rank, shape):
    """A context whose residual is split over the model axis: the rank's
    S shard of a sequence, and a sequence that does not split refused by
    ``seq_part`` and ``row_out``, naming the flag."""
    from repro_torch.distributed.context import ShardCtx
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(shape, ("data", "model"), "cpu")
    ctx = ShardCtx(mesh, {}, {}, specs={}).with_step(sp=("model",))
    x = torch.arange(2 * 8 * 3).reshape(2, 8, 3)
    i = ctx.index("model")
    out = {"part": torch.equal(ctx.seq_part(x), x[:, 2 * i:2 * i + 2])}
    for name, fn in (("seq_part", ctx.seq_part),
                     ("row_out", lambda t: ctx.row_out(t, ("model",)))):
        try:
            fn(torch.zeros(2, 6, 3))
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


TASKS = {"gpipe": task_gpipe, "train": task_train, "serve": task_serve,
         "placements": task_placements, "rows": task_rows,
         "loss": task_loss, "seqpar": task_seqpar, "mixer": task_mixer,
         "mixer_decode": task_mixer_decode, "blocks": task_blocks,
         "seq_split": task_seq_split}


def rank_main(rank: int, world: int, workdir: str, tasks) -> None:
    workdir = Path(workdir)
    torch.manual_seed(0)
    torch.set_num_threads(1)     # four ranks share the host's cores
    # a file store: no port to race other processes for
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=180))
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
        for arch in SERVE_ARCHS + RECURRENT_ARCHS:
            out.append(("serve", shape, arch))
        for arch in RECURRENT_ARCHS:
            out.append(("loss", shape, arch))
        for which in MIXERS:
            out += [("mixer", shape, which), ("mixer_decode", shape, which)]
    out += [("blocks", (1, 4)), ("seq_split", (1, 4))]
    for arch in SEQPAR_ARCHS:
        out.append(("seqpar", (2, 2), arch))
    return out


#: the launcher's runs: granite (checkpointed, then resumed by the
#: test) and jamba
LAUNCH_ARCHS = ("granite-3-2b", "jamba-1.5-large-398b")


def launch_rank(rank: int, ports, ckpt: str, out: str) -> None:
    """A rank of ``launch/train.py --distributed`` (2 ranks, the CPU), a
    run a ``LAUNCH_ARCHS`` config, each on a port of its own; jamba's in
    float32 (``float32_launch``)."""
    import os
    torch.set_num_threads(1)
    from repro_torch.launch import train
    res = {}
    for arch, port in zip(LAUNCH_ARCHS, ports):
        os.environ.update(RANK=str(rank), WORLD_SIZE="2",
                          MASTER_ADDR="localhost", MASTER_PORT=str(port))
        with (float32_launch() if arch != "granite-3-2b"
              else contextlib.nullcontext()):
            r = train.main(["--distributed", "--device", "cpu", "--steps",
                            "3", "--batch", "4", "--seq", "32", "--arch",
                            arch, "--ckpt-dir", f"{ckpt}/{arch}",
                            "--ckpt-every", "3"])
        res[arch] = {"losses": r.losses, "rank": r.rank}
    torch.save(res, Path(out) / f"launch{rank}.pt")

