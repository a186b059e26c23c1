"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake tensors.

Port of ``repro.launch.dryrun``. Where the reference lowers and compiles
each cell's jitted step with ``ShapeDtypeStruct`` stand-ins, this traces
the port's own sharded step (``train/train_step.py``'s ``jit_*_step``)
for rank 0 of the mesh, in a fake world of the mesh's size
(``launch/mesh.py:fake_world``: every collective returns at once) and
under ``FakeTensorMode`` on the meta params (``abstract_params``): no
array is allocated. It writes one JSON record a cell under --out, with
the reference's keys:

  * ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count of
    rank 0's step (matrix products and attention; elementwise work is
    not counted). The plain versions of the kernels run here, so a
    causal attention counts every key, where the kernel skips the tiles
    above the diagonal;
  * ``bytes_accessed``: the sum over every aten op of its input and output
    tensors' bytes (views excluded): unfused, so an upper bound where
    XLA's count comes after fusion;
  * ``collectives``: ``bytes`` and ``counts`` under the reference's five
    kinds, from the collectives the step issued
    (``distributed/collectives.py`` counts each call's output bytes, as
    the reference's HLO parse counts an op's result);
  * ``memory_analysis``: ``argument_size_in_bytes`` from the local shards'
    shapes (params, moments, batch), ``temp_size_in_bytes`` the peak of
    the live fake-tensor bytes the step made (each storage counted once,
    released by a weakref finalizer); the params and moments are
    updated in place, so their bytes are ``alias_size_in_bytes`` and the
    outputs' own are the metrics and logits;
  * ``lower_s``: seconds to build the step and its fake inputs;
    ``compile_s``: seconds of the traced step.

Two loops of the plain versions step through time one position at a
time, and under ``FakeTensorMode`` each step costs a Python iteration
and a few dispatched ops: the selective scan's and its backward's
(``kernels/selective_scan``), and the sLSTM's (``models/xlstm.py:
_slstm_steps``). jamba's ``train_4k`` record took more than 3 minutes
on its smoke config alone that way. So the trace counts them from their
shapes (``_by_shape``): the scan's S products h_t · C_t (B, d, n) x (n,)
are one batched product of the same flops (2·B·S·d·n), and every
operand the loop reads or writes (dA, dBx, Cm, the state and the saved
states) is read or written once by an elementwise op; its backward has
no matrix product (the plain loop's FlopCounter count is 0 too), and
reads each input and writes each gradient once; the sLSTM's time loop
is ``_slstm_cell`` over all S steps at once, its S products h_{t-1} @ wh
one (B·S, d) x (d, 4d) product, whose backward makes both products (one
(B, d) x (d, 4d) product more than the loop, whose first h needs no
gradient). The bytes so counted lie between the operands' own and the
stepped loop's, which moves the state through memory every step
(``tests/test_torch_dryrun.py`` holds each stand-in to its loop). The
collectives, the rest of the step and every other loop are traced as
they run.

The port's stack is a Python loop, so every period is counted;
``extrapolated`` stays, filled by ``_depth_extrapolate`` from the 1- and
2-period variants as ``launch/recost.py`` does, and equal to the full
count (``tests/test_torch_dryrun.py``). A shape the config does not
support is ``skipped``, as in the reference.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--mesh 4x4]
"""
import argparse
import contextlib
import dataclasses as _dc
import json
import math
import sys
import time
import traceback
import weakref
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import ARCHS, get_config
from ..configs.base import SHAPES
from ..distributed import collectives as col
from ..models import get_model
from ..models.blueprint import abstract_params, count_params, tree_map
from ..models.registry import input_specs
from .mesh import end_world, fake_world, mesh_from_spec, mesh_size

# ---- perf-iteration variants: the knobs the port's model reads ------------
VARIANTS = {
    # chunked loss (no full-logits materialization)
    "loss_chunk": lambda c: _dc.replace(c, loss_chunk=512),
    "loss_full": lambda c: _dc.replace(c, loss_chunk=0),
    # bigger mamba chunk
    "ssm_chunk1k": lambda c: _dc.replace(c, ssm_chunk=1024),
    # bigger / smaller xlstm chunk
    "xlstm_chunk512": lambda c: _dc.replace(c, xlstm_chunk=512),
    "xlstm_chunk64": lambda c: _dc.replace(c, xlstm_chunk=64),
    # MoE capacity tightening
    "moe_cap1": lambda c: _dc.replace(c, moe_capacity=1.0),
    "moe_cap2": lambda c: _dc.replace(c, moe_capacity=2.0),
    # sequence parallelism on the residual stream (AR -> RS+AG)
    "seqpar": lambda c: _dc.replace(c, seq_shard_activations=True),
}

#: the reference's variants whose knob the port does not read
DROPPED = {
    "skip_blocks": "attn_skip_masked_blocks: the flash_attention kernel "
                   "always skips the tiles above the diagonal",
    "chunk1k": "attn_chunk: the kernel tiles by itself",
    "naive_attn": "attn_impl: attention always goes through the "
                  "flash_attention kernel",
}


def apply_variant(cfg, variant: str):
    for v in filter(None, variant.split("+")):
        if v in DROPPED:
            raise ValueError(f"variant {v!r}: the port does not read "
                             f"{DROPPED[v]}")
        cfg = VARIANTS[v](cfg)
    return cfg


# ---- counting ---------------------------------------------------------------

def _tensors(tree):
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Every aten op's input and output bytes (views and the ``prim``
    queries excluded), and the
    peak of the live bytes of the storages the ops made, each counted
    once and released when its last tensor dies."""

    def __init__(self, outside=()):
        super().__init__()
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._refs: dict = {}
        self._outside = {self._key(t) for t in outside}

    @staticmethod
    def _key(t: torch.Tensor):
        return t.untyped_storage()._cdata

    def _drop(self, key, n):
        c = self._refs.get(key)
        if c is None:
            return
        if c[0] == 1:
            del self._refs[key]
            self.live -= n
        else:
            c[0] -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "aten" and not getattr(func, "is_view", False):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        for t in _tensors(out):
            k = self._key(t)
            if k in self._outside:
                continue
            n = t.untyped_storage().nbytes()
            if k in self._refs:
                self._refs[k][0] += 1
            else:
                self._refs[k] = [1]
                self.live += n
                self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._drop, k, n)
        return out


def _fake(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype)


def _scan_by_shape(dA, dBx, Cm, h=None, states=None):
    """``selective_scan_plain``'s work from its shapes (the module's
    docstring): dA, dBx and Cm read once, the loop's S products h_t · C_t
    as one batched product of the same flops, y written once, and h and
    ``states`` read and written where given. Stand-ins, not the scan's
    values."""
    from ..kernels.selective_scan.selective_scan import STATE_EVERY
    hs = dA.float() * dBx.float()       # every step's state, stood in
    if h is not None:
        h.copy_(h + hs[:, -1])
    if states is not None:
        states.copy_(hs[:, ::STATE_EVERY])
    return torch.einsum("bsdn,bsn->bsd", hs, Cm.float()).to(dA.dtype)


def _scan_bwd_by_shape(dA, dBx, Cm, h0, dy, dh_last=None):
    """``selective_scan_bwd_plain``'s work from its shapes: every input
    read once, every gradient written once in its dtype, and no matrix
    product (the loop has none). Stand-ins, not the gradients' values."""
    a, c, gy = dA.float(), Cm.float(), dy.float()
    hs = a * dBx.float()                    # the states again
    g = gy[..., None] * c[:, :, None]       # every step's dL/dh
    dh0 = a[:, 0] * g[:, 0]
    for t in (h0, dh_last):
        if t is not None:
            dh0 = dh0 + t
    return ((g * hs).to(dA.dtype), g.to(dBx.dtype),
            (gy[..., None] * hs).sum(2).to(Cm.dtype), dh0)


def _slstm_steps_by_shape(p, zx, d):
    """``xlstm._slstm_steps``' work from its shapes: ``_slstm_cell`` once
    over all S steps from the initial state, broadcast, with an h_in of
    zx's that stands in for every step's h, so that the S products h @ wh
    are one product of the same flops and, where zx needs a gradient,
    the backward makes both of its products (the loop's first h is the
    initial state's and needs none: one (B, d) x (d, 4d) product more)."""
    from ..models.xlstm import _slstm_cell, slstm_init_state
    B = zx.shape[0]
    carry = tuple(t[:, None] for t in slstm_init_state(B, d, zx.dtype,
                                                       zx.device))
    return _slstm_cell(p, zx, carry, zx[..., :d])[0]


@contextlib.contextmanager
def _by_shape():
    """The time loops counted from their shapes while inside."""
    from ..kernels.selective_scan import selective_scan as ss
    from ..kernels.selective_scan import selective_scan_bwd as sb
    from ..models import xlstm
    saved = [(ss, "selective_scan_plain", _scan_by_shape),
             (sb, "selective_scan_bwd_plain", _scan_bwd_by_shape),
             (xlstm, "_slstm_steps", _slstm_steps_by_shape)]
    olds = [getattr(m, n) for m, n, _ in saved]
    for m, n, f in saved:
        setattr(m, n, f)
    try:
        yield
    finally:
        for (m, n, _), old in zip(saved, olds):
            setattr(m, n, old)


def _trace(cfg, shape: str, mesh, kind: str, memory: bool = False) -> dict:
    """Trace rank 0's step of one cell -> its counts (and with
    ``memory`` the memory analysis and timings)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from ..train.optimizer import AdamWConfig, init_opt_state
    from ..train.train_step import (StepConfig, jit_decode_step,
                                    jit_prefill_step, jit_train_step,
                                    make_step_ctx, shard_batch)
    model = get_model(cfg)
    params_abs = abstract_params(model.blueprint())
    t0 = time.time()
    ctx = make_step_ctx(model, mesh, shape)     # its groups made here
    with FakeTensorMode(), _by_shape():
        params = ctx.shard_tree(tree_map(_fake, params_abs))
        specs = input_specs(cfg, shape)
        if kind == "train":
            step, (_, _, bsh) = jit_train_step(model, mesh,
                                               StepConfig(remat=True), shape)
            opt = init_opt_state(params, AdamWConfig())
            batch = shard_batch(tree_map(lambda s: torch.empty(
                s.shape, dtype=s.dtype), specs), ctx, bsh)
            args = (params, opt, batch)
        else:
            build = jit_prefill_step if kind == "prefill" else \
                jit_decode_step
            step, (_, bsh) = build(model, mesh, shape)
            batch = shard_batch(tree_map(lambda s: torch.empty(
                s.shape, dtype=s.dtype), specs), ctx, bsh)
            args = (params, batch)
        arg_tensors = _tensors(args)
        t_lower = time.time() - t0
        col.reset()
        t0 = time.time()
        with FlopCounterMode(display=False) as fc, \
                OpCounter(arg_tensors) as oc:
            out = step(*args)
        t_trace = time.time() - t0
        coll = col.counters()
        out_bytes = sum(_nbytes(t) for t in _tensors(out)
                        if all(t.untyped_storage()._cdata
                               != a.untyped_storage()._cdata
                               for a in arg_tensors))
        res = {"flops": float(fc.get_total_flops()),
               "bytes": float(oc.bytes),
               "coll": {k: coll["bytes"][k] for k in col.KINDS},
               "counts": {k: coll["counts"][k] for k in col.KINDS}}
        if memory:
            arg = sum(_nbytes(t) for t in arg_tensors)
            alias = sum(_nbytes(t) for t in _tensors(args[:-1]))
            res["mem"] = {"argument_size_in_bytes": arg,
                          "output_size_in_bytes": out_bytes,
                          "temp_size_in_bytes": oc.peak,
                          "alias_size_in_bytes": alias,
                          "available": True}
            res["lower_s"], res["compile_s"] = t_lower, t_trace
        del out, args, params
    return res


def _depth_extrapolate(cfg, shape: str, mesh, kind: str) -> dict:
    """cost(P) = cost(1 period) + (P-1) * per-period delta, from the 1-
    and 2-period variants (the reference's way; the port's full count
    counts every period, so the two agree)."""
    pat = len(cfg.layer_pattern())
    P = cfg.n_layers // pat
    if P < 2:
        c1 = _trace(cfg, shape, mesh, kind)
        return {"periods": P, "flops": c1["flops"], "bytes": c1["bytes"],
                "coll": c1["coll"], "method": "exact-1"}

    def variant(k: int):
        kw = {"n_layers": k * pat}
        if cfg.enc_dec:
            kw["enc_layers"] = k
        return _dc.replace(cfg, **kw)

    c1 = _trace(variant(1), shape, mesh, kind)
    c2 = _trace(variant(2), shape, mesh, kind)
    out = {"periods": P, "method": "linear-extrapolation"}
    out["flops"] = c1["flops"] + (P - 1) * (c2["flops"] - c1["flops"])
    out["bytes"] = c1["bytes"] + (P - 1) * (c2["bytes"] - c1["bytes"])
    out["coll"] = {k: c1["coll"][k] + (P - 1) * (c2["coll"][k]
                                                 - c1["coll"][k])
                   for k in c1["coll"]}
    return out


def run_cell(arch: str, shape: str, mesh_spec: str, out_dir: Path,
             verbose: bool = True, variant: str = "", cfg=None,
             extrapolate: bool = True) -> dict:
    """One cell's record, written under ``out_dir``. ``cfg``: the config
    to trace in place of the arch's (a test's cut), its name ``arch``."""
    cfg = apply_variant(cfg or get_config(arch), variant)
    base = {"arch": arch, "shape": shape, "mesh": mesh_spec,
            "variant": variant}
    if shape not in cfg.applicable_shapes():
        rec = {**base, "status": "skipped",
               "reason": f"{cfg.family} does not support {shape} "
                         "(see DESIGN.md SArch-applicability)"}
        _write(out_dir, rec)
        return rec
    fake_world(mesh_size(mesh_spec))
    try:
        mesh = mesh_from_spec(mesh_spec, "cpu")
        kind = SHAPES[shape].kind
        cost = _trace(cfg, shape, mesh, kind, memory=True)
        try:
            extrap = (_depth_extrapolate(cfg, shape, mesh, kind)
                      if extrapolate else {})
        except Exception as e:            # pragma: no cover
            extrap = {"error": f"{type(e).__name__}: {e}"}
        shape_ = [int(s) for s in mesh.shape]
    finally:
        end_world()
    coll = {"bytes": cost["coll"], "counts": cost["counts"]}
    rec = {
        **base,
        "status": "ok",
        "n_devices": math.prod(shape_),
        "mesh_shape": shape_,
        "n_params": int(count_params(get_model(cfg).blueprint())),
        "step_kind": kind,
        "flops": cost["flops"],
        "bytes_accessed": cost["bytes"],
        "cost_analysis": {"flops": cost["flops"],
                          "bytes accessed": cost["bytes"]},
        "memory_analysis": cost["mem"],
        "collectives": coll,
        "extrapolated": extrap,
        "lower_s": round(cost["lower_s"], 2),
        "compile_s": round(cost["compile_s"], 2),
    }
    if verbose:
        ag = coll["bytes"]
        print(f"[dryrun] {arch:26s} {shape:12s} {mesh_spec:9s} "
              f"flops/dev={rec['flops']:.3e} bytes/dev="
              f"{rec['bytes_accessed']:.3e} "
              f"coll(AG/AR/RS/A2A)={ag['all-gather']:.2e}/"
              f"{ag['all-reduce']:.2e}/{ag['reduce-scatter']:.2e}/"
              f"{ag['all-to-all']:.2e} trace={rec['compile_s']:.1f}s",
              flush=True)
    _write(out_dir, rec)
    return rec


def _write(out_dir: Path, rec: dict) -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    if rec.get("variant"):
        name = name.replace(".json", f"__{rec['variant']}.json")
    (out_dir / name).write_text(json.dumps(rec, indent=1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod",
                    help="pod | multipod | AxB (e.g. 4x4)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="",
                    help="'+'-joined names from VARIANTS")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    mesh_spec = "multipod" if args.multi_pod else args.mesh
    cells = []
    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    for a in archs:
        shapes = (list(SHAPES) if (args.all or args.shape is None)
                  else [args.shape])
        for s in shapes:
            cells.append((a, s))

    failures = 0
    for a, s in cells:
        fname = out_dir / f"{a}__{s}__{mesh_spec}.json"
        if args.skip_existing and fname.exists():
            prev = json.loads(fname.read_text())
            if prev.get("status") in ("ok", "skipped"):
                print(f"[dryrun] skip existing {a} {s}", flush=True)
                continue
        try:
            run_cell(a, s, mesh_spec, out_dir, variant=args.variant)
        except Exception as e:
            failures += 1
            rec = {"arch": a, "shape": s, "mesh": mesh_spec,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            _write(out_dir, rec)
            print(f"[dryrun] FAIL {a} {s}: {e}", flush=True)
    print(f"[dryrun] done, {failures} failures", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
