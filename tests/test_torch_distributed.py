"""The port's distribution against the JAX package's and its own
one-device path, on the CPU.

  (a) The sharding planner against the reference, leaf for leaf: the
      rules ``dynamic_rules`` adapts, ``param_specs`` and
      ``input_shardings`` (decode's ``cache_pspecs`` included) equal the
      reference's ``tuple(PartitionSpec)``s for all ten configs on the
      meshes 16x16, 2x16x16, 2x4 and 4x2 and the four shapes; the
      reference's ``test_planner_rules_respect_divisibility`` cases and
      its divisibility invariant (``test_param_specs_shapes_divide``).
  (b) The port's GPipe (4 gloo ranks) against the reference's
      ``make_pipelined_apply`` on 4 host devices in a JAX subprocess: L 8,
      d 16, M 4, tanh layers, inputs from a numpy seed, atol 1e-5 (both
      float32; the same products in another order).
  (c) The sharded train step against the port's one-device step on
      meshes (2, 2) and (1, 4), at ``tests/test_torch_train.py``'s
      tolerances: the loss within ``STEP_TOL``, each leaf's gradient at
      relative L2 error ``GRAD_TOL``, each leaf after AdamW at ``GRAD_TOL``
      (a leaf that starts at zero, a zeroed router, is held by its
      gradient: one AdamW step moves each element by about lr * sign(g)).
      The smoke configs: granite (also at microbatches 2), olmoe (router
      zeroed), command-r-plus (parallel block), qwen2-vl (M-RoPE),
      seamless (encoder-decoder); the smoke kv 2 on a model axis of 4
      replicates the kv heads. The granite loss on (2, 2) also against
      the reference's ``build_train_step`` on a (2, 2) host mesh, in the
      same JAX subprocess, at ``STEP_TOL``.
      Each leaf's gradient of the granite step, on both meshes, also
      against the reference's under its (2, 2) host mesh's shardings,
      at ``REF_GRAD_TOL`` (3e-2: the one-device port is itself up to
      0.022 from the reference on this draw).
  (d) Sharded prefill and 6 decode steps against the one-device path at
      ``tests/test_torch_lm.py``'s ``TOL`` (0.1): on (2, 2) the cache is
      head-sharded, on (1, 4) sequence-sharded (kv 2 on 4); granite's
      also against the reference's ``jit_prefill_step`` and
      ``jit_decode_step`` on the same mesh shapes, at ``TOL``.
  (e) ``launch/train.py --distributed`` with 2 gloo ranks for 3 steps:
      its losses equal the one-process run's within 1e-4 relative (the
      data-parallel sums run in another order), and a one-process run
      resumes from its checkpoint and continues; jamba's smoke config's
      losses too, in float32 on both sides (``W.float32_launch``).
  (f) The recurrent mixers sharded, on (2, 2) and (1, 4): jamba's and
      xlstm's smoke loss within ``STEP_TOL`` of the one-device port's;
      their prefill logits and 6 decode steps in float32 (the test's
      ``float32_lm`` patch) within ``F32_TOL``, and in bf16 within the
      one-device port's own movement under one bf16 ulp of noise on a
      tenth of the embedding (ROADMAP C15: these random smoke LMs are
      ill-conditioned in bf16, and TOL cannot hold them whole); each
      mixer block (mamba, mLSTM, sLSTM) in float32, its output and every
      gradient at ``GRAD_TOL``, and 3 decode steps of each, under the
      context against none; jamba's sharded loss against the reference's
      ``build_train_step`` at ``STEP_TOL``, and its prefill and decode
      logits, and xlstm's decode, in float32 on both sides (each one's
      ``float32_lm`` patch) against the reference's on a (2, 2) host
      mesh at ``F32_TOL``; the 2- and 4-block layouts; ROADMAP C19's
      sLSTM (the smoke xlstm at d 6 on (1, 4): 4·d splits 4 ways, d
      does not) in float32, its prefill, decode, loss and gradients
      against one process at ``F32_TOL``.
  (g) The sequence-parallel residual: the sharded step with
      ``seq_shard_activations`` against the same step without it on
      (2, 2), for a config of every family (jamba and xlstm in float32,
      the rest in bf16): the loss within ``STEP_TOL``, every leaf's
      gradient at ``GRAD_TOL``, and the all-reduce's bytes moved to the
      reduce-scatter and the all-gather.

One world of 4 ranks runs (b), (c), (d), (f) and (g), and one of 2 runs
(e) (module-scoped fixtures; ``tests/torch_dist_worker.py`` holds the
ranks' code), while the JAX subprocess runs beside them.
"""
import os
import subprocess
import sys
import multiprocessing as mp
import socket
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_worker as W
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.models import get_model as ref_get_model
from repro.models.blueprint import param_specs as ref_param_specs
from repro.models.registry import dynamic_rules as ref_dynamic_rules
from repro.models.registry import input_shardings as ref_input_shardings
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.models import get_model
from repro_torch.models.blueprint import (DEFAULT_RULES, PSpec, leaves,
                                          param_specs, tree_map)
from repro_torch.models.registry import dynamic_rules, input_shardings

ROOT = Path(__file__).resolve().parent.parent
STEP_TOL = 2e-2           # tests/test_torch_train.py
GRAD_TOL = 2e-2           # tests/test_torch_train.py
TOL = 0.1                 # tests/test_torch_lm.py
#: a gradient of the port's against the reference's on this file's draw:
#: the one-device port's own gradients are 0.008-0.022 from the
#: reference's here (bf16 rounded at other places, as
#: tests/test_torch_train.py's docstring says), above GRAD_TOL, which
#: holds the sharded step against the one-device port; a wrong sharded
#: backward (a sum left out, a block layout crossed, a sign) is off by
#: order 1
REF_GRAD_TOL = 3e-2
#: the sharded LM against the one-device LM or the reference's, all in
#: float32: the same sums in another order (measured up to 2.6e-4 on
#: logits of |4|)
F32_TOL = 1e-3
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4},
          "4x2": {"data": 4, "model": 2}}


def _spec_tree(tree):
    """{path: tuple} of a tree of dicts, lists and tuples ending in specs
    (either package's; a spec is a tuple of axes or None)."""
    def is_spec(x):
        return isinstance(x, PSpec) or type(x).__name__ == "PartitionSpec"

    out = {}

    def walk(t, path):
        if is_spec(t):
            out[path] = tuple(t)
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, f"{path}/{i}")
        else:
            raise TypeError(f"{path}: {type(t)}")
    walk(tree, "")
    return out


def _fsdp(axes):
    return ("pod", "data") if "pod" in axes else "data"


# --------------------------------------------------------------------------
# (a) the planner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_planner_matches_reference(arch, mesh):
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    axes = MESHES[mesh]
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    rules = dynamic_rules(cfg, axes)
    assert rules == ref_dynamic_rules(rcfg, axes)
    got = _spec_tree(param_specs(get_model(cfg).blueprint(), rules,
                                 _fsdp(axes)))
    want = _spec_tree(ref_param_specs(ref_get_model(rcfg).blueprint(),
                                      rules, _fsdp(axes)))
    assert got == want
    da = ("pod", "data") if "pod" in axes else ("data",)
    for shape in SHAPES:
        g = _spec_tree(input_shardings(cfg, shape, da, axes))
        w = _spec_tree(ref_input_shardings(rcfg, shape, da, axes))
        assert g == w, shape


def test_planner_rules_respect_divisibility():
    """The reference's cases (tests/test_distributed.py)."""
    # starcoder2: 36 heads % 16 != 0 -> heads replicated; ff still sharded
    r = dynamic_rules(get_config("starcoder2-7b"), {"model": 16})
    assert r["heads"] is None and r["kv_heads"] is None
    assert r["ff"] == "model"
    # llama: 128 heads fine; kv=8 replicated on 16-way TP
    r = dynamic_rules(get_config("llama3-405b"), {"model": 16})
    assert r["heads"] == "model" and r["kv_heads"] is None
    # olmoe experts divide
    r = dynamic_rules(get_config("olmoe-1b-7b"), {"model": 16})
    assert r["experts"] == "model"
    assert dynamic_rules(get_config("granite-3-2b"), {"model": 1}) == \
        DEFAULT_RULES


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_shapes_divide(arch):
    """Every leaf's sharded dims divide their mesh axes on both
    production meshes (the reference's invariant), a gated FF's blocks
    each on their own."""
    for axes in MESHES.values():
        cfg = get_config(arch)
        bp = get_model(cfg).blueprint()
        specs = param_specs(bp, dynamic_rules(cfg, axes), _fsdp(axes))
        for l, spec in zip(leaves(bp), _spec_tree(specs).values()):
            for d, (dim, ax) in enumerate(zip(l.shape, spec)):
                if ax is None:
                    continue
                axs = ax if isinstance(ax, tuple) else (ax,)
                total = int(np.prod([axes[a] for a in axs]))
                blocks = l.blocks if d == len(l.shape) - 1 else 1
                assert dim % (total * blocks) == 0, \
                    f"{arch}: {l.shape} vs {spec}"


def test_pspec_is_its_tuple_and_pickles():
    import pickle
    s = PSpec(("pod", "data"), None, "model")
    assert s == (("pod", "data"), None, "model")
    assert pickle.loads(pickle.dumps(s)) == s
    assert type(pickle.loads(pickle.dumps(s))) is PSpec
    assert tree_map(lambda x: x, {"a": s})["a"] is s


def test_blocks_layout_round_trip():
    """A gated wi's shards, gathered block by block, give the leaf back."""
    from repro_torch.distributed import collectives as C
    t = torch.arange(2 * 24).reshape(2, 24)
    n, b = 3, 2
    parts = [torch.cat([blk.chunk(n, 1)[i] for blk in t.chunk(b, 1)], 1)
             for i in range(n)]
    joined = torch.cat(parts, 1).T
    assert torch.equal(C._ranks_to_blocks(joined, n, b).T, t)
    assert torch.equal(C._blocks_to_ranks(t.T, n, b).T, joined.T)


# --------------------------------------------------------------------------
# the worlds
# --------------------------------------------------------------------------

def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _spawn(target, n, args):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args)) for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
        if p.is_alive():
            p.kill()
    return [p.exitcode for p in procs]


def _draw_params(wd: Path, arch: str, rng) -> None:
    bp = get_model(get_config(arch, smoke=True)).blueprint()
    arrays = {}
    for path, l in W._paths(bp).items():
        if l.init == "ones":
            a = np.ones(l.shape, np.float32)
        elif l.init == "zeros" or path.endswith("/router"):
            a = np.zeros(l.shape, np.float32)
        else:
            fan = (l.shape[l.scale_dim] if l.scale_dim is not None
                   else l.shape[-2] if len(l.shape) >= 2 else l.shape[-1])
            a = (rng.standard_normal(l.shape) / np.sqrt(fan)) \
                .astype(np.float32)
        # rounded to bf16 once, here, for both
        arrays[W.npz_key(path)] = torch.from_numpy(a).to(
            l.dtype).float().numpy()
    np.savez(wd / W.params_file(arch), **arrays)


def _draws(wd: Path) -> None:
    """The inputs both packages read, from numpy seeds (jamba's routers
    zeroed: bf16 near-ties route tokens apart otherwise)."""
    rng = np.random.default_rng(0)
    _draw_params(wd, "granite-3-2b", rng)
    np.savez(wd / "batch.npz", tokens=rng.integers(
        0, 512, (W.B, W.S)).astype(np.int32), pre_s=W.PRE_S,
        pre_s_hybrid=W.PRE_S_HYBRID, dec_len=W.DEC_LEN,
        dec_steps=W.DEC_STEPS)
    np.savez(wd / "gpipe.npz",
             Ws=(rng.standard_normal((8, 16, 16)) * 0.1).astype(np.float32),
             xs=rng.standard_normal((4, 2, 16)).astype(np.float32))
    for seed, arch in enumerate(W.RECURRENT_ARCHS, 1):
        _draw_params(wd, arch, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    wd = tmp_path_factory.mktemp("dist")
    _draws(wd)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    jxs = [subprocess.Popen([sys.executable, str(ROOT / "tests" /
                                                 "jax_dist_ref.py"), str(wd),
                             *part], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
           for part in ([], ["jamba_train"])]
    codes = _spawn(W.rank_main, 4, (4, str(wd), W.all_tasks()))
    ranks = [torch.load(wd / f"rank{r}.pt", weights_only=False)
             if (wd / f"rank{r}.pt").exists() else {} for r in range(4)]
    for jx in jxs:
        out, err = jx.communicate(timeout=600)
        assert jx.returncode == 0, err[-3000:]
    return {"codes": codes, "ranks": ranks,
            "jax": {**np.load(wd / "jax_ref.npz"),
                    **np.load(wd / "jax_ref_jamba_train.npz")}, "wd": wd}


def _result(world, task):
    assert world["codes"] == [0] * 4, world["codes"]
    rs = [r.get(task) for r in world["ranks"]]
    for r in rs:
        assert r is not None, f"{task}: not run"
        assert "error" not in r, r["error"]
    return rs


# --------------------------------------------------------------------------
# (b) GPipe
# --------------------------------------------------------------------------

def test_gpipe_matches_reference(world):
    rs = _result(world, ("gpipe",))
    for r in rs:       # every stage gets the outputs
        np.testing.assert_allclose(r["ys"], world["jax"]["ys"], atol=1e-5,
                                   rtol=0)


def test_placements_and_shards(world):
    """On (data 2, model 2): embed (vocab, embed) is Shard(1) on data and
    Shard(0) on model; a norm's moments replicate on model; a rank's
    shards of wq (embed, heads, head_dim), wk and the gated wi."""
    r = _result(world, ("placements", (2, 2)))[0]
    assert r["embed"] == [("Shard", 1), ("Shard", 0)]
    assert r["wi"] == [("Shard", 1), ("Shard", 2)]
    assert r["ln1"] == [("Shard", 1), ("Replicate", None)]
    assert r["step"] == [("Replicate", None), ("Replicate", None)]
    assert r["shapes"] == {"wq": (2, 64, 2, 32), "wk": (2, 64, 1, 32),
                           "wi": (2, 64, 256)}      # 2 periods stacked


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)], ids=["4x1", "2x2"])
def test_loop_splits_its_own_batch(world, shape):
    """``train_loop``'s context splits the batch it is given over the data
    axes, by rows (axis 1 of ``mrope_positions``), and refuses one they
    do not divide."""
    for r in _result(world, ("rows", shape)):
        assert r == {"refused": True, "batch": ("data",), "tokens": True,
                     "mrope": True}


def test_abstract_params_are_meta():
    from repro_torch.models.blueprint import abstract_params
    bp = get_model(get_config("kimi-k2-1t-a32b")).blueprint()
    ps = abstract_params(bp)
    assert all(t.is_meta for t in leaves(ps))
    assert [(t.shape, t.dtype) for t in leaves(ps)] == \
        [(torch.Size(l.shape), l.dtype) for l in leaves(bp)]


# --------------------------------------------------------------------------
# (c) the sharded train step
# --------------------------------------------------------------------------

TRAIN_CASES = [(shape, arch, 1) for shape in W.MESHES
               for arch in W.TRAIN_ARCHS] + \
    [(shape, "granite-3-2b", 2) for shape in W.MESHES]


@pytest.mark.parametrize("shape,arch,mb", TRAIN_CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}-mb{m}"
                              for s, a, m in TRAIN_CASES])
def test_sharded_train_step_matches_one_device(world, shape, arch, mb):
    rs = _result(world, ("train", shape, arch, mb))
    r0 = rs[0]
    assert len({r["loss"] for r in rs}) == 1      # the global loss
    assert abs(r0["loss"] - r0["loss_one"]) < STEP_TOL
    np.testing.assert_allclose(r0["grad_norm"], r0["grad_norm_one"],
                               rtol=GRAD_TOL)
    assert r0["zero_grads"] == r0["zero_grads_sharded"]
    bad = {k: e for k, e in r0["gerr"].items() if not e <= GRAD_TOL}
    assert not bad, bad
    bad = {k: e for k, e in r0["perr"].items() if not e <= GRAD_TOL}
    assert not bad, bad


def test_sharded_loss_matches_reference_step(world):
    """granite smoke on (2, 2): the port's sharded loss against the
    reference's ``build_train_step`` on a (2, 2) host mesh."""
    r0 = _result(world, ("train", (2, 2), "granite-3-2b", 1))[0]
    assert abs(r0["loss"] - float(world["jax"]["loss"])) < STEP_TOL
    np.testing.assert_allclose(r0["grad_norm"],
                               float(world["jax"]["grad_norm"]),
                               rtol=GRAD_TOL)


@pytest.mark.parametrize("shape", W.MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in W.MESHES])
def test_sharded_gradients_match_reference(world, shape):
    """granite smoke: each leaf's gradient of the port's sharded step,
    gathered, and of its one-device step, against the reference's under
    its (2, 2) host mesh's shardings, at relative L2 error
    ``REF_GRAD_TOL``."""
    r0 = _result(world, ("train", shape, "granite-3-2b", 1))[0]
    ref = world["jax"]
    assert sorted(r0["grads"]) == sorted(k[len("grad__"):] for k in ref
                                         if k.startswith("grad__"))
    for which in ("grads", "grads_one"):
        errs = {k: float(np.linalg.norm(g - ref["grad__" + k])
                         / np.linalg.norm(ref["grad__" + k]))
                for k, g in r0[which].items()}
        bad = {k: e for k, e in errs.items() if not e <= REF_GRAD_TOL}
        assert not bad, (which, bad)


# --------------------------------------------------------------------------
# (d) sharded prefill and decode
# --------------------------------------------------------------------------

SERVE_CASES = [(shape, arch) for shape in W.MESHES for arch in W.SERVE_ARCHS]


@pytest.mark.parametrize("shape,arch", SERVE_CASES,
                         ids=[f"{a}-{s[0]}x{s[1]}" for s, a in SERVE_CASES])
def test_sharded_prefill_and_decode_match_one_device(world, shape, arch):
    r0 = _result(world, ("serve", shape, arch))[0]
    assert r0["prefill_ok"], r0["prefill_err"]
    assert r0["decode_ok"], r0["decode_errs"]
    cfg = get_config(arch, smoke=True)
    if cfg.n_kv_heads % shape[1]:   # kv 2 on 4: the sequence is split
        assert r0["seq"] == ["model"], r0
        assert r0["cache_spec"][2] == "model"
    else:
        assert r0["seq"] == [] and r0["cache_spec"][3] == "model"


@pytest.mark.parametrize("shape", W.MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in W.MESHES])
def test_sharded_prefill_and_decode_match_reference(world, shape):
    """granite smoke: the port's sharded prefill logits and 6 decode
    steps' logits, gathered, against the reference's ``jit_prefill_step``
    and ``jit_decode_step`` on the same mesh shape of host devices, at
    ``TOL``."""
    r0 = _result(world, ("serve", shape, "granite-3-2b"))[0]
    tag = f"{shape[0]}x{shape[1]}"
    np.testing.assert_allclose(r0["prefill"], world["jax"]["prefill_" + tag],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(r0["decode"], world["jax"]["decode_" + tag],
                               atol=TOL, rtol=TOL)


# --------------------------------------------------------------------------
# (f) the recurrent mixers sharded
# --------------------------------------------------------------------------

REC_CASES = [(shape, arch) for shape in W.MESHES
             for arch in W.RECURRENT_ARCHS]
REC_IDS = [f"{a.split('-')[0]}-{s[0]}x{s[1]}" for s, a in REC_CASES]


@pytest.mark.parametrize("shape,arch", REC_CASES, ids=REC_IDS)
def test_recurrent_sharded_loss_matches_one_device(world, shape, arch):
    rs = _result(world, ("loss", shape, arch))
    assert len({r["loss"] for r in rs}) == 1
    assert abs(rs[0]["loss"] - rs[0]["loss_one"]) < STEP_TOL


@pytest.mark.parametrize("shape,arch", REC_CASES, ids=REC_IDS)
def test_recurrent_sharded_prefill_and_decode_match_one_device(
        world, shape, arch):
    r0 = _result(world, ("serve", shape, arch))[0]
    assert r0["f32"]["prefill"] <= F32_TOL, r0["f32"]
    assert r0["f32"]["decode"] <= F32_TOL, r0["f32"]
    noise = r0["noise"]
    assert r0["prefill_err"] <= noise["prefill"], (r0["prefill_err"], noise)
    assert max(r0["decode_errs"]) <= noise["decode"], \
        (r0["decode_errs"], noise)
    if arch.startswith("jamba"):    # kv 2 on 4: the sequence is split
        assert r0["seq"] == (["model"] if shape[1] == 4 else [])


@pytest.mark.parametrize("shape", W.MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in W.MESHES])
@pytest.mark.parametrize("which", sorted(W.MIXERS))
def test_sharded_mixer_gradients_match_one_device(world, shape, which):
    """A mixer block in float32: its output, its input's gradient and
    every leaf's, under the context (gathered) against none."""
    r0 = _result(world, ("mixer", shape, which))[0]
    assert r0["y"] <= GRAD_TOL and r0["x"] <= GRAD_TOL, r0
    bad = {k: e for k, e in r0["grads"].items() if not e <= GRAD_TOL}
    assert not bad, bad


@pytest.mark.parametrize("shape", W.MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in W.MESHES])
def test_mamba_x_proj_adjoint_sums_the_ranks_partials(world, shape):
    """Each rank's dC, dB and d(dt) are sums over its own ``d_inner``
    channels only; the x_proj all-reduce's adjoint sums them over the
    ranks. Without that sum, x_proj's gradient (xz^T of the whole dC, dB
    and d(dt)) and the input's (through in_proj) would hold one rank's
    part alone."""
    r0 = _result(world, ("mixer", shape, "mamba"))[0]
    for k in ("x_proj", "in_proj", "dt_proj", "A_log"):
        assert r0["grads"][k] <= GRAD_TOL, (k, r0["grads"][k])
    assert r0["x"] <= GRAD_TOL


@pytest.mark.parametrize("shape", W.MESHES,
                         ids=[f"{s[0]}x{s[1]}" for s in W.MESHES])
@pytest.mark.parametrize("which", sorted(W.MIXERS))
def test_sharded_mixer_decode_matches_one_device(world, shape, which):
    """3 decode steps of a mixer in float32 under the context against
    none: each step's output and each rank's part of the state; the
    state sharded as ``cache_pspecs`` says (mamba and sLSTM on their
    channels, the mLSTM's replicated)."""
    rs = _result(world, ("mixer_decode", shape, which))
    cfg = get_config(W.MIXERS[which][0], smoke=True)
    m = shape[1]
    want = {"mamba": [(W.MIX_B, cfg.ssm_d_conv - 1, cfg.ssm_d_inner // m),
                      (W.MIX_B, cfg.ssm_d_inner // m, cfg.ssm_d_state)],
            "mlstm": [(W.MIX_B, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                      (W.MIX_B, cfg.n_heads, cfg.head_dim),
                      (W.MIX_B, cfg.n_heads)],
            "slstm": [(W.MIX_B, cfg.d_model // m)] * 4}[which]
    for r in rs:
        assert max(r["y"]) <= GRAD_TOL and max(r["state"]) <= GRAD_TOL, r
        assert r["local_state"] == want


def test_jamba_sharded_matches_reference(world):
    """jamba's smoke on (2, 2): the sharded loss against the reference's
    ``build_train_step`` at ``STEP_TOL``; its prefill (32 tokens) and 6
    decode steps in float32 (each side's ``float32_lm``) against the
    reference's ``jit_prefill_step`` and ``jit_decode_step`` at
    ``F32_TOL`` (the one-device port is 4.4e-5 from them in float32; in
    bf16 these random smoke models are ROADMAP C15's)."""
    ref = world["jax"]
    loss = _result(world, ("loss", (2, 2), "jamba-1.5-large-398b"))[0]
    assert abs(loss["loss"] - float(ref["jamba_loss"])) < STEP_TOL
    r0 = _result(world, ("serve", (2, 2), "jamba-1.5-large-398b"))[0]
    for kind in ("prefill", "decode"):
        np.testing.assert_allclose(r0[kind], ref["jamba_" + kind],
                                   atol=F32_TOL, rtol=0)


def test_xlstm_sharded_decode_matches_reference(world):
    """xlstm's smoke on (2, 2): 6 sharded decode steps in float32 against
    the reference's ``jit_decode_step`` (its recurrence), at ``F32_TOL``
    (the one-device port is 2.2e-4 from it in float32)."""
    r0 = _result(world, ("serve", (2, 2), "xlstm-1.3b"))[0]
    np.testing.assert_allclose(r0["decode"], world["jax"]["xlstm_decode"],
                               atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("blocks", [2, 4])
def test_blocks_layouts_shard_and_round_trip(world, blocks):
    """On (1, 4): a leaf of ``blocks`` blocks, each rank's shard its part
    of every block (mamba's in_proj [x | z], the sLSTM's [i | f | z |
    o]), and ``unshard`` gives the leaf back."""
    for r in _result(world, ("blocks", (1, 4))):
        assert r[blocks] == {"shard": True, "round_trip": True}


def test_blocks_refuse_a_block_that_does_not_split(world):
    """ROADMAP C19, repaired: where 4 blocks of 6 meet a model axis of 4
    (24 splits 4 ways, a block does not), nothing is refused any more.
    The smoke xlstm at d 6 on (1, 4), in float32: the sharded prefill's
    logits and the sharded step's loss meet one process at ``F32_TOL``
    (the same sums in another order)."""
    r0 = _result(world, ("uneven_slstm", (1, 4)))[0]
    assert r0["prefill"] < F32_TOL
    assert abs(r0["loss"] - r0["loss_one"]) < F32_TOL * abs(r0["loss_one"])


def test_uneven_block_leaf_is_cut_as_one_dim(world):
    """The 24 columns cut as one dim, 6 a rank (the reference's layout),
    and joined back the same way; the sLSTM's wx, wh and b so stored and
    its wo (6 rows, which do not split 4 ways) whole on every rank, its
    spec replicated there."""
    for r in _result(world, ("blocks", (1, 4))):
        assert r["uneven"] == {"shard": True, "round_trip": True}
    for r in _result(world, ("uneven_slstm", (1, 4))):
        assert r["local"] == {"wx": (1, 6, 6), "wh": (1, 6, 6),
                              "b": (1, 6), "wo": (1, 6, 6)}
        assert tuple(r["wx_spec"]) == ("data", "model")
        assert "model" not in tuple(r["wo_spec"])


def test_only_a_dim_beside_an_uneven_leaf_is_kept_whole(world):
    """``fit_specs`` replicates a dim that does not split only beside a
    ``blocks`` leaf cut as one dim (the sLSTM's wo rows); a lone dim of 6
    on a model axis of 4 keeps its spec, and ``shard`` still refuses
    it."""
    for r in _result(world, ("blocks", (1, 4))):
        assert r["fit"] == {"wx": (None, "model"), "wo": (),
                            "lone": ("model",)}
        assert r["lone_refused"] and "does not split 4 ways" in \
            r["lone_refused"]


def test_uneven_slstm_decode_matches_one_process(world):
    """C19's xlstm: 6 sharded decode steps (the sLSTM's state whole on
    every rank, its gates gathered each step) against one process, in
    float32, at ``F32_TOL``."""
    r0 = _result(world, ("uneven_slstm", (1, 4)))[0]
    assert len(r0["decode"]) == W.DEC_STEPS
    assert max(r0["decode"]) < F32_TOL, r0["decode"]


def test_uneven_slstm_gradients_match_one_process(world):
    """C19's xlstm step: every leaf's gradient, gathered, against one
    process in float32 at relative L2 ``F32_TOL``; the embedding's at
    ``GRAD_TOL``, as the LM looks its rows up in bf16 on both paths (the
    gradient there is rounded to bf16 and summed over the ranks in
    another order)."""
    r0 = _result(world, ("uneven_slstm", (1, 4)))[0]
    assert any("/slstm/" in n for n in r0["gerr"])
    bad = {n: e for n, e in r0["gerr"].items()
           if not e < (GRAD_TOL if n == "/embed" else F32_TOL)}
    assert not bad, bad


# --------------------------------------------------------------------------
# (g) the sequence-parallel residual
# --------------------------------------------------------------------------

def test_seqpar_refuses_a_sequence_that_does_not_split(world):
    """On (1, 4): a rank's shard is its quarter of S; S = 6 is refused,
    naming the flag, before a slice or a reduce-scatter."""
    for r in _result(world, ("seq_split", (1, 4))):
        assert r["part"]
        for k in ("seq_part", "row_out"):
            assert r[k] and "seq_shard_activations" in r[k], r


@pytest.mark.parametrize("arch", W.SEQPAR_ARCHS)
def test_seqpar_step_matches_step_without(world, arch):
    rs = _result(world, ("seqpar", (2, 2), arch))
    r0 = rs[0]
    assert r0["sp"] == ["model"] and r0["sp_off"] == []
    assert r0["f32"] == (arch in W.RECURRENT_ARCHS)
    assert abs(r0["loss_sp"] - r0["loss"]) < STEP_TOL
    bad = {k: e for k, e in r0["gerr"].items() if not e <= GRAD_TOL}
    assert not bad, bad
    for r in rs:    # the residual's all-reduces became RS + AG
        off, on = r["coll"]["bytes"], r["coll_sp"]["bytes"]
        assert on["all-reduce"] < off["all-reduce"]
        assert on["reduce-scatter"] > off["reduce-scatter"]
        assert on["all-gather"] > off["all-gather"]


# --------------------------------------------------------------------------
# (e) launch/train.py --distributed
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """2 ranks of the launcher for 3 steps (a checkpoint at 3), and one
    process straight for 5 steps."""
    wd = tmp_path_factory.mktemp("launch")
    ck = wd / "ckpt"
    codes = _spawn(W.launch_rank, 2, ([_port() for _ in W.LAUNCH_ARCHS],
                                      str(ck), str(wd)))
    runs = [torch.load(wd / f"launch{r}.pt") if (wd / f"launch{r}.pt")
            .exists() else None for r in range(2)]
    threads = torch.get_num_threads()
    # one thread, as each rank: the plain scan's many small ops crawl on
    # a host whose cores the other test workers share
    torch.set_num_threads(1)
    try:
        straight = _one(["--steps", "5", "--ckpt-dir",
                         str(wd / "straight"), "--ckpt-every", "100"])
        with W.float32_launch():
            jamba = _one(["--steps", "3", "--arch", "jamba-1.5-large-398b",
                          "--ckpt-dir", str(wd / "jamba"), "--ckpt-every",
                          "100"])
    finally:
        torch.set_num_threads(threads)
    return {"codes": codes, "runs": runs, "ckpt": ck / "granite-3-2b",
            "straight": straight.losses, "jamba": jamba.losses}


def _one(args):
    from repro_torch.launch import train
    return train.main(["--device", "cpu", "--batch", "4", "--seq", "32",
                       *args])


def test_launch_train_distributed_matches_one_process(launched):
    assert launched["codes"] == [0, 0]
    r0, r1 = (r["granite-3-2b"] for r in launched["runs"])
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 3
    np.testing.assert_allclose(r0["losses"], launched["straight"][:3],
                               rtol=1e-4)


def test_launch_train_distributed_takes_jamba(launched):
    """jamba's smoke config (mamba, attention, MoE with its random router)
    under the launcher's (2, 1) mesh, in float32 on both sides
    (``W.float32_launch``: the bf16 gradients of these random smoke
    models are ill-conditioned, ROADMAP C15): every step's loss equals
    one process's within 1e-4 relative."""
    assert launched["codes"] == [0, 0]
    r0, r1 = (r["jamba-1.5-large-398b"] for r in launched["runs"])
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 3
    np.testing.assert_allclose(r0["losses"], launched["jamba"], rtol=1e-4)


def test_launch_train_resumes_onto_one_device(launched):
    assert launched["codes"] == [0, 0]
    res = _one(["--steps", "5", "--ckpt-dir", str(launched["ckpt"])])
    assert res.resumed_from == 3 and res.steps_done == 5
    np.testing.assert_allclose(res.losses, launched["straight"][3:],
                               rtol=1e-4)
