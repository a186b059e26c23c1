"""The port's training path against the JAX package's, on the CPU.

Inputs come from a numpy seed (or the reference's ``init_params``, carried
over by ``lm_params_from_numpy``) and go through both packages.
Tolerances, each with its reason:

  * ``synthetic_batch``, ``compress_int8``, checkpoints: bit for bit (the
    same numpy draws; the same float32 operations; the same bytes).
  * ``adamw_update``: float32 leaves and moments at rtol 1e-6 (atol 1e-6
    of the leaf's largest value: the global norm is summed in another
    order, and ``b ** step`` is XLA's pow against torch's); bf16 leaves
    within one bf16 ulp (the float32 result rounded once on each side).
  * ``LM.loss_fn`` on granite's and olmoe's smoke configs: the loss at the
    prefill test's ``TOL`` (0.1, tests/test_torch_lm.py), each leaf's
    gradient at relative L2 error 2e-2 against ``jax.grad`` (bf16 products
    rounded at other places: the reference rounds attention scores and
    probabilities to bf16, the port keeps them float32; measured 0.006-
    0.018). olmoe's router is zeroed, so that bf16 near-ties cannot route
    tokens apart (tests/test_torch_moe.py); its aux term is in the loss.
  * three ``build_train_step`` steps, ``microbatches`` 1 and 2: each loss
    within ``STEP_TOL`` = 2e-2 of the reference's (losses about 6.8; the
    gradients' bf16 differences move the params by under an ulp a step).

The reference's ``tests/test_fault.py`` cases run as port cases below:
checkpoint round trip, retention and atomicity, crash-resume
determinism, stateless data addressing, error feedback, AdamW on a
quadratic. The straggler watchdog's slow step is injected by step number
(the step function advances a fake clock at step 6), not by counting
clock calls (ROADMAP C3).
"""
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import get_model as ref_get_model
from repro.models.blueprint import init_params as ref_init_params
from repro.train import checkpoint as RC
from repro.train import data as RD
from repro.train import optimizer as RO
from repro.train import train_step as RS
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models import get_model
from repro_torch.models.blueprint import init_params, tree_map
from repro_torch.train import loop as L
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.data import DataConfig, host_slice, synthetic_batch
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.optimizer import (AdamWConfig, adamw_update,
                                         compress_int8, decompress_int8,
                                         init_error_feedback, init_opt_state,
                                         leaves)
from repro_torch.train.train_step import (StepConfig, build_train_step,
                                          value_and_grad)

TOL = 0.1
GRAD_TOL = 2e-2
STEP_TOL = 2e-2
B, S = 2, 64


def _paths(tree, path=""):
    """{path: leaf} of a tree of dicts and lists (either package's)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _paths(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _paths(sub, f"{path}/{i}").items()}
    return {path: tree}


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _bits16(a) -> np.ndarray:
    """bf16 values (a torch tensor or a JAX array) as int32 of their
    bits, for ulp distances."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().astype(np.int32)
    return np.asarray(a).view(np.int16).astype(np.int32)


# --------------------------------------------------------------------------
# data, optimizer, compression
# --------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,seq,batch,step", [(512, 64, 4, 0),
                                                   (49155, 128, 2, 7),
                                                   (128, 16, 8, 3)])
def test_synthetic_batch_matches_reference(vocab, seq, batch, step):
    cfg = DataConfig(vocab=vocab, seq_len=seq, global_batch=batch)
    rcfg = RD.DataConfig(vocab=vocab, seq_len=seq, global_batch=batch)
    got = synthetic_batch(cfg, step)["tokens"]
    want = RD.synthetic_batch(rcfg, step)["tokens"]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_data_pipeline_stateless_addressing():
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=8)
    a = synthetic_batch(cfg, 7)["tokens"]
    np.testing.assert_array_equal(a, synthetic_batch(cfg, 7)["tokens"])
    assert not np.array_equal(a, synthetic_batch(cfg, 8)["tokens"])
    halves = [host_slice(DataConfig(vocab=128, seq_len=16, global_batch=8,
                                    n_hosts=2, host_id=h),
                         synthetic_batch(cfg, 7))["tokens"] for h in (0, 1)]
    np.testing.assert_array_equal(np.concatenate(halves), a)


def _opt_case(seed: int, step: int, gscale: float):
    """Params (a float32 and a bf16 leaf), grads and carried moments as
    numpy, from a seed."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (64, 48), "b": {"v": (300,)}}
    p = {"w": rng.standard_normal(shapes["w"]).astype(np.float32),
         "b": {"v": rng.standard_normal(300).astype(np.float32)}}
    g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * gscale, p)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * 0.01, p)
    v = jax.tree.map(lambda a: np.abs(rng.standard_normal(a.shape)).astype(
        np.float32) * 1e-4, p)
    return shapes, p, g, m, v, step


@pytest.mark.parametrize("step,gscale", [(0, 0.01), (5, 1.0), (150, 0.02)])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(step, gscale, state_dtype):
    """One update from carried params, grads and moments: warmup (step 0,
    5) and past it (150), clipped (gscale 1: a norm of about 66) and not;
    the b leaf in bf16, its grad too."""
    _, p, g, m, v, step = _opt_case(step, step, gscale)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[state_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[state_dtype]
    rcfg = RO.AdamWConfig(lr=1e-3, state_dtype=jdt)
    cfg = AdamWConfig(lr=1e-3, state_dtype=tdt)
    jp = {"w": jnp.array(p["w"]), "b": {"v": jnp.array(p["b"]["v"],
                                                       jnp.bfloat16)}}
    jg = {"w": jnp.array(g["w"]), "b": {"v": jnp.array(g["b"]["v"],
                                                       jnp.bfloat16)}}
    jstate = {"step": jnp.int32(step), "m": jax.tree.map(
        lambda a: jnp.array(a, jdt), m), "v": jax.tree.map(
        lambda a: jnp.array(a, jdt), v)}
    wp, wstate, wmet = RO.adamw_update(jp, jg, jstate, rcfg)

    to_t = lambda tree: tree_map(  # noqa: E731
        lambda a: torch.from_numpy(np.array(a, np.float32)), _np32(tree))
    tp = {"w": to_t(jp)["w"], "b": {"v": to_t(jp)["b"]["v"].bfloat16()}}
    tg = {"w": to_t(jg)["w"], "b": {"v": to_t(jg)["b"]["v"].bfloat16()}}
    tstate = {"step": torch.tensor(step, dtype=torch.int32),
              "m": tree_map(lambda a: a.to(tdt), to_t(jstate["m"])),
              "v": tree_map(lambda a: a.to(tdt), to_t(jstate["v"]))}
    gp, gstate, gmet = adamw_update(tp, tg, tstate, cfg)

    assert gp is tp and int(gstate["step"]) == step + 1
    np.testing.assert_allclose(float(gmet["grad_norm"]),
                               float(wmet["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(gmet["lr"]), float(wmet["lr"]),
                               rtol=1e-6)
    want = np.asarray(wp["w"])
    np.testing.assert_allclose(gp["w"].numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    assert np.abs(_bits16(gp["b"]["v"]) - _bits16(wp["b"]["v"])).max() <= 1
    for key in ("m", "v"):
        got, want = _paths(gstate[key]), _paths(wstate[key])
        for k, w in want.items():
            if state_dtype == "bfloat16":
                assert np.abs(_bits16(got[k]) - _bits16(w)).max() <= 1
            else:
                w = np.asarray(w)
                np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6,
                                           atol=1e-6 * np.abs(w).max())


def test_adamw_update_works_through_slices(monkeypatch):
    """A leaf updated in slices of 7 elements gets the values of a
    whole-leaf update, bit for bit."""
    from repro_torch.train import optimizer as O
    _, p, g, m, v, _ = _opt_case(1, 3, 0.1)
    run = []
    for sl in (O.SLICE, 7):
        monkeypatch.setattr(O, "SLICE", sl)
        tp = tree_map(lambda a: torch.from_numpy(a.copy()), p)
        state = {"step": torch.tensor(3, dtype=torch.int32),
                 "m": tree_map(lambda a: torch.from_numpy(a.copy()), m),
                 "v": tree_map(lambda a: torch.from_numpy(a.copy()), v)}
        out = adamw_update(tp, tree_map(torch.from_numpy, g), state,
                           AdamWConfig())
        run.append(leaves(out[0]) + leaves(out[1]["m"]))
    assert all(torch.equal(a, b) for a, b in zip(*run))


@pytest.mark.parametrize("n,seed", [(512, 0), (4096, 1), (37, 2)])
def test_compress_int8_matches_reference_bit_for_bit(n, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal(n).astype(np.float32)
    err = (rng.standard_normal(n) * 0.01).astype(np.float32)
    wq, ws, we = RO.compress_int8(jnp.array(g), jnp.array(err))
    q, s, e = compress_int8(torch.from_numpy(g), torch.from_numpy(err))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(e.numpy(), np.asarray(we))
    np.testing.assert_array_equal(decompress_int8(q, s).numpy(),
                                  np.asarray(RO.decompress_int8(wq, ws)))


def test_grad_compression_error_feedback():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        512).astype(np.float32))
    err = init_error_feedback({"g": g})["g"]
    total = torch.zeros_like(g)
    for _ in range(64):
        q, scale, err = compress_int8(g, err)
        total = total + decompress_int8(q, scale)
    np.testing.assert_allclose((total / 64).numpy(), g.numpy(), atol=1e-3)


def test_adamw_decreases_loss_quadratic():
    w = {"w": torch.ones(8) * 5}
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1)
    opt = init_opt_state(w, cfg)
    for _ in range(200):
        w, opt, _ = adamw_update(w, {"w": 2 * w["w"]}, opt, cfg)
    assert float(w["w"].abs().max()) < 0.3


# --------------------------------------------------------------------------
# LM.loss_fn and the train step against the reference
# --------------------------------------------------------------------------

def _carried(arch: str, zero_router: bool = False):
    cfg = ref_get_config(arch, smoke=True)
    ref = ref_get_model(cfg)
    rp = ref_init_params(ref.blueprint(), jax.random.PRNGKey(0))
    if zero_router:
        for layer in rp["stack"]:
            layer["moe"]["router"] = jnp.zeros_like(layer["moe"]["router"])
    model = get_model(get_config(arch, smoke=True))
    params = lm_params_from_numpy(_np32(rp), "cpu", model.blueprint())
    return cfg, ref, rp, model, params


@pytest.mark.parametrize("arch,zero_router", [("granite-3-2b", False),
                                              ("olmoe-1b-7b", True)])
def test_loss_fn_and_grads_match_jax_grad(arch, zero_router):
    cfg, ref, rp, model, params = _carried(arch, zero_router)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    want_l, want_g = jax.value_and_grad(
        lambda p: ref.loss_fn(p, {"tokens": jnp.array(toks)}))(rp)
    loss, grads = value_and_grad(model, params,
                                 {"tokens": torch.from_numpy(toks)},
                                 remat=True)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(want_l), atol=TOL,
                               rtol=TOL)
    want, got = _paths(want_g), _paths(grads)
    assert want.keys() == got.keys()
    for k, w in want.items():
        assert got[k].dtype == params_dtype(params, k)
        w = np.asarray(w, np.float32)
        err = np.linalg.norm(got[k].float().numpy() - w) / np.linalg.norm(w)
        assert err <= GRAD_TOL, (k, err)
    if zero_router:
        # the aux term the loss carries: each MoE layer's load-balancing
        # loss, summed over the stack as the reference sums it (with every
        # router logit tied, each layer's is 1 up to float32 rounding)
        x = params["embed"][torch.from_numpy(toks).long()].bfloat16()
        pos = torch.arange(S)[None, :]
        with torch.no_grad():
            _, aux = model._run_stack(params["stack"], x, pos,
                                      kinds=model.period, causal=True)
        _, want_aux = ref._run_stack(
            rp["stack"], rp["embed"][jnp.array(toks)].astype(jnp.bfloat16),
            jnp.arange(S)[None, :], kinds=ref.period, causal=True)
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
        np.testing.assert_allclose(float(aux), model.n_periods, rtol=1e-5)


def test_loss_chunk_matches_reference():
    """``loss_chunk`` (logits a chunk of 16 positions at a time): the
    reference's loss at TOL, and the port's unchunked loss up to float32
    rounding of the sum."""
    import dataclasses
    cfg = dataclasses.replace(ref_get_config("granite-3-2b", smoke=True),
                              loss_chunk=16)
    ref = ref_get_model(cfg)
    rp = ref_init_params(ref.blueprint(), jax.random.PRNGKey(0))
    model = get_model(dataclasses.replace(
        get_config("granite-3-2b", smoke=True), loss_chunk=16))
    params = lm_params_from_numpy(_np32(rp), "cpu", model.blueprint())
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)
    want = float(ref.loss_fn(rp, {"tokens": jnp.array(toks)}))
    with torch.no_grad():
        got = model.loss_fn(params, {"tokens": torch.from_numpy(toks)})
        whole = get_model(get_config("granite-3-2b", smoke=True)).loss_fn(
            params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(got), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(float(got), float(whole), rtol=1e-6)


def params_dtype(params, path):
    return _paths(params)[path].dtype


def test_remat_changes_no_value():
    """remat recomputes each period in the backward: the same loss and
    gradients, bit for bit."""
    _, _, _, model, params = _carried("granite-3-2b")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (B, S)))
    a = value_and_grad(model, params, {"tokens": toks}, remat=True)
    b = value_and_grad(model, params, {"tokens": toks}, remat=False)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(x, y) for x, y in zip(leaves(a[1]),
                                                 leaves(b[1])))


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_track_reference(microbatches):
    """Three steps of each package's build_train_step from the same
    params and batches (lr 1e-3 from the first step)."""
    cfg, ref, rp, model, params = _carried("granite-3-2b")
    rcfg = RS.StepConfig(microbatches=microbatches, remat=True,
                         opt=RO.AdamWConfig(lr=1e-3, warmup_steps=1))
    scfg = StepConfig(microbatches=microbatches, remat=True,
                      opt=AdamWConfig(lr=1e-3, warmup_steps=1))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    rstep = jax.jit(RS.build_train_step(ref, mesh, rcfg))
    step = build_train_step(model, scfg)
    ropt = RO.init_opt_state(rp, rcfg.opt)
    opt = init_opt_state(params, scfg.opt)
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4)
    for s in range(3):
        toks = synthetic_batch(data, s)["tokens"]
        rp, ropt, rmet = rstep(rp, ropt, {"tokens": jnp.array(toks)})
        params, opt, met = step(params, opt,
                                {"tokens": torch.from_numpy(toks)})
        assert abs(float(met["loss"]) - float(rmet["loss"])) < STEP_TOL, s
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(rmet["grad_norm"]), rtol=GRAD_TOL)
    assert int(opt["step"]) == 3


def test_opt_state_carries_over():
    """The reference's AdamW state after a step, carried into the port by
    ``opt_state_from_numpy``: the next update matches the reference's."""
    _, p, g, m, v, _ = _opt_case(4, 0, 0.05)
    jp = jax.tree.map(jnp.array, p)
    rcfg = RO.AdamWConfig(lr=1e-3)
    jp, jstate, _ = RO.adamw_update(jp, jax.tree.map(jnp.array, g),
                                    RO.init_opt_state(jp, rcfg), rcfg)
    dtype_of = tree_map(lambda a: types.SimpleNamespace(shape=a.shape), p)
    state = opt_state_from_numpy(
        {"step": int(jstate["step"]), "m": _np32(jstate["m"]),
         "v": _np32(jstate["v"])}, "cpu", dtype_of)
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 1
    tp = tree_map(lambda a: torch.from_numpy(np.array(a)), _np32(jp))
    wp, _, _ = RO.adamw_update(jp, jax.tree.map(jnp.array, g), jstate, rcfg)
    gp, _, _ = adamw_update(tp, tree_map(torch.from_numpy, g), state,
                            AdamWConfig(lr=1e-3))
    got, want = _paths(gp), _paths(wp)
    for k, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(got[k].numpy(), w, rtol=1e-6,
                                   atol=1e-6 * np.abs(w).max())


# --------------------------------------------------------------------------
# checkpoints: the reference's format, both ways
# --------------------------------------------------------------------------

def test_reference_checkpoint_restores_bit_for_bit(tmp_path):
    cfg, ref, rp, model, _ = _carried("granite-3-2b")
    ropt = RO.init_opt_state(rp, RO.AdamWConfig())
    ropt["m"] = jax.tree.map(lambda a: a + 0.5, ropt["m"])
    RC.CheckpointManager(str(tmp_path)).save(3, rp, ropt,
                                             extra={"data_step": 3})
    bp = model.blueprint()
    params, opt, extra = CheckpointManager(str(tmp_path)).restore(
        (bp, {"step": None, "m": bp, "v": bp}), device="cpu")
    assert extra == {"data_step": 3}
    assert opt["step"].dtype == torch.int32 and int(opt["step"]) == 0
    got, want = _paths(params), _paths(rp)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits16(got[k]), _bits16(w))
    got, want = _paths(opt["m"]), _paths(ropt["m"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w))


def test_port_checkpoint_restores_in_reference_bit_for_bit(tmp_path):
    model = get_model(get_config("granite-3-2b", smoke=True))
    params = init_params(model.blueprint(), torch.Generator().manual_seed(3))
    opt = init_opt_state(params, AdamWConfig())
    opt["v"] = tree_map(lambda a: a + 0.25, opt["v"])
    CheckpointManager(str(tmp_path)).save(5, params, opt,
                                          extra={"data_step": 5})
    manifest = json.loads((tmp_path / "step_00000005" /
                           "manifest.json").read_text())
    assert manifest["dtypes"]["params/embed"] == "bfloat16"
    assert manifest["dtypes"]["opt/step"] == "int32"
    ref = ref_get_model(ref_get_config("granite-3-2b", smoke=True))
    rp = ref_init_params(ref.blueprint(), jax.random.PRNGKey(0))
    ropt = RO.init_opt_state(rp, RO.AdamWConfig())
    p2, o2, extra = RC.CheckpointManager(str(tmp_path)).restore((rp, ropt))
    assert extra == {"data_step": 5}
    got, want = _paths(p2), _paths(params)
    for k, w in want.items():
        assert str(got[k].dtype) == "bfloat16"
        np.testing.assert_array_equal(_bits16(got[k]), _bits16(w))
    got, want = _paths(o2["v"]), _paths(opt["v"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), w.numpy())


def _tiny():
    return get_model(get_config("granite-3-2b", smoke=True))


def test_checkpoint_roundtrip(tmp_path):
    model = _tiny()
    params = init_params(model.blueprint(), torch.Generator().manual_seed(0))
    opt = init_opt_state(params, AdamWConfig())
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(10, params, opt, extra={"data_step": 10})
    p2, o2, extra = mgr.restore((params, opt), device="cpu")
    assert extra["data_step"] == 10
    for a, b in zip(leaves(params) + leaves(opt), leaves(p2) + leaves(o2)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_retention_and_atomicity(tmp_path):
    model = _tiny()
    params = init_params(model.blueprint(), torch.Generator().manual_seed(0))
    opt = init_opt_state(params, AdamWConfig())
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, params, opt)
    assert mgr.all_steps() == [3, 4]
    assert not list(tmp_path.glob("*.tmp"))
    # a write cut before its rename leaves the latest checkpoint as it was
    (tmp_path / "step_00000005.tmp").mkdir()
    assert mgr.latest_step() == 4


# --------------------------------------------------------------------------
# the loop: resume, straggler watchdog, the CLI
# --------------------------------------------------------------------------

def test_crash_resume_is_deterministic(tmp_path):
    """6 steps with a crash injected at 4 and a resume equal 6 straight
    steps, bit for bit (the same data addressing, the same updates)."""
    model = _tiny()
    data_cfg = DataConfig(vocab=model.cfg.vocab, seq_len=16, global_batch=4)
    scfg = StepConfig(remat=False, opt=AdamWConfig(lr=1e-3))
    res1 = train_loop(model, data_cfg,
                      LoopConfig(total_steps=6, ckpt_every=2, log_every=0),
                      scfg, str(tmp_path / "straight"), device="cpu")
    with pytest.raises(RuntimeError, match="injected failure"):
        train_loop(model, data_cfg,
                   LoopConfig(total_steps=6, ckpt_every=2, log_every=0,
                              fail_at_step=4),
                   scfg, str(tmp_path / "crashy"), device="cpu")
    res2 = train_loop(model, data_cfg,
                      LoopConfig(total_steps=6, ckpt_every=2, log_every=0),
                      scfg, str(tmp_path / "crashy"), device="cpu")
    assert res2.resumed_from == 4 and res2.steps_done == 6
    assert res1.losses[-2:] == res2.losses
    assert len(res1.grad_norms) == len(res1.step_ms) == 6


def test_straggler_watchdog_flags_slow_steps(tmp_path, monkeypatch):
    """Step 6 takes 60 s more on the loop's clock: the step function
    advances a fake clock when the optimizer's step counter says 6."""
    offset, real = [0.0], L.time.perf_counter
    clock = types.SimpleNamespace(perf_counter=lambda: real() + offset[0])
    build = L.build_train_step

    def slow_builder(model, step_cfg):
        step = build(model, step_cfg)

        def run(params, opt, batch):
            if int(opt["step"]) == 6:
                offset[0] += 60.0
            return step(params, opt, batch)
        return run

    monkeypatch.setattr(L, "build_train_step", slow_builder)
    monkeypatch.setattr(L, "time", clock)
    model = _tiny()
    res = train_loop(model, DataConfig(vocab=model.cfg.vocab, seq_len=16,
                                       global_batch=4),
                     LoopConfig(total_steps=10, ckpt_every=100, log_every=0,
                                straggler_factor=3.0),
                     StepConfig(remat=False), str(tmp_path), device="cpu")
    assert [e["step"] for e in res.straggler_events] == [6]


def test_train_loop_refuses_a_data_desync(tmp_path, monkeypatch):
    class Skipping(L.Prefetcher):
        def next(self):
            s, batch = super().next()
            return s + 1, batch

    monkeypatch.setattr(L, "Prefetcher", Skipping)
    model = _tiny()
    with pytest.raises(RuntimeError, match="desync"):
        train_loop(model, DataConfig(vocab=model.cfg.vocab, seq_len=16,
                                     global_batch=2),
                   LoopConfig(total_steps=2, log_every=0), StepConfig(),
                   str(tmp_path), device="cpu")


def test_launch_train_cli_on_the_cpu(tmp_path, capsys):
    launch_train.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "16", "--ckpt-dir", str(tmp_path)])
    assert "done: 2 steps" in capsys.readouterr().out
    # --distributed takes its ranks from a launcher's environment
    # (tests/test_torch_distributed.py runs two)
    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE")
           if k in os.environ}
    try:
        with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE"):
            launch_train.main(["--distributed", "--device", "cpu"])
    finally:
        os.environ.update(env)
