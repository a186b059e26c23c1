"""Whole-model parity of the training loss: ``LM.loss_fn`` and every
leaf's gradient, for every config the port runs, against
``jax.value_and_grad`` of the reference's ``loss_fn`` on the same params
(``test_torch_archs.py``'s: the same cut and routers) and tokens of
``tests/test_torch_train.py``'s shape, (2, 64). seamless-m4t's batch
adds 32 source frames (half the tokens, so that the tokens reach its
decoder: ROADMAP C16), qwen2-vl's 16 patch embeddings on a 4 x 4 grid
and their M-RoPE positions (``test_torch_encdec.py`` has more).

Tolerances, the existing ones (``tests/test_torch_train.py``): the loss
at ``TOL`` 0.1, each leaf's gradient at relative L2 error ``GRAD_TOL``
2e-2; a leaf that the loss does not read (the mLSTM's ``norm``) has a
zero gradient on both sides.

xlstm-1.3b's oracle is the NLL of the reference's decode recurrence run
teacher-forced over the sequence (``test_torch_archs.py``; its chunked
mLSTM is not causal, ROADMAP C14), built the way the reference's
``loss_fn`` builds it (the last position has no label).

Three configs meet the reference's loss but not, whole, its gradients
(ROADMAP C15): kimi-k2's router, jamba's and xlstm's leaves. Their smoke
LMs are ill-conditioned in bf16: one ulp of noise on a tenth of the
embedding's entries moves the port's own gradients by as much as it
differs from the reference's (``tests/arch_parity_report.py`` prints
both). Their mixers' gradients are held block by block instead
(``test_torch_xlstm.py``, ``test_torch_ssm.py``); kimi-k2's layers are
olmoe's (router, experts) and a dense MLP, held whole here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.models.blueprint import tree_map
from repro_torch.models.registry import mrope_grid_positions
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import (StepConfig, build_train_step,
                                          value_and_grad)
from test_torch_archs import RUN, _ref_teacher_forced, carried

TOL = 0.1
GRAD_TOL = 2e-2
B, S = 2, 64
TRAIN = RUN
#: frontend frames a batch carries: seamless's source, qwen2-vl's patches
FRAMES = {"seamless-m4t-large-v2": 32, "qwen2-vl-72b": 16}
#: the configs whose gradients are held whole
WHOLE = [a for a in TRAIN if a not in ("kimi-k2-1t-a32b",
                                       "jamba-1.5-large-398b",
                                       "xlstm-1.3b")]


def _paths(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _paths(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _paths(sub, f"{path}/{i}").items()}
    return {path: tree}


def decode_nll(arch):
    """The xlstm oracle's loss as a function of the reference's params and
    tokens."""
    cfg = carried(arch)[0]
    run = _ref_teacher_forced(arch)

    def loss(p, tokens):
        logits = run(p, tokens)[..., :cfg.vocab]
        n, s = tokens.shape
        labels = jnp.concatenate([tokens[:, 1:], tokens[:, :1]], axis=1)
        valid = jnp.ones((n, s), jnp.float32).at[:, -1].set(0.0)
        lse = jax.nn.logsumexp(logits, axis=-1)
        ll = jnp.take_along_axis(logits, labels[..., None], axis=-1)[..., 0]
        return ((lse - ll) * valid).sum() / valid.sum()

    return loss


def tokens(arch):
    return np.random.default_rng(0).integers(
        0, carried(arch)[0].vocab, (B, S)).astype(np.int32)


def batches(arch):
    """(the reference's batch, the port's): the tokens, and the config's
    frames (numpy seed, bf16) and M-RoPE positions."""
    cfg = carried(arch)[0]
    toks = tokens(arch)
    ref, port = {"tokens": jnp.array(toks)}, {"tokens": torch.from_numpy(toks)}
    if arch in FRAMES:
        fe = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (B, FRAMES[arch], cfg.d_model)).astype(np.float32)).bfloat16()
        ref["frontend_embeds"] = jnp.array(fe.float().numpy(), jnp.bfloat16)
        port["frontend_embeds"] = fe
    if cfg.pos == "mrope":
        pos = mrope_grid_positions(B, S, 4, 4)
        ref["mrope_positions"] = jnp.array(pos.numpy())
        port["mrope_positions"] = pos
    return ref, port


@functools.lru_cache(maxsize=None)
def both(arch):
    """((loss, grads) of the reference or its oracle, the port's), the
    grads as {path: float32 array}."""
    cfg, ref, rp, model, params, _ = carried(arch)
    rb, pb = batches(arch)
    if arch == "xlstm-1.3b":
        fn = decode_nll(arch)
        rb = rb["tokens"]
    else:
        def fn(p, b):
            return ref.loss_fn(p, b)
    want_l, want_g = jax.jit(jax.value_and_grad(fn))(rp, rb)
    loss, grads = value_and_grad(model, params, pb, remat=True)
    assert loss.dtype == torch.float32
    return ((float(want_l), {k: np.asarray(v, np.float32)
                             for k, v in _paths(want_g).items()}),
            (float(loss), {k: v.float().numpy()
                           for k, v in _paths(grads).items()}))


def grad_errors(arch):
    """{leaf: relative L2 error of the port's gradient}, leaves whose
    reference gradient is zero left out (checked zero on both sides)."""
    (_, want), (_, got) = both(arch)
    assert want.keys() == got.keys()
    errs = {}
    for k, w in want.items():
        if not w.any():
            assert not got[k].any(), k
            continue
        errs[k] = float(np.linalg.norm(got[k] - w) / np.linalg.norm(w))
    return errs


@pytest.mark.parametrize("arch", sorted(FRAMES))
def test_frontend_configs_take_a_microbatched_step(arch):
    """qwen2-vl and seamless-m4t train through ``build_train_step`` at two
    microbatches, their frames and M-RoPE positions split along the batch
    (ROADMAP C17): finite loss, a nonzero gradient norm, the params
    moved."""
    cfg, ref, rp, model, params, _ = carried(arch)
    p = tree_map(torch.clone, params)
    scfg = StepConfig(microbatches=2, remat=True,
                      opt=AdamWConfig(lr=1e-3, warmup_steps=1))
    _, _, met = build_train_step(model, scfg)(
        p, init_opt_state(p, scfg.opt), batches(arch)[1])
    assert np.isfinite(float(met["loss"])) and float(met["grad_norm"]) > 0
    assert not torch.equal(p["unembed"], params["unembed"])


@pytest.mark.parametrize("arch", TRAIN)
def test_loss_fn_matches_reference(arch):
    (want, _), (got, _) = both(arch)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch", WHOLE)
def test_grads_match_reference(arch):
    errs = grad_errors(arch)
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    assert worst[0][1] <= GRAD_TOL, worst


def test_xlstm_unread_leaf_has_zero_gradient():
    """The mLSTM's ``norm`` leaf is in the blueprint (the reference's) and
    read by nothing: both sides give it a zero gradient."""
    (_, want), (_, got) = both("xlstm-1.3b")
    norms = [k for k in want if k.endswith("/mlstm/norm")]
    assert len(norms) == 7
    for k in norms:
        assert not want[k].any() and not got[k].any()
