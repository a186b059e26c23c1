"""Whole-model parity of the training loss: ``LM.loss_fn`` and every
leaf's gradient, for every config the port runs but qwen2-vl-72b (its
``loss_fn`` needs VLM inputs, ROADMAP A11) and seamless-m4t (A11), against
``jax.value_and_grad`` of the reference's ``loss_fn`` on the same params
(``test_torch_archs.py``'s: the same cut and routers) and tokens of
``tests/test_torch_train.py``'s shape, (2, 64).

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

from repro_torch.train.train_step import value_and_grad
from test_torch_archs import RUN, _ref_teacher_forced, carried

TOL = 0.1
GRAD_TOL = 2e-2
B, S = 2, 64
TRAIN = [a for a in RUN if a != "qwen2-vl-72b"]
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


@functools.lru_cache(maxsize=None)
def both(arch):
    """((loss, grads) of the reference or its oracle, the port's), the
    grads as {path: float32 array}."""
    cfg, ref, rp, model, params, _ = carried(arch)
    toks = tokens(arch)
    if arch == "xlstm-1.3b":
        fn = decode_nll(arch)
    else:
        def fn(p, t):
            return ref.loss_fn(p, {"tokens": t})
    want_l, want_g = jax.jit(jax.value_and_grad(fn))(rp, jnp.array(toks))
    loss, grads = value_and_grad(model, params,
                                 {"tokens": torch.from_numpy(toks)},
                                 remat=True)
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


def test_qwen2_vl_training_is_a11():
    """Its loss_fn raises naming the ROADMAP item: the port's VLM inputs
    wait for A11."""
    cfg, ref, rp, model, params, toks = carried("qwen2-vl-72b")
    with pytest.raises(NotImplementedError, match="A11"):
        model.loss_fn(params, {"tokens": torch.from_numpy(toks),
                               "mrope_positions": torch.zeros(3, 2, 32)})


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
