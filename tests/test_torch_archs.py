"""Whole-model parity: every config the port runs, at smoke size, against
the JAX package on the same params (``init_params`` of the reference,
carried over by ``lm_params_from_numpy``).

Here: prefill, and 6 decode steps from an empty cache (seamless-m4t's
without an encoder output, as the reference's prefill runs its decoder;
``test_torch_encdec.py`` decodes it against one).
``test_torch_archs_train.py`` holds ``loss_fn`` and its gradients.

Tolerances, the existing ones (no new bound):
  * ``TOL`` 0.1 (atol and rtol) on float32 logits for the dense and MoE
    configs (``tests/test_torch_lm.py``, ``tests/test_torch_train.py``);
  * ``LM_ATOL`` 0.2, ``LM_RTOL`` 0.1 for the recurrent ones, jamba and
    xlstm, 16 layers deep (``tests/test_torch_ssm.py``).
The MoE configs (olmoe, kimi-k2, jamba) zero their routers, as
``test_torch_moe.py``, ``test_torch_ssm.py`` and ``test_torch_train.py``
do: bf16 near-ties route tokens apart otherwise. S is 32, a multiple of
the smoke attention chunk (32, ROADMAP C6) and of the mamba chunk (16,
C10).

Two configs take another oracle than the reference's own function, for
faults of the reference:
  * command-r-plus-104b: the reference decodes a parallel block
    sequentially (ROADMAP C11), so the port's decode step t is held to
    the reference's prefill of the first t + 1 tokens;
  * xlstm-1.3b: the reference's chunked mLSTM, which its prefill and
    ``loss_fn`` run, reads the rest of its chunk (ROADMAP C14), so the
    oracle is its decode recurrence, ``decode_step`` run teacher-forced
    over the sequence (in JAX, under ``lax.scan``).

The recurrent configs are cut to one period (8 layers), as
``test_torch_ssm.py`` cuts jamba. xlstm's whole-model logits are held
layer by layer (ROADMAP C15): each of its 8 layers, fed the oracle's
residual stream, meets the oracle's layer at ``BLOCK_TOL`` 3e-2
(``test_torch_ssm.py``'s) over every position, in prefill and in decode,
and the final norm and unembedding meet it at ``TOL``. Its smoke LM is
ill-conditioned in bf16: one ulp of noise on a tenth of the embedding's
entries moves the port's own logits by up to about 1, so the two sides'
one-ulp differences a layer (the reference's XLA keeps excess
precision between operations) put the chained logits 0.17-0.48 apart,
past ``LM_ATOL`` (``tests/arch_parity_report.py`` prints these numbers).
Chained, the port's decode reproduces its own prefill at the tolerance
of ``tests/test_archs.py`` (atol 0.55, rtol 0.1).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import get_model as ref_get_model
from repro.models import layers as RL
from repro.models.blueprint import init_params as ref_init_params
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import get_model
from repro_torch.models import layers as PL
from repro_torch.models.blueprint import tree_map

#: every config the port runs
RUN = sorted(ARCHS)
ZERO_ROUTER = ("olmoe-1b-7b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b")
RECURRENT = ("jamba-1.5-large-398b", "xlstm-1.3b")
TOL = 0.1
LM_ATOL, LM_RTOL = 0.2, 0.1
BLOCK_TOL = 3e-2
B, S = 2, 32
#: the configs held whole against the reference's logits
WHOLE = [a for a in RUN if a != "xlstm-1.3b"]


def tol(arch):
    """(atol, rtol) of an arch's logits."""
    return (LM_ATOL, LM_RTOL) if arch in RECURRENT else (TOL, TOL)


def _cut(cfg):
    """A recurrent config cut to one period (8 layers), as
    ``test_torch_ssm.py`` cuts jamba; the others as they are."""
    if cfg.name.removesuffix("-smoke") in RECURRENT:
        return dataclasses.replace(cfg, n_layers=len(cfg.layer_pattern()))
    return cfg


@functools.lru_cache(maxsize=None)
def carried(arch):
    """(config, reference LM, its params, port LM, the same params, tokens
    (B, S) int32)."""
    cfg = _cut(ref_get_config(arch, smoke=True))
    ref = ref_get_model(cfg)
    rp = ref_init_params(ref.blueprint(), jax.random.PRNGKey(0))
    if arch in ZERO_ROUTER:
        for layer in rp["stack"]:
            if "moe" in layer:
                layer["moe"]["router"] = jnp.zeros_like(
                    layer["moe"]["router"])
    model = get_model(_cut(get_config(arch, smoke=True)))
    params = lm_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), rp), "cpu",
        model.blueprint())
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    return cfg, ref, rp, model, params, toks.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _ref_teacher_forced(arch):
    """The reference's decode_step over the whole sequence, under
    lax.scan, as a function of its params: logits (B, S, V) float32."""
    cfg, ref, rp, model, params, toks = carried(arch)

    def run(p, tokens):
        def step(cache, t):
            logits, cache = ref.decode_step(
                p, cache, jax.lax.dynamic_slice_in_dim(tokens, t, 1, 1),
                jnp.full((tokens.shape[0],), t, jnp.int32))
            return cache, logits[:, 0]

        _, out = jax.lax.scan(step, ref.init_cache(tokens.shape[0],
                                                   tokens.shape[1]),
                              jnp.arange(tokens.shape[1]))
        return jnp.moveaxis(out, 0, 1)

    return run


def test_every_config_runs():
    assert "seamless-m4t-large-v2" in RUN and "qwen2-vl-72b" in RUN
    assert len(RUN) == len(ARCHS) == 10


@pytest.mark.parametrize("arch", WHOLE)
def test_prefill_matches_reference(arch):
    cfg, ref, rp, model, params, toks = carried(arch)
    atol, rtol = tol(arch)
    got = model.prefill(params, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32
    assert got.shape == (B, cfg.padded_vocab)
    want = np.asarray(ref.prefill(rp, jnp.array(toks)))
    np.testing.assert_allclose(got.numpy()[:, :cfg.vocab],
                               want[:, :cfg.vocab], atol=atol, rtol=rtol)


@pytest.mark.parametrize("arch", WHOLE)
def test_decode_steps_match_reference(arch):
    cfg, ref, rp, model, params, toks = carried(arch)
    atol, rtol = tol(arch)
    ref_cache = ref.init_cache(B, 16)
    cache = model.init_cache(B, 16, device="cpu")
    for t in range(6):
        pos = np.full((B,), t, np.int32)
        tok = toks[:, t:t + 1]
        got, cache = model.decode_step(params, cache,
                                       torch.from_numpy(tok).long(),
                                       torch.from_numpy(pos))
        if arch == "command-r-plus-104b":
            want = np.asarray(ref.prefill(rp, jnp.array(toks[:, :t + 1])))
        else:
            want, ref_cache = ref.decode_step(rp, ref_cache, jnp.array(tok),
                                              jnp.array(pos))
            want = np.asarray(want)[:, 0]
        assert got.shape == (B, 1, cfg.padded_vocab)
        np.testing.assert_allclose(got.numpy()[:, 0, :cfg.vocab],
                                   want[:, :cfg.vocab], atol=atol,
                                   rtol=rtol)


# --------------------------------------------------------------------------
# xlstm-1.3b, layer by layer against its decode recurrence
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _xlstm_oracle_layers():
    """The reference's decode recurrence, teacher-forced, layer by layer:
    the residual stream into each layer and out of it, (B, S, d) float32
    each, and the final stream."""
    cfg, ref, rp, model, params, toks = carried("xlstm-1.3b")
    layers = [jax.tree.map(lambda a: a[0], rp["stack"])[k]
              for k in range(len(ref.period))]
    cache = [jax.tree.map(lambda a: a[0], c)
             for c in ref.init_cache(B, S)]
    steps = {kind: jax.jit(functools.partial(ref._decode_layer, kind))
             for kind in set(ref.period)}
    ins = [[] for _ in layers]
    x = rp["embed"][jnp.array(toks)].astype(jnp.bfloat16)
    final = []
    for t in range(S):
        h = x[:, t:t + 1]
        pos = jnp.full((B,), t, jnp.int32)
        for k, kind in enumerate(ref.period):
            ins[k].append(np.asarray(h, np.float32))
            h, cache[k] = steps[kind](layers[k], cache[k], h, pos[:, None],
                                      pos, None)
        final.append(np.asarray(h, np.float32))
    return ([np.concatenate(i, 1) for i in ins], np.concatenate(final, 1))


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


def test_xlstm_layers_match_reference_recurrence():
    """Each layer's prefill (the port's chunked mLSTM or its sLSTM loop)
    over all 32 positions, fed the oracle's input to that layer, against
    the oracle's output of that layer."""
    cfg, ref, rp, model, params, toks = carried("xlstm-1.3b")
    ins, final = _xlstm_oracle_layers()
    outs = ins[1:] + [final]
    pp = tree_map(lambda a: a[0], params["stack"])
    assert [k.mixer for k in model.period] == ["slstm"] + ["mlstm"] * 7
    for k, kind in enumerate(model.period):
        got = model._apply_layer(kind, pp[k], _bf16(ins[k]),
                                 torch.arange(S)[None, :], causal=True)
        np.testing.assert_allclose(got.float().numpy(), outs[k],
                                   atol=BLOCK_TOL, rtol=BLOCK_TOL,
                                   err_msg=f"layer {k}")


def test_xlstm_decode_layers_match_reference_recurrence():
    """Each layer's decode step over the 32 positions, its state carried
    in the port's cache, fed the oracle's input to that layer."""
    cfg, ref, rp, model, params, toks = carried("xlstm-1.3b")
    ins, final = _xlstm_oracle_layers()
    outs = ins[1:] + [final]
    pp = tree_map(lambda a: a[0], params["stack"])
    cache = model.init_cache(B, S, device="cpu")
    for t in range(S):
        pos = torch.full((B,), t)
        for k, kind in enumerate(model.period):
            lc = (tuple(a[0] for a in cache[k]) if kind.mixer == "slstm"
                  else {n: a[0] for n, a in cache[k].items()})
            got = model._decode_layer(kind, pp[k], lc,
                                      _bf16(ins[k][:, t:t + 1]),
                                      pos[:, None], pos)
            np.testing.assert_allclose(got.float().numpy(),
                                       outs[k][:, t:t + 1], atol=BLOCK_TOL,
                                       rtol=BLOCK_TOL,
                                       err_msg=f"step {t}, layer {k}")


def test_xlstm_head_matches_reference():
    """The final norm and the tied unembedding on the oracle's final
    stream: the logits at every position, at TOL."""
    cfg, ref, rp, model, params, toks = carried("xlstm-1.3b")
    _, final = _xlstm_oracle_layers()
    fj = jnp.array(final, jnp.bfloat16)
    want = np.asarray(jnp.einsum("bsd,dv->bsv", RL.rmsnorm(rp["ln_f"], fj),
                                 rp["embed"].T).astype(jnp.float32))
    x = PL.rmsnorm(params["ln_f"], _bf16(final))
    got = (x @ model._unembed(params)).float()
    np.testing.assert_allclose(got.numpy()[..., :cfg.vocab],
                               want[..., :cfg.vocab], atol=TOL, rtol=TOL)


def test_xlstm_decode_matches_own_prefill():
    """Chained: teacher-forced decode reproduces the port's own prefill
    at every position (tests/test_archs.py's tolerance), over two chunks
    of 16."""
    cfg, ref, rp, model, params, toks = carried("xlstm-1.3b")
    x = params["embed"][torch.from_numpy(toks).long()].to(torch.bfloat16)
    x, _ = model._run_stack(params["stack"], x, torch.arange(S)[None, :],
                            kinds=model.period, causal=True)
    full = (PL.rmsnorm(params["ln_f"], x) @ model._unembed(params)).float()
    last = model.prefill(params, torch.from_numpy(toks).long())
    np.testing.assert_array_equal(full[:, -1].numpy(), last.numpy())
    cache = model.init_cache(B, S, device="cpu")
    for t in range(S):
        logits, cache = model.decode_step(
            params, cache, torch.from_numpy(toks[:, t:t + 1]).long(),
            torch.full((B,), t))
        np.testing.assert_allclose(logits[:, 0, :cfg.vocab].numpy(),
                                   full[:, t, :cfg.vocab].numpy(),
                                   atol=0.55, rtol=0.1, err_msg=f"step {t}")


def test_xlstm_blueprint_and_params_match_reference():
    """Same leaves, shapes, axes, init rules and dtypes as the
    reference's, smoke and full (the full one is never allocated:
    1,035,343,872 params), and the carried params bit for bit."""
    from repro_torch.models.blueprint import count_params
    for smoke in (True, False):
        ref_bp = _flat(ref_get_model(ref_get_config("xlstm-1.3b", smoke))
                       .blueprint())
        bp = _flat(get_model(get_config("xlstm-1.3b", smoke)).blueprint())
        assert bp.keys() == ref_bp.keys()
        for k, leaf in bp.items():
            r = ref_bp[k]
            assert (leaf.shape, leaf.axes, leaf.init, leaf.scale_dim) == \
                (r.shape, r.axes, r.init, r.scale_dim), k
            assert str(leaf.dtype) == f"torch.{np.dtype(r.dtype).name}", k
    assert count_params(get_model(get_config("xlstm-1.3b")).blueprint()) \
        == 1_035_343_872 == sum(int(np.prod(r.shape))
                                for r in ref_bp.values())
    cfg, ref, rp, model, params, toks = carried("xlstm-1.3b")
    ref_flat, flat = _flat(rp), _flat(params)
    assert flat.keys() == ref_flat.keys()
    for k, t in flat.items():
        np.testing.assert_array_equal(np.asarray(ref_flat[k], np.float32),
                                      t.float().numpy())


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: tree}
