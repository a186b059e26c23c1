"""The encoder-decoder stack and the VLM inputs, on the CPU, against the
JAX package: seamless-m4t-large-v2 and qwen2-vl-72b at smoke size, with
the reference's ``init_params`` carried over (``test_torch_archs.py``'s
``carried``) and inputs drawn from a numpy seed.

  * seamless: the blueprint and the carried params and moments (the
    encoder's ``enc_stack`` and ``enc_ln_f``, the decoder's ``xattn`` and
    ``lnx``), the encoder, ``prefill`` (the decoder alone, as the
    reference's), 6 ``decode_step``s against one encoder output,
    ``loss_fn`` and every leaf's gradient at the reference's train split
    (as many frames as tokens) and at half as many frames;
  * qwen2-vl: ``loss_fn`` and every leaf's gradient with patch
    embeddings and M-RoPE positions laid out as Qwen2-VL does;
  * ROADMAP C16 on both packages: at the reference's split the decoder
    reads no token (the embedding table does not move the loss), and
    more frames than tokens fail (the port raises ``ValueError``);
  * ROADMAP C17: the reference's microbatched step cannot split a VLM
    batch; the port's 2-microbatch step is the mean of its halves and
    meets its 1-microbatch step;
  * remat: the encoder's gradient is the same with and without it;
  * ``input_specs`` against the reference's for every config and shape.

Tolerances, the existing ones: logits and the loss at ``TOL`` 0.1
(``tests/test_torch_lm.py``), each leaf's gradient at relative L2 error
``GRAD_TOL`` 2e-2 (``tests/test_torch_train.py``), the encoder's output
at ``BLOCK_TOL`` 3e-2 (``tests/test_torch_ssm.py``'s, a block in bf16).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import registry as RR
from repro.models.transformer import LayerKind as RefLayerKind
from repro.train import optimizer as RO
from repro.train import train_step as RS
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import opt_state_from_numpy
from repro_torch.models import get_model, registry
from repro_torch.models.blueprint import tree_map
from repro_torch.train.optimizer import AdamWConfig, init_opt_state
from repro_torch.train.train_step import (StepConfig, build_train_step,
                                          microbatch, value_and_grad)
from test_torch_archs import carried
from test_torch_archs_train import _paths

SEAMLESS, QWEN = "seamless-m4t-large-v2", "qwen2-vl-72b"
TOL = 0.1
GRAD_TOL = 2e-2
BLOCK_TOL = 3e-2
B, S = 2, 64


def _frames(n, S_src, d, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, S_src, d)).astype(np.float32)


def _tokens(cfg, n, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (n, s)).astype(np.int32)


def _batches(arch, Sf, S_tgt=S):
    """The same batch for both packages: tokens (B, S_tgt), frames
    (B, Sf, d) in bf16, and for qwen2-vl the M-RoPE positions of a
    (Sf = h * w) patch grid."""
    cfg = carried(arch)[0]
    toks = _tokens(cfg, B, S_tgt)
    fe = torch.from_numpy(_frames(B, Sf, cfg.d_model)).bfloat16()
    ref = {"tokens": jnp.array(toks),
           "frontend_embeds": jnp.array(fe.float().numpy(), jnp.bfloat16)}
    port = {"tokens": torch.from_numpy(toks), "frontend_embeds": fe}
    if cfg.pos == "mrope":
        side = int(Sf ** 0.5)
        pos = registry.mrope_grid_positions(B, S_tgt, side, Sf // side)
        ref["mrope_positions"] = jnp.array(pos.numpy())
        port["mrope_positions"] = pos
    return ref, port


@functools.lru_cache(maxsize=None)
def both(arch, Sf):
    """((loss, {leaf: grad}) of the reference, the port's) on
    ``_batches(arch, Sf)``."""
    cfg, ref, rp, model, params, _ = carried(arch)
    rb, pb = _batches(arch, Sf)
    want_l, want_g = jax.jit(jax.value_and_grad(
        lambda p, b: ref.loss_fn(p, b)))(rp, rb)
    loss, grads = value_and_grad(model, params, pb, remat=True)
    return ((float(want_l), {k: np.asarray(v, np.float32)
                             for k, v in _paths(want_g).items()}),
            (float(loss), {k: v.float().numpy()
                           for k, v in _paths(grads).items()}))


def _grad_errors(arch, Sf):
    (_, want), (_, got) = both(arch, Sf)
    assert want.keys() == got.keys()
    errs = {}
    for k, w in want.items():
        if not w.any():
            assert not got[k].any(), k
            continue
        errs[k] = float(np.linalg.norm(got[k] - w) / np.linalg.norm(w))
    return errs


# --------------------------------------------------------------------------
# seamless-m4t: blueprint, carried params, encoder, prefill, decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
def test_seamless_blueprint_matches_reference(smoke):
    """The encoder's and the cross-attention's leaves, with the
    reference's names, shapes, axes and init rules; the full config is
    never allocated."""
    from repro.models import get_model as ref_get_model
    ref_bp = _paths(ref_get_model(ref_get_config(SEAMLESS, smoke))
                    .blueprint())
    bp = _paths(get_model(get_config(SEAMLESS, smoke)).blueprint())
    assert bp.keys() == ref_bp.keys()
    for k, l in bp.items():
        r = ref_bp[k]
        assert (l.shape, l.axes, l.init, l.scale_dim) == \
            (r.shape, r.axes, r.init, r.scale_dim), k
    assert {"/enc_ln_f/scale", "/enc_stack/0/attn/wq", "/stack/0/xattn/wo",
            "/stack/0/lnx/scale"} <= bp.keys()
    n_enc = bp["/enc_stack/0/attn/wq"].shape[0]
    assert n_enc == ref_get_config(SEAMLESS, smoke).enc_layers


def test_seamless_params_and_moments_carry_over():
    """``lm_params_from_numpy`` and ``opt_state_from_numpy`` walk the
    blueprint, so the encoder's and the cross-attention's leaves arrive
    bit for bit, params and AdamW moments."""
    cfg, ref, rp, model, params, _ = carried(SEAMLESS)
    want = _paths(rp)
    got = _paths(params)
    assert got.keys() == want.keys()
    for k in ("/enc_stack/0/attn/wk", "/enc_stack/0/mlp/wi", "/enc_ln_f/scale",
              "/stack/0/xattn/wv", "/stack/0/lnx/scale"):
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))
    rcfg = RO.AdamWConfig(lr=1e-3)
    g = jax.tree.map(lambda a: jnp.full(a.shape, 1e-3, jnp.float32), rp)
    _, state, _ = RO.adamw_update(rp, g, RO.init_opt_state(rp, rcfg), rcfg)
    np32 = jax.tree.map(lambda a: np.asarray(a, np.float32), state)
    port = opt_state_from_numpy({"step": int(state["step"]),
                                 "m": np32["m"], "v": np32["v"]}, "cpu",
                                model.blueprint())
    for name in ("m", "v"):
        w, p = _paths(np32[name]), _paths(port[name])
        for k in ("/enc_stack/0/attn/wq", "/stack/0/xattn/wk",
                  "/stack/0/lnx/scale"):
            assert p[k].dtype == torch.float32
            np.testing.assert_array_equal(p[k].numpy(), w[k])


def _ref_encode(ref, rp, frames):
    src = jnp.array(frames, jnp.bfloat16)
    out, _ = ref._run_stack(rp["enc_stack"], src,
                            jnp.arange(src.shape[1])[None, :],
                            kinds=[RefLayerKind("attn", "dense")],
                            causal=False)
    return RL.rmsnorm(rp["enc_ln_f"], out)


def test_seamless_encoder_matches_reference():
    """The encoder (non-causal, RoPE on the source positions, enc_ln_f)
    over 40 frames: ragged against the smoke attention chunk."""
    cfg, ref, rp, model, params, _ = carried(SEAMLESS)
    frames = _frames(B, 40, cfg.d_model)
    want = np.asarray(_ref_encode(ref, rp, frames), np.float32)
    got = model._encode(params, torch.from_numpy(frames))
    assert got.dtype == torch.bfloat16 and got.shape == (B, 40, cfg.d_model)
    np.testing.assert_allclose(got.float().numpy(), want, atol=BLOCK_TOL,
                               rtol=BLOCK_TOL)


def test_seamless_prefill_runs_the_decoder_alone():
    """As the reference's: no encoder, no cross-attention (the xattn
    leaves do not move the logits)."""
    cfg, ref, rp, model, params, toks = carried(SEAMLESS)
    t = torch.from_numpy(toks).long()
    got = model.prefill(params, t)
    want = np.asarray(ref.prefill(rp, jnp.array(toks)))
    np.testing.assert_allclose(got.numpy()[:, :cfg.vocab],
                               want[:, :cfg.vocab], atol=TOL, rtol=TOL)
    zeroed = {**params, "stack": [{**layer, "xattn": tree_map(
        torch.zeros_like, layer["xattn"])} for layer in params["stack"]]}
    assert torch.equal(model.prefill(zeroed, t), got)


@pytest.mark.parametrize("S_src", [40, 64])
def test_seamless_decode_against_encoder_matches_reference(S_src):
    """6 decode steps from an empty cache against one encoder output
    (B, S_src, d), which each step's cross-attention reads whole (one
    query row against S_src keys, non-causal)."""
    cfg, ref, rp, model, params, toks = carried(SEAMLESS)
    enc = torch.from_numpy(_frames(B, S_src, cfg.d_model, seed=5)).bfloat16()
    ref_enc = jnp.array(enc.float().numpy(), jnp.bfloat16)
    ref_cache = ref.init_cache(B, 16)
    cache = model.init_cache(B, 16, device="cpu")
    for t in range(6):
        pos = np.full((B,), t, np.int32)
        tok = toks[:, t:t + 1]
        want, ref_cache = ref.decode_step(rp, ref_cache, jnp.array(tok),
                                          jnp.array(pos), ref_enc)
        got, cache = model.decode_step(params, cache,
                                       torch.from_numpy(tok).long(),
                                       torch.from_numpy(pos), enc)
        np.testing.assert_allclose(got.numpy()[:, 0, :cfg.vocab],
                                   np.asarray(want)[:, 0, :cfg.vocab],
                                   atol=TOL, rtol=TOL)
    # the encoder's output reaches the logits
    other, _ = model.decode_step(params, model.init_cache(B, 16, "cpu"),
                                 torch.from_numpy(toks[:, :1]).long(),
                                 torch.zeros(B, dtype=torch.long),
                                 torch.zeros_like(enc))
    first, _ = model.decode_step(params, model.init_cache(B, 16, "cpu"),
                                 torch.from_numpy(toks[:, :1]).long(),
                                 torch.zeros(B, dtype=torch.long), enc)
    assert not torch.equal(other, first)


def test_seamless_decode_matches_own_forward():
    """Teacher-forced decode against one encoder output reproduces the
    decoder's full causal forward over the same tokens and encoder output
    at every position (tests/test_archs.py's atol 0.55, rtol 0.1)."""
    cfg, ref, rp, model, params, toks = carried(SEAMLESS)
    enc = torch.from_numpy(_frames(1, 24, cfg.d_model, seed=6)).bfloat16()
    t = torch.from_numpy(toks[:1, :12]).long()
    full = model._decoder_forward(params, t, enc)
    cache = model.init_cache(1, 16, device="cpu")
    for i in range(12):
        got, cache = model.decode_step(params, cache, t[:, i:i + 1],
                                       torch.full((1,), i), enc)
        np.testing.assert_allclose(got[:, 0, :cfg.vocab].numpy(),
                                   full[:, i, :cfg.vocab].numpy(),
                                   atol=0.55, rtol=0.1)


# --------------------------------------------------------------------------
# training: loss and gradients
# --------------------------------------------------------------------------

#: seamless's frames: the reference's train split (Sf = S_tgt), where
#: the decoder reads the frames alone (C16), and half as many, where the
#: tokens reach the decoder; qwen2-vl's: a 4 x 4 patch grid
SPLITS = [(SEAMLESS, S), (SEAMLESS, S // 2), (QWEN, 16)]


@pytest.mark.parametrize("arch,Sf", SPLITS)
def test_loss_fn_matches_reference(arch, Sf):
    (want, _), (got, _) = both(arch, Sf)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("arch,Sf", SPLITS)
def test_grads_match_reference(arch, Sf):
    """Every leaf's gradient, the encoder's included, at GRAD_TOL."""
    errs = _grad_errors(arch, Sf)
    if arch == SEAMLESS:
        assert any(k.startswith("/enc_stack/") for k in errs)
        assert "/stack/0/xattn/wq" in errs
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    assert worst[0][1] <= GRAD_TOL, worst


def test_mrope_positions_reach_the_loss():
    """qwen2-vl's loss reads the M-RoPE positions: text positions in
    place of the grid's move it."""
    cfg, ref, rp, model, params, _ = carried(QWEN)
    _, pb = _batches(QWEN, 16)
    plain = dict(pb, mrope_positions=torch.arange(S).expand(3, B, S))
    with torch.no_grad():
        a = model.loss_fn(params, pb)
        b = model.loss_fn(params, plain)
    assert float(a) != float(b)


def test_mrope_grid_positions_follow_qwen2_vl():
    """The patches at t = 0 on their (row, column), then the text from the
    grid's largest index on, the same on the three axes and every row."""
    pos = registry.mrope_grid_positions(2, 10, 2, 3)
    assert pos.shape == (3, 2, 10) and pos.dtype == torch.int32
    assert pos[:, 0, :6].tolist() == [[0] * 6, [0, 0, 0, 1, 1, 1],
                                      [0, 1, 2, 0, 1, 2]]
    assert (pos[:, :, 6:] == torch.arange(3, 7)).all()
    assert torch.equal(pos[:, 0], pos[:, 1])
    with pytest.raises(ValueError):
        registry.mrope_grid_positions(1, 5, 2, 3)


def test_remat_keeps_the_encoders_gradient():
    """Every checkpoint region takes the encoder's output as an argument,
    so the gradient that the decoder's cross-attention layers send back
    reaches the encoder with and without remat alike."""
    cfg, ref, rp, model, params, _ = carried(SEAMLESS)
    _, pb = _batches(SEAMLESS, S // 2)
    _, g0 = value_and_grad(model, params, pb, remat=False)
    _, g1 = value_and_grad(model, params, pb, remat=True)
    a, b = _paths(g0), _paths(g1)
    enc = [k for k in a if k.startswith("/enc")]
    assert len(enc) == 9
    for k in enc:
        assert a[k].float().norm() > 0, k
        torch.testing.assert_close(b[k], a[k], rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# ROADMAP C16 and C17
# --------------------------------------------------------------------------

def test_c16_decoder_reads_frames_not_tokens_at_the_train_split():
    """At Sf = S_tgt both packages write the frames over every token
    embedding: the embedding table's gradient is zero and a zeroed table
    leaves the loss bit for bit; at Sf = S_tgt / 2 it is not so."""
    cfg, ref, rp, model, params, _ = carried(SEAMLESS)
    (_, want), (_, got) = both(SEAMLESS, S)
    assert not want["/embed"].any() and not got["/embed"].any()
    (_, want_half), (_, got_half) = both(SEAMLESS, S // 2)
    assert want_half["/embed"].any() and got_half["/embed"].any()
    rb, pb = _batches(SEAMLESS, S)
    rz = dict(rp, embed=jnp.zeros_like(rp["embed"]))
    assert float(ref.loss_fn(rp, rb)) == float(ref.loss_fn(rz, rb))
    pz = dict(params, embed=torch.zeros_like(params["embed"]))
    with torch.no_grad():
        assert torch.equal(model.loss_fn(params, pb),
                           model.loss_fn(pz, pb))


def test_c16_more_frames_than_tokens_fail():
    """Sf > S_tgt: the reference fails on shapes, the port raises
    ValueError naming C16."""
    cfg, ref, rp, model, params, _ = carried(SEAMLESS)
    rb, pb = _batches(SEAMLESS, 40, S_tgt=32)
    with pytest.raises((TypeError, ValueError)):
        ref.loss_fn(rp, rb)
    with pytest.raises(ValueError, match="C16"):
        model.loss_fn(params, pb)


def test_c17_reference_cannot_microbatch_a_vlm_batch():
    """The reference reshapes axis 0 of every leaf: (3, B, S) M-RoPE
    positions do not split in two."""
    cfg, ref, rp, model, params, _ = carried(QWEN)
    rb, _ = _batches(QWEN, 16)
    rcfg = RS.StepConfig(microbatches=2, remat=True)
    step = RS.build_train_step(ref, None, rcfg)
    with pytest.raises(TypeError):
        step(rp, RO.init_opt_state(rp, rcfg.opt), rb)


def test_c17_microbatches_split_mrope_along_the_batch():
    """The port splits the positions along axis 1: the 2-microbatch step's
    loss is the mean of its halves' (each half sliced by hand), and meets
    the 1-microbatch step's loss and gradient norm."""
    cfg, ref, rp, model, params, _ = carried(QWEN)
    _, pb = _batches(QWEN, 16)
    half = microbatch(pb, 2, 1)
    assert torch.equal(half["mrope_positions"], pb["mrope_positions"][:, 1:])
    assert torch.equal(half["frontend_embeds"], pb["frontend_embeds"][1:])
    halves = [float(value_and_grad(model, params, {
        "tokens": pb["tokens"][i:i + 1],
        "frontend_embeds": pb["frontend_embeds"][i:i + 1],
        "mrope_positions": pb["mrope_positions"][:, i:i + 1]},
        remat=True)[0]) for i in range(2)]
    mets = []
    for n in (1, 2):
        scfg = StepConfig(microbatches=n, remat=True,
                          opt=AdamWConfig(lr=1e-3, warmup_steps=1))
        p = tree_map(torch.clone, params)
        _, _, met = build_train_step(model, scfg)(
            p, init_opt_state(p, scfg.opt), pb)
        mets.append(met)
    assert float(mets[1]["loss"]) == pytest.approx(sum(halves) / 2,
                                                   rel=1e-6)
    np.testing.assert_allclose(float(mets[1]["loss"]),
                               float(mets[0]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(mets[1]["grad_norm"]),
                               float(mets[0]["grad_norm"]), rtol=GRAD_TOL)


# --------------------------------------------------------------------------
# input specs
# --------------------------------------------------------------------------

def _spec_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(
            tree, registry.Spec):
        return [x for v in tree for x in _spec_leaves(v)]
    return [(tuple(tree.shape), str(tree.dtype).split(".")[-1])]


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_input_specs_match_reference(arch, shape):
    """Each input's shape and dtype, the decode cache's leaves included
    (the full configs: nothing is allocated)."""
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    want = RR.input_specs(ref_get_config(arch), shape)
    got = registry.input_specs(get_config(arch), shape)
    assert got.keys() == want.keys()
    for k in got:
        assert _spec_leaves(got[k]) == _spec_leaves(want[k]), k
