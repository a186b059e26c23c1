"""The port's LM against the JAX package's, at smoke size.

granite-3-2b's smoke variant (2 layers, d_model 128, 4 heads with 2 KV
heads, head_dim 32, vocab 512): the JAX package's ``init_params`` output
goes to the port through ``lm_params_from_numpy``, and the same tokens go
through both ``prefill`` and ``decode_step``.

Tolerance: atol = rtol = 0.1 on float32 logits of size up to ~4, both
sides in bf16. Measured: prefill 0.035, decode 0.036 (one or two bf16
ulps of the logits; the reference rounds attention scores and
probabilities to bf16, the port's prefill keeps them in float32). The
prompt is 64 tokens, a multiple of the smoke config's attention chunk
(32): the reference's chunked attention is wrong for a ragged last chunk
(ROADMAP C6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import get_model as ref_get_model
from repro.models.blueprint import init_params as ref_init_params
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import get_model
from repro_torch.models.blueprint import count_params, init_params
from repro_torch.train.train_step import value_and_grad

B, S = 2, 64
TOL = 0.1


def _flat(tree, path=""):
    """{path: leaf} of a tree of dicts and lists (either package's)."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: tree}


@pytest.fixture(scope="module")
def granite():
    cfg = ref_get_config("granite-3-2b", smoke=True)
    ref = ref_get_model(cfg)
    ref_params = ref_init_params(ref.blueprint(), jax.random.PRNGKey(0))
    model = get_model(get_config("granite-3-2b", smoke=True))
    params = lm_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), ref_params),
        "cpu", model.blueprint())
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (B, S))
    return cfg, ref, ref_params, model, params, toks.astype(np.int32)


def test_params_carry_over_exactly(granite):
    cfg, ref, ref_params, model, params, toks = granite
    ref_flat, flat = _flat(ref_params), _flat(params)
    assert flat.keys() == ref_flat.keys()
    for k, t in flat.items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(np.asarray(ref_flat[k], np.float32),
                                      t.float().numpy())


def test_prefill_matches_reference(granite):
    cfg, ref, ref_params, model, params, toks = granite
    want = np.asarray(ref.prefill(ref_params, jnp.array(toks)))
    got = model.prefill(params, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_decode_steps_match_reference(granite):
    cfg, ref, ref_params, model, params, toks = granite
    ref_cache = ref.init_cache(B, 16)
    cache = model.init_cache(B, 16, device="cpu")
    for t in range(6):
        pos = np.full((B,), t, np.int32)
        want, ref_cache = ref.decode_step(ref_params, ref_cache,
                                          jnp.array(toks[:, t:t + 1]),
                                          jnp.array(pos))
        got, cache = model.decode_step(
            params, cache, torch.from_numpy(toks[:, t:t + 1]).long(),
            torch.from_numpy(pos))
        assert got.shape == (B, 1, cfg.padded_vocab)
        np.testing.assert_allclose(got.numpy()[..., :cfg.vocab],
                                   np.asarray(want)[..., :cfg.vocab],
                                   atol=TOL, rtol=TOL)
        assert (got[..., cfg.vocab:] == -1e30).all()
    # the in-place cache holds what the reference's functional one holds
    for ref_kv, kv in zip(ref_cache, cache):
        for name in ("k", "v"):
            np.testing.assert_allclose(kv[name].float().numpy(),
                                       np.asarray(ref_kv[name], np.float32),
                                       atol=TOL, rtol=TOL)


def test_decode_matches_prefill(granite):
    """The port's own check (tests/test_archs.py's, tolerance and all):
    teacher-forced decode reproduces prefill's last-position logits."""
    cfg, ref, ref_params, model, params, toks = granite
    full = model.prefill(params, torch.from_numpy(toks[:1, :8]).long())
    cache = model.init_cache(1, 16, device="cpu")
    for t in range(8):
        logits, cache = model.decode_step(
            params, cache, torch.from_numpy(toks[:1, t:t + 1]).long(),
            torch.full((1,), t))
    np.testing.assert_allclose(logits[:, 0, :cfg.vocab].numpy(),
                               full[:, :cfg.vocab].numpy(), atol=0.55,
                               rtol=0.1)


DENSE = sorted(n for n, m in ARCHS.items()
               if m.CONFIG.family in ("dense", "vlm"))


@pytest.mark.parametrize("arch", DENSE)
def test_blueprint_matches_reference(arch):
    """Every attention-and-dense-FF config: same leaves, shapes, axes,
    init rules and dtypes, smoke and full (the full one is never
    allocated)."""
    for smoke in (True, False):
        ref_bp = _flat(ref_get_model(ref_get_config(arch, smoke)).blueprint())
        bp = _flat(get_model(get_config(arch, smoke)).blueprint())
        assert bp.keys() == ref_bp.keys()
        for k, l in bp.items():
            r = ref_bp[k]
            assert (l.shape, l.axes, l.init, l.scale_dim) == \
                (r.shape, r.axes, r.init, r.scale_dim), k
            assert str(l.dtype) == f"torch.{np.dtype(r.dtype).name}", k
        assert count_params(get_model(get_config(arch, smoke)).blueprint()) \
            == sum(int(np.prod(r.shape)) for r in ref_bp.values())


def test_init_params_follows_the_rules():
    model = get_model(get_config("granite-3-2b", smoke=True))
    bp = model.blueprint()
    p = init_params(bp, torch.Generator().manual_seed(0), "cpu")
    assert (p["ln_f"]["scale"] == 1).all()
    w = p["stack"][0]["mlp"]["wi"].float()       # fan-in d_model = 128
    assert w.shape == (2, 128, 512)
    assert abs(float(w.std()) - 128 ** -0.5) < 0.01
    again = init_params(bp, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["embed"], p["embed"])


def test_init_params_draws_large_leaves_in_slices(monkeypatch):
    """A leaf past DRAW_SLICE elements is drawn slice by slice into the
    leaf itself: the same rules (dtype, scale, seed), other numbers."""
    from repro_torch.models import blueprint as BP
    bp = get_model(get_config("granite-3-2b", smoke=True)).blueprint()
    whole = init_params(bp, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(BP, "DRAW_SLICE", 1000)
    sliced = init_params(bp, torch.Generator().manual_seed(0), "cpu")
    again = init_params(bp, torch.Generator().manual_seed(0), "cpu")
    w, w0 = sliced["stack"][0]["mlp"]["wi"], whole["stack"][0]["mlp"]["wi"]
    assert w.shape == w0.shape and w.dtype == w0.dtype == torch.bfloat16
    assert abs(float(w.float().std()) - 128 ** -0.5) < 0.01
    assert torch.equal(w, again["stack"][0]["mlp"]["wi"])
    assert not torch.equal(w, w0)
    small = sliced["stack"][0]["ln1"]["scale"]          # ones, not drawn
    assert torch.equal(small, whole["stack"][0]["ln1"]["scale"])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_model_builds(arch):
    """Every config builds, smoke and full, the encoder-decoder too: its
    blueprint has the reference's parameter count (the full one is never
    allocated)."""
    for smoke in (True, False):
        bp = get_model(get_config(arch, smoke)).blueprint()
        ref_bp = ref_get_model(ref_get_config(arch, smoke)).blueprint()
        assert count_params(bp) == sum(
            int(np.prod(r.shape)) for r in _flat(ref_bp).values())


def test_loss_fn_trains_the_encoder_decoder():
    """seamless-m4t's ``loss_fn`` (``test_torch_encdec.py`` holds it to
    the reference's): a finite loss from tokens and source frames, whose
    gradient reaches the encoder and the cross-attention."""
    model = get_model(get_config("seamless-m4t-large-v2", smoke=True))
    params = init_params(model.blueprint(), torch.Generator().manual_seed(0),
                         "cpu")
    batch = {"tokens": torch.randint(0, 512, (1, 16)),
             "frontend_embeds": torch.randn(1, 8, 128).bfloat16()}
    loss, grads = value_and_grad(model, params, batch, remat=True)
    assert torch.isfinite(loss)
    for g in (grads["enc_stack"][0]["attn"]["wq"],
              grads["stack"][0]["xattn"]["wk"], grads["enc_ln_f"]["scale"]):
        assert g.float().norm() > 0


@pytest.mark.parametrize("grad", [True, False])
def test_kernels_without_backward_refuse_grad(grad):
    """The expert FF and the selective scan on a tensor that is neither on
    the CPU nor on a card (meta tensors stand in for CUDA ones here): a
    call that autograd records goes through the layers' Functions
    (``GroupedExpertFF``, ``SelectiveScan``) to the forward kernels'
    device checks, which refuse the meta device before anything is
    launched; without grad the wrappers refuse it the same way. Nothing
    falls back to a plain version."""
    from repro_torch.kernels.moe_dispatch import moe_dispatch as MD
    from repro_torch.kernels.moe_dispatch import moe_dispatch_bwd as MB
    from repro_torch.kernels.selective_scan import selective_scan as SS
    from repro_torch.kernels.selective_scan import selective_scan_bwd as SB
    meta = dict(device="meta", requires_grad=grad)
    x, wi = torch.ones(2, 4, 64, **meta), torch.ones(2, 64, 64, **meta)
    wo = torch.ones(2, 32, 64, **meta)
    dA = torch.ones(1, 8, 16, 8, **meta)
    Cm = torch.ones(1, 8, 8, device="meta")
    h0 = torch.zeros(1, 16, 8, device="meta")
    ff = (lambda: MB.GroupedExpertFF.apply(x, wi, wo, None, True)) \
        if grad else (lambda: MD.grouped_expert_ff(x, wi, wo))
    scan = (lambda: SB.SelectiveScan.apply(dA, dA.detach(), Cm, h0)) \
        if grad else (lambda: SS.selective_scan(dA, dA.detach(), Cm))
    for call in (ff, scan):
        with pytest.raises(ValueError, match="CUDA device"):
            call()


# --------------------------------------------------------------------------
# parallel_block (command-r-plus-104b): ROADMAP C11
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def command_r():
    """command-r-plus-104b's smoke variant (parallel attention + FF), the
    reference's params carried over, and one 12-token prompt."""
    cfg = ref_get_config("command-r-plus-104b", smoke=True)
    assert cfg.parallel_block
    ref = ref_get_model(cfg)
    ref_params = ref_init_params(ref.blueprint(), jax.random.PRNGKey(0))
    model = get_model(get_config("command-r-plus-104b", smoke=True))
    params = lm_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), ref_params),
        "cpu", model.blueprint())
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (1, 12))
    return cfg, ref, ref_params, model, params, toks.astype(np.int32)


def _ref_decode_last(ref, ref_params, toks):
    cache = ref.init_cache(1, 16)
    for t in range(toks.shape[1]):
        logits, cache = ref.decode_step(ref_params, cache,
                                        jnp.array(toks[:, t:t + 1]),
                                        jnp.array([t], jnp.int32))
    return np.asarray(logits)[:, 0]


def test_parallel_block_prefill_matches_reference(command_r):
    cfg, ref, ref_params, model, params, toks = command_r
    want = np.asarray(ref.prefill(ref_params, jnp.array(toks)))
    got = model.prefill(params, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_parallel_block_decode_matches_prefill(command_r):
    """The port decodes a parallel block as prefill computes it:
    teacher-forced decode reproduces its own prefill at granite's
    tolerance (tests/test_archs.py's)."""
    cfg, ref, ref_params, model, params, toks = command_r
    full = model.prefill(params, torch.from_numpy(toks).long())
    cache = model.init_cache(1, 16, device="cpu")
    for t in range(toks.shape[1]):
        logits, cache = model.decode_step(
            params, cache, torch.from_numpy(toks[:, t:t + 1]).long(),
            torch.full((1,), t))
    np.testing.assert_allclose(logits[:, 0, :cfg.vocab].numpy(),
                               full[:, :cfg.vocab].numpy(), atol=0.55,
                               rtol=0.1)


def test_reference_decodes_parallel_block_sequentially(command_r):
    """ROADMAP C11, on the reference as it is: its decode of a parallel
    block runs attention and FF one after the other, so its decode does
    not reproduce its own prefill, by far more than granite's tolerance;
    the port's decode stays within it of the reference's prefill."""
    cfg, ref, ref_params, model, params, toks = command_r
    want = np.asarray(ref.prefill(ref_params, jnp.array(toks)))[:, :cfg.vocab]
    ref_gap = np.abs(_ref_decode_last(ref, ref_params, toks)[:, :cfg.vocab]
                     - want).max()
    assert ref_gap > 1.0
    cache = model.init_cache(1, 16, device="cpu")
    for t in range(toks.shape[1]):
        logits, cache = model.decode_step(
            params, cache, torch.from_numpy(toks[:, t:t + 1]).long(),
            torch.full((1,), t))
    np.testing.assert_allclose(logits[:, 0, :cfg.vocab].numpy(), want,
                               atol=0.55, rtol=0.1)
