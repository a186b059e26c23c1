"""The port's mamba block and jamba LM against the JAX package's, at smoke
size.

The mamba block (d 128, d_inner 256, d_state 16, conv 4, jamba's smoke
widths) gets the same bf16 input and the JAX package's ``init_params``
output on both sides. Held at ``BLOCK_TOL`` = 3e-2 (rtol and atol) on
outputs of size up to ~10: both sides round the projections and the
conv to bf16 at the same places and scan in float32 (measured: at most
0.0078, one bf16 ulp).

The reference's chunked scan is right only where the chunk divides S
(ROADMAP C10): it clamps the last chunk's start. At a ragged S the port
is held to the reference run with one chunk of S, the unchunked oracle.

The LM is jamba's smoke config cut to one period (8 layers: mamba at
every index but 4, MoE on the odd ones), with the routers zeroed as in
``test_torch_moe.py``: bf16 near-ties would route tokens apart. Layer
by layer the two sides meet within a bf16 ulp of the residual stream,
which grows to ~12 (ulp 0.0625); over 8 layers the logits (std ~1)
meet at atol = 0.2, rtol = 0.1 (measured 0.109 at prefill, 0.146 over 6
decode steps; the port keeps attention scores and the expert hidden in
float32 where the reference rounds them to bf16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import get_model as ref_get_model
from repro.models import ssm as RS
from repro.models.blueprint import init_params as ref_init_params
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.selective_scan import selective_scan as SSK
from repro_torch.models import get_model
from repro_torch.models import ssm as PS
from repro_torch.models.blueprint import count_params

ARCH = "jamba-1.5-large-398b"
BLOCK_TOL = 3e-2
LM_ATOL, LM_RTOL = 0.2, 0.1
D, D_INNER, N, CHUNK = 128, 256, 16, 16


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _flat(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{path}/{i}").items()}
    return {path: tree}


@pytest.fixture(scope="module")
def block():
    """One mamba block's params, the reference's and the port's."""
    ref_p = ref_init_params(RS.mamba_bp(D, D_INNER, N, 4),
                            jax.random.PRNGKey(1))
    return ref_p, lm_params_from_numpy(_np(ref_p), "cpu",
                                       PS.mamba_bp(D, D_INNER, N, 4))


def _x(shape, seed):
    t = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                         .astype(np.float32)).bfloat16()
    return jnp.array(t.float().numpy(), jnp.bfloat16), t


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("S", [16, 32, 64])
def test_scan_matches_reference(block, S):
    """S a multiple of the chunk: the reference's chunking is right."""
    ref_p, p = block
    xj, xt = _x((2, S, D), S)
    got = PS.mamba_scan_chunked(p, xt, d_state=N, chunk=CHUNK)
    assert got.dtype == torch.bfloat16 and got.shape == (2, S, D)
    _close(got, RS.mamba_scan_chunked(ref_p, xj, d_state=N, chunk=CHUNK),
           BLOCK_TOL, BLOCK_TOL)


@pytest.mark.parametrize("S", [1, 9, 40])
def test_scan_is_right_at_a_ragged_length(block, S):
    """S not a multiple of the chunk: the port meets the reference run
    unchunked (one chunk of S)."""
    ref_p, p = block
    xj, xt = _x((2, S, D), 100 + S)
    _close(PS.mamba_scan_chunked(p, xt, d_state=N, chunk=CHUNK),
           RS.mamba_scan_chunked(ref_p, xj, d_state=N, chunk=S),
           BLOCK_TOL, BLOCK_TOL)


def test_reference_scan_is_wrong_at_a_ragged_length(block):
    """ROADMAP C10: the reference's own chunked scan at S = 40, chunk 16
    against its unchunked run differs by far more than rounding."""
    ref_p, _ = block
    xj, _ = _x((2, 40, D), 140)
    chunked = np.asarray(RS.mamba_scan_chunked(ref_p, xj, d_state=N,
                                               chunk=CHUNK), np.float32)
    whole = np.asarray(RS.mamba_scan_chunked(ref_p, xj, d_state=N,
                                             chunk=40), np.float32)
    assert np.abs(chunked[:, :32] - whole[:, :32]).max() <= BLOCK_TOL
    assert np.abs(chunked[:, 32:] - whole[:, 32:]).max() > 0.5


def test_scan_calls_the_kernel_wrapper_once_per_chunk(block, monkeypatch):
    """Each chunk's dA and dBx are made for that chunk and go to
    ``selective_scan`` with the state carried in ``h``."""
    _, p = block
    calls = []
    wrapped = PS.selective_scan

    def spy(dA, dBx, Cm, h=None):
        calls.append((tuple(dA.shape), h is not None))
        return wrapped(dA, dBx, Cm, h)

    monkeypatch.setattr(PS, "selective_scan", spy)
    PS.mamba_scan_chunked(p, _x((2, 40, D), 0)[1], d_state=N, chunk=CHUNK)
    assert wrapped is SSK.selective_scan
    assert calls == [((2, 16, D_INNER, N), True)] * 2 + [
        ((2, 8, D_INNER, N), True)]


def test_decode_steps_match_reference(block):
    """The recurrent step and its states, token by token; the port
    advances its state in place."""
    ref_p, p = block
    xj, xt = _x((2, 6, D), 7)
    ref_state = {"conv": jnp.zeros((2, 3, D_INNER), jnp.bfloat16),
                 "ssm": jnp.zeros((2, D_INNER, N), jnp.float32)}
    state = {"conv": torch.zeros(2, 3, D_INNER, dtype=torch.bfloat16),
             "ssm": torch.zeros(2, D_INNER, N)}
    conv, ssm = state["conv"], state["ssm"]
    for t in range(6):
        want, ref_state = RS.mamba_decode_step(ref_p, xj[:, t:t + 1],
                                               ref_state, d_state=N)
        got, state = PS.mamba_decode_step(p, xt[:, t:t + 1], state,
                                          d_state=N)
        _close(got, want, BLOCK_TOL, BLOCK_TOL)
        assert state["conv"] is conv and state["ssm"] is ssm
        _close(conv, ref_state["conv"], 0, 0)
        _close(ssm, ref_state["ssm"], 1e-5, 1e-5)


def test_decode_reproduces_the_scan(block):
    """The port's own check: teacher-forced decode steps give the
    chunked scan's outputs, at a ragged length."""
    _, p = block
    _, xt = _x((1, 21, D), 8)
    full = PS.mamba_scan_chunked(p, xt, d_state=N, chunk=CHUNK)
    state = {"conv": torch.zeros(1, 3, D_INNER, dtype=torch.bfloat16),
             "ssm": torch.zeros(1, D_INNER, N)}
    steps = [PS.mamba_decode_step(p, xt[:, t:t + 1], state, d_state=N)[0]
             for t in range(21)]
    _close(torch.cat(steps, 1), full.float().numpy(), BLOCK_TOL, BLOCK_TOL)


# --------------------------------------------------------------------------
# the LM: jamba's smoke config, one period
# --------------------------------------------------------------------------

def _period(cfg):
    return dataclasses.replace(cfg, n_layers=len(cfg.layer_pattern()))


@pytest.fixture(scope="module")
def jamba():
    ref = ref_get_model(_period(ref_get_config(ARCH, smoke=True)))
    ref_params = ref_init_params(ref.blueprint(), jax.random.PRNGKey(0))
    for layer in ref_params["stack"]:
        if "moe" in layer:
            layer["moe"]["router"] = jnp.zeros_like(layer["moe"]["router"])
    cfg = _period(get_config(ARCH, smoke=True))
    model = get_model(cfg)
    params = lm_params_from_numpy(_np(ref_params), "cpu", model.blueprint())
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
    return cfg, ref, ref_params, model, params, toks.astype(np.int32)


def test_period_has_every_layer_kind(jamba):
    cfg = jamba[0]
    kinds = [(k.mixer, k.ff) for k in cfg.layer_pattern()]
    assert cfg.n_layers == 8 and kinds == [
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"),
        ("mamba", "moe"), ("attn", "dense"), ("mamba", "moe"),
        ("mamba", "dense"), ("mamba", "moe")]


def test_params_carry_over_exactly(jamba):
    """Every leaf, the mamba leaves ("ones" A_log and D, "small" conv_w,
    "zeros" biases) included."""
    cfg, ref, ref_params, model, params, toks = jamba
    ref_flat, flat = _flat(ref_params), _flat(params)
    assert flat.keys() == ref_flat.keys()
    for k, t in flat.items():
        np.testing.assert_array_equal(np.asarray(ref_flat[k], np.float32),
                                      t.float().numpy())
    assert (params["stack"][0]["mamba"]["A_log"] == 1).all()


@pytest.mark.parametrize("smoke", [True, False])
def test_blueprint_matches_reference(smoke):
    """Same leaves, shapes, axes, init rules and dtypes (the full one is
    never allocated)."""
    ref_bp = _flat(ref_get_model(ref_get_config(ARCH, smoke)).blueprint())
    bp = _flat(get_model(get_config(ARCH, smoke)).blueprint())
    assert bp.keys() == ref_bp.keys()
    for k, l in bp.items():
        r = ref_bp[k]
        assert (l.shape, l.axes, l.init, l.scale_dim) == \
            (r.shape, r.axes, r.init, r.scale_dim), k
        assert str(l.dtype) == f"torch.{np.dtype(r.dtype).name}", k


def test_one_chip_cut_keeps_every_width():
    """The card's cut: four layers at full width, one of each kind
    [mamba/dense, mamba/moe, attn/dense, mamba/moe]: 23,021,379,584
    params, the reference's count of the same cut."""
    cut = dict(n_layers=4, attn_every_k=4)
    cfg = dataclasses.replace(get_config(ARCH), **cut)
    assert [(k.mixer, k.ff) for k in cfg.layer_pattern()] == [
        ("mamba", "dense"), ("mamba", "moe"), ("attn", "dense"),
        ("mamba", "moe")]
    n = count_params(get_model(cfg).blueprint())
    ref_bp = ref_get_model(dataclasses.replace(ref_get_config(ARCH), **cut)
                           ).blueprint()
    assert n == 23_021_379_584 == sum(
        int(np.prod(l.shape)) for l in _flat(ref_bp).values())


def test_prefill_matches_reference(jamba):
    cfg, ref, ref_params, model, params, toks = jamba
    want = np.asarray(ref.prefill(ref_params, jnp.array(toks)))
    got = model.prefill(params, torch.from_numpy(toks).long())
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=LM_ATOL, rtol=LM_RTOL)


def test_decode_steps_match_reference_and_keep_the_states(jamba):
    cfg, ref, ref_params, model, params, toks = jamba
    B = toks.shape[0]
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
        np.testing.assert_allclose(got.numpy()[..., :cfg.vocab],
                                   np.asarray(want)[..., :cfg.vocab],
                                   atol=LM_ATOL, rtol=LM_RTOL)
    for kind, ref_layer, layer in zip(model.period, ref_cache, cache):
        assert layer.keys() == ref_layer.keys()
        for name, t in layer.items():
            assert t.shape == ref_layer[name].shape
            assert str(t.dtype) == \
                f"torch.{np.dtype(ref_layer[name].dtype).name}"
    assert len(model.recurrent_state(cache)) == 2 * 7


def test_decode_matches_prefill(jamba):
    """The port's own check (tests/test_archs.py's tolerance), over 21
    tokens: a ragged number of chunks of 16. At capacity factor 8 neither
    path drops an assignment (C >= T), as the two would drop apart."""
    cfg, ref, ref_params, model, params, toks = jamba
    model = get_model(dataclasses.replace(cfg, moe_capacity=8.0))
    prompt = torch.from_numpy(toks[:1, :21]).long()
    full = model.prefill(params, prompt)
    cache = model.init_cache(1, 32, device="cpu")
    for t in range(21):
        logits, cache = model.decode_step(params, cache, prompt[:, t:t + 1],
                                          torch.full((1,), t))
    np.testing.assert_allclose(logits[:, 0, :cfg.vocab].numpy(),
                               full[:, :cfg.vocab].numpy(), atol=0.55,
                               rtol=0.1)


def test_prefill_goes_through_the_scan_once_per_chunk(jamba, monkeypatch):
    """Seven mamba layers, two chunks of 16 each at S = 32."""
    cfg, ref, ref_params, model, params, toks = jamba
    shapes = []
    wrapped = PS.selective_scan

    def spy(dA, dBx, Cm, h=None):
        shapes.append(tuple(dA.shape))
        return wrapped(dA, dBx, Cm, h)

    monkeypatch.setattr(PS, "selective_scan", spy)
    model.prefill(params, torch.from_numpy(toks).long())
    assert shapes == [(2, 16, cfg.ssm_d_inner, cfg.ssm_d_state)] * 14
