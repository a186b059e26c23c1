"""The port's xLSTM blocks against the JAX package's, at smoke size.

One mLSTM and one sLSTM block at xlstm-1.3b's smoke widths (d 128, 4
heads of 32, chunk 16), the JAX package's ``init_params`` output carried
over, the same bf16 input on both sides. Held at ``BLOCK_TOL`` = 3e-2
(rtol and atol; ``tests/test_torch_ssm.py``'s): both sides round the
projections to bf16 at the same places and keep gates, stabilisers and
states in float32.

The reference's chunked mLSTM is not causal (ROADMAP C14: its mask keeps
s >= t, ``xlstm.py:74-75``), and it raises at S < chunk and rereads
positions on a ragged last chunk. Its recurrent ``mlstm_decode_step`` is
the xLSTM paper's recurrence, so the port's chunked mLSTM is held to
that, scanned over the sequence: at S a multiple of the chunk, at a
ragged S and at S < chunk.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as RX
from repro.models.blueprint import init_params as ref_init_params
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import xlstm as PX

BLOCK_TOL = 3e-2
D, H, CHUNK = 128, 4, 16


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def mlstm():
    ref_p = ref_init_params(RX.mlstm_bp(D, H), jax.random.PRNGKey(1))
    return ref_p, lm_params_from_numpy(_np(ref_p), "cpu", PX.mlstm_bp(D, H))


@pytest.fixture(scope="module")
def slstm():
    ref_p = ref_init_params(RX.slstm_bp(D, H), jax.random.PRNGKey(2))
    return ref_p, lm_params_from_numpy(_np(ref_p), "cpu", PX.slstm_bp(D, H))


def _x(shape, seed):
    t = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                         .astype(np.float32)).bfloat16()
    return jnp.array(t.float().numpy(), jnp.bfloat16), t


def _close(got, want, atol=BLOCK_TOL, rtol=BLOCK_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _ref_mlstm_state(B):
    hd = D // H
    return {"C": jnp.zeros((B, H, hd, hd), jnp.float32),
            "n": jnp.zeros((B, H, hd), jnp.float32),
            "m": jnp.full((B, H), -1e30, jnp.float32)}


_ref_mlstm_step = jax.jit(partial(RX.mlstm_decode_step, n_heads=H))


def _ref_mlstm_recurrent(ref_p, xj):
    """The reference's decode recurrence scanned over the sequence."""
    state = _ref_mlstm_state(xj.shape[0])
    out = []
    for t in range(xj.shape[1]):
        y, state = _ref_mlstm_step(ref_p, xj[:, t:t + 1], state)
        out.append(np.asarray(y, np.float32))
    return np.concatenate(out, 1)


@pytest.mark.parametrize("S", [32, 40, 8])
def test_mlstm_chunked_matches_reference_recurrence(mlstm, S):
    """S a multiple of the chunk, a ragged S (a short last chunk), and
    S < chunk (the reference's chunked form raises there)."""
    ref_p, p = mlstm
    xj, xt = _x((2, S, D), S)
    got = PX.mlstm_chunked(p, xt, n_heads=H, chunk=CHUNK)
    assert got.dtype == torch.bfloat16 and got.shape == (2, S, D)
    _close(got, _ref_mlstm_recurrent(ref_p, xj))


def test_mlstm_is_causal_where_the_reference_is_not(mlstm):
    """ROADMAP C14: within one 16-token chunk, new inputs at positions
    8-15 move the reference's chunked outputs at 0-7 by far more than
    rounding, and leave the port's exactly as they were."""
    ref_p, p = mlstm
    xj, xt = _x((2, 16, D), 3)
    xj2 = xj.at[:, 8:].set(0)
    xt2 = xt.clone()
    xt2[:, 8:] = 0
    ref = [np.asarray(RX.mlstm_chunked(ref_p, a, n_heads=H, chunk=CHUNK),
                      np.float32) for a in (xj, xj2)]
    assert np.abs(ref[0][:, :8] - ref[1][:, :8]).max() > 0.5
    got = [PX.mlstm_chunked(p, a, n_heads=H, chunk=CHUNK) for a in (xt, xt2)]
    assert torch.equal(got[0][:, :8], got[1][:, :8])
    assert not torch.equal(got[0][:, 8:], got[1][:, 8:])


def test_mlstm_decode_steps_match_reference(mlstm):
    """The recurrent step and its state, token by token; the port
    advances the state in place."""
    ref_p, p = mlstm
    xj, xt = _x((2, 6, D), 4)
    ref_state = _ref_mlstm_state(2)
    state = PX.mlstm_init_state(2, H, D // H)
    leaves = dict(state)
    for t in range(6):
        want, ref_state = _ref_mlstm_step(ref_p, xj[:, t:t + 1], ref_state)
        got, state = PX.mlstm_decode_step(p, xt[:, t:t + 1], state,
                                          n_heads=H)
        _close(got, want)
        for k in ("C", "n", "m"):
            assert state[k] is leaves[k]
            _close(state[k], ref_state[k], 1e-5, 1e-5)


def test_mlstm_chunked_matches_own_decode(mlstm):
    """The port's own check: teacher-forced decode steps give the chunked
    outputs, over three chunks and a short one."""
    _, p = mlstm
    _, xt = _x((1, 53, D), 5)
    full = PX.mlstm_chunked(p, xt, n_heads=H, chunk=CHUNK)
    state = PX.mlstm_init_state(1, H, D // H)
    steps = [PX.mlstm_decode_step(p, xt[:, t:t + 1], state, n_heads=H)[0]
             for t in range(53)]
    _close(torch.cat(steps, 1), full.float().numpy())


@pytest.mark.parametrize("S", [16, 24])
def test_slstm_seq_matches_reference(slstm, S):
    ref_p, p = slstm
    xj, xt = _x((2, S, D), 10 + S)
    got = PX.slstm_seq(p, xt)
    assert got.dtype == torch.bfloat16 and got.shape == (2, S, D)
    _close(got, RX.slstm_seq(ref_p, xj))


def test_slstm_decode_steps_match_reference(slstm):
    ref_p, p = slstm
    xj, xt = _x((2, 6, D), 11)
    ref_state = RX.slstm_init_state(2, D)
    state = PX.slstm_init_state(2, D)
    leaves = tuple(state)
    step = jax.jit(RX.slstm_decode_step)
    for t in range(6):
        want, ref_state = step(ref_p, xj[:, t:t + 1], ref_state)
        got, state = PX.slstm_decode_step(p, xt[:, t:t + 1], state)
        _close(got, want)
        assert all(a is b for a, b in zip(state, leaves))
        assert state[0].dtype == torch.bfloat16
        # c, n, m at the block's tolerance: z is the sum of two bf16
        # products, which XLA may add before it rounds
        for a, b in zip(state, ref_state):
            _close(a, b)


def test_initial_states_are_the_reference_s():
    ref = RX.slstm_init_state(3, D)
    got = PX.slstm_init_state(3, D)
    for a, b in zip(got, ref):
        assert str(a.dtype) == f"torch.{np.dtype(b.dtype).name}"
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    st = PX.mlstm_init_state(3, H, D // H)
    for k, b in _ref_mlstm_state(3).items():
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(b))


# --------------------------------------------------------------------------
# gradients, block by block, in float32 (params, x and every step): the
# point is the algorithm, the port's chunked form and autograd against
# jax.grad of the recurrence. In bf16 a block's gradients are
# ill-conditioned: where |q n| < 1 the output scales with the stabiliser
# m, a max, so one ulp of noise on x can hand its gradient to another
# gate; the port's own wif gradient then moves by up to 0.34 (ROADMAP
# C15). The whole smoke LM holds its loss only
# (tests/test_torch_archs_train.py).
# --------------------------------------------------------------------------

GRAD_TOL = 2e-2      # tests/test_torch_train.py's: relative L2 a leaf


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if not want.any():
        return float(np.abs(got).max())
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _grads(fn, p, xt, w):
    """The gradients of sum(fn(p, x) * w) for each leaf of p and for x."""
    ps = {k: v.detach().requires_grad_() for k, v in p.items()}
    xs = xt.detach().requires_grad_()
    (fn(ps, xs).float() * w).sum().backward()
    return {k: v.grad if v.grad is not None else torch.zeros(v.shape)
            for k, v in ps.items()}, xs.grad


def _ref_mlstm_scan(p, xj):
    def step(state, xt):
        y, state = RX.mlstm_decode_step(p, xt[:, None], state, n_heads=H)
        return state, y[:, 0]

    _, ys = jax.lax.scan(step, _ref_mlstm_state(xj.shape[0]),
                         jnp.moveaxis(xj, 1, 0))
    return jnp.moveaxis(ys, 0, 1)


def _check_grads(ref_fn, ref_p, fn, p, S, seed):
    xj, xt = _x((2, S, D), seed)
    xj, xt = xj.astype(jnp.float32), xt.float()
    ref_p = jax.tree.map(lambda a: a.astype(jnp.float32), ref_p)
    p = {k: v.float() for k, v in p.items()}
    w = np.random.default_rng(seed + 1).standard_normal(
        (2, S, D)).astype(np.float32)
    want_p, want_x = jax.jit(jax.grad(
        lambda q, a: (ref_fn(q, a).astype(jnp.float32) * w).sum(),
        argnums=(0, 1)))(ref_p, xj)
    got_p, got_x = _grads(fn, p, xt, torch.from_numpy(w))
    errs = {k: _rel(got_p[k], want_p[k]) for k in want_p}
    errs["x"] = _rel(got_x, want_x)
    assert max(errs.values()) <= GRAD_TOL, errs


@pytest.mark.parametrize("S", [32, 40])
def test_mlstm_chunked_grads_match_reference_recurrence(mlstm, S):
    """Every leaf's gradient and x's, of the port's chunked form against
    jax.grad of the reference's decode recurrence scanned over S; the
    unread ``norm`` leaf gets none on either side."""
    ref_p, p = mlstm
    _check_grads(_ref_mlstm_scan, ref_p,
                 lambda q, a: PX.mlstm_chunked(q, a, n_heads=H,
                                               chunk=CHUNK), p, S, 30 + S)


def test_slstm_seq_grads_match_reference(slstm):
    ref_p, p = slstm
    _check_grads(RX.slstm_seq, ref_p, PX.slstm_seq, p, 24, 50)
