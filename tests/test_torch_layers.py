"""The port's ``models/layers.py`` against ``repro.models.layers``: the
same inputs, made with numpy from a seed, through both.

Tolerances: float32 at rtol = atol = 1e-5 everywhere; bfloat16 at
rtol = atol = 3e-2, the bf16 attention tolerance of
``tests/test_kernels.py``. Measured in bf16: rmsnorm, rope, mrope, mlp,
naive and decode attention are bit-identical; ``attention_chunked``
(causal or not) and ``gqa_attention`` differ by at most 0.0156 (one bf16
ulp at 2-4, outputs up to 2.9), since the reference rounds its scores
and probabilities to bf16 and the port's kernel and its plain version
keep them in float32. The port's ``gqa_attention`` has no ``impl`` or
``chunk``: each case holds it against the reference's lowering named.

The reference's ``attention_chunked`` is held only where S is at most
one chunk or a multiple of it: for a ragged last chunk its
``dynamic_slice`` clamps the start and reads the wrong keys (ROADMAP C6);
the port there meets ``attention_naive``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as TL

JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
DTYPES = [torch.float32, torch.bfloat16]


def _arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _both(a, dtype):
    t = torch.from_numpy(np.asarray(a)).to(dtype)
    return jnp.array(t.float().numpy(), JNP[dtype]), t


def _tree(d, dtype):
    """{name: array} -> ({name: jax}, {name: torch})."""
    pairs = {k: _both(v, dtype) for k, v in d.items()}
    return ({k: p[0] for k, p in pairs.items()},
            {k: p[1] for k, p in pairs.items()})


def _check(got, want, dtype):
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm(dtype):
    x, s = _arrays(0, (2, 5, 64), (64,))
    jx, tx = _both(x, dtype)
    jp, tp = _tree({"scale": s}, dtype)
    _check(TL.rmsnorm(tp, tx), JL.rmsnorm(jp, jx), dtype)


def test_rope_freqs():
    np.testing.assert_allclose(TL.rope_freqs(64, 10000.0).numpy(),
                               np.asarray(JL.rope_freqs(64, 10000.0)),
                               rtol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_rope(dtype):
    x, = _arrays(1, (2, 9, 4, 32))
    pos = np.arange(100, 109)[None, :].repeat(2, 0)
    jx, tx = _both(x, dtype)
    _check(TL.apply_rope(tx, torch.from_numpy(pos), 10000.0),
           JL.apply_rope(jx, jnp.array(pos), 10000.0), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_mrope(dtype):
    x, = _arrays(2, (2, 7, 4, 32))
    pos3 = np.random.default_rng(3).integers(0, 50, (3, 2, 7))
    jx, tx = _both(x, dtype)
    _check(TL.apply_mrope(tx, torch.from_numpy(pos3), theta=1e4),
           JL.apply_mrope(jx, jnp.array(pos3), theta=1e4), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("gated", [True, False])
def test_mlp(dtype, gated):
    d, ff = 64, 96
    x, wi, wo = _arrays(4, (2, 5, d), (d, 2 * ff if gated else ff),
                        (ff, d))
    jx, tx = _both(x, dtype)
    jp, tp = _tree({"wi": wi / np.sqrt(d), "wo": wo / np.sqrt(ff)}, dtype)
    _check(TL.mlp(tp, tx, gated), JL.mlp(jp, jx, gated), dtype)


def test_repeat_kv():
    k, = _arrays(5, (2, 3, 2, 4))
    np.testing.assert_array_equal(
        TL._repeat_kv(torch.from_numpy(k), 3).numpy(),
        np.asarray(JL._repeat_kv(jnp.array(k), 3)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
def test_attention_naive(dtype, causal):
    q, k, v = _arrays(6, (2, 12, 4, 32), (2, 12, 4, 32), (2, 12, 4, 32))
    (jq, tq), (jk, tk), (jv, tv) = [_both(a, dtype) for a in (q, k, v)]
    _check(TL.attention_naive(tq, tk, tv, causal=causal),
           JL.attention_naive(jq, jk, jv, causal=causal), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,chunk", [(64, 32), (24, 32), (48, 16)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_chunked(dtype, S, chunk, causal):
    q, k, v = _arrays(7, (2, S, 4, 32), (2, S, 4, 32), (2, S, 4, 32))
    (jq, tq), (jk, tk), (jv, tv) = [_both(a, dtype) for a in (q, k, v)]
    want = JL.attention_chunked(jq, jk, jv, causal=causal, chunk=chunk)
    _check(TL.attention_chunked(tq, tk, tv, causal=causal), want, dtype)


def test_attention_chunked_ragged_meets_naive():
    """S = 40 with chunk 32: the port meets the reference's naive
    attention (its chunked one clamps the last chunk, ROADMAP C6)."""
    q, k, v = [jnp.array(a) for a in _arrays(8, *[(2, 40, 4, 32)] * 3)]
    got = TL.attention_chunked(*[torch.from_numpy(np.array(a))
                                 for a in (q, k, v)])
    _check(got, JL.attention_naive(q, k, v), torch.float32)


def test_attention_chunked_takes_gqa_kv():
    """K/V with H/4 heads equal K/V repeated to H heads."""
    q, = _arrays(9, (2, 20, 8, 32))
    k, v = _arrays(10, (2, 20, 2, 32), (2, 20, 2, 32))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    want = JL.attention_naive(jnp.array(q), JL._repeat_kv(jnp.array(k), 4),
                              JL._repeat_kv(jnp.array(v), 4))
    _check(TL.attention_chunked(tq, tk, tv), want, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_decode(dtype):
    B, Smax, Hkv, H, D = 3, 16, 2, 4, 32
    q, kc, vc = _arrays(11, (B, 1, H, D), (B, Smax, Hkv, D),
                        (B, Smax, Hkv, D))
    lens = np.array([1, 7, 16], np.int32)
    (jq, tq), (jk, tk), (jv, tv) = [_both(a, dtype) for a in (q, kc, vc)]
    _check(TL.attention_decode(tq, tk, tv, torch.from_numpy(lens)),
           JL.attention_decode(jq, jk, jv, jnp.array(lens)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["chunked", "naive", "mrope", "cross"])
def test_gqa_attention(dtype, variant):
    B, S, d, H, Hkv, D = 2, 32, 64, 4, 2, 32
    x, enc, wq, wk, wv, wo = _arrays(12, (B, S, d), (B, 9, d), (d, H, D),
                                     (d, Hkv, D), (d, Hkv, D), (H, D, d))
    jx, tx = _both(x, dtype)
    jp, tp = _tree({"wq": wq / 8, "wk": wk / 8, "wv": wv / 8,
                    "wo": wo / np.sqrt(H * D)}, dtype)
    pos = np.arange(S)[None, :]
    # the reference's impl and chunk choose its lowering; the port takes
    # neither and always goes through attention_chunked
    tkw = dict(n_heads=H, n_kv=Hkv)
    jkw = dict(tkw, chunk=16,
               impl="naive" if variant == "naive" else "chunked")
    if variant == "mrope":
        pos3 = np.random.default_rng(13).integers(0, S, (3, B, S))
        jkw["mrope_positions"] = jnp.array(pos3)
        tkw["mrope_positions"] = torch.from_numpy(pos3)
    if variant == "cross":
        je, te = _both(enc, dtype)
        jkw.update(kv_in=je, causal=False, impl="naive")
        tkw.update(kv_in=te, causal=False)
    _check(TL.gqa_attention(tp, tx, torch.from_numpy(pos), **tkw),
           JL.gqa_attention(jp, jx, jnp.array(pos), **jkw), dtype)
