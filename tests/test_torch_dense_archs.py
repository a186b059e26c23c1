"""The dense configs' widths and shapes on the CPU: starcoder2-7b,
command-r-plus-104b and llama3-405b.

  * ``rmsnorm_bwd``'s float32 source built for the host (g++ with the
    stand-in runtime in ``tests/cuda_host``) at command-r-plus's and
    llama3's d_model, 12,288 and 16,384 (512 threads a CTA, each holding
    only its dscale partials): against ``rmsnorm_bwd_plain`` at 1e-5, and
    dscale bit for bit the sum of the CTAs' partials in their order. Two
    rows each (two CTAs), so that the host runs stay short.
  * The attention sources at their GQA groups, 9, 12 and 16 query heads
    on a KV head at head dim 128: the float32 forward and backward and the
    bf16 tensor-core routes (``sm90.cuh`` emulated), against the plain
    versions at the tolerances of ``test_torch_lm_kernels.py`` (2e-5
    float32; the card's bf16 rtol 1e-2, atol 2e-3 forward and 1e-2 of the
    largest value backward).
  * Gradients through the chunked loss: command-r-plus's (parallel blocks)
    and llama3's smoke configs with ``loss_chunk`` 16 (B 2, S 64: four
    chunks); the loss and every leaf's gradient against
    ``jax.value_and_grad`` of the reference's ``loss_fn``, which scans the
    chunks with ``lax.scan``, at ``tests/test_torch_train.py``'s ``TOL``
    0.1 and ``GRAD_TOL`` 2e-2 (bf16 products rounded at other places);
    the port's chunked loss and gradients against its own unchunked ones:
    the loss at 1e-6; in bf16 every leaf bit for bit but the
    unembedding, whose gradient is summed over the chunks in bf16, within
    one bf16 ulp (2^-7, relative L2); in float32 (the dist tests'
    ``float32_lm``) every leaf at relative L2 1e-5.
"""
import dataclasses
import math

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
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import flash_attention_bwd as FB
from repro_torch.kernels.rmsnorm import rmsnorm as RN
from repro_torch.kernels.rmsnorm import rmsnorm_bwd as RB
from repro_torch.models import get_model
from repro_torch.models.blueprint import tree_map
from repro_torch.train.train_step import value_and_grad
from torch_dist_worker import float32_lm
from torch_host_kernels import close
from torch_host_kernels import host_libs, host_tc_libs  # noqa: F401

TOL = 0.1
GRAD_TOL = 2e-2
#: the port's chunked gradients against its unchunked ones in float32
#: (sums in another order)
CHUNK_GRAD_TOL = 1e-5
CARD_BF16_TOL = (1e-2, 2e-3)
CARD_BWD_TOL = 1e-2
B, S, CHUNK = 2, 64, 16
CHUNKED = ("command-r-plus-104b", "llama3-405b")


# --------------------------------------------------------------------------
# rmsnorm's backward at the widest rows
# --------------------------------------------------------------------------

def test_rmsnorm_bwd_takes_every_config_width():
    """Every config's d_model is within the kernel's widest row, and the
    widest, llama3-405b's, is the limit."""
    widths = {a: get_config(a).d_model for a in ARCHS}
    assert max(widths.values()) == RB.MAX_D == 16384, widths


@pytest.mark.parametrize("d", [12288, 16384])
def test_rmsnorm_bwd_wide_rows_match_plain_on_host(d, host_libs):
    g = torch.Generator().manual_seed(d)
    N = 2
    x, dy = torch.randn(N, d, generator=g), torch.randn(N, d, generator=g)
    s = torch.randn(d, generator=g)
    _, rstd = RN.rmsnorm_plain(x, s, with_rstd=True)
    parts = min(N, RB.PARTS)
    dx, ds = torch.empty(N, d), torch.empty(d)
    partial = torch.empty(parts, d)
    assert host_libs[RB].rmsnorm_bwd_f32(
        x.data_ptr(), s.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), ds.data_ptr(), partial.data_ptr(), N, d, parts,
        None) == 0
    want_dx, want_ds = RB.rmsnorm_bwd_plain(x, s, rstd, dy)
    close(dx, want_dx.numpy(), 1e-5)
    close(ds, want_ds.numpy(), 1e-5)
    acc = torch.zeros(d)
    for row in partial:
        acc = acc + row
    assert torch.equal(ds, acc)


# --------------------------------------------------------------------------
# attention at the configs' GQA groups, head dim 128
# --------------------------------------------------------------------------

#: (H, Hkv): starcoder2's group of 9, command-r-plus's 12, llama3's 16
GROUPS = [(9, 1), (12, 1), (16, 1)]
SQ = 70


def _qkv(g, H, Hkv, dtype):
    """q, k, v as the layer passes them: (1, H, S, 128) views of
    (1, S, H, 128) tensors."""
    return tuple(torch.randn(1, SQ, h, 128, generator=g).to(dtype)
                 .transpose(1, 2) for h in (H, Hkv, Hkv))


def _strides(*ts):
    return [st for t in ts for st in t.stride()[:3]]


@pytest.mark.parametrize("H,Hkv", GROUPS)
def test_gqa_groups_forward_and_backward_on_host(H, Hkv, host_libs):
    """The float32 sources, forward and backward, causal."""
    g = torch.Generator().manual_seed(H)
    q, k, v = _qkv(g, H, Hkv, torch.float32)
    out, lse = torch.empty(1, H, SQ, 128), torch.empty(1, H, SQ)
    assert host_libs[FA].flash_attention_f32_d128(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), 1, H, Hkv, SQ, SQ, *_strides(q, k, v), 1,
        1.0 / math.sqrt(128), None) == 0
    want, want_lse = FA.flash_attention_plain(q, k, v, causal=True,
                                              with_lse=True)
    close(out, want.numpy(), 2e-5)
    close(lse, want_lse.numpy(), 2e-5)
    do = torch.randn(1, SQ, H, 128, generator=g).transpose(1, 2)
    dq = torch.empty(1, H, SQ, 128)
    dk, dv = torch.empty(1, Hkv, SQ, 128), torch.empty(1, Hkv, SQ, 128)
    assert host_libs[FB].flash_attention_bwd_f32_d128(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), want.data_ptr(),
        do.data_ptr(), want_lse.data_ptr(), torch.empty(1, H, SQ).data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1, H, Hkv, SQ, SQ,
        FB._STRIDES(*_strides(q, k, v, want, do)), 1,
        1.0 / math.sqrt(128), None) == 0
    grads = FB.flash_attention_bwd_plain(q, k, v, want, do, want_lse,
                                         causal=True)
    for got, w in zip((dq, dk, dv), grads):
        close(got, w.numpy(), 2e-5)


@pytest.mark.parametrize("H,Hkv", GROUPS)
def test_gqa_groups_tensor_cores_on_host(H, Hkv, host_tc_libs):
    """The bf16 tensor-core routes, forward and backward (delta pre-pass,
    dkdv walking the group's query heads, dq), causal, under the emulated
    ``sm90.cuh`` helpers."""
    g = torch.Generator().manual_seed(H + 1)
    q, k, v = _qkv(g, H, Hkv, torch.bfloat16)
    out = torch.empty(1, H, SQ, 128, dtype=torch.bfloat16)
    lse = torch.empty(1, H, SQ)
    vh, vexp, vmax = FA.v_scratch(1, Hkv, SQ, 128, "cpu")
    scale = 1.0 / math.sqrt(128)
    assert getattr(host_tc_libs[FA], FA.entry(torch.bfloat16, 128))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), vh.data_ptr(),
        vexp.data_ptr(), vmax.data_ptr(), out.data_ptr(), lse.data_ptr(),
        1, H, Hkv, SQ, SQ, *_strides(q, k, v), 1, scale, None) == 0
    want, want_lse = FA.flash_attention_plain(q, k, v, causal=True,
                                              with_lse=True)
    rtol, atol = CARD_BF16_TOL
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)
    close(lse, want_lse.numpy(), 1e-5)
    do = torch.randn(1, SQ, H, 128, generator=g).bfloat16().transpose(1, 2)
    dq = torch.empty(1, H, SQ, 128, dtype=torch.bfloat16)
    dk = torch.empty(1, Hkv, SQ, 128, dtype=torch.bfloat16)
    dv = torch.empty_like(dk)
    assert getattr(host_tc_libs[FB], FB.entry(torch.bfloat16, 128))(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), want.data_ptr(),
        do.data_ptr(), want_lse.data_ptr(), torch.empty(1, H, SQ).data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), 1, H, Hkv, SQ, SQ,
        FB._STRIDES(*_strides(q, k, v, want, do)), 1, scale, None) == 0
    grads = FB.flash_attention_bwd_plain(q, k, v, want, do, want_lse,
                                         causal=True)
    rels = [float((a.float() - b.float()).abs().max() / b.float().abs().max())
            for a, b in zip((dq, dk, dv), grads)]
    assert max(rels) < CARD_BWD_TOL, rels


# --------------------------------------------------------------------------
# gradients through the chunked loss
# --------------------------------------------------------------------------

def _paths(tree, path=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _paths(sub, f"{path}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _paths(sub, f"{path}/{i}").items()}
    return {path: tree}


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _smoke(arch, loss_chunk=CHUNK):
    """(the port's smoke LM with ``loss_chunk``, the reference's params
    carried over, the tokens (B, S) int32)."""
    rcfg = dataclasses.replace(ref_get_config(arch, smoke=True),
                               loss_chunk=loss_chunk)
    rp = ref_init_params(ref_get_model(rcfg).blueprint(),
                         jax.random.PRNGKey(0))
    model = get_model(dataclasses.replace(get_config(arch, smoke=True),
                                          loss_chunk=loss_chunk))
    params = lm_params_from_numpy(
        jax.tree.map(lambda a: np.asarray(a, np.float32), rp), "cpu",
        model.blueprint())
    toks = np.random.default_rng(3).integers(
        0, rcfg.vocab, (B, S)).astype(np.int32)
    return rcfg, rp, model, params, toks


def _grads(model, params, toks):
    loss, grads = value_and_grad(model, params,
                                 {"tokens": torch.from_numpy(toks)},
                                 remat=True)
    return float(loss), {k: v.float().numpy()
                         for k, v in _paths(grads).items()}


@pytest.mark.parametrize("arch", CHUNKED)
def test_chunked_loss_grads_match_reference(arch):
    """The loss and every leaf's gradient of the smoke config with
    ``loss_chunk`` 16 against the reference's (its chunks under
    ``lax.scan``); a leaf the loss does not read (a parallel block's
    ln2) has a zero gradient on both sides."""
    rcfg, rp, model, params, toks = _smoke(arch)
    want_l, want_g = jax.jit(jax.value_and_grad(ref_get_model(rcfg).loss_fn))(
        rp, {"tokens": jnp.array(toks)})
    loss, got = _grads(model, params, toks)
    np.testing.assert_allclose(loss, float(want_l), atol=TOL, rtol=TOL)
    want = {k: np.asarray(v, np.float32) for k, v in _paths(want_g).items()}
    assert want.keys() == got.keys()
    zero = [k for k, w in want.items() if not w.any()]
    assert zero == [k for k, v in got.items() if not v.any()]
    assert zero == ([k for k in want if k.endswith("/ln2/scale")]
                    if rcfg.parallel_block else []), zero
    errs = {k: _rel_l2(got[k], w) for k, w in want.items() if w.any()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


@pytest.mark.parametrize("arch", CHUNKED)
def test_chunked_loss_grads_match_unchunked(arch):
    """The port's chunked loss and gradients against its unchunked ones on
    the same params and tokens. In bf16 every leaf but the unembedding is
    bit for bit the same, and the unembedding's gradient, summed over the
    four chunks in bf16 (each add rounds the running sum: the reference's
    ``lax.scan`` sums it so too), is within one bf16 ulp, 2^-7 (measured
    3.4e-3). In float32 (``float32_lm``) every leaf is within
    CHUNK_GRAD_TOL."""
    _, _, model, params, toks = _smoke(arch)
    whole_model = get_model(dataclasses.replace(model.cfg, loss_chunk=0))
    loss, got = _grads(model, params, toks)
    whole_l, whole = _grads(whole_model, params, toks)
    np.testing.assert_allclose(loss, whole_l, rtol=1e-6)
    for k, w in whole.items():
        if k == "/unembed":
            assert _rel_l2(got[k], w) <= 2.0 ** -7, k
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    p32 = tree_map(lambda a: a.float(), params)
    with float32_lm():
        loss, got = _grads(model, p32, toks)
        whole_l, whole = _grads(whole_model, p32, toks)
    np.testing.assert_allclose(loss, whole_l, rtol=1e-6)
    for k, w in whole.items():
        if w.any():
            assert _rel_l2(got[k], w) <= CHUNK_GRAD_TOL, k
