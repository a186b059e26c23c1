"""selective_scan on the card: the CUDA kernel against its plain version,
and jamba's smoke LM going through it.

Imports nothing of JAX, so it runs on a machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssm_cuda.py

Skips where ``torch.cuda.is_available()`` is false. Tolerances: float32
rtol = atol = 1e-5 (the same recurrence; the plain version's dot product
is a batched matrix product, the kernel's a sum in registers); bf16 the
same on float32 sums whose output both sides round to bf16 once, so
rtol 1e-2 (one bf16 ulp) and atol 1e-5. The smoke LM (one period, 8
layers) on the card against the same LM on the CPU: atol 0.2, rtol 0.1
on the logits, as ``tests/test_torch_ssm.py`` holds it to the JAX
package, with the routers zeroed so that bf16 near-ties cannot route a
token apart on the two devices. The backward against its plain version
at chip_smoke.py's float32 BWD_TOL: 1e-4 of each output's largest value
(dCm summed over the channels in another order).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.moe_dispatch import moe_dispatch as MD
from repro_torch.kernels.rmsnorm import rmsnorm as RN
from repro_torch.kernels.selective_scan import selective_scan as SS
from repro_torch.kernels.selective_scan import selective_scan_bwd as SB
from repro_torch.models import get_model
from repro_torch.models.blueprint import init_params, tree_map

TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1e-2, 1e-5)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, shape, dtype, seed=0):
    """dA in (0.5, 0.99), dBx and Cm at scale 0.1, as tests/test_kernels.py
    draws them."""
    B, S, d, n = shape
    g = torch.Generator(dev).manual_seed(seed)
    dA = torch.rand(B, S, d, n, generator=g, device=dev) * 0.49 + 0.5
    dBx = torch.randn(B, S, d, n, generator=g, device=dev) * 0.1
    Cm = torch.randn(B, S, n, generator=g, device=dev) * 0.1
    return [t.to(dtype) for t in (dA, dBx, Cm)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 128, 16, 8), (1, 256, 32, 16), (3, 64, 8, 4),   # Pallas sweep
    (2, 37, 200, 16), (1, 1, 1, 16),
    (4, 256, 4096, 16)])          # jamba's chunk, a quarter of d_inner
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_state", [False, True])
def test_selective_scan_kernel_matches_plain(cuda, shape, dtype,
                                             with_state):
    dA, dBx, Cm = _inputs(cuda, shape, dtype)
    B, S, d, n = shape
    h0 = torch.randn(B, d, n, device=cuda) if with_state else None
    h = None if h0 is None else h0.clone()
    want_h = None if h0 is None else h0.clone()
    before = SS.LAUNCHES
    got = SS.selective_scan(dA, dBx, Cm, h)
    torch.cuda.synchronize()
    assert SS.LAUNCHES == before + 1
    want = SS.selective_scan_plain(dA, dBx, Cm, want_h)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)
    if h is not None:
        torch.testing.assert_close(h, want_h, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_chained_kernel_calls_match_one_call(cuda):
    dA, dBx, Cm = _inputs(cuda, (2, 100, 300, 16), torch.float32, 1)
    want = SS.selective_scan(dA, dBx, Cm)
    h = torch.zeros(2, 300, 16, device=cuda)
    ys = [SS.selective_scan(dA[:, a:b].contiguous(), dBx[:, a:b].contiguous(),
                            Cm[:, a:b].contiguous(), h)
          for a, b in ((0, 33), (33, 64), (64, 100))]
    torch.testing.assert_close(torch.cat(ys, 1), want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    dA, dBx, Cm = _inputs(cuda, (1, 4, 8, 16), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        SS.selective_scan(dA.transpose(2, 3).contiguous().transpose(2, 3),
                          dBx, Cm)
    with pytest.raises(ValueError, match="one CUDA device"):
        SS.selective_scan(dA, dBx.cpu(), Cm)
    with pytest.raises(ValueError, match="state size"):
        SS.selective_scan(*_inputs(cuda, (1, 4, 8, 2), torch.float32))
    odd = torch.zeros(dA.numel() + 1, device=cuda)[1:].view(dA.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        SS.selective_scan(odd, dBx, Cm)
    before = SS.LAUNCHES
    assert SS.selective_scan(dA[:, :0], dBx[:, :0], Cm[:, :0]).shape == \
        (1, 0, 8) and SS.LAUNCHES == before


@pytest.mark.cuda
def test_smoke_jamba_on_the_card_goes_through_the_kernels(cuda):
    """jamba's smoke LM, one period (7 mamba layers, 1 attention, 4 MoE):
    prefill on the card (kernels) equals the CPU (plain versions), and
    every kernel launches where the path runs it."""
    cfg = get_config("jamba-1.5-large-398b", smoke=True)
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.layer_pattern()))
    model = get_model(cfg)
    params = init_params(model.blueprint(), torch.Generator().manual_seed(0))
    for layer in params["stack"]:
        if "moe" in layer:
            layer["moe"]["router"].zero_()
    S = 40                         # two chunks of 16 and a ragged one
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, S)))
    want = model.prefill(params, toks)
    on_card = tree_map(lambda a: a.to(cuda), params)
    mods = (RN, FA, MD, SS)
    counts = [m.LAUNCHES for m in mods]
    got = model.prefill(on_card, toks.to(cuda))
    torch.cuda.synchronize()
    kinds = cfg.layer_pattern()
    n_mamba = sum(k.mixer == "mamba" for k in kinds)
    assert [m.LAUNCHES - c for m, c in zip(mods, counts)] == [
        2 * cfg.n_layers + 1, cfg.n_layers - n_mamba,
        sum(k.ff == "moe" for k in kinds),
        n_mamba * math.ceil(S / cfg.ssm_chunk)]
    torch.testing.assert_close(got.cpu(), want, rtol=0.1, atol=0.2)


BWD_TOL = 1e-4


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _saved_states(dA, dBx, Cm, h0):
    """The forward kernel's states from h0 (None: zeros)."""
    B, S, d, n = dA.shape
    states = torch.empty(SS.states_shape(B, S, d, n), device=dA.device)
    SS.selective_scan(dA, dBx, Cm, None if h0 is None else h0.clone(),
                      states)
    return states


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (2, 40, 16, 8), (2, 64, 300, 16), (1, 37, 200, 4), (4, 256, 1024, 16),
    (1, 13, 600, 8),
    (4, 256, 16384, 16)])         # jamba's chunk
@pytest.mark.parametrize("with_states", [False, True])
def test_selective_scan_bwd_kernel_matches_plain(cuda, shape, with_states):
    """Every output against the reverse torch loop, from the forward's
    saved states; two calls give the same bits."""
    B, S, d, n = shape
    dA, dBx, Cm = _inputs(cuda, shape, torch.float32)
    g = torch.Generator(cuda).manual_seed(9)
    dy = torch.randn(B, S, d, generator=g, device=cuda)
    h0, dh = ((torch.randn(B, d, n, generator=g, device=cuda),
               torch.randn(B, d, n, generator=g, device=cuda))
              if with_states else (None, None))
    states = _saved_states(dA, dBx, Cm, h0)
    before = SB.LAUNCHES
    got = SB.selective_scan_bwd(dA, dBx, Cm, h0, dy, dh, states)
    torch.cuda.synchronize()
    assert SB.LAUNCHES == before + 1
    want = SB.selective_scan_bwd_plain(dA, dBx, Cm, h0, dy, dh)
    for a, b in zip(got, want):
        assert _rel(a, b) <= BWD_TOL
    again = SB.selective_scan_bwd(dA, dBx, Cm, h0, dy, dh, states)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 37, 200, 16), (4, 256, 16384, 16)])
def test_forward_states_match_plain(cuda, shape):
    """The forward's saved states against the plain loop's (the same
    float32 steps), and y the same bits with and without them."""
    B, S, d, n = shape
    dA, dBx, Cm = _inputs(cuda, shape, torch.float32)
    h0 = torch.randn(B, d, n, device=cuda)
    states = torch.empty(SS.states_shape(B, S, d, n), device=cuda)
    y = SS.selective_scan(dA, dBx, Cm, h0.clone(), states)
    assert torch.equal(y, SS.selective_scan(dA, dBx, Cm, h0.clone()))
    want = torch.empty_like(states)
    SS.selective_scan_plain(dA, dBx, Cm, h0.clone(), want)
    torch.testing.assert_close(states, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(states[:, 0], h0)


@pytest.mark.cuda
def test_bwd_kernel_refuses_no_states(cuda):
    dA, dBx, Cm = _inputs(cuda, (1, 8, 32, 16), torch.float32)
    dy = torch.randn(1, 8, 32, device=cuda)
    with pytest.raises(ValueError, match="states"):
        SB.selective_scan_bwd(dA, dBx, Cm, None, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [256, 37])
def test_function_gradient_matches_plain(cuda, S):
    """The Function's gradients (the backward kernels from the forward's
    saved states) against the plain version's (which recomputes every
    state), at the path's width."""
    B, d, n = 2, 4096, 16
    dA, dBx, Cm = _inputs(cuda, (B, S, d, n), torch.float32)
    h0 = torch.randn(B, d, n, device=cuda)
    dy = torch.randn(B, S, d, device=cuda)
    dh = torch.randn(B, d, n, device=cuda)
    leaves = [t.clone().requires_grad_() for t in (dA, dBx, Cm, h0)]
    y, h = SB.SelectiveScan.apply(*leaves)
    torch.autograd.backward((y, h), (dy, dh))
    want = SB.selective_scan_bwd_plain(dA, dBx, Cm, h0, dy, dh)
    for leaf, w in zip(leaves, want):
        assert _rel(leaf.grad, w) <= BWD_TOL


@pytest.mark.cuda
def test_function_launches_both_kernels(cuda):
    """Under autograd the Function scans a copy of h0 forward (the caller's
    state is left as it was) and runs the backward kernel once; it refuses
    bf16, which its backward does not take."""
    dA, dBx, Cm = (t.requires_grad_() for t in
                   _inputs(cuda, (2, 32, 64, 16), torch.float32))
    h0 = torch.randn(2, 64, 16, device=cuda, requires_grad=True)
    keep = h0.detach().clone()
    n = SS.LAUNCHES, SB.LAUNCHES
    y, h = SB.SelectiveScan.apply(dA, dBx, Cm, h0)
    (y.sum() + h.sum()).backward()
    torch.cuda.synchronize()
    assert (SS.LAUNCHES, SB.LAUNCHES) == (n[0] + 1, n[1] + 1)
    assert torch.equal(h0.detach(), keep)
    for t in (dA, dBx, Cm, h0):
        assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0
    with pytest.raises(TypeError, match="float32"):
        SB.SelectiveScan.apply(*(t.detach().bfloat16() for t in
                                 (dA, dBx, Cm)), h0)
