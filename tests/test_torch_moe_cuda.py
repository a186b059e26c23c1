"""moe_dispatch on the card: the CUDA kernel against its plain version,
and olmoe-1b-7b's smoke LM going through it.

Imports nothing of JAX, so it runs on a machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_cuda.py

Skips where ``torch.cuda.is_available()`` is false. Tolerances are those
of ``tests/test_kernels.py``: 1e-5 in float32 and 3e-2 in bfloat16; the
shapes added for the tensor-core route and for counts, drawn as the path
draws them, are held at chip_smoke.py's rtol 1e-2, atol 2e-3 in bf16.
The
backward (the SwiGLU kernel between batched products) and the combine's
gather at chip_smoke.py's BWD_TOL: bf16 1e-2, float32 1e-4 of each
output's largest value. The
smoke LM on the card against the same LM on the CPU: atol = rtol = 0.1
on the logits, as ``tests/test_torch_moe.py`` holds it to the JAX
package, with the router zeroed so that bf16 near-ties cannot route a
token apart on the two devices.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.moe_dispatch import moe_combine as MC
from repro_torch.kernels.moe_dispatch import moe_dispatch as MD
from repro_torch.kernels.moe_dispatch import moe_dispatch_bwd as MB
from repro_torch.kernels.rmsnorm import rmsnorm as RN
from repro_torch.models import get_model
from repro_torch.models.blueprint import init_params, tree_map

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
#: the backward against its plain version: the largest |got - want| over
#: the largest |want| of each output (chip_smoke.py's BWD_TOL)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
#: chip_smoke.py's bf16 tolerance for moe_dispatch: rtol, atol
CARD_BF16_TOL = (1e-2, 2e-3)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, shape, dtype, seed=0):
    E, C, d, f = shape
    g = torch.Generator(dev).manual_seed(seed)
    return [(torch.randn(s, generator=g, device=dev) * 0.1).to(dtype)
            for s in ((E, C, d), (E, d, 2 * f), (E, f, d))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (4, 128, 64, 32), (2, 256, 32, 64), (8, 128, 128, 16),   # Pallas sweep
    (8, 1, 2048, 1024), (3, 40, 128, 64), (2, 130, 100, 300),
    (64, 17, 256, 96),
    # f past the first kernel's 3552, sliced: C = 1 (decode), C > 1
    (2, 1, 64, 4000), (16, 1, 256, 3000), (4, 1, 1024, 24576),
    (3, 40, 128, 3600), (2, 20, 100, 2050)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_expert_ff_kernel_matches_plain(cuda, shape, dtype):
    x, wi, wo = _inputs(cuda, shape, dtype)
    before = MD.LAUNCHES
    routes = dict(MD.LAUNCHES_BY_ROUTE)
    got = MD.grouped_expert_ff(x, wi, wo)
    torch.cuda.synchronize()
    assert MD.LAUNCHES == before + 1
    routes[MD.route(dtype, *shape[1:])] += 1
    assert MD.LAUNCHES_BY_ROUTE == routes
    want = MD.grouped_expert_ff_plain(x, wi, wo)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (3, 17, 136, 200), (3, 40, 136, 200), (3, 130, 136, 200),
    (3, 1280, 136, 200),      # d, f multiples of 8, not of 128
    (4, 40, 256, 96), (64, 17, 256, 96), (2, 130, 128, 200),
    (2, 64, 1024, 512), (8, 256, 512, 256)])
def test_grouped_expert_ff_tensor_cores_match_plain(cuda, shape):
    """The bf16 route at C > 1 on the tensor cores (the hidden and wo in
    fp16 for the down product), x at unit scale and the weights drawn as
    init_params draws them, at the card's bf16 tolerance."""
    x, wi, wo = _path_inputs(cuda, shape, 3)
    tc = MD.LAUNCHES_BY_ROUTE["tensor_cores"]
    got = MD.grouped_expert_ff(x, wi, wo)
    torch.cuda.synchronize()
    assert MD.LAUNCHES_BY_ROUTE["tensor_cores"] == tc + 1
    want = MD.grouped_expert_ff_plain(x, wi, wo)
    assert got.dtype == want.dtype and got.shape == want.shape
    rtol, atol = CARD_BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["h", "wo"])
def test_grouped_expert_ff_tensor_cores_take_values_past_fp16_range(
        cuda, what):
    """ROADMAP C13 on the card: a hidden value past fp16's 65504 (one
    expert's gate and up columns set to 5 x one row of its x) or one wo
    element at 7e4. The output is finite and within the card's bf16
    tolerance of the plain version (tests/test_torch_moe_kernels.py runs
    the same on the host)."""
    E, C, d, f = 4, 300, 256, 520
    x, wi, wo = _path_inputs(cuda, (E, C, d, f), 5)
    if what == "h":
        wi[1, :, 150] = (5 * x[1, 3].float()).bfloat16()
        wi[1, :, f + 150] = wi[1, :, 150]
    else:
        wo[2, 37, 100] = 7e4
    tc = MD.LAUNCHES_BY_ROUTE["tensor_cores"]
    got = MD.grouped_expert_ff(x, wi, wo)
    torch.cuda.synchronize()
    assert MD.LAUNCHES_BY_ROUTE["tensor_cores"] == tc + 1
    want = MD.grouped_expert_ff_plain(x, wi, wo)
    assert torch.isfinite(got.float()).all()
    rtol, atol = CARD_BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def _path_inputs(dev, shape, seed):
    """x at unit scale and the weights drawn as init_params draws them,
    bf16."""
    E, C, d, f = shape
    g = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(E, C, d, generator=g, device=dev).bfloat16()
    wi = (torch.randn(E, d, 2 * f, generator=g, device=dev)
          * d ** -0.5).bfloat16()
    wo = (torch.randn(E, f, d, generator=g, device=dev)
          * f ** -0.5).bfloat16()
    return x, wi, wo


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["zero", "mixed", "full"])
@pytest.mark.parametrize("shape,dtype", [
    ((64, 1, 1024, 512), torch.bfloat16),    # C = 1, CUDA cores
    ((64, 1, 1024, 512), torch.float32),
    ((4, 300, 256, 96), torch.bfloat16),     # C > 1, tensor cores
    ((2, 130, 100, 300), torch.bfloat16),    # C > 1, CUDA cores
    ((3, 40, 128, 64), torch.float32)])
def test_grouped_expert_ff_counts_match_plain(cuda, shape, dtype, how):
    """With counts (none filled, a mix, all filled) on every route: x's
    rows past the count are not zero here and come out zero; at C = 1
    the hidden is cut into the finest slices."""
    E, C, d, f = shape
    x, wi, wo = (t.to(dtype) for t in _path_inputs(cuda, shape, 5))
    if how == "zero":
        counts = torch.zeros(E, dtype=torch.int32, device=cuda)
    elif how == "full":
        counts = torch.full((E,), C, dtype=torch.int32, device=cuda)
    else:
        g = torch.Generator(cuda).manual_seed(6)
        counts = torch.randint(0, C + 1, (E,), generator=g, device=cuda,
                               dtype=torch.int32)
        counts[0], counts[-1] = 0, C
    routes = dict(MD.LAUNCHES_BY_ROUTE)
    got = MD.grouped_expert_ff(x, wi, wo, counts)
    torch.cuda.synchronize()
    routes[MD.route(dtype, C, d, f)] += 1
    assert MD.LAUNCHES_BY_ROUTE == routes
    want = MD.grouped_expert_ff_plain(x, wi, wo, counts)
    keep = torch.arange(C, device=cuda)[None, :] < counts[:, None]
    assert (got[~keep] == 0).all()
    rtol, atol = (CARD_BF16_TOL if dtype == torch.bfloat16
                  else (TOL[dtype],) * 2)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x, wi, wo = _inputs(cuda, (2, 4, 16, 8), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        MD.grouped_expert_ff(x.transpose(1, 2).contiguous().transpose(1, 2),
                             wi, wo)
    with pytest.raises(ValueError, match="one CUDA device"):
        MD.grouped_expert_ff(x, wi.cpu(), wo)
    odd = torch.zeros(x.numel() + 1, device=cuda)[1:].view(x.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        MD.grouped_expert_ff(odd, wi, wo)
    before = MD.LAUNCHES
    empty = MD.grouped_expert_ff(x[:, :0], wi, wo)
    assert empty.shape == (2, 0, 16) and MD.LAUNCHES == before


@pytest.mark.cuda
def test_smoke_olmoe_on_the_card_goes_through_the_kernels(cuda):
    """olmoe-1b-7b's smoke LM: prefill on the card (kernels) equals the
    CPU (plain versions); per layer two rmsnorm launches, one attention
    and one grouped expert FF."""
    cfg = get_config("olmoe-1b-7b", smoke=True)
    model = get_model(cfg)
    params = init_params(model.blueprint(), torch.Generator().manual_seed(0))
    params["stack"][0]["moe"]["router"].zero_()
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 64)))
    want = model.prefill(params, toks)
    on_card = tree_map(lambda a: a.to(cuda), params)
    counts = RN.LAUNCHES, FA.LAUNCHES, MD.LAUNCHES
    got = model.prefill(on_card, toks.to(cuda))
    torch.cuda.synchronize()
    assert (RN.LAUNCHES - counts[0], FA.LAUNCHES - counts[1],
            MD.LAUNCHES - counts[2]) == (2 * cfg.n_layers + 1,
                                         cfg.n_layers, cfg.n_layers)
    torch.testing.assert_close(got.cpu(), want, rtol=0.1, atol=0.1)


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _counts(dev, E, C, seed):
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randint(0, C + 1, (E,), generator=g, device=dev,
                         dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 8, 64, 32), (8, 40, 128, 1024),
                                   (2, 17, 100, 300), (3, 5, 64, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_counts", [False, True])
def test_swiglu_bwd_kernel_matches_plain(cuda, shape, dtype, with_counts):
    """Both routes (16-byte vectors; f = 7 one element a thread), rows
    past counts zero."""
    E, C, d, f = shape
    g = torch.Generator(cuda).manual_seed(1)
    gu = torch.randn(E, C, 2 * f, generator=g, device=cuda).to(dtype)
    dh = torch.randn(E, C, f, generator=g, device=cuda).to(dtype)
    counts = _counts(cuda, E, C, 2) if with_counts else None
    before = MB.LAUNCHES
    got = MB.swiglu_bwd(gu, dh, counts)
    torch.cuda.synchronize()
    assert MB.LAUNCHES == before + 1
    for a, b in zip(got, MB.swiglu_bwd_plain(gu, dh, counts)):
        assert _rel(a, b) <= BWD_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 64, 256, 128), (8, 130, 128, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_expert_ff_bwd_matches_plain(cuda, shape, dtype):
    """dx, dwi and dwo with the counts of a random routing, against the
    plain closed form; two calls give the same bits."""
    E, C, d, f = shape
    x, wi, wo = _inputs(cuda, shape, dtype)
    dy = (torch.randn(E, C, d, device=cuda) * 0.1).to(dtype)
    counts = _counts(cuda, E, C, 3)
    got = MB.grouped_expert_ff_bwd(x, wi, wo, dy, counts)
    want = MB.grouped_expert_ff_bwd_plain(x, wi, wo, dy, counts)
    for a, b in zip(got, want):
        assert a.dtype == dtype and _rel(a, b) <= BWD_TOL[dtype]
    again = MB.grouped_expert_ff_bwd(x, wi, wo, dy, counts)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_function_launches_both_kernels(cuda):
    """Under autograd the Function runs the forward kernel once and, in
    the backward, the SwiGLU kernel once."""
    x, wi, wo = (t.requires_grad_() for t in
                 _inputs(cuda, (4, 64, 128, 64), torch.bfloat16))
    counts = _counts(cuda, 4, 64, 4)
    n = MD.LAUNCHES, MB.LAUNCHES
    MB.GroupedExpertFF.apply(x, wi, wo, counts).float().sum().backward()
    torch.cuda.synchronize()
    assert (MD.LAUNCHES, MB.LAUNCHES) == (n[0] + 1, n[1] + 1)
    for t in (x, wi, wo):
        assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2048, 100, 13])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_sum_kernel_matches_plain(cuda, d, dtype):
    """The combine's gather: 8 gate ranks a token, some dropped (slot M);
    float32 bit for bit (the same order), bf16 one rounding."""
    g = torch.Generator(cuda).manual_seed(5)
    M, T, k = 300, 97, 8
    src = torch.randn(M, d, generator=g, device=cuda).to(dtype)
    slots = torch.randint(0, M + 20, (T, k), generator=g, device=cuda,
                          dtype=torch.int32).clamp_max(M)
    before = MC.LAUNCHES
    got = MC.gather_sum(src, slots)
    torch.cuda.synchronize()
    assert MC.LAUNCHES == before + 1
    want = MC.gather_sum_plain(src, slots)
    if dtype == torch.float32:
        assert torch.equal(got, want)
    else:
        assert _rel(got, want) <= BWD_TOL[dtype]
