"""moe_dispatch on the card: the CUDA kernel against its plain version,
and olmoe-1b-7b's smoke LM going through it.

Imports nothing of JAX, so it runs on a machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_cuda.py

Skips where ``torch.cuda.is_available()`` is false. Tolerances are those
of ``tests/test_kernels.py``: 1e-5 in float32 and 3e-2 in bfloat16; the
shapes added for the tensor-core route, drawn as the path draws them,
are held at chip_smoke.py's rtol 1e-2, atol 2e-3. The
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
from repro_torch.kernels.moe_dispatch import moe_dispatch as MD
from repro_torch.kernels.rmsnorm import rmsnorm as RN
from repro_torch.models import get_model
from repro_torch.models.blueprint import init_params, tree_map

TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
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
    (4, 40, 256, 96), (64, 17, 256, 96), (2, 130, 128, 200)])
def test_grouped_expert_ff_tensor_cores_match_plain(cuda, shape):
    """The bf16 route at C > 1 on the tensor cores, x at unit scale and
    the weights drawn as init_params draws them, at the card's bf16
    tolerance."""
    E, C, d, f = shape
    g = torch.Generator(cuda).manual_seed(3)
    x = torch.randn(E, C, d, generator=g, device=cuda).bfloat16()
    wi = (torch.randn(E, d, 2 * f, generator=g, device=cuda)
          * d ** -0.5).bfloat16()
    wo = (torch.randn(E, f, d, generator=g, device=cuda)
          * f ** -0.5).bfloat16()
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
