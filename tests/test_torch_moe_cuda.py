"""moe_dispatch on the card: the CUDA kernel against its plain version,
and olmoe-1b-7b's smoke LM going through it.

Imports nothing of JAX, so it runs on a machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_moe_cuda.py

Skips where ``torch.cuda.is_available()`` is false. Tolerances are those
of ``tests/test_kernels.py``: 1e-5 in float32 and 3e-2 in bfloat16. The
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
    (64, 17, 256, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_expert_ff_kernel_matches_plain(cuda, shape, dtype):
    x, wi, wo = _inputs(cuda, shape, dtype)
    before = MD.LAUNCHES
    got = MD.grouped_expert_ff(x, wi, wo)
    torch.cuda.synchronize()
    assert MD.LAUNCHES == before + 1
    want = MD.grouped_expert_ff_plain(x, wi, wo)
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    x, wi, wo = _inputs(cuda, (2, 4, 16, 8), torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        MD.grouped_expert_ff(x.transpose(1, 2).contiguous().transpose(1, 2),
                             wi, wo)
    with pytest.raises(ValueError, match="one CUDA device"):
        MD.grouped_expert_ff(x, wi.cpu(), wo)
    big = _inputs(cuda, (1, 2, 16, 4000), torch.bfloat16)
    with pytest.raises(ValueError, match="shared memory"):
        MD.grouped_expert_ff(*big)
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
