"""The encoder-decoder's attention routes on the card, at seamless-m4t's
shapes (16 heads of 64), against the plain versions: the forward
non-causal at Sq = Sk, at Sq != Sk both ways and ragged on the tensor
cores, and at Sq = 1 against up to 4096 keys on the decode route
(cross-attention at decode; at head dim 128 and a GQA group of 8 too);
the backward non-causal at Sq != Sk; then seamless's and qwen2-vl's smoke
models, whose encoder, cross-attention, decode and M-RoPE training run
on the card against the same models on the CPU.

Imports nothing of JAX, so it runs on a machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_encdec_cuda.py

Skips where ``torch.cuda.is_available()`` is false.

Tolerances, those of ``tests/test_torch_lm_cuda.py`` and
``tests/test_torch_train_cuda.py``: the forward at rtol 1e-2, atol 2e-3
(bf16: one ulp of the output, the route's fp16 P and V within it); the
backward as the largest |got - want| over the largest |want|, 1e-2 (one
bf16 ulp); the smoke models on the card against the CPU at atol = rtol =
0.1 on the logits (``tests/test_torch_lm.py``), the loss at 2e-2 and each
leaf's gradient at relative L2 2e-2 (``tests/test_torch_train_cuda.py``).
"""
import math

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import flash_attention_bwd as FB
from repro_torch.models import get_model
from repro_torch.models.blueprint import init_params, tree_map
from repro_torch.models.registry import mrope_grid_positions
from repro_torch.train.optimizer import leaves
from repro_torch.train.train_step import value_and_grad

FWD_TOL = (1e-2, 2e-3)
BWD_TOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(dev, B, H, Hkv, Sq, Sk, D, seed=0):
    g = torch.Generator(dev).manual_seed(seed)
    return tuple(torch.randn(B, S, h, D, generator=g, device=dev)
                 .bfloat16().transpose(1, 2)
                 for S, h in ((Sq, H), (Sk, Hkv), (Sk, Hkv)))


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


#: (B, H, Hkv, Sq, Sk, D): the encoder (Sq = Sk) and cross-attention in
#: training (Sq = S_tgt against Sk = S_src, both ways, ragged)
FWD_SHAPES = [(4, 16, 16, 2048, 2048, 64), (4, 16, 16, 2048, 1500, 64),
              (2, 16, 16, 1000, 2048, 64)]
#: cross-attention at decode: one query row against the encoder's keys,
#: the decode route's (ragged 130 keys: one split; qwen2-vl's GQA group
#: of 8 at head dim 128)
DECODE_SHAPES = [(8, 16, 16, 1, 2048, 64), (8, 16, 16, 1, 4096, 64),
                 (8, 16, 16, 1, 130, 64), (4, 64, 8, 1, 4096, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D", FWD_SHAPES)
def test_non_causal_forward_on_the_tensor_cores(B, H, Hkv, Sq, Sk, D, cuda):
    q, k, v = _qkv(cuda, B, H, Hkv, Sq, Sk, D)
    assert FA.route(torch.bfloat16, D,
                    FA._rows_aligned(q, k, v)) == "tensor_cores"
    before = dict(FA.LAUNCHES_BY_ROUTE)
    got, lse = FA.flash_attention(q, k, v, causal=False, with_lse=True)
    assert FA.LAUNCHES_BY_ROUTE["tensor_cores"] == \
        before["tensor_cores"] + 1
    want, want_lse = FA.flash_attention_plain(q, k, v, causal=False,
                                              with_lse=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=FWD_TOL[0],
                               atol=FWD_TOL[1])
    assert _rel(lse, want_lse) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D", DECODE_SHAPES)
def test_non_causal_forward_at_one_row_on_the_decode_route(B, H, Hkv, Sq,
                                                           Sk, D, cuda):
    """The Sq = 1 cases, which took the tensor cores before the decode
    route: o at the forward's tolerance, the lse at 1e-5, two calls bit
    for bit."""
    q, k, v = _qkv(cuda, B, H, Hkv, Sq, Sk, D)
    assert FA.route(torch.bfloat16, D, FA._rows_aligned(q, k, v),
                    Sq) == "decode"
    before = dict(FA.LAUNCHES_BY_ROUTE)
    got, lse = FA.flash_attention(q, k, v, causal=False, with_lse=True)
    assert FA.LAUNCHES_BY_ROUTE == {**before,
                                    "decode": before["decode"] + 1}
    want, want_lse = FA.flash_attention_plain(q, k, v, causal=False,
                                              with_lse=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=FWD_TOL[0],
                               atol=FWD_TOL[1])
    assert _rel(lse, want_lse) < 1e-5
    assert torch.equal(FA.flash_attention(q, k, v, causal=False), got)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D", [
    (4, 16, 16, 2048, 1500, 64), (2, 16, 16, 1000, 2048, 64),
    (2, 16, 16, 2048, 2048, 64), (2, 16, 16, 1, 130, 64)])
@pytest.mark.parametrize("do_scale", [1.0, 1.0 / 8192])
def test_non_causal_backward_on_the_tensor_cores(B, H, Hkv, Sq, Sk, D,
                                                 do_scale, cuda):
    q, k, v = _qkv(cuda, B, H, Hkv, Sq, Sk, D)
    g = torch.Generator(cuda).manual_seed(1)
    do = (torch.randn(B, Sq, H, D, generator=g, device=cuda)
          * do_scale).bfloat16().transpose(1, 2)
    o, lse = FA.flash_attention(q, k, v, causal=False, with_lse=True)
    before = FB.LAUNCHES_BY_ROUTE["tensor_cores"]
    got = FB.flash_attention_bwd(q, k, v, o, do, lse, causal=False)
    assert FB.LAUNCHES_BY_ROUTE["tensor_cores"] == before + 1
    want = FB.flash_attention_bwd_plain(q, k, v, o, do, lse, causal=False)
    rels = [_rel(a, b) for a, b in zip(got, want)]
    assert max(rels) < BWD_TOL, rels
    again = FB.flash_attention_bwd(q, k, v, o, do, lse, causal=False)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _smoke(arch, seed=0):
    model = get_model(get_config(arch, smoke=True))
    return model, init_params(model.blueprint(),
                              torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.cuda
def test_seamless_smoke_decodes_against_an_encoder_card_vs_cpu(cuda):
    """The encoder over 40 frames and 6 decode steps against its output,
    on the card against the CPU."""
    model, p_cpu = _smoke("seamless-m4t-large-v2")
    p_card = tree_map(lambda a: a.to(cuda), p_cpu)
    g = torch.Generator().manual_seed(2)
    frames = torch.randn(2, 40, 128, generator=g).bfloat16()
    toks = torch.randint(0, 512, (2, 6), generator=g)
    outs = []
    for p, dev in ((p_cpu, "cpu"), (p_card, cuda)):
        enc = model._encode(p, frames.to(dev))
        cache = model.init_cache(2, 8, device=dev)
        steps = []
        for t in range(6):
            logits, cache = model.decode_step(
                p, cache, toks[:, t:t + 1].to(dev),
                torch.full((2,), t, device=dev), enc)
            steps.append(logits.cpu())
        outs.append((enc.cpu(), torch.cat(steps, 1)))
    (enc0, l0), (enc1, l1) = outs
    torch.testing.assert_close(enc1.float(), enc0.float(), rtol=0.1,
                               atol=0.1)
    torch.testing.assert_close(l1[..., :512], l0[..., :512], rtol=0.1,
                               atol=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "qwen2-vl-72b"])
def test_smoke_training_card_vs_cpu(arch, cuda):
    """``loss_fn`` and every leaf's gradient with the config's frames (and
    M-RoPE positions), on the card against the CPU, every attention
    through the backward kernel (head dim 32: the CUDA cores)."""
    model, p_cpu = _smoke(arch)
    p_card = tree_map(lambda a: a.to(cuda), p_cpu)
    g = torch.Generator().manual_seed(3)
    Sf = 32 if arch.startswith("seamless") else 16
    batch = {"tokens": torch.randint(0, 512, (2, 64), generator=g),
             "frontend_embeds": torch.randn(2, Sf, 128,
                                            generator=g).bfloat16()}
    if arch == "qwen2-vl-72b":
        batch["mrope_positions"] = mrope_grid_positions(2, 64, 4, 4)
    l0, g0 = value_and_grad(model, p_cpu, batch, remat=True)
    before = FB.LAUNCHES
    l1, g1 = value_and_grad(model, p_card,
                            {k: v.to(cuda) for k, v in batch.items()},
                            remat=True)
    layers = model.cfg.n_layers * (
        2 if arch.startswith("seamless") else 1) + model.cfg.enc_layers
    assert FB.LAUNCHES - before == layers
    assert math.isclose(float(l1), float(l0), abs_tol=2e-2)
    for a, b in zip(leaves(g1), leaves(g0)):
        err = float((a.cpu().float() - b.float()).norm()
                    / b.float().norm().clamp_min(1e-30))
        assert err < 2e-2 or not b.float().any()
