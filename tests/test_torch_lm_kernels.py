"""rmsnorm and flash_attention: the port's plain versions against the JAX
package's Pallas kernels (interpret mode) and oracles, and the CUDA
sources' float32 instantiations run on the host.

The CUDA kernels against their plain versions, on a card, are in
``test_torch_lm_cuda.py``.

Tolerances are those of ``tests/test_kernels.py``: rmsnorm 1e-5 in
float32 and 2e-2 in bfloat16; attention 2e-5 in float32 and 3e-2 in
bfloat16 (both sides round their output to bf16 once). The host runs of
the CUDA sources are held to the plain version at 1e-5 (rmsnorm) and
2e-5 (attention): sums in another order, the online softmax.
"""
import ctypes
import math
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention_op
from repro.kernels.flash_attention.ref import attention_ref
from repro.kernels.rmsnorm.ops import rmsnorm_op
from repro.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.rmsnorm import rmsnorm as RN

HOST_CUDA = Path(__file__).parent / "cuda_host"
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _pair(a: np.ndarray, dtype: torch.dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    t = torch.from_numpy(a).to(dtype)
    return jnp.array(t.float().numpy(), JNP[dtype]), t


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("shape", [(256, 64), (128, 512), (384, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_plain_matches_pallas(shape, dtype):
    rng = np.random.default_rng(0)
    jx, x = _pair(rng.standard_normal(shape).astype(np.float32), dtype)
    js, s = _pair(rng.standard_normal(shape[1]).astype(np.float32), dtype)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    got = RN.rmsnorm(x, s)
    assert got.dtype == dtype
    _close(got, rmsnorm_op(jx, js, block=128), tol)
    _close(RN.rmsnorm_plain(x, s), rmsnorm_ref(jx, js), tol)


@pytest.mark.parametrize("shape", [(1, 2, 128, 64), (2, 1, 256, 64),
                                   (1, 1, 128, 128), (2, 2, 192, 32),
                                   (1, 2, 128, 128), (1, 1, 192, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas(shape, dtype, causal):
    rng = np.random.default_rng(1)
    (jq, q), (jk, k), (jv, v) = [
        _pair(rng.standard_normal(shape).astype(np.float32), dtype)
        for _ in range(3)]
    got = FA.flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype and got.shape == shape
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    _close(got, flash_attention_op(jq, jk, jv, causal=causal, block_q=64,
                                   block_k=64), tol)


@pytest.mark.parametrize("S", [1, 37, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_ragged_gqa_matches_oracle(S, causal):
    """Any S, and K/V with Hkv = H/4 heads, against the JAX oracle on
    K/V repeated to H heads (head h reads KV head h // 4)."""
    rng = np.random.default_rng(2)
    B, H, Hkv, D = 2, 8, 2, 32
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    want = attention_ref(jnp.array(q), jnp.array(np.repeat(k, 4, axis=1)),
                         jnp.array(np.repeat(v, 4, axis=1)), causal=causal)
    got = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal)
    _close(got, want, 2e-5)


def test_plain_versions_do_not_count():
    x = torch.ones(4, 8)
    before = (RN.LAUNCHES, FA.LAUNCHES)
    RN.rmsnorm(x, torch.ones(8))
    FA.flash_attention(x.view(1, 1, 4, 8), x.view(1, 1, 4, 8),
                       x.view(1, 1, 4, 8))
    assert (RN.LAUNCHES, FA.LAUNCHES) == before


def test_wrappers_refuse_bad_shapes():
    with pytest.raises(ValueError, match="scale"):
        RN.rmsnorm(torch.ones(4, 8), torch.ones(7))
    with pytest.raises(ValueError, match="Hkv must divide H"):
        FA.flash_attention(torch.ones(1, 4, 8, 32), torch.ones(1, 3, 8, 32),
                           torch.ones(1, 3, 8, 32))


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version; anything else goes to
    the kernel's checks and is refused there."""
    x = torch.ones(4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        RN.rmsnorm(x, torch.ones(8, device="meta"))
    q = torch.ones(1, 2, 4, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        FA.flash_attention(q, q, q)


# --------------------------------------------------------------------------
# the CUDA sources, run on the host: g++ with the stand-in runtime in
# tests/cuda_host (one std::thread per CUDA thread), float32 only
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """Both kernels' sources built for the host, one g++ each, at once."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to run the CUDA sources on the host")
    out = tmp_path_factory.mktemp("host_lm_kernels")
    procs = {}
    for mod in (RN, FA):
        so = out / f"{mod.KERNEL.kind}.so"
        procs[mod] = (so, subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             f"-I{HOST_CUDA}", "-x", "c++", "-o", str(so),
             str(mod.KERNEL.cu)], stderr=subprocess.PIPE, text=True))
    libs = {}
    for mod, (so, p) in procs.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        lib = ctypes.CDLL(str(so))
        for name, types in mod.KERNEL.argtypes.items():
            if "bf16" not in name:
                getattr(lib, name).argtypes = types
        libs[mod] = lib
    return libs


@pytest.mark.parametrize("shape", [(3, 64), (5, 300), (2, 2048)])
def test_rmsnorm_source_matches_plain_on_host(shape, host_libs):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g)
    s = torch.randn(shape[1], generator=g)
    out = torch.empty_like(x)
    err = host_libs[RN].rmsnorm_f32(x.data_ptr(), s.data_ptr(),
                                    out.data_ptr(), shape[0], shape[1],
                                    1e-6, None)
    assert err == 0
    _close(out, RN.rmsnorm_plain(x, s).numpy(), 1e-5)


@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D,causal", [
    (1, 2, 1, 80, 80, 32, True),      # ragged second query tile, GQA
    (2, 4, 2, 64, 64, 64, True),      # one full tile, D = 64
    (1, 2, 2, 50, 90, 32, False),     # Sq != Sk, every key
    (1, 1, 1, 130, 130, 64, True),    # three query tiles, ragged keys
    (1, 2, 1, 70, 70, 128, True),     # D = 128: the dynamic-memory tiles
    (1, 1, 1, 40, 100, 128, False),   # D = 128, Sq != Sk, every key
])
def test_flash_attention_source_matches_plain_on_host(B, H, Hkv, Sq, Sk, D,
                                                      causal, host_libs):
    """q, k, v as transposed views of (B, S, H, D) tensors, as the layer
    passes them: the kernel reads their strides."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(B, Sq, H, D, generator=g).transpose(1, 2)
    k = torch.randn(B, Sk, Hkv, D, generator=g).transpose(1, 2)
    v = torch.randn(B, Sk, Hkv, D, generator=g).transpose(1, 2)
    out = torch.empty(B, H, Sq, D)
    err = getattr(host_libs[FA], f"flash_attention_f32_d{D}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
        Hkv, Sq, Sk, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), 1.0 / math.sqrt(D), None)
    assert err == 0
    _close(out, FA.flash_attention_plain(q, k, v, causal=causal).numpy(),
           2e-5)
