"""The forward rmsnorm source's float32 instantiation run on the host (g++
with the stand-in runtime in ``tests/cuda_host``, ``host_libs`` of
``torch_host_kernels.py``) against the plain version at 1e-5: sums in
another order. Every route: 16-byte vectors at one, two, four or eight a
thread, and the scalar route.
"""
import pytest
import torch

from repro_torch.kernels.rmsnorm import rmsnorm as RN
from torch_host_kernels import close as _close
from torch_host_kernels import host_libs  # noqa: F401


@pytest.mark.parametrize("shape", [(3, 64), (5, 300), (2, 2048)])
def test_rmsnorm_source_matches_plain_on_host(shape, host_libs):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(shape, generator=g)
    s = torch.randn(shape[1], generator=g)
    out, rstd = torch.empty_like(x), torch.empty(shape[0])
    err = host_libs[RN].rmsnorm_f32(x.data_ptr(), s.data_ptr(),
                                    out.data_ptr(), rstd.data_ptr(),
                                    shape[0], shape[1], 1e-6, None)
    assert err == 0
    want, want_rstd = RN.rmsnorm_plain(x, s, with_rstd=True)
    _close(out, want.numpy(), 1e-5)
    _close(rstd, want_rstd.numpy(), 1e-5)


@pytest.mark.parametrize("N", [1, 8, 129])
@pytest.mark.parametrize("d", [8, 99, 100, 2048, 4096, 7168, 8196])
@pytest.mark.parametrize("offset", [0, 1])
def test_rmsnorm_routes_match_plain_on_host(N, d, offset, host_libs):
    """Each route of the float32 source: 256 threads a row holding one,
    two, four or eight vectors of 4 (d 8, 100, 2048, 4096 and 7168: 2,
    25, 512, 1024 and 1792 vectors), and the scalar route (d 99, not a
    whole number of vectors; d 8196, more than 8 vectors a thread; or x
    one element past a 16-byte boundary)."""
    g = torch.Generator().manual_seed(N * d)
    x = torch.randn(N * d + offset, generator=g)[offset:].view(N, d)
    s = torch.randn(d, generator=g)
    out, rstd = torch.empty(N, d), torch.empty(N)
    err = host_libs[RN].rmsnorm_f32(x.data_ptr(), s.data_ptr(),
                                    out.data_ptr(), rstd.data_ptr(), N, d,
                                    1e-6, None)
    assert err == 0
    want, want_rstd = RN.rmsnorm_plain(x, s, with_rstd=True)
    _close(out, want.numpy(), 1e-5)
    _close(rstd, want_rstd.numpy(), 1e-5)
    # without an rstd buffer the same output
    again = torch.empty(N, d)
    assert host_libs[RN].rmsnorm_f32(x.data_ptr(), s.data_ptr(),
                                     again.data_ptr(), None, N, d, 1e-6,
                                     None) == 0
    assert torch.equal(again, out)
