"""The port's CUDA sources built for the host (g++ against the stand-in
runtime in ``tests/cuda_host``), shared by the test files that run them:
``test_torch_lm_kernels.py``, ``test_torch_rmsnorm_host.py`` and
``test_torch_dense_archs.py``. A test file takes the fixtures by
importing them; each module builds its own libraries once."""
import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.build import CSRC
from repro_torch.kernels.flash_attention import flash_attention as FA
from repro_torch.kernels.flash_attention import flash_attention_bwd as FB
from repro_torch.kernels.rmsnorm import rmsnorm as RN
from repro_torch.kernels.rmsnorm import rmsnorm_bwd as RB

HOST_CUDA = Path(__file__).parent / "cuda_host"
HOST_SM90 = HOST_CUDA / "sm90"


def close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# --------------------------------------------------------------------------
# the CUDA sources, run on the host: g++ with the stand-in runtime in
# tests/cuda_host (one std::thread per CUDA thread), float32 only
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """The four kernel sources (rmsnorm, flash_attention and their
    backward) built for the host, one g++ each, at once."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to run the CUDA sources on the host")
    out = tmp_path_factory.mktemp("host_lm_kernels")
    procs = {}
    for mod in (RN, FA, RB, FB):
        so = out / f"{mod.KERNEL.kind}.so"
        procs[mod] = (so, subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             f"-I{HOST_CUDA}", f"-I{CSRC}", "-x", "c++", "-o", str(so),
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


# --------------------------------------------------------------------------
# the tensor-core routes, run on the host: the bf16 code of the attention
# sources built with g++ against tests/cuda_host/sm90 (sm90.cuh's helpers
# emulated: wgmma reads its operands through the descriptors and the
# 128-byte swizzle, each thread computes its accumulator fragment)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_tc_libs(tmp_path_factory):
    """flash_attention.cu and flash_attention_bwd.cu with their bf16
    tensor-core entries, built for the host, one g++ each, at once."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is needed to run the CUDA sources on the host")
    out = tmp_path_factory.mktemp("host_tc_kernels")
    procs = {}
    for mod in (FA, FB):
        so = out / f"{mod.KERNEL.kind}.so"
        procs[mod] = (so, subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-D__CUDACC__", f"-I{HOST_SM90}", f"-I{HOST_CUDA}", "-x", "c++",
             "-o", str(so), str(mod.KERNEL.cu)],
            stderr=subprocess.PIPE, text=True))
    libs = {}
    for mod, (so, p) in procs.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        lib = ctypes.CDLL(str(so))
        for name, types in mod.KERNEL.argtypes.items():
            if "_tc_" in name:
                getattr(lib, name).argtypes = types
        libs[mod] = lib
    return libs
