"""VOLT-compiled SIMT programs launched as CUDA kernels on Hopper.

Replaces ``repro/kernels/simt_exec/simt_exec.py:pallas_simt_launch`` (the
Pallas TPU kernel, one grid program per workgroup). Here ``codegen`` emits
CUDA C++ from the divergence-managed VIR: one CTA per workgroup, one
thread per lane, W = ``params.wg_threads`` <= 1024. Every pointer param is
tiled at W elements per workgroup, so each buffer must be ``grid*W`` long.

Bound: the map kernels of the bench suite are memory-bound. Their least
time on an H100 is (buffers read + buffers written) x n x 4 B over
3.35 TB/s; they do a few operations per element.

The first design is simple and correct, not fast: lockstep predication
runs both sides of every branch, and every STORE sits between two
``__syncthreads()``. Each emitted kernel is built at first use with nvcc
into ``build/simt/<sha256>.so`` (the hash covers the source, the runtime
header and the flags) and loaded with ctypes.

On CPU tensors the wrapper runs the plain version instead: the torch
walker over all workgroups at once, as (grid, W) rows with tile windows.
A CUDA tensor goes to the kernel or raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import weakref
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ...convert import to_scalars
from ...core.backends.torch_backend import (_TY_DTYPE, _FnLowering, _State,
                                            intrinsics, scalar_lanes)
from ...core.interp import LaunchParams
from ...core.vir import Function, Op, Ty
from .codegen import emit_kernel

#: launches of the CUDA kernel; the plain version does not count
LAUNCHES = 0

_CSRC = Path(__file__).resolve().parent / "csrc"
_HEADER = _CSRC / "simt_runtime.cuh"
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "simt"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]
_CTYPE = {torch.float32: "float", torch.int32: "int"}
_BOUND: "weakref.WeakKeyDictionary[Function, Dict[tuple, Any]]" = \
    weakref.WeakKeyDictionary()
_ANALYSED: "weakref.WeakKeyDictionary[Function, tuple]" = \
    weakref.WeakKeyDictionary()


# --------------------------------------------------------------------------
# checks shared by the kernel and its plain version
# --------------------------------------------------------------------------

def _analyse(kernel_fn: Function) -> Tuple[List[str], List[str], bool]:
    """(pointer params, written pointer params, has atomics), walked once
    per Function and IR version so a repeated launch skips the walk."""
    hit = _ANALYSED.get(kernel_fn)
    if hit is None or hit[0] != kernel_fn.ir_version:
        buf_names = [p.name for p in kernel_fn.params if p.ty is Ty.PTR]
        written, atomic = set(), False
        for i in kernel_fn.instructions():
            if i.op is Op.STORE:
                written.add(getattr(i.operands[0], "name", "?"))
            elif i.op is Op.ATOMIC:
                atomic = True
        hit = _ANALYSED[kernel_fn] = (
            kernel_fn.ir_version, buf_names,
            [nm for nm in buf_names if nm in written], atomic)
    return hit[1:]


def _check(kernel_fn: Function, params: LaunchParams,
           buffers: Dict[str, torch.Tensor]) -> Tuple[List[str], List[str]]:
    """(pointer params, written pointer params); raises on what the tiled
    kernel does not take."""
    W, grid = params.wg_threads, params.grid
    buf_names, out_names, atomic = _analyse(kernel_fn)
    devices = set()
    for nm in buf_names:
        t = buffers[nm]
        if t.dim() != 1 or t.shape[0] != grid * W:
            raise ValueError(f"buffer {nm} not tileable: {tuple(t.shape)} "
                             f"!= ({grid * W},)")
        if t.dtype not in _CTYPE:
            raise TypeError(f"buffer {nm} has dtype {t.dtype}; the kernel "
                            "takes float32 and int32")
        if not t.is_contiguous():
            raise ValueError(f"buffer {nm} is not contiguous")
        devices.add(t.device)
    if len(devices) > 1:
        raise ValueError(f"buffers on several devices: {devices}")
    if atomic:
        raise NotImplementedError(
            "atomic kernels are not tileable; use compile_torch")
    return buf_names, out_names


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------

def simt_launch_plain(kernel_fn: Function, params: LaunchParams,
                      buffers: Dict[str, torch.Tensor],
                      scalars: Optional[Dict[str, Any]] = None
                      ) -> Dict[str, torch.Tensor]:
    """The plain torch version of ``simt_launch``, on any device.

    All ``grid`` workgroups run at once as rows of (grid, W) lane tensors;
    each row sees its own tile window of every buffer (``buf_offsets``).
    Written buffers are updated in place, as the kernel does.
    """
    buf_names, out_names = _check(kernel_fn, params, buffers)
    W, R = params.wg_threads, params.grid
    dev = buffers[buf_names[0]].device if buf_names else torch.device("cpu")
    rows = torch.arange(R, dtype=torch.int32, device=dev).unsqueeze(1)
    intr = intrinsics(params, rows, W, tiled=True)
    argmap = scalar_lanes(kernel_fn, scalars or {}, R, W, dev)
    offsets = {nm: rows * W for nm in buf_names}
    low = _FnLowering(kernel_fn, R, W, intr, argmap, dev,
                      buf_offsets=offsets)
    bufs = {nm: buffers[nm].view(R, W) for nm in buf_names}
    for g in kernel_fn.shared:
        bufs[f"@{g.name}"] = torch.zeros((R, g.size),
                                         dtype=_TY_DTYPE[g.elem_ty],
                                         device=dev)
    st = _State({}, bufs, torch.ones((R, W), dtype=torch.bool, device=dev))
    kind, _, out = low.walk(kernel_fn.entry, 0, st, None)
    if kind != "ret":
        raise RuntimeError(f"kernel walk ended with {kind}")
    for nm in out_names:
        buffers[nm].copy_(out.bufs[nm].reshape(-1))
    return buffers


# --------------------------------------------------------------------------
# build and load
# --------------------------------------------------------------------------

def kernel_source(kernel_fn: Function, params: LaunchParams,
                  buffers: Dict[str, torch.Tensor]) -> str:
    """The CUDA C++ that ``simt_launch`` builds for these buffers."""
    _check(kernel_fn, params, buffers)
    return emit_kernel(kernel_fn, params,
                       {p.name: _CTYPE[buffers[p.name].dtype]
                        for p in kernel_fn.params if p.ty is Ty.PTR})


def source_hash(src: str) -> str:
    h = hashlib.sha256()
    h.update(src.encode())
    h.update(_HEADER.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the simt_exec kernels")
    return path


def build_many(sources: List[str]) -> List[Tuple[Path, float]]:
    """Build every source not built yet, one nvcc process each, all
    started together. Returns each shared library with the seconds its
    nvcc took (0.0 where it was built already), in order."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    outs, procs = [], {}
    t0 = time.perf_counter()
    for src in sources:
        key = source_hash(src)
        so = BUILD_DIR / f"{key}.so"
        outs.append(so)
        if so.exists() or so in procs:
            continue
        cu = BUILD_DIR / f"{key}.cu"
        cu.write_text(src)
        tmp = BUILD_DIR / f"{key}.{os.getpid()}.tmp.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
               str(cu)]
        log = BUILD_DIR / f"{key}.log"
        with open(log, "w") as f:
            procs[so] = (tmp, log, subprocess.Popen(
                cmd, stdout=f, stderr=subprocess.STDOUT))
    seconds: Dict[Path, float] = {}
    errors = []
    while len(seconds) < len(procs):
        for so, (tmp, log, proc) in procs.items():
            if so in seconds or proc.poll() is None:
                continue
            seconds[so] = time.perf_counter() - t0
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {so.stem}.cu:\n"
                              f"{log.read_text()}")
            else:
                os.replace(tmp, so)
        time.sleep(0.02)
    if errors:
        raise RuntimeError("\n".join(errors))
    return [(so, seconds.get(so, 0.0)) for so in outs]


def _library(src: str):
    lib = ctypes.CDLL(str(build_many([src])[0][0]))
    lib.launch.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_void_p]
    lib.launch.restype = ctypes.c_int
    return lib


def _bound_library(kernel_fn: Function, params: LaunchParams,
                   buffers: Dict[str, torch.Tensor]):
    """The loaded library for this kernel, geometry and buffer types.
    Remembered per Function (keyed by its IR version), so a repeated
    launch neither emits nor hashes the source again."""
    key = (kernel_fn.ir_version, params.wg_threads, params.local_size,
           params.warp_size, tuple(buffers[p.name].dtype
                                   for p in kernel_fn.params
                                   if p.ty is Ty.PTR))
    per_fn = _BOUND.setdefault(kernel_fn, {})
    lib = per_fn.get(key)
    if lib is None:
        lib = per_fn[key] = _library(kernel_source(kernel_fn, params,
                                                   buffers))
    return lib


def _pack_scalars(kernel_fn: Function, scalars: Dict[str, Any]) -> bytes:
    """The scalar params in order, 4 bytes each (bool as int32)."""
    typed = to_scalars(scalars, kernel_fn)
    return b"".join((typed[p.name] if p.ty is Ty.F32
                     else np.int32(typed[p.name])).tobytes()
                    for p in kernel_fn.params if p.ty is not Ty.PTR)


# --------------------------------------------------------------------------
# the wrapper
# --------------------------------------------------------------------------

def simt_launch(kernel_fn: Function, params: LaunchParams,
                buffers: Dict[str, torch.Tensor],
                scalars: Optional[Dict[str, Any]] = None
                ) -> Dict[str, torch.Tensor]:
    """Run a divergence-managed VIR kernel, one CTA per workgroup.

    Buffers are updated in place on the caller's tensors (the counterpart
    of the Pallas kernel's ``input_output_aliases``) and returned. CUDA
    tensors go to the emitted kernel; CPU tensors go to the plain version.
    """
    global LAUNCHES
    scalars = scalars or {}
    buf_names, _ = _check(kernel_fn, params, buffers)
    if not buf_names or buffers[buf_names[0]].device.type == "cpu":
        return simt_launch_plain(kernel_fn, params, buffers, scalars)
    lib = _bound_library(kernel_fn, params, buffers)
    ptrs = (ctypes.c_void_p * max(1, len(buf_names)))(
        *[buffers[nm].data_ptr() for nm in buf_names])
    packed = ctypes.create_string_buffer(
        _pack_scalars(kernel_fn, scalars) or b"\0")
    stream = torch.cuda.current_stream(buffers[buf_names[0]].device)
    with torch.cuda.device(buffers[buf_names[0]].device):
        err = lib.launch(ptrs, ctypes.cast(packed, ctypes.c_void_p),
                         params.grid, ctypes.c_void_p(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(f"simt_exec launch of @{kernel_fn.name} failed: "
                           f"cudaError {err}")
    LAUNCHES += 1
    return buffers
