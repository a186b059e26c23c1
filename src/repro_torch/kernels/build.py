"""Build CUDA C++ into shared libraries with nvcc, and load them with ctypes.

One route for every kernel of the port: a source with a plain C interface
is written to ``build/<kind>/<sha256>.cu`` at the repo root and built by
one nvcc process into ``<sha256>.so`` beside it. The key hashes the
source, the headers it includes and the flags, so a stale library is
never loaded. Several sources build at once, one nvcc each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import torch

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
#: headers shared by the hand-written kernels (``sm90.cuh``)
CSRC = Path(__file__).resolve().parent / "csrc"
#: sm_90a: the H100's target with wgmma and setmaxnreg; ptxas prints each
#: kernel's registers and spills into the build log
BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def source_key(src: str, headers: Sequence[Path], flags: Sequence[str]
               ) -> str:
    h = hashlib.sha256()
    h.update(src.encode())
    for hdr in headers:
        h.update(hdr.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def build_many(kind: str, sources: List[str], *, flags: Sequence[str],
               include: Sequence[Path], headers: Sequence[Path] = ()
               ) -> List[Tuple[Path, float]]:
    """Build every source not built yet, one nvcc process each, all
    started together, with ``-I`` for each directory of ``include``;
    ``headers`` are the files the sources include, hashed into the key.
    Returns each shared library with the seconds its nvcc took (0.0
    where it was built already), in order."""
    build_dir = BUILD_ROOT / kind
    build_dir.mkdir(parents=True, exist_ok=True)
    outs, procs = [], {}
    t0 = time.perf_counter()
    for src in sources:
        key = source_key(src, headers, flags)
        so = build_dir / f"{key}.so"
        outs.append(so)
        if so.exists() or so in procs:
            continue
        cu = build_dir / f"{key}.cu"
        cu.write_text(src)
        tmp = build_dir / f"{key}.{os.getpid()}.tmp.so"
        cmd = [nvcc(), *flags, *(f"-I{d}" for d in include), "-o", str(tmp),
               str(cu)]
        log = build_dir / f"{key}.log"
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


class SourceKernel:
    """A kernel library built from one ``.cu`` file of the checkout, at
    first use. ``argtypes`` gives the ctypes signature of each exported C
    function; every function returns ``cudaGetLastError()`` as an int.
    ``headers`` are the files the source includes: their bytes are part
    of the build key and their directories are on the include path."""

    def __init__(self, kind: str, cu: Path,
                 argtypes: Dict[str, List[type]], *,
                 headers: Sequence[Path] = ()) -> None:
        self.kind, self.cu, self.argtypes = kind, cu, argtypes
        self.headers = tuple(headers)
        self._lib = None
        self._fns: Dict[str, object] = {}

    def includes(self) -> List[Path]:
        """The ``-I`` directories: the source's own, then its headers'."""
        dirs = [self.cu.parent]
        for h in self.headers:
            if h.parent not in dirs:
                dirs.append(h.parent)
        return dirs

    def key(self) -> str:
        return source_key(self.cu.read_text(), self.headers, BASE_FLAGS)

    def build(self) -> Tuple[Path, float]:
        return build_many(self.kind, [self.cu.read_text()],
                          flags=BASE_FLAGS, include=self.includes(),
                          headers=self.headers)[0]

    def build_log(self) -> str:
        """What nvcc printed when it built this library (ptxas's
        registers and spills among it); '' where there is no log."""
        log = BUILD_ROOT / self.kind / f"{self.key()}.log"
        return log.read_text() if log.exists() else ""

    def lib(self):
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()[0]))
            fns = {}
            for name, types in self.argtypes.items():
                fn = fns[name] = getattr(lib, name)
                fn.argtypes = types
                fn.restype = ctypes.c_int
            self._lib, self._fns = lib, fns
        return self._lib

    def call(self, name: str, device: int, *args) -> None:
        """``name(*args, stream)`` on the current stream of CUDA device
        ``device`` (``launch_on``); raises where the launch fails."""
        if self._lib is None:
            self.lib()
        err = launch_on(device, self._fns[name], *args)
        if err != 0:
            raise RuntimeError(f"{self.kind}: launch of {name} failed: "
                               f"cudaError {err}")


_SMS: Dict[int, int] = {}


def sm_count(device: int) -> int:
    """The SMs of CUDA device ``device``, read once."""
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def launch_on(device: int, fn, *args) -> int:
    """``fn(*args, stream)`` with the current CUDA stream of ``device``;
    the device is entered only where it is not the current one (a launch
    goes to the current device). The stream and the device come from
    torch's raw calls, as Triton's launcher takes them:
    ``torch.cuda.current_stream()`` builds a Stream object on every call,
    a cost that decode's small launches would pay once each."""
    if torch._C._cuda_getDevice() == device:
        return fn(*args, torch._C._cuda_getCurrentRawStream(device))
    with torch.cuda.device(device):
        return fn(*args, torch._C._cuda_getCurrentRawStream(device))
