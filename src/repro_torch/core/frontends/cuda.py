"""CUDA-like dialect (the CuPBoP-path analogue in the paper).

Kernel language: threadIdx/blockIdx/blockDim/gridDim attributes,
__syncthreads, atomicAdd/Max/Min, warp-level primitives
(__ballot_sync/__any_sync/__all_sync/__shfl_sync) which — per Case Study 1 —
are recognized as NVVM-style intrinsic calls and replaced with Vortex
``vx_vote``/``vx_shfl`` built-ins in the runtime library, and
__shared__ arrays.

Host-side APIs (Case Study 2) live in core.runtime: cudaMemcpyToSymbol is
emulated by buffering host data and materializing it into global memory just
before kernel launch.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from ..vir import Const, Module, Op, Ty, Value
from .ast_frontend import Dialect, Translator, compile_python_kernel


def _tid(tr: Translator, dim: int = 0):
    return tr.b.intr("local_id", dim)


def _bid(tr: Translator, dim: int = 0):
    return tr.b.intr("group_id", dim)


def _bdim(tr: Translator, dim: int = 0):
    return tr.b.intr("local_size", dim)


def _gdim(tr: Translator, dim: int = 0):
    return tr.b.intr("num_groups", dim)


def _sync(tr: Translator, args: List[Value]):
    tr.b.barrier("local")
    return None


def _atomic(kind: str):
    def h(tr: Translator, args: List[Value]):
        ptr, idx, val = args[0], tr._coerce(args[1], Ty.I32), args[2]
        return tr.b.atomic(kind, ptr, idx, val)
    return h


def _vote(mode: str):
    # CUDA signature: __xxx_sync(mask, pred). The mask argument is dropped:
    # Vortex vx_vote operates on the current hardware thread mask (the VOLT
    # runtime-library shim does the same, Case Study 1).
    def h(tr: Translator, args: List[Value]):
        pred = args[1] if len(args) > 1 else args[0]
        return tr.b.vote(mode, tr._as_bool(pred))
    return h


def _shfl(tr: Translator, args: List[Value]):
    # __shfl_sync(mask, val, srcLane)
    val = args[1] if len(args) > 2 else args[0]
    lane = args[-1]
    return tr.b.shfl(val, tr._coerce(lane, Ty.I32))


def _popc(tr: Translator, args: List[Value]):
    return tr.b.unop(Op.POPC, tr._coerce(args[0], Ty.I32))


def _ffs(tr: Translator, args: List[Value]):
    return tr.b.unop(Op.FFS, tr._coerce(args[0], Ty.I32))


def _lane_id(tr: Translator, args: List[Value]):
    return tr.b.intr("lane_id", 0)


def _warp_id(tr: Translator, args: List[Value]):
    return tr.b.intr("warp_id", 0)


DIALECT = Dialect(
    name="cuda",
    call_handlers={
        "__syncthreads": _sync,
        "atomicAdd": _atomic("add"),
        "atomicMax": _atomic("max"),
        "atomicMin": _atomic("min"),
        "atomicExch": _atomic("xchg"),
        "atomicCAS": _atomic("cas"),
        "__ballot_sync": _vote("ballot"),
        "__any_sync": _vote("any"),
        "__all_sync": _vote("all"),
        "__shfl_sync": _shfl,
        "__shfl_idx_sync": _shfl,
        "__lane_id": _lane_id,
        "__warp_id": _warp_id,
        "__popc": _popc,
        "__ffs": _ffs,
    },
    attr_handlers={
        ("threadIdx", "x"): lambda tr: _tid(tr, 0),
        ("threadIdx", "y"): lambda tr: _tid(tr, 1),
        ("blockIdx", "x"): lambda tr: _bid(tr, 0),
        ("blockIdx", "y"): lambda tr: _bid(tr, 1),
        ("blockDim", "x"): lambda tr: _bdim(tr, 0),
        ("blockDim", "y"): lambda tr: _bdim(tr, 1),
        ("gridDim", "x"): lambda tr: _gdim(tr, 0),
        ("gridDim", "y"): lambda tr: _gdim(tr, 1),
    },
    shared_decls=("__shared__",),
)


class _KernelHandle:
    def __init__(self, pyfunc: Callable, deps: Sequence[Callable]) -> None:
        self.pyfunc = pyfunc
        self.deps = tuple(deps)
        self.name = pyfunc.__name__
        self._vir_function = None

    def build(self, module: Optional[Module] = None) -> Module:
        module = module or Module(self.name)
        fn = compile_python_kernel(module, DIALECT, self.pyfunc,
                                   device_deps=self.deps)
        self._vir_function = fn
        return module


def kernel(fn: Callable = None, *, deps: Sequence[Callable] = ()):
    """``@cuda.kernel`` decorator."""
    def wrap(f: Callable) -> _KernelHandle:
        return _KernelHandle(f, deps)
    return wrap(fn) if fn is not None else wrap


def device(fn: Callable) -> Callable:
    fn._vir_function = None  # type: ignore[attr-defined]
    return fn
