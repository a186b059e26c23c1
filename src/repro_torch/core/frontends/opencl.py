"""OpenCL-like dialect (the PoCL-path analogue in the paper).

Kernel-language intrinsics: get_global_id, get_local_id, get_group_id,
get_local_size, get_num_groups, get_global_size, barrier, atomic_*,
local_array (``__local`` memory), plus warp-level extensions exposed the way
VOLT's built-in library exposes them (sub_group_any/all/ballot/shuffle).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from ..vir import Const, Module, Op, Ty, Value
from .ast_frontend import Dialect, Translator, compile_python_kernel


def _dim_of(args: List[Value]) -> int:
    if args and isinstance(args[0], Const):
        return int(args[0].value)
    return 0


def _intr(name: str):
    def h(tr: Translator, args: List[Value]):
        return tr.b.intr(name, _dim_of(args))
    return h


def _barrier(tr: Translator, args: List[Value]):
    tr.b.barrier("local")
    return None


def _atomic(kind: str):
    def h(tr: Translator, args: List[Value]):
        ptr, idx, val = args[0], tr._coerce(args[1], Ty.I32), args[2]
        return tr.b.atomic(kind, ptr, idx, val)
    return h


def _vote(mode: str):
    def h(tr: Translator, args: List[Value]):
        return tr.b.vote(mode, tr._as_bool(args[0]))
    return h


def _shfl(tr: Translator, args: List[Value]):
    return tr.b.shfl(args[0], tr._coerce(args[1], Ty.I32))


def _printf(tr: Translator, args: List[Value]):
    tr.b.emit(Op.PRINT, list(args))
    return None


DIALECT = Dialect(
    name="opencl",
    call_handlers={
        "get_global_id": _intr("global_id"),
        "get_local_id": _intr("local_id"),
        "get_group_id": _intr("group_id"),
        "get_local_size": _intr("local_size"),
        "get_num_groups": _intr("num_groups"),
        "get_global_size": _intr("global_size"),
        "get_num_threads": _intr("num_threads"),
        "get_num_warps": _intr("num_warps"),
        "get_warp_id": _intr("warp_id"),
        "get_core_id": _intr("core_id"),
        "barrier": _barrier,
        "atomic_add": _atomic("add"),
        "atomic_max": _atomic("max"),
        "atomic_min": _atomic("min"),
        "atomic_xchg": _atomic("xchg"),
        "atomic_cas": _atomic("cas"),
        "sub_group_any": _vote("any"),
        "sub_group_all": _vote("all"),
        "sub_group_ballot": _vote("ballot"),
        "sub_group_shuffle": _shfl,
        "printf": _printf,
    },
    shared_decls=("local_array",),
)


class _KernelHandle:
    """Lazy-compiled kernel: call .compile() or launch via core.runtime."""

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
    """``@opencl.kernel`` decorator."""
    def wrap(f: Callable) -> _KernelHandle:
        return _KernelHandle(f, deps)
    return wrap(fn) if fn is not None else wrap


def device(fn: Callable) -> Callable:
    """``@opencl.device`` helper-function decorator (compiled on demand as an
    internal-linkage function; feeds Algorithm 1)."""
    fn._vir_function = None  # type: ignore[attr-defined]
    return fn
