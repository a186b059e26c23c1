"""Spans and counters of the program's own.

``span(name)`` marks a stretch of the host's work, ``count(name, value)``
adds to a counter. Tracing is off by default, and then a span is one
shared object that does nothing, reached after one test of a module
flag: no profiler range is opened and no description is built.

With tracing on (``enable(True)``), a span opens a profiler range named
``repro_torch.<name>``: torch's ``_RecordFunctionFast`` where torch has
it, about a microsecond from Python, else
``torch.profiler.record_function``, some tens of microseconds. A
profiler that is running records it on the host's clock, the clock of
its device events too, so each kernel can be put down to the spans open
on the thread that launched it. Spans nest; a span entered from
autograd's backward opens on the thread that runs the backward.

  * ``train.step``, ``train.forward``, ``train.backward``,
    ``train.optimizer``, ``train.grad_norm``: ``train/train_step.py``;
  * ``lm.prefill``, ``lm.period`` (a period of the stack: its forward,
    and its recomputation in the backward under remat), ``lm.loss_head``:
    ``models/transformer.py``;
  * ``moe.ff``, ``moe.route``, ``moe.dispatch``, ``moe.expert_ff``,
    ``moe.combine``: ``models/moe.py``;
  * ``kernel.<name>``: the Python entry of a kernel (``kernel``), which
    also keeps each call's description (``describe``: shapes and
    dtypes, small integer tensors whole) while tracing is on.

Counters are numbers by name. A host number (an ``int`` or a ``float``)
is always counted; a tensor is added on its device, only while tracing
is on, and never read back until ``counters()``, the one call that
waits for the device. ``reset()`` clears the counters and the kept
descriptions. Host counters that are always kept: each kernel's launches
by route (``Routes``, the kernels' ``LAUNCHES_BY_ROUTE``), and
``kernel.builds``, ``kernel.build_s`` and ``kernel.loads`` of
``kernels/build.py``.
"""
from __future__ import annotations

import functools
from collections import defaultdict
from collections.abc import MutableMapping
from typing import Any, Callable, Dict, Iterable, List

import torch

PREFIX = "repro_torch."
#: integer tensors of at most this many elements are kept whole: the
#: expert FF's per-expert counts (one an expert), not the combine's (T, k)
#: slots, which, kept for every call of a traced stretch, would make the
#: allocator take new device memory inside it
KEEP_INTS = 1 << 12

_on = False
_host: Dict[str, Any] = {}
_device: Dict[str, torch.Tensor] = {}
_calls: Dict[str, List[dict]] = defaultdict(list)


class _Off:
    """The span of a program that is not traced."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)


def enable(flag: bool = True) -> None:
    global _on
    _on = bool(flag)


def enabled() -> bool:
    return _on


def describe(value: Any) -> Any:
    """One argument of a kernel's call: a tensor's shape and dtype, and
    the tensor itself where it holds at most ``KEEP_INTS`` integers."""
    if isinstance(value, torch.Tensor):
        keep = (not value.is_floating_point() and value.numel() <= KEEP_INTS)
        return {"shape": tuple(value.shape), "dtype": str(value.dtype),
                "tensor": value if keep else None}
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    return type(value).__name__


def span(name: str, **desc):
    """``with span(name):`` around a stretch of the program; ``desc``, a
    kernel call's ``args`` and ``kwargs``, is described and kept under
    ``name`` while tracing is on."""
    if not _on:
        return _OFF
    if desc:
        _calls[name].append({"args": [describe(a) for a in desc["args"]],
                             "kwargs": {k: describe(v) for k, v in
                                        desc["kwargs"].items()}})
    return _RANGE(PREFIX + name)


def kernel(name: str) -> Callable:
    """Decorates a kernel's Python entry: the span ``kernel.<name>``
    around each call, with its description."""
    full = "kernel." + name

    def wrap(fn):
        @functools.wraps(fn)
        def entry(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with span(full, args=args, kwargs=kwargs):
                return fn(*args, **kwargs)
        return entry
    return wrap


def count(name: str, value) -> None:
    """Adds ``value`` to the counter ``name``: a host number always, a
    tensor (on its device, in 64 bits) while tracing is on."""
    if not isinstance(value, torch.Tensor):
        _host[name] = _host.get(name, 0) + value
    elif _on:
        have = _device.get(name)
        if have is None:
            wide = torch.float64 if value.is_floating_point() else torch.int64
            _device[name] = value.detach().to(wide, copy=True)
        else:
            have.add_(value.detach())


def counters() -> Dict[str, Any]:
    """A snapshot: every counter by name, a tensor's as a number or a
    list. Waits for the device."""
    out = dict(_host)
    for name, t in _device.items():
        out[name] = t.item() if t.dim() == 0 else t.tolist()
    return out


def calls() -> Dict[str, List[dict]]:
    """The descriptions of the kernel calls made while tracing was on,
    by span name, since ``reset()``."""
    return {k: list(v) for k, v in _calls.items()}


def reset() -> None:
    _host.clear()
    _device.clear()
    _calls.clear()


class Routes(MutableMapping):
    """A kernel's launches by route as a dict, kept in the host counters
    ``launches.<kernel>.<route>``."""

    def __init__(self, kernel_name: str, routes: Iterable[str]) -> None:
        self._names = {r: f"launches.{kernel_name}.{r}" for r in routes}

    def __getitem__(self, route: str):
        return _host.get(self._names[route], 0)

    def __setitem__(self, route: str, value) -> None:
        _host[self._names[route]] = value

    def __delitem__(self, route: str) -> None:
        raise TypeError("a kernel's routes are fixed")

    def __iter__(self):
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def __repr__(self) -> str:
        return repr(dict(self))
