"""Spans of the benchmark's own around the port's layers.

The port has no spans of its own yet. A traced run wraps the module
attributes that the metrics name (``"module:attribute"``) in
``torch.profiler.record_function`` ranges called ``bench.<span>``, and,
while ``recording`` is set, keeps a description of every call's arguments
(shapes and dtypes; small integer tensors themselves, such as the expert
FF's per-expert counts) for the metrics that count work from shapes. No
file of the port is edited, and an untraced run wraps nothing.
"""
from __future__ import annotations

import importlib
from collections import defaultdict
from typing import Any, Dict, List, Tuple

import torch

PREFIX = "bench."
#: integer tensors of at most this many elements are kept whole
KEEP_INTS = 1 << 16


def describe(value: Any) -> Any:
    """One argument as the work counters read it."""
    if isinstance(value, torch.Tensor):
        keep = (not value.is_floating_point() and value.numel() <= KEEP_INTS)
        return {"shape": tuple(value.shape), "dtype": str(value.dtype),
                "tensor": value if keep else None}
    if isinstance(value, (bool, int, float, str)) or value is None:
        return value
    return type(value).__name__


class Spans:
    def __init__(self) -> None:
        self.recording = False
        self.calls: Dict[str, List[dict]] = defaultdict(list)
        self._undo: List[Tuple[Any, str, Any]] = []

    def range(self, span: str):
        return torch.profiler.record_function(PREFIX + span)

    def wrap(self, span: str, target: str) -> None:
        """Puts ``target``'s function inside the span ``span``."""
        modname, attr = target.split(":")
        mod = importlib.import_module(modname)
        orig = getattr(mod, attr)
        name = PREFIX + span

        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name):
                if self.recording:
                    self.calls[span].append({
                        "args": [describe(a) for a in args],
                        "kwargs": {k: describe(v)
                                   for k, v in kwargs.items()}})
                return orig(*args, **kwargs)

        wrapper.__wrapped__ = orig
        setattr(mod, attr, wrapper)
        self._undo.append((mod, attr, orig))

    def undo(self) -> None:
        while self._undo:
            mod, attr, orig = self._undo.pop()
            setattr(mod, attr, orig)
