"""Carry data from the JAX package's world into the port's.

For the compiler, data takes the place of weights: numpy buffer dicts (a
bench's ``make(rng)`` output, ``interp.launch`` buffers), scalar args and
a reference ``LaunchParams`` (read by attribute, so nothing of the
reference is imported). For the LM, the reference's parameter tree and
AdamW state, handed over as numpy arrays.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.interp import LaunchParams
from .core.vir import Ty
from .models.blueprint import Leaf, tree_map

_SCALAR_TYPES = {Ty.I32: np.int32, Ty.F32: np.float32, Ty.BOOL: np.bool_}
_LAUNCH_FIELDS = ("grid", "local_size", "warp_size", "grid_y",
                  "local_size_y", "fuel", "strict_oob_loads")


def to_tensors(buffers: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """Copy each buffer (numpy array or tensor) to a contiguous tensor on
    ``device``; the caller's arrays are never aliased."""
    out = {}
    for k, v in buffers.items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().to(device, copy=True).contiguous()
        else:
            out[k] = torch.from_numpy(np.array(v, copy=True)).to(device)
    return out


def to_numpy(buffers: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in buffers.items()}


def to_scalars(scalars: Dict[str, Any], kernel_fn) -> Dict[str, Any]:
    """Typed scalar args for ``kernel_fn``: numpy int32, float32 or bool
    after each scalar param's type."""
    return {p.name: _SCALAR_TYPES[p.ty](scalars[p.name])
            for p in kernel_fn.params
            if p.ty is not Ty.PTR and p.name in scalars}


def launch_params(ref) -> LaunchParams:
    """The port's ``LaunchParams`` from any object with the same
    attributes (the reference's ``interp.LaunchParams``)."""
    return LaunchParams(**{f: getattr(ref, f) for f in _LAUNCH_FIELDS})


def lm_params_from_numpy(tree: Any, device, dtype_of: Any) -> Any:
    """The port's LM params from the reference's parameter tree given as
    numpy arrays (dicts and lists, leaf for leaf). ``dtype_of`` is the
    port's blueprint of the same model: each array must have its Leaf's
    shape and is cast to its Leaf's dtype. numpy has no bfloat16, so a
    bf16 reference leaf comes as float32; bf16 -> f32 -> bf16 is exact."""
    def one(a: np.ndarray, l: Leaf) -> torch.Tensor:
        if tuple(a.shape) != l.shape:
            raise ValueError(f"param shape {a.shape} != blueprint {l.shape}")
        return torch.from_numpy(np.array(a, copy=True)).to(device, l.dtype)

    return tree_map(one, tree, dtype_of)


def opt_state_from_numpy(state: Any, device, dtype_of: Any,
                         state_dtype: torch.dtype = torch.float32) -> Any:
    """The port's AdamW state from the reference's, given as numpy:
    ``{"step": int, "m": tree, "v": tree}`` with m and v leaf for leaf
    like ``dtype_of``, the port's blueprint of the model (shapes checked
    against it). The step becomes a 0-d int32 tensor and each moment a
    tensor of ``state_dtype`` (float32 by default, as the reference's
    ``AdamWConfig``), on ``device``."""
    def one(a: np.ndarray, l: Leaf) -> torch.Tensor:
        if tuple(a.shape) != l.shape:
            raise ValueError(f"moment shape {a.shape} != blueprint "
                             f"{l.shape}")
        return torch.from_numpy(np.array(a, copy=True)).to(device,
                                                            state_dtype)

    return {"step": torch.tensor(int(state["step"]), dtype=torch.int32,
                                 device=device),
            "m": tree_map(one, state["m"], dtype_of),
            "v": tree_map(one, state["v"], dtype_of)}

