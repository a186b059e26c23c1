"""Fault-tolerant checkpointing (port of ``repro.train.checkpoint``), in
the reference's on-disk format, so that either package restores the
other's checkpoints:

  * ``step_XXXXXXXX/arrays.npz``: one array a leaf of ``{"params": ...,
    "opt": ...}``, its path's ``/`` written as ``__``; bf16 stored as its
    uint16 bits (npz has no bf16);
  * ``step_XXXXXXXX/manifest.json``: step, time, keys, each leaf's dtype
    (``"bfloat16"`` for bf16) and the caller's ``extra`` (the data step);
  * **atomic**: written to ``step_XXXXXXXX.tmp/``, then renamed;
  * **retention**: the last ``keep`` checkpoints stay.

bf16 comes back through ``torch.from_numpy(bits).view(torch.bfloat16)``:
the port needs no ``ml_dtypes``. ``restore`` puts every tensor on the
device it is given (the card unless asked otherwise), in the dtype it was
saved in.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten_into(template: Any, flat: Dict[str, Any],
                    prefix: str = "") -> Any:
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in template.items()}
    if isinstance(template, tuple):
        return tuple(_unflatten_into(v, flat, f"{prefix}{i}/")
                     for i, v in enumerate(template))
    if isinstance(template, list):
        return [_unflatten_into(v, flat, f"{prefix}{i}/")
                for i, v in enumerate(template)]
    return flat[prefix.rstrip("/")]


def _to_numpy(v: Any) -> Tuple[np.ndarray, str]:
    """A leaf as the array stored and the dtype named in the manifest."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(v)
    return a, str(a.dtype)


def _to_tensor(a: np.ndarray, dtype: Optional[str], device) -> torch.Tensor:
    a = np.array(a, order="C")      # keeps 0-d arrays 0-d
    if dtype == "bfloat16":      # stored as its 16 bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- save -------------------------------------------------------------------
    def save(self, step: int, params: Any, opt_state: Any,
             extra: Optional[Dict[str, Any]] = None) -> Path:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)

        flat = _flatten({"params": params, "opt": opt_state})
        arrays = {}
        dtypes: Dict[str, str] = {}
        for k, v in flat.items():
            a, dtypes[k] = _to_numpy(v)
            arrays[k.replace("/", "__")] = a
        np.savez(tmp / "arrays.npz", **arrays)
        manifest = {
            "step": int(step),
            "time": time.time(),
            "keys": sorted(flat.keys()),
            "dtypes": dtypes,
            "extra": extra or {},
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic publish
        self._gc()
        return final

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- query --------------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        s = self.all_steps()
        return s[-1] if s else None

    # -- restore --------------------------------------------------------------------
    def restore(self, template: Tuple[Any, Any], step: Optional[int] = None,
                device=None) -> Tuple[Any, Any, Dict[str, Any]]:
        """template: (params_like, opt_like), trees of the checkpoint's
        structure (any leaves: a blueprint does). Returns (params, opt,
        extra), every tensor on ``device`` (default: the card)."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        final = self.dir / f"step_{step:08d}"
        manifest = json.loads((final / "manifest.json").read_text())
        dtypes = manifest.get("dtypes", {})
        with np.load(final / "arrays.npz") as npz:
            flat = {}
            for k in npz.files:
                key = k.replace("__", "/")
                flat[key] = _to_tensor(npz[k], dtypes.get(key), dev)
        tree = _unflatten_into({"params": template[0], "opt": template[1]},
                               flat)
        return tree["params"], tree["opt"], manifest["extra"]
