"""The selective-scan (Mamba SSM) recurrence, as a CUDA kernel on Hopper.

Replaces ``repro/kernels/selective_scan/selective_scan.py:selective_scan``
(the Pallas TPU kernel). ``csrc/selective_scan.cu`` holds the kernel and
its note: one thread per (batch, channel), its states in registers,
bound by bytes. It is built with nvcc at first use into
``build/selective_scan/<sha256>.so`` and launched through ctypes on the
current stream.

The TPU kernel carries the (d, n) state in scratch memory across the
chunks of a sequential grid axis. Here the caller may hand a state ``h``
(B, d, n) float32 in: it is read as the first state and overwritten in
place with the last, so that ``models/ssm.py`` can walk a sequence chunk
by chunk, making each chunk's dA and dBx only when it needs them.
Without ``h`` the state starts at zero and the function is the TPU
kernel's.

On CPU tensors ``selective_scan`` runs ``selective_scan_plain``, the same
recurrence as a torch loop over the steps. A CUDA tensor goes to the
kernel or raises; there is no fallback. The wrapper records nothing
for autograd: the gradient goes through
``selective_scan_bwd.SelectiveScan``, which hands the kernel a fresh
state.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from ..build import SourceKernel

#: launches of the CUDA kernel; the plain version does not count
LAUNCHES = 0
#: state sizes the kernel takes (its states live in registers)
STATE_SIZES = (4, 8, 16)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
KERNEL = SourceKernel(
    "selective_scan",
    Path(__file__).resolve().parent / "csrc" / "selective_scan.cu",
    {f"selective_scan_{t}": [_P] * 5 + [_I] * 4 + [_P]
     for t in _SUFFIX.values()})


def _shapes(dA, dBx, Cm, h):
    if dA.dim() != 4 or dBx.shape != dA.shape or Cm.dim() != 3:
        raise ValueError(f"selective_scan takes dA and dBx (B, S, d, n) and "
                         f"Cm (B, S, n), got {tuple(dA.shape)}, "
                         f"{tuple(dBx.shape)}, {tuple(Cm.shape)}")
    B, S, d, n = dA.shape
    if Cm.shape != (B, S, n):
        raise ValueError(f"Cm {tuple(Cm.shape)} does not fit dA "
                         f"{tuple(dA.shape)}: it must be (B, S, n)")
    if h is not None and (h.shape != (B, d, n) or h.dtype != torch.float32):
        raise ValueError(f"the state h must be (B, d, n) = {(B, d, n)} "
                         f"float32, got {tuple(h.shape)} {h.dtype}")
    return B, S, d, n


def selective_scan_plain(dA: torch.Tensor, dBx: torch.Tensor,
                         Cm: torch.Tensor,
                         h: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``h_t = dA_t * h + dBx_t``, ``y_t = h_t @ Cm_t`` as a loop over the
    steps in float32, y cast to dA's dtype; any device. ``h``, where
    given, is the first state and receives the last."""
    B, S, d, n = _shapes(dA, dBx, Cm, h)
    a, bx, c = dA.float(), dBx.float(), Cm.float()
    state = (torch.zeros(B, d, n, device=dA.device) if h is None
             else h.clone())
    y = torch.empty(B, S, d, device=dA.device)
    for t in range(S):
        state = a[:, t] * state + bx[:, t]
        y[:, t] = torch.bmm(state, c[:, t, :, None])[..., 0]
    if h is not None:
        h.copy_(state)
    return y.to(dA.dtype)


def selective_scan(dA: torch.Tensor, dBx: torch.Tensor, Cm: torch.Tensor,
                   h: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dA, dBx: (B, S, d, n), Cm: (B, S, n) -> y (B, S, d) in dA's dtype,
    float32 or bfloat16. ``h`` (B, d, n) float32, where given, is the
    first state and is overwritten with the last. CPU tensors take the
    plain version, CUDA tensors the kernel."""
    global LAUNCHES
    B, S, d, n = _shapes(dA, dBx, Cm, h)
    if dA.dtype not in _SUFFIX or {dBx.dtype, Cm.dtype} != {dA.dtype}:
        raise TypeError(f"selective_scan takes float32 or bfloat16 dA, dBx, "
                        f"Cm of one dtype, got {dA.dtype}, {dBx.dtype}, "
                        f"{Cm.dtype}")
    tensors = [dA, dBx, Cm] + ([] if h is None else [h])
    devices = {t.device for t in tensors}
    if devices == {torch.device("cpu")}:
        return selective_scan_plain(dA, dBx, Cm, h)
    if len(devices) != 1 or dA.device.type != "cuda":
        raise ValueError(f"selective_scan kernel: dA, dBx, Cm, h on "
                         f"{devices}; all must be on one CUDA device")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError("selective_scan kernel: dA, dBx, Cm and h must be "
                         "contiguous and 16-byte aligned")
    n_blocks = B * -(-d // 128)
    if n not in STATE_SIZES or n_blocks >= 2**31:
        raise ValueError(f"selective_scan kernel: state size n = {n} (it "
                         f"takes {STATE_SIZES}), {n_blocks} blocks")
    y = torch.empty(B, S, d, dtype=dA.dtype, device=dA.device)
    if y.numel() == 0:
        return y
    KERNEL.call(f"selective_scan_{_SUFFIX[dA.dtype]}", dA.get_device(),
                dA.data_ptr(), dBx.data_ptr(), Cm.data_ptr(),
                None if h is None else h.data_ptr(), y.data_ptr(), B, S, d,
                n)
    LAUNCHES += 1
    return y
