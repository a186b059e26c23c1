"""Public wrapper: compile a @kernel handle through the full VOLT pipeline
and launch it with ``simt_launch``."""
from typing import Any, Dict, Optional

from ...convert import to_tensors
from ...device import resolve_device
from ...core.interp import LaunchParams
from ...core.passes.pipeline import PassConfig, run_pipeline
from .simt_exec import simt_launch


def volt_torch_run(kernel_handle, buffers: Dict[str, Any],
                   params: LaunchParams,
                   scalars: Optional[Dict[str, Any]] = None,
                   config: Optional[PassConfig] = None,
                   device=None) -> Dict[str, Any]:
    """Run ``kernel_handle`` on ``device`` (``None`` means the card).

    ``buffers`` may be numpy arrays or tensors; they are copied onto the
    device and the updated copies are returned.
    """
    dev = resolve_device(device)
    module = kernel_handle.build(None)
    ck = run_pipeline(module, kernel_handle.name,
                      config or PassConfig(uni_hw=True, uni_ann=True,
                                           uni_func=True))
    return simt_launch(ck.fn, params, to_tensors(buffers, dev), scalars)
