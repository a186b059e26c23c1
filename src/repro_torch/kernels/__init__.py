"""Hand-written Hopper kernels of the port, one package each."""
import torch


def needs_grad(*tensors: torch.Tensor) -> bool:
    """Autograd records a call on these inputs: grad mode is on and one
    of them requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def plain_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the plain versions compute in: float32, or float64 for
    float64 inputs (``torch.autograd.gradcheck``'s)."""
    return torch.float64 if dtype == torch.float64 else torch.float32
